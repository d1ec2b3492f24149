"""The port's HF checkpoint import and export against the JAX package's,
on the CPU.

- JAX ``init_params`` of f32 and bf16 ``tiny_llama`` and ``tiny_mla``,
  exported by JAX ``to_hf_state_dict``, loads through the port's
  ``load_hf`` from the dict, from a two-shard safetensors directory with
  an index (written by the ``safetensors`` package, BF16 for the bf16
  trees) and from a ``pytorch_model.bin`` directory, bit for bit equal to
  ``params_from_jax`` of the JAX tree (serving and master dtypes);
- the port's ``to_hf_state_dict``, read back by JAX
  ``from_hf_state_dict``, equals the JAX tree;
- MoE (Mixtral's or DeepSeek's) keys in a dense-MLP config and a
  low-rank q in a full-rank one (or the reverse) are refused as config
  mismatches, and so are unknown keys, missing keys raise, all by name
  before any tensor is read (DeepSeek's own import is
  ``tests/test_torch_deepseek.py``);
- an engine served from HF-loaded weights gives the JAX engine's greedy
  tokens on the same state dict.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from safetensors.torch import save_file

from k8s_runpod_kubelet_tpu.models import convert as jconvert
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models import convert
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
SMALL = dict(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
             max_seq_len=256)


def _jcfg(family: str, dtype: str):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    make = jllama.tiny_mla if family == "mla" else jllama.tiny_llama
    extra = {} if family == "mla" else dict(n_heads=4, n_kv_heads=2)
    return make(**SMALL, **extra, dtype=jdt, param_dtype=jdt)


def _case(family: str, dtype: str):
    """(JAX config, JAX tree as numpy, port config, HF state dict)."""
    jcfg = _jcfg(family, dtype)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_init_params(jcfg, jax.random.PRNGKey(5)))
    cfg = config_from_jax(jcfg, torch.float32 if dtype == "f32"
                          else torch.bfloat16)
    return jcfg, tree, cfg, jconvert.to_hf_state_dict(jcfg, tree)


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        if name == "layers":
            _assert_params_equal(got[name], want[name])
            continue
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def _write_sharded(sd: dict, path: str, dtype: torch.dtype):
    """Two safetensors shards and their index, as HF writes them."""
    tensors = {k: torch.from_numpy(np.array(v, order="C")).to(dtype)
               for k, v in sd.items()}
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    weight_map = {}
    for fname, keys in shards.items():
        save_file({k: tensors[k] for k in keys}, os.path.join(path, fname))
        weight_map.update(dict.fromkeys(keys, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


CASES = [("dense", "f32"), ("dense", "bf16"), ("mla", "f32"), ("mla", "bf16")]


@pytest.mark.parametrize("family,dtype", CASES)
def test_load_hf_matches_params_from_jax(tmp_path, family, dtype):
    _, tree, cfg, sd = _case(family, dtype)
    want = params_from_jax(tree, cfg, device="cpu")
    _assert_params_equal(convert.load_hf(cfg, sd, device="cpu"), want)
    _assert_params_equal(convert.load_hf(cfg, sd, device="cpu", master=True),
                         params_from_jax(tree, cfg, device="cpu",
                                         master=True))
    # the bf16 trees' values are bf16 numbers: BF16 files hold them exactly
    st_dir = tmp_path / "st"
    st_dir.mkdir()
    _write_sharded(sd, str(st_dir), torch.float32 if dtype == "f32"
                   else torch.bfloat16)
    _assert_params_equal(convert.load_hf(cfg, str(st_dir), device="cpu"),
                         want)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    torch.save({k: torch.from_numpy(np.array(v, order="C"))
                for k, v in sd.items()}, bin_dir / "pytorch_model.bin")
    _assert_params_equal(convert.load_hf(cfg, str(bin_dir), device="cpu"),
                         want)


@pytest.mark.parametrize("family,dtype", CASES)
def test_to_hf_round_trips_through_jax(family, dtype):
    jcfg, tree, cfg, _ = _case(family, dtype)
    ours = convert.to_hf_state_dict(
        cfg, params_from_jax(tree, cfg, device="cpu", master=True))
    back = jconvert.from_hf_state_dict(jcfg, ours)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        ref = flat_b[path]
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, path
        assert np.array_equal(np.asarray(leaf, np.float32),
                              np.asarray(ref, np.float32)), path


def test_safetensors_reader_dtypes(tmp_path):
    """BF16, F16, F32 and I8 read back bit for bit, unsharded."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn((3, 5), generator=g).to(torch.bfloat16),
               "b": torch.randn((7,), generator=g).to(torch.float16),
               "c": torch.randn((2, 2, 2), generator=g),
               "d": torch.randint(-127, 128, (9,), generator=g,
                                  dtype=torch.int8)}
    save_file(tensors, str(tmp_path / "model.safetensors"))
    got = convert._read_dir_state_dict(str(tmp_path))
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    got["a"].zero_()   # a private map: the file keeps its bytes
    again = convert.read_safetensors(str(tmp_path / "model.safetensors"))
    assert torch.equal(again["a"], tensors["a"])


def _names(cfg) -> dict:
    """Every key of a checkpoint of ``cfg``, each value None: a check that
    read a tensor would fail on it."""
    sd = dict.fromkeys("model." + k for k in convert.expected_keys(cfg))
    sd["lm_head.weight"] = None
    return sd


# Mixtral's and DeepSeek's MoE keys load into their MoE configs; into this
# dense-MLP, full-rank-q MLA config each is refused by name as a config
# mismatch (ValueError), as the low-rank q is
@pytest.mark.parametrize("extra,match,error", [
    ("model.layers.1.mlp.experts.0.gate_proj.weight", "DeepSeek-MoE",
     ValueError),
    ("model.layers.0.block_sparse_moe.gate.weight", "Mixtral", ValueError),
    ("model.layers.1.mlp.gate.weight", "DeepSeek-MoE", ValueError),
    ("model.layers.0.self_attn.q_a_proj.weight",
     "low-rank q.*mla_q_lora_rank=None", ValueError),
], ids=["moe", "mixtral", "dense_prefix_router", "q_lora"])
def test_refused_by_key_name(extra, match, error):
    cfg = config_from_jax(_jcfg("mla", "f32"), torch.float32)
    sd = _names(cfg)
    sd[extra] = None
    with pytest.raises(error, match=match):
        convert.load_hf(cfg, sd, device="cpu")


def test_unknown_and_missing_keys_refused(tmp_path):
    cfg = config_from_jax(_jcfg("dense", "f32"), torch.float32)
    sd = _names(cfg)
    sd["model.layers.0.self_attn.q_proj.bias"] = None
    with pytest.raises(ValueError, match="no place"):
        convert.load_hf(cfg, sd, device="cpu")
    sd = _names(cfg)
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = None   # no weight
    convert.check_keys(cfg, sd)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        convert.load_hf(cfg, sd, device="cpu")
    # a directory is checked from its headers: an expert key refuses it
    # before any tensor is read
    save_file({"model.layers.0.mlp.experts.0.up_proj.weight":
               torch.zeros(2)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="DeepSeek-MoE"):
        convert.load_hf(cfg, str(tmp_path), device="cpu")
    # a low-rank-q config refuses a full-rank checkpoint by name
    q_cfg = config_from_jax(jllama.tiny_mla(**SMALL, mla_q_lora_rank=32),
                            torch.float32)
    full = _names(config_from_jax(_jcfg("mla", "f32"), torch.float32))
    with pytest.raises(ValueError, match="full-rank"):
        convert.load_hf(q_cfg, full, device="cpu")


@pytest.mark.parametrize("family", ["dense", "mla"])
def test_engine_from_hf_matches_the_jax_engine(family):
    jcfg, _, cfg, sd = _case(family, "f32")
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 128, n)] for n in (5, 19, 33)]
    sc = dict(slots=2, max_prefill_len=32, cache_len=96, max_new_tokens=10,
              kv_page_tokens=8)
    jeng = JaxServingEngine(jcfg, jconvert.load_hf(jcfg, sd),
                            JaxServingConfig(**sc)).start()
    try:
        ref = [jeng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
    finally:
        jeng.stop()
    eng = ServingEngine(cfg, convert.load_hf(cfg, sd, device="cpu"),
                        ServingConfig(**sc), device="cpu").start()
    try:
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
    finally:
        eng.stop()
    assert got == ref


def test_reading_a_directory_loads_no_safetensors_transformers_or_jax(
        tmp_path):
    """The card's machine has no safetensors package: the port reads the
    format itself, in a fresh interpreter that never imports it."""
    _write_sharded(_case("dense", "bf16")[3], str(tmp_path), torch.bfloat16)
    code = (
        "import sys, torch\n"
        "from k8s_runpod_kubelet_tpu_torch.models import convert, tiny_llama\n"
        f"cfg = tiny_llama(**{dict(SMALL, n_heads=4, n_kv_heads=2)!r}, "
        "dtype=torch.bfloat16)\n"
        f"p = convert.load_hf(cfg, {str(tmp_path)!r}, device='cpu')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "      ('safetensors', 'transformers', 'jax')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_cli_flags_load_the_checkpoint(tmp_path, caplog):
    """--hf-checkpoint on serve_main and train_main: the engine serves the
    directory's weights; the trainer starts from them."""
    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS, init_params
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main, train_main

    cfg = MODEL_CONFIGS["tiny"]()
    params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    save_file(convert.to_hf_state_dict(cfg, params),
              str(tmp_path / "model.safetensors"))
    args = serve_main.parse_args(["--device", "cpu", "--model", "tiny",
                                  "--slots", "2", "--cache-len", "64",
                                  "--hf-checkpoint", str(tmp_path)])
    engine, _ = serve_main.build_engine(args)
    try:
        _assert_params_equal(engine.params, params)
    finally:
        engine.stop()
    caplog.set_level("INFO")
    assert train_main.main(["--device", "cpu", "--model", "tiny", "--steps",
                            "1", "--batch", "2", "--seq-len", "32",
                            "--hf-checkpoint", str(tmp_path)]) == 0
    assert "initializing from HF checkpoint" in caplog.text
