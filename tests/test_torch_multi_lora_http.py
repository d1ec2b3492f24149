"""Multi-LoRA through the port's HTTP front and CLI, on the CPU (an f32
byte-vocabulary tiny model, adapters with non-zero B written by the
port's ``save_adapter``):

- POST /adapters: 403 without --dynamic-adapters, 200 with it (the
  adapter then serves), 400 on a missing or corrupt file with the detail
  kept out of the answer;
- GET /v1/models lists the base model and the adapters;
- the OpenAI "model" field selects an adapter (the same text as /generate
  with "adapter"), the base model's name serves the base, an unknown name
  is a 404; /generate with an unknown adapter is a 400;
- /v1/embeddings refuses an adapter's name (400) and an unknown one (404);
- the CLI: the LoRA flags reach the engine, and ``--lora-rank`` with an
  MLA model is refused before any weight is drawn.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from k8s_runpod_kubelet_tpu_torch.models import (LoraConfig, apply_lora,
                                                 init_params, save_adapter,
                                                 tiny_llama)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.tokenizer import ByteTokenizer

TIMEOUT = 120
TARGETS = ("wq", "wv", "w_up")


def _http(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An engine with --lora-rank 4 behind two fronts: one with
    --dynamic-adapters, one without; an adapter file on disk."""
    cfg = tiny_llama(vocab_size=260, embed_dim=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=64, max_seq_len=128,
                     dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wrapped = apply_lora(cfg, params, LoraConfig(rank=4, targets=TARGETS),
                         torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    for t in TARGETS:
        w = wrapped["layers"][t]["lora_b"]
        w.copy_(torch.randn(w.shape, generator=gen) * 0.5)
    path = save_adapter(str(tmp_path_factory.mktemp("ad") / "tenant"),
                        wrapped)
    tok = ByteTokenizer()
    eng = ServingEngine(cfg, params, ServingConfig(
        slots=2, max_prefill_len=32, cache_len=64, max_new_tokens=6,
        kv_page_tokens=8, eos_token=tok.eos_id, lora_rank=4,
        lora_targets=TARGETS, max_adapters=2), device="cpu").start()
    on = serve(eng, port=0, tokenizer=tok, host="127.0.0.1",
               allow_adapters=True)
    off = serve(eng, port=0, tokenizer=tok, host="127.0.0.1")
    yield eng, on.server_address[1], off.server_address[1], path
    for httpd in (on, off):
        httpd.shutdown()
        httpd.server_close()
    eng.stop()


def test_adapters_route_registers_only_when_enabled(served, tmp_path):
    eng, on, off, path = served
    status, body = _http(off, "POST", "/adapters",
                         {"name": "tenant", "path": path})
    assert status == 403 and "--dynamic-adapters" in body["error"]
    assert eng.adapter_names == ()
    assert _http(on, "POST", "/adapters", {"name": "tenant",
                                           "path": path}) \
        == (200, {"registered": "tenant"})
    assert eng.adapter_names == ("tenant",)
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(b"not a zip")
    for bad in ({"name": "x", "path": str(tmp_path / "missing.npz")},
                {"name": "x", "path": str(corrupt)}, {"name": "x"}):
        status, body = _http(on, "POST", "/adapters", bad)
        assert status == 400
        assert body == {"error": "adapter registration failed (see server "
                                 "log)"}
    status, body = _http(on, "GET", "/v1/models")
    assert status == 200
    assert [(m["id"], m["owned_by"]) for m in body["data"]] == [
        ("tiny", "base"), ("tenant", "adapter")]


def test_model_field_selects_the_adapter(served):
    eng, on, _, path = served
    if "tenant" not in eng.adapter_names:
        _http(on, "POST", "/adapters", {"name": "tenant", "path": path})
    prompt = "the quick brown fox"
    texts = {}
    for model in ("tenant", "tiny", None):
        body = {"prompt": prompt, "max_tokens": 6, "temperature": 0}
        if model:
            body["model"] = model
        status, out = _http(on, "POST", "/v1/completions", body)
        assert status == 200, out
        texts[model] = out["choices"][0]["text"]
    status, gen = _http(on, "POST", "/generate",
                        {"text": prompt, "max_new_tokens": 6,
                         "temperature": 0, "adapter": "tenant"})
    assert status == 200
    _, base = _http(on, "POST", "/generate",
                    {"text": prompt, "max_new_tokens": 6, "temperature": 0})
    assert texts["tenant"] == gen["text"]
    assert texts["tiny"] == texts[None] == base["text"]
    assert gen["tokens"] != base["tokens"]     # the adapter bites
    status, out = _http(on, "POST", "/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "hi"}],
                         "model": "nobody", "max_tokens": 2})
    assert status == 404 and "does not exist" in out["error"]["message"]
    status, out = _http(on, "POST", "/generate",
                        {"tokens": [1, 2], "adapter": "nobody"})
    assert status == 400 and "unknown adapter" in out["error"]


def test_embeddings_refuse_adapter_names(served):
    eng, on, _, path = served
    if "tenant" not in eng.adapter_names:
        _http(on, "POST", "/adapters", {"name": "tenant", "path": path})
    body = {"input": [1, 2, 3]}
    assert _http(on, "POST", "/v1/embeddings", body)[0] == 200
    assert _http(on, "POST", "/v1/embeddings",
                 dict(body, model="tiny"))[0] == 200
    status, out = _http(on, "POST", "/v1/embeddings",
                        dict(body, model="tenant"))
    assert status == 400 and "base model" in out["error"]["message"]
    assert _http(on, "POST", "/v1/embeddings",
                 dict(body, model="nobody"))[0] == 404


def test_cli_lora_flags():
    args = serve_main.parse_args(["--device", "cpu", "--model", "tiny",
                                  "--lora-rank", "8", "--lora-targets",
                                  "wq,wk,wo", "--max-adapters", "3",
                                  "--dynamic-adapters"])
    assert (args.lora_rank, args.lora_targets, args.max_adapters,
            args.dynamic_adapters) == (8, "wq,wk,wo", 3, True)
    assert not serve_main.parse_args([]).dynamic_adapters
    with pytest.raises(ValueError, match="does not compose with MLA"):
        serve_main.build_engine(serve_main.parse_args(
            ["--device", "cpu", "--model", "tiny-mla", "--lora-rank", "4"]))
    with pytest.raises(ValueError, match="no dense mlp weights"):
        serve_main.build_engine(serve_main.parse_args(
            ["--device", "cpu", "--model", "tiny-moe", "--lora-rank", "4",
             "--lora-targets", "wq,w_down"]))
    engine, _ = serve_main.build_engine(serve_main.parse_args(
        ["--device", "cpu", "--model", "tiny", "--slots", "2",
         "--cache-len", "64", "--lora-rank", "4", "--lora-targets",
         "wq,wk,wo", "--max-adapters", "3"]))
    try:
        snap = engine.debug_snapshot()
        assert snap["multi_lora"] and snap["lora_rank"] == 4
        assert set(engine._adapters) == {"wq", "wk", "wo"}
        assert engine._adapters["wq"]["a"].shape == (2, 4, 256, 4)
    finally:
        engine.stop()
