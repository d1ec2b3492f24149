"""Hugging Face checkpoint import and export (port of the JAX package's
``models/convert.py``, cut to the layouts this port serves: the dense
Llama family with Gemma-7B's, Mistral's, Qwen2's and Qwen3's branches,
Mixtral's sparse MoE, and DeepSeek's MLA with its MoE, dense prefix and
low-rank q).

``load_hf(cfg, src, device)`` takes a HF model directory (``*.safetensors``,
sharded through ``model.safetensors.index.json`` or not, or
``pytorch_model*.bin``) or a state dict, and returns the port's parameters
on ``device`` in the dtypes ``params_from_jax`` gives: matmul weights, the
embedding and the LM head in ``cfg.dtype``, norms in f32, or every leaf in
``cfg.param_dtype`` with ``master=True`` (training).

Mapping (as in the JAX package): HF ``nn.Linear`` stores (out, in) and the
port multiplies x @ W with (in, out), so every projection transposes;
layer leaves stack on a leading (n_layers, ...) axis; RoPE is rotate-half
on both sides for Llama. DeepSeek's MLA checkpoints rotate interleaved
pairs, so the rope columns of ``q_proj`` and ``kv_a_proj_with_mqa`` are
permuted to rotate-half (``_rope_deinterleave``), and ``kv_b_proj`` splits
into ``w_uk`` and ``w_uv``; the low-rank q's ``q_a_proj``,
``q_a_layernorm`` and ``q_b_proj`` are ``w_qa``, ``q_a_norm`` and ``w_qb``
(its rope columns permuted the same way). DeepSeek-MoE's ``mlp.gate`` is
the router, V3's ``mlp.gate.e_score_correction_bias`` the router bias,
``mlp.experts.{e}.{gate,up,down}_proj`` the experts and
``mlp.shared_experts.*`` the shared experts' ``ws_*``; the dense prefix's
layers keep their dense ``mlp.*_proj`` under their global layer index and
load into ``prefix_layers``. Mixtral's ``block_sparse_moe.gate`` is the
router and its ``experts.{e}.w1``/``w3``/``w2`` are ``we_gate``/``we_up``/
``we_down``, stacked over experts inside each layer. Qwen2's
``self_attn.{q,k,v}_proj.bias`` are ``wq_b``/``wk_b``/``wv_b`` and Qwen3's
``self_attn.{q,k}_norm.weight`` are ``q_norm``/``k_norm``. Gemma stores its
norms zero-centered, as the port's tree does, and ties its head (no
``lm_head.weight``).

A checkpoint whose keys do not match the config (MoE layers for a dense
MLP, a low-rank q for a full-rank one or the reverse, a dense prefix of
another length) is refused by its key names before any tensor is read,
and so is any bias or norm the config does not have.
Safetensors files are read here, without the ``safetensors`` package: the
8-byte little-endian header length, the JSON header and each tensor's
``data_offsets``, the data viewed through ``torch.frombuffer`` on a
private memory map (BF16 needs no detour through numpy, which has no
bf16). This module imports no jax.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .llama import STACKS, LlamaConfig, Params, keeps_f32, param_shapes

__all__ = ["from_hf_state_dict", "load_hf", "read_safetensors",
           "to_hf_state_dict"]

# safetensors dtype names this reader takes
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32, "I8": torch.int8}
# keys a HF checkpoint may carry that hold no weight
_IGNORED = re.compile(r"(^|\.)rotary_emb\.inv_freq$")

# per-layer (ours, HF name) pairs; projections transpose, norms do not
_DENSE_ATTN = (("wq", "self_attn.q_proj.weight"),
               ("wk", "self_attn.k_proj.weight"),
               ("wv", "self_attn.v_proj.weight"),
               ("wo", "self_attn.o_proj.weight"))
_MLP = (("w_gate", "mlp.gate_proj.weight"), ("w_up", "mlp.up_proj.weight"),
        ("w_down", "mlp.down_proj.weight"))
# Mixtral: the router, and each expert's (ours, HF name) projections
_MOE_ROUTER = "block_sparse_moe.gate.weight"
_EXPERTS = (("we_gate", "w1"), ("we_up", "w3"), ("we_down", "w2"))


# DeepSeek-MoE: the router, V3's correction bias, each routed expert's
# (ours, HF name) projections and the shared experts'
_DS_ROUTER = "mlp.gate.weight"
_DS_BIAS = "mlp.gate.e_score_correction_bias"
_DS_EXPERTS = (("we_gate", "gate_proj"), ("we_up", "up_proj"),
               ("we_down", "down_proj"))
_DS_SHARED = (("ws_gate", "mlp.shared_experts.gate_proj.weight"),
              ("ws_up", "mlp.shared_experts.up_proj.weight"),
              ("ws_down", "mlp.shared_experts.down_proj.weight"))
# key fragments of DeepSeek-MoE's MLP, which a config of another MLP has
# no place for
_DEEPSEEK_MOE = (".mlp.experts.", ".mlp.shared_experts.", "." + _DS_ROUTER,
                 "." + _DS_BIAS)


def _expert_key(cfg: LlamaConfig, e: int, theirs: str) -> str:
    """Expert ``e``'s projection ``theirs`` under the family's names:
    DeepSeek's (an MLA config) or Mixtral's."""
    if cfg.is_mla:
        return f"mlp.experts.{e}.{theirs}.weight"
    return f"block_sparse_moe.experts.{e}.{theirs}.weight"


def _expert_names(cfg: LlamaConfig) -> tuple:
    return _DS_EXPERTS if cfg.is_mla else _EXPERTS


def _mlp_keys(cfg: LlamaConfig) -> list[str]:
    """The per-layer HF names of one layer's MLP under ``cfg`` (a layer
    stack's view): the dense three, Mixtral's router and every expert's
    three, or DeepSeek-MoE's router (and V3's correction bias), experts
    and shared experts."""
    if not cfg.n_experts:
        return [theirs for _, theirs in _MLP]
    experts = [_expert_key(cfg, e, theirs) for e in range(cfg.n_experts)
               for _, theirs in _expert_names(cfg)]
    if not cfg.is_mla:
        return [_MOE_ROUTER] + experts
    return ([_DS_ROUTER] + ([_DS_BIAS] if cfg.router_sigmoid_bias else [])
            + experts + ([theirs for _, theirs in _DS_SHARED]
                         if cfg.n_shared_experts else []))


def layer_views(cfg: LlamaConfig):
    """(global layer index, stack key, index in the stack, the stack's
    config view) of every layer: the dense prefix's layers first, under
    ``prefix_cfg``, then the main ones under ``main_cfg``."""
    k = cfg.n_dense_prefix
    pre, main = cfg.prefix_cfg(), cfg.main_cfg()
    for i in range(cfg.n_layers):
        yield (i, "prefix_layers", i, pre) if i < k else \
            (i, "layers", i - k, main)
_NORMS = (("attn_norm", "input_layernorm.weight"),
          ("mlp_norm", "post_attention_layernorm.weight"))
# Qwen3's per-head q/k norms and Qwen2's q/k/v biases, copied as they are
_QK_NORMS = (("q_norm", "self_attn.q_norm.weight"),
             ("k_norm", "self_attn.k_norm.weight"))
_QKV_BIASES = (("wq_b", "self_attn.q_proj.bias"),
               ("wk_b", "self_attn.k_proj.bias"),
               ("wv_b", "self_attn.v_proj.bias"))


# Gemma 2 and 3's sandwich norms: HF's post_attention_layernorm is then
# the attention output's norm, and the MLP's input norm is
# pre_feedforward_layernorm
_POST_NORMS = (("attn_norm", "input_layernorm.weight"),
               ("attn_post_norm", "post_attention_layernorm.weight"),
               ("mlp_norm", "pre_feedforward_layernorm.weight"),
               ("mlp_post_norm", "post_feedforward_layernorm.weight"))


def _plain_leaves(cfg: LlamaConfig) -> tuple:
    """The per-layer (ours, HF name) pairs copied without a transpose:
    the norms (four with ``post_norms``), and the config's q/k norms and
    q/k/v biases."""
    return ((_POST_NORMS if cfg.post_norms else _NORMS)
            + (_QK_NORMS if cfg.qk_norm else ())
            + (_QKV_BIASES if cfg.qkv_bias else ()))
_MLA_KV = ("self_attn.kv_a_proj_with_mqa.weight",
           "self_attn.kv_a_layernorm.weight", "self_attn.kv_b_proj.weight",
           "self_attn.o_proj.weight")
_MLA_Q_LORA = ("self_attn.q_a_proj.weight", "self_attn.q_a_layernorm.weight",
               "self_attn.q_b_proj.weight")


def _attn_keys(cfg: LlamaConfig) -> list[str]:
    """The per-layer HF names of the attention: dense q/k/v/o, or MLA's
    full-rank or low-rank q and its latent projections."""
    if not cfg.is_mla:
        return [theirs for _, theirs in _DENSE_ATTN]
    q = (list(_MLA_Q_LORA) if cfg.mla_q_lora_rank is not None
         else ["self_attn.q_proj.weight"])
    return q + list(_MLA_KV)


def _strip(name: str) -> str:
    return name[len("model."):] if name.startswith("model.") else name


def expected_keys(cfg: LlamaConfig) -> set:
    """The HF names (without the ``model.`` prefix) a checkpoint of
    ``cfg`` holds; ``lm_head.weight`` is optional either way (a tied
    checkpoint may omit it, an untied config then materializes the tie)."""
    keys = {"embed_tokens.weight", "norm.weight"}
    for i, _, _, sub in layer_views(cfg):
        per_layer = ([theirs for _, theirs in _plain_leaves(sub)]
                     + _attn_keys(sub) + _mlp_keys(sub))
        keys.update(f"layers.{i}.{n}" for n in per_layer)
    return keys


def _check_mla_keys(cfg: LlamaConfig, names: set) -> None:
    """The JAX package's key checks of a DeepSeek checkpoint, with its
    messages: the low-rank q present exactly when the config has one, and
    (experts in the checkpoint) the dense prefix where the config puts
    it."""
    has_q_lora = "layers.0.self_attn.q_a_proj.weight" in names
    if has_q_lora and cfg.mla_q_lora_rank is None:
        raise ValueError(
            "checkpoint uses low-rank q (q_lora_rank, DeepSeek-V2 full) "
            "but the config has mla_q_lora_rank=None; set it to the "
            "checkpoint's q_lora_rank")
    if not has_q_lora and cfg.mla_q_lora_rank is not None:
        raise ValueError(
            f"config expects low-rank q (mla_q_lora_rank="
            f"{cfg.mla_q_lora_rank}) but the checkpoint has a full-rank "
            "q_proj; set mla_q_lora_rank=None")
    if cfg.n_experts and any(".mlp.experts." in "." + k for k in names):
        kpre = cfg.n_dense_prefix
        for i in range(cfg.n_layers):
            has_experts = (f"layers.{i}.mlp.experts.0.gate_proj.weight"
                           in names)
            if i < kpre and has_experts:
                raise ValueError(
                    f"layer {i} has experts but the config expects a dense "
                    f"prefix of {kpre} (n_dense_prefix mismatch — check "
                    "the checkpoint's first_k_dense_replace)")
            if i >= kpre and not has_experts:
                raise ValueError(
                    f"layer {i} has a dense MLP where experts are expected "
                    "(the checkpoint's first_k_dense_replace exceeds the "
                    f"config's n_dense_prefix={kpre}); set n_dense_prefix "
                    "to match")


def check_keys(cfg: LlamaConfig, names) -> None:
    """Key-name checks, run before any tensor is read: a key of a layout
    the config does not have (MoE layers for a dense MLP, a low-rank q
    for a full-rank one, a dense prefix of another length) raises
    ValueError naming it, and so does any other key the mapping would not
    read (a silently dropped bias or norm would serve a different model);
    a missing one KeyError."""
    names = {_strip(k) for k in names if not _IGNORED.search(k)}
    moe = bool(cfg.n_experts)
    for what, frags, like, fits in (
            ("Mixtral's sparse-MoE layers", (".block_sparse_moe.",),
             "mixtral-8x7b", moe and not cfg.is_mla),
            ("DeepSeek-MoE layers", _DEEPSEEK_MOE, "deepseek-v2-lite",
             moe and cfg.is_mla)):
        hit = sorted(k for k in names if any(f in "." + k for f in frags))
        if hit and not fits:
            raise ValueError(
                f"checkpoint holds {what} ({hit[0]!r}, {len(hit)} keys); "
                f"{cfg.name!r} has "
                + ("another MoE layout" if moe else "a dense MLP")
                + f" (load it with an MoE config such as {like})")
    if cfg.is_mla:
        _check_mla_keys(cfg, names)
    want = expected_keys(cfg)
    extra = sorted(names - want - {"lm_head.weight"})
    if extra:
        raise ValueError(f"checkpoint keys {extra[:4]} ({len(extra)} in "
                         f"all) have no place in {cfg.name!r}")
    missing = sorted(want - names)
    if missing:
        raise KeyError(f"HF checkpoint missing {missing[:4]} "
                       f"({len(missing)} in all)")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    arr = np.asarray(x)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr)   # torch takes no read-only numpy memory
    return torch.from_numpy(arr)


def _rope_perm(dr: int, device) -> torch.Tensor:
    """Column i of the rotate-half layout takes checkpoint column perm[i]:
    DeepSeek's interleaved pairs (2i, 2i+1) become (i, dr/2 + i)."""
    return torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)]) \
        .to(device)


def _rope_deinterleave(w: torch.Tensor, dr: int) -> torch.Tensor:
    """Permute the last ``dr`` columns of ``w`` from DeepSeek's
    pair-interleaved RoPE layout to the port's rotate-half layout."""
    out = w.clone()
    out[..., -dr:] = w[..., -dr:][..., _rope_perm(dr, w.device)]
    return out


def _rope_reinterleave(w: torch.Tensor, dr: int) -> torch.Tensor:
    """Inverse of ``_rope_deinterleave`` (export)."""
    out = w.clone()
    out[..., -dr:][..., _rope_perm(dr, w.device)] = w[..., -dr:]
    return out


def _mla_layer(cfg: LlamaConfig, get, i: int) -> dict:
    """DeepSeek-V2 MLA attention of layer ``i`` (each tensor on the target
    device, HF layout): q_proj (H(dh+dr), E) -> wq (E, H(dh+dr)) with each
    head's rope tail de-interleaved (or the low-rank q_a_proj ->
    w_qa, q_a_layernorm -> q_a_norm, q_b_proj -> w_qb, de-interleaved the
    same way); kv_a_proj_with_mqa (r+dr, E) ->
    w_dkv (E, r+dr), rope tail de-interleaved; kv_a_layernorm -> c_norm;
    kv_b_proj (H(dh+dv), r) -> w_uk (r, H dh) and w_uv (r, H dv), per head
    [k_nope; v]; o_proj -> wo."""
    hd, dr, r, hn = (cfg.head_dim_, cfg.mla_rope_dim, cfg.mla_latent_dim,
                     cfg.n_heads)
    p = f"layers.{i}.self_attn."
    if cfg.mla_q_lora_rank is not None:
        qb = get(p + "q_b_proj.weight").t().reshape(-1, hn, hd + dr)
        out = {"w_qa": get(p + "q_a_proj.weight").t(),
               "q_a_norm": get(p + "q_a_layernorm.weight"),
               "w_qb": _rope_deinterleave(qb, dr).reshape(qb.shape[0], -1)}
    else:
        q = get(p + "q_proj.weight").t().reshape(-1, hn, hd + dr)
        out = {"wq": _rope_deinterleave(q, dr).reshape(q.shape[0], -1)}
    b = get(p + "kv_b_proj.weight").t().reshape(r, hn, -1)
    if b.shape[-1] != 2 * hd:
        raise NotImplementedError(
            f"v_head_dim {b.shape[-1] - hd} != qk_nope_head_dim {hd}: this "
            "family assumes square heads (true for V2-Lite)")
    return {**out,
            "w_dkv": _rope_deinterleave(
                get(p + "kv_a_proj_with_mqa.weight").t(), dr),
            "c_norm": get(p + "kv_a_layernorm.weight"),
            "w_uk": b[:, :, :hd].reshape(r, hn * hd),
            "w_uv": b[:, :, hd:].reshape(r, hn * hd),
            "wo": get(p + "o_proj.weight").t()}


def from_hf_state_dict(cfg: LlamaConfig, sd: Mapping[str, Any], device=None,
                       master: bool = False) -> Params:
    """A HF ``state_dict``-shaped mapping (``model.`` prefix or not;
    torch tensors or numpy arrays) -> the port's parameters on
    ``device``. Each tensor moves to the device in its own dtype and is
    transposed, permuted and cast there, one layer at a time, into
    preallocated stacked leaves."""
    dev = resolve_device(device)
    check_keys(cfg, sd.keys())
    norm = {_strip(k): v for k, v in sd.items()}

    def get(name: str) -> torch.Tensor:
        return _as_tensor(norm[name]).to(dev)

    def dtype_of(name: str) -> torch.dtype:
        if master:
            return cfg.param_dtype
        return torch.float32 if keeps_f32(name) else cfg.dtype

    shapes = param_shapes(cfg)

    def put(name: str, t: torch.Tensor, shape) -> torch.Tensor:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: HF tensor maps to {tuple(t.shape)}, "
                             f"the config needs {tuple(shape)}")
        return torch.empty(shape, dtype=dtype_of(name), device=dev).copy_(t)

    out: Params = {
        "tok_embed": put("tok_embed", get("embed_tokens.weight"),
                         shapes["tok_embed"]),
        "final_norm": put("final_norm", get("norm.weight"),
                          shapes["final_norm"])}
    if not cfg.tie_embeddings:
        head = (get("lm_head.weight") if "lm_head.weight" in norm
                else get("embed_tokens.weight"))   # the checkpoint ties
        out["lm_head"] = put("lm_head", head.t(), shapes["lm_head"])
    stacks = {key: {name: torch.empty(s, dtype=dtype_of(name), device=dev)
                    for name, s in shapes[key].items()}
              for key in STACKS if key in shapes}
    for i, key, j, sub in layer_views(cfg):
        pre = f"layers.{i}."
        if sub.is_mla:
            leaves = _mla_layer(sub, get, i)
        else:
            leaves = {ours: get(pre + theirs).t()
                      for ours, theirs in _DENSE_ATTN}
        if sub.n_experts:
            leaves["router"] = get(pre + (_DS_ROUTER if sub.is_mla
                                          else _MOE_ROUTER)).t()
            leaves.update({ours: torch.stack(
                [get(pre + _expert_key(sub, e, theirs)).t()
                 for e in range(sub.n_experts)])
                for ours, theirs in _expert_names(sub)})
            if sub.router_sigmoid_bias:
                leaves["router_bias"] = get(pre + _DS_BIAS)
            if sub.n_shared_experts:
                leaves.update({ours: get(pre + theirs).t()
                               for ours, theirs in _DS_SHARED})
        else:
            leaves.update({ours: get(pre + theirs).t()
                           for ours, theirs in _MLP})
        leaves.update({ours: get(pre + theirs)
                       for ours, theirs in _plain_leaves(sub)})
        layers = stacks[key]
        for name, t in leaves.items():
            if tuple(t.shape) != tuple(layers[name].shape[1:]):
                raise ValueError(f"{pre}{name}: HF tensor maps to "
                                 f"{tuple(t.shape)}, the config needs "
                                 f"{tuple(layers[name].shape[1:])}")
            layers[name][j].copy_(t)
    out.update(stacks)
    return out


def to_hf_state_dict(cfg: LlamaConfig, params: Params
                     ) -> dict[str, torch.Tensor]:
    """Inverse mapping (export): the port's parameters -> a HF-named state
    dict of contiguous CPU tensors in the parameters' own dtypes (so bf16
    weights round-trip bit for bit). Quantized leaves are refused. A
    dense prefix's layers export from their own stack under their global
    layer index."""

    def host(t) -> torch.Tensor:
        if isinstance(t, dict):
            raise ValueError("quantized parameters have no HF layout; "
                             "export the unquantized weights")
        return t.detach().contiguous().cpu()

    sd = {"model.embed_tokens.weight": host(params["tok_embed"]),
          "model.norm.weight": host(params["final_norm"])}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = host(params["lm_head"].t())
    hd, dr, r, hn = (cfg.head_dim_, cfg.mla_rope_dim, cfg.mla_latent_dim,
                     cfg.n_heads)
    for gi, key, i, sub in layer_views(cfg):
        lp = params[key]
        pre = f"model.layers.{gi}."
        for ours, theirs in _plain_leaves(sub):
            sd[pre + theirs] = host(lp[ours][i])
        if sub.n_experts:
            sd[pre + (_DS_ROUTER if sub.is_mla else _MOE_ROUTER)] = host(
                lp["router"][i].t())
            if sub.router_sigmoid_bias:
                sd[pre + _DS_BIAS] = host(lp["router_bias"][i])
            for ours, theirs in _expert_names(sub):
                for e in range(sub.n_experts):
                    sd[pre + _expert_key(sub, e, theirs)] = host(
                        lp[ours][i, e].t())
            if sub.n_shared_experts:
                for ours, theirs in _DS_SHARED:
                    sd[pre + theirs] = host(lp[ours][i].t())
        else:
            for ours, theirs in _MLP:
                sd[pre + theirs] = host(lp[ours][i].t())
        if sub.is_mla:
            a = pre + "self_attn."
            if sub.mla_q_lora_rank is not None:
                sd[a + "q_a_proj.weight"] = host(lp["w_qa"][i].t())
                sd[a + "q_a_layernorm.weight"] = host(lp["q_a_norm"][i])
                qb = lp["w_qb"][i].reshape(-1, hn, hd + dr)
                sd[a + "q_b_proj.weight"] = host(
                    _rope_reinterleave(qb, dr).reshape(qb.shape[0], -1).t())
            else:
                q = lp["wq"][i].reshape(-1, hn, hd + dr)
                sd[a + "q_proj.weight"] = host(
                    _rope_reinterleave(q, dr).reshape(q.shape[0], -1).t())
            sd[a + "kv_a_proj_with_mqa.weight"] = host(
                _rope_reinterleave(lp["w_dkv"][i], dr).t())
            sd[a + "kv_a_layernorm.weight"] = host(lp["c_norm"][i])
            uk = lp["w_uk"][i].reshape(r, hn, hd)
            uv = lp["w_uv"][i].reshape(r, hn, hd)
            sd[a + "kv_b_proj.weight"] = host(
                torch.cat([uk, uv], dim=-1).reshape(r, -1).t())
            sd[a + "o_proj.weight"] = host(lp["wo"][i].t())
        else:
            for ours, theirs in _DENSE_ATTN:
                sd[pre + theirs] = host(lp[ours][i].t())
    return sd


def _st_header(f) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data) of an
    open safetensors file."""
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{f.name}: not a safetensors file")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file as a CPU tensor viewing a
    private (copy-on-write) memory map of the file: nothing is read until
    a tensor is used, and writing to one never reaches the file."""
    with open(path, "rb") as f:
        header, base = _st_header(f)
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"this reader takes {sorted(_ST_DTYPES)}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        item = torch.empty((), dtype=dtype).element_size()
        if end - start != item * int(np.prod(shape, dtype=np.int64)) \
                or base + end > size:
            raise ValueError(f"{path}: {name} data_offsets {start}..{end} "
                             f"do not hold {shape} {info['dtype']}")
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype,
                                     count=(end - start) // item,
                                     offset=base + start).reshape(shape)
    return out


def _st_files(path: str) -> list[str]:
    """The safetensors files of a model directory: those the index names,
    else every ``*.safetensors`` there."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    return sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))


def _dir_key_names(path: str) -> Optional[list[str]]:
    """Tensor names of a HF model directory from the safetensors headers
    alone; None when it holds only ``.bin`` shards (``torch.load`` has no
    header to read: those are checked after loading)."""
    files = _st_files(path)
    if not files:
        return None
    names: list[str] = []
    for fname in files:
        with open(os.path.join(path, fname), "rb") as f:
            names.extend(_st_header(f)[0])
    return names


def _read_dir_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A HF model directory's state dict: ``*.safetensors`` (indexed or
    not) or ``pytorch_model*.bin`` shards."""
    files = _st_files(path)
    if files:
        sd: dict[str, torch.Tensor] = {}
        for fname in files:
            sd.update(read_safetensors(os.path.join(path, fname)))
        return sd
    bins = sorted(f for f in os.listdir(path)
                  if re.match(r"pytorch_model.*\.bin$", f))
    if not bins:
        raise FileNotFoundError(
            f"{path}: no *.safetensors or pytorch_model*.bin found")
    sd = {}
    for fname in bins:
        sd.update(torch.load(os.path.join(path, fname), map_location="cpu",
                             weights_only=True))
    return sd


def load_hf(cfg: LlamaConfig, src: Union[str, Mapping[str, Any]],
            device=None, master: bool = False) -> Params:
    """One-call import: ``src`` is a HF model directory or a state dict.
    A directory's key names are checked from the safetensors headers
    before any tensor data is touched."""
    if isinstance(src, (str, os.PathLike)):
        src = os.fspath(src)
        names = _dir_key_names(src)
        if names is not None:
            check_keys(cfg, names)
        src = _read_dir_state_dict(src)
    return from_hf_state_dict(cfg, src, device=device, master=master)
