"""Bridge from the JAX package's parameter tree to the port's.

``params_from_jax`` takes the nested dict that the JAX ``init_params``
returns, with every leaf already converted to a numpy array (stacked
``layers/*`` leaves of shape (L, ...)), and returns the port's parameters
on ``device``: for serving, matmul weights, q/k/v biases, embedding and
LM head in ``cfg.dtype`` and norm weights, the MoE router and V3's router
bias in f32 — the values the
JAX model computes with once it casts its f32 params at use (it routes in
f32); for training (``master=True``),
every leaf in ``cfg.param_dtype`` (f32), the JAX model's master tree as it
is. Both packages then compute the same thing, which is what the parity
tests need. A tree the JAX quantizer made (``{"q4", "scale"}`` or
``{"q8", "scale"}`` leaves) carries over as it is: the integers keep
their type, the scales stay f32. ``adapter_from_jax`` carries a LoRA
adapter over the same way. This module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .llama import STACKS, LlamaConfig, Params, keeps_f32, param_shapes


def config_from_jax(jcfg, dtype: torch.dtype) -> LlamaConfig:
    """The port's config for a JAX ``LlamaConfig`` (read by attribute, so
    no jax import), with ``dtype`` as the compute dtype; ``param_dtype``
    follows the JAX config's by name."""
    fields = ("name", "vocab_size", "embed_dim", "n_layers", "n_heads",
              "n_kv_heads", "head_dim", "mlp_dim", "max_seq_len",
              "rope_theta", "rope_scaling", "norm_eps", "sliding_window",
              "sliding_window_pattern", "attn_logit_softcap",
              "query_pre_attn_scalar", "post_norms", "rope_local_theta",
              "logit_softcap", "qk_norm", "tie_embeddings", "mlp_activation", "embed_scale",
              "norm_zero_centered", "qkv_bias",
              "remat", "remat_policy", "ring_flash", "mla_latent_dim",
              "mla_rope_dim",
              "mla_q_lora_rank", "n_experts", "n_experts_per_tok",
              "capacity_factor", "router_norm_topk", "router_aux_coef",
              "router_z_coef", "router_sigmoid_bias", "router_n_group",
              "router_topk_group", "routed_scaling_factor",
              "n_shared_experts", "n_dense_prefix", "dense_prefix_mlp_dim")
    param_dtype = getattr(torch, np.dtype(jcfg.param_dtype).name)
    return LlamaConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=dtype,
                       param_dtype=param_dtype)


def adapter_from_jax(tree: dict, device=None,
                     dtype: torch.dtype = torch.float32) -> dict:
    """A JAX LoRA adapter (numpy leaves) -> the port's ``{target: {"a",
    "b", "scale"}}`` tensors on ``device``: either a LoRA-wrapped params
    tree (``layers/<target>`` leaves ``{"w", "lora_a", "lora_b",
    "scale"}``, from the JAX ``apply_lora``) or an ``extract_adapter`` /
    ``load_adapter`` dict. A and B in ``dtype``, the scale f32 (L,)."""
    if "layers" in tree:
        src = {t: {"a": w["lora_a"], "b": w["lora_b"], "scale": w["scale"]}
               for t, w in tree["layers"].items()
               if isinstance(w, dict) and "lora_a" in w}
    else:
        src = tree
    if not src:
        raise ValueError("the tree carries no LoRA adapters")
    dev = resolve_device(device)
    out = {}
    for t, ad in src.items():
        if set(ad) != {"a", "b", "scale"}:
            raise ValueError(f"{t}: adapter entries {sorted(ad)}, expected "
                             "a, b and scale")
        a, b = np.asarray(ad["a"], np.float32), np.asarray(ad["b"],
                                                          np.float32)
        if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
                or a.shape[2] != b.shape[1]:
            raise ValueError(f"{t}: A {a.shape} and B {b.shape} are not "
                             "(L, in, r) and (L, r, out)")
        scale = np.broadcast_to(np.asarray(ad["scale"], np.float32),
                                (a.shape[0],))
        out[t] = {"a": torch.from_numpy(a.copy()).to(dev, dtype),
                  "b": torch.from_numpy(b.copy()).to(dev, dtype),
                  "scale": torch.from_numpy(scale.copy()).to(dev)}
    return out


def params_from_jax(tree: dict, cfg: LlamaConfig, device=None,
                    master: bool = False) -> Params:
    """JAX parameter tree (numpy leaves) -> the port's parameters: serving
    weights, or with ``master=True`` the f32 master weights training
    updates."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    extra = set(tree) - set(shapes)
    for stack in STACKS:
        extra |= set(tree.get(stack, {})) - set(shapes.get(stack, {}))
    if extra:
        raise ValueError(f"parameters {sorted(extra)} belong to branches "
                         "this port does not serve")

    def convert(name: str, leaf, shape):
        if isinstance(leaf, dict):
            return convert_quantized(name, leaf, shape)
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        if arr.shape != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        if master:
            dtype = cfg.param_dtype
        else:
            dtype = torch.float32 if keeps_f32(name) else cfg.dtype
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    def convert_quantized(name: str, leaf: dict, shape) -> dict:
        """A leaf the JAX quantizer made, carried as it is: the integers
        keep their type and the scale stays f32."""
        kind = "q4" if "q4" in leaf else "q8"
        if master or set(leaf) != {kind, "scale"}:
            raise ValueError(f"{name}: quantized leaf {sorted(leaf)} is not "
                             "a serving weight this port takes")
        q = np.array(leaf[kind])
        scale = np.array(leaf["scale"], dtype=np.float32)
        *lead, kin, out = shape
        want = (tuple(lead) + (kin // 2, out), np.uint8) if kind == "q4" \
            else (tuple(shape), np.int8)
        groups = scale.shape[-3] if kind == "q4" and scale.ndim >= 3 else 1
        want_scale = tuple(lead) + ((groups,) if kind == "q4" else ()) \
            + (1, out)
        if (q.shape, q.dtype) != want or scale.shape != want_scale \
                or (kin // 2) % groups:
            raise ValueError(f"{name}: {kind} {q.shape} {q.dtype} with "
                             f"scale {scale.shape} does not quantize "
                             f"{tuple(shape)}")
        return {kind: torch.from_numpy(q).to(dev),
                "scale": torch.from_numpy(scale).to(dev)}

    return {name: ({leaf: convert(leaf, tree[name][leaf], ls)
                    for leaf, ls in s.items()} if name in STACKS
                   else convert(name, tree[name], s))
            for name, s in shapes.items()}
