"""Bridge from the JAX package's parameter tree to the port's.

``params_from_jax`` takes the nested dict that the JAX ``init_params``
returns, with every leaf already converted to a numpy array (stacked
``layers/*`` leaves of shape (L, ...)), and returns the port's parameters
on ``device``: for serving, matmul weights, embedding and LM head in
``cfg.dtype`` and norm weights in f32 — the values the JAX model computes
with once it casts its f32 params at use; for training (``master=True``),
every leaf in ``cfg.param_dtype`` (f32), the JAX model's master tree as it
is. Both packages then compute the same thing, which is what the parity
tests need. A tree the JAX quantizer made (``{"q4", "scale"}`` or
``{"q8", "scale"}`` leaves) carries over as it is: the integers keep
their type, the scales stay f32. This module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .llama import LlamaConfig, Params, is_norm, param_shapes

# JAX config fields that select code paths this port does not have yet;
# a config that sets any of them away from the dense default is refused
_UNSUPPORTED = {
    "sliding_window": None, "attn_logit_softcap": None,
    "query_pre_attn_scalar": None, "post_norms": False, "qk_norm": False,
    "rope_local_theta": None, "mlp_activation": "silu",
    "embed_scale": False, "logit_softcap": None,
    "norm_zero_centered": False, "qkv_bias": False, "n_experts": 0,
    "n_dense_prefix": 0, "sliding_window_pattern": 1,
}


def config_from_jax(jcfg, dtype: torch.dtype) -> LlamaConfig:
    """The port's config for a JAX ``LlamaConfig`` (read by attribute, so
    no jax import), with ``dtype`` as the compute dtype; ``param_dtype``
    follows the JAX config's by name. Raises on any field that needs a
    branch the port does not have."""
    bad = [f for f, dense in _UNSUPPORTED.items()
           if getattr(jcfg, f, dense) != dense]
    if getattr(jcfg, "remat_policy", "full") not in ("full", "none"):
        bad.append("remat_policy")
    if bad:
        raise ValueError(f"config {jcfg.name!r} needs {bad}, which this "
                         "port does not serve yet")
    fields = ("name", "vocab_size", "embed_dim", "n_layers", "n_heads",
              "n_kv_heads", "head_dim", "mlp_dim", "max_seq_len",
              "rope_theta", "rope_scaling", "norm_eps", "tie_embeddings",
              "remat", "remat_policy", "mla_latent_dim", "mla_rope_dim",
              "mla_q_lora_rank")
    param_dtype = getattr(torch, np.dtype(jcfg.param_dtype).name)
    return LlamaConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=dtype,
                       param_dtype=param_dtype)


def params_from_jax(tree: dict, cfg: LlamaConfig, device=None,
                    master: bool = False) -> Params:
    """JAX parameter tree (numpy leaves) -> the port's parameters: serving
    weights, or with ``master=True`` the f32 master weights training
    updates."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    extra = set(tree) - set(shapes) | (set(tree.get("layers", {}))
                                       - set(shapes["layers"]))
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
            dtype = torch.float32 if is_norm(name) else cfg.dtype
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

    out: Params = {name: convert(name, tree[name], s)
                   for name, s in shapes.items() if name != "layers"}
    out["layers"] = {name: convert(name, tree["layers"][name], s)
                     for name, s in shapes["layers"].items()}
    return out
