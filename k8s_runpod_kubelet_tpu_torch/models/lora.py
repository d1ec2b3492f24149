"""LoRA adapters on frozen base weights (port of the JAX package's
``models/lora.py``).

A LoRA-wrapped projection is a dict leaf ``{"w": base, "lora_a": (..., in,
r), "lora_b": (..., r, out), "scale": (...,)}``; ``llama._mm`` computes

    y = x @ w.detach() + ((x @ A) @ B) * scale

so gradients exist only for A and B. A ~ N(0, 1/d_in) (fan-in scaled), B =
0: the wrapped model starts as exactly the base model. ``merge_lora``
folds ``w + A @ B * scale`` back into plain leaves. An adapter alone is
``{target: {"a": (L, in, r), "b": (L, r, out), "scale": (L,)}}``
(``extract_adapter``), the shape the serving engine's ``register_adapter``
takes and the ``.npz`` file holds: ``save_adapter`` and ``load_adapter``
write and read the JAX package's layout (``wq.a``, ``wq.b``, ``wq.scale``,
...), so an adapter exported by its ``train_main --export-adapter`` serves
here unchanged, and the reverse.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from .llama import LlamaConfig, Params

__all__ = ["LoraConfig", "LORA_TARGETS", "apply_lora", "merge_lora",
           "lora_mask", "is_lora", "lora_param_count", "extract_adapter",
           "save_adapter", "load_adapter"]

# every projection an adapter may target
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_DEFAULT_TARGETS = ("wq", "wv")  # the original paper's default


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # which stacked-layer projections get adapters, of LORA_TARGETS
    targets: tuple[str, ...] = _DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def is_lora(w: Any) -> bool:
    return isinstance(w, dict) and "lora_a" in w


def apply_lora(cfg: LlamaConfig, params: Params, lc: LoraConfig,
               generator: torch.Generator, device=None,
               dtype: Optional[torch.dtype] = None) -> Params:
    """Wrap the target projections of ``params`` with fresh adapters drawn
    from ``generator`` on ``device`` (default ``cuda``; the generator must
    live there): A fan-in-scaled gaussian in ``dtype`` (default the base
    weight's), B zero, scale (L,) f32 at alpha / rank, so the wrapped
    model computes exactly the base model. Adapters wrap the main stack,
    ``layers``, alone (a DeepSeek dense prefix stays as it is), as in the
    JAX package. The base leaves are shared, not copied."""
    if not lc.targets:
        raise ValueError("LoRA with no targets would freeze the whole model "
                         "and train nothing")
    unknown = set(lc.targets) - set(LORA_TARGETS)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}")
    dev = resolve_device(device)
    layers = dict(params["layers"])
    for name in lc.targets:
        if name not in layers:
            raise ValueError(f"LoRA target {name!r} not in this model "
                             f"(MoE configs have no dense mlp weights)")
        w = layers[name]
        if isinstance(w, dict):
            raise ValueError(f"{name} already has a LoRA adapter"
                             if is_lora(w) else
                             f"{name} is quantized; adapters wrap raw "
                             "weights")
        d_in, d_out = w.shape[-2], w.shape[-1]
        lead = tuple(w.shape[:-2])
        ad_dtype = dtype or w.dtype
        a = (torch.randn((*lead, d_in, lc.rank), generator=generator,
                         device=dev, dtype=torch.float32)
             / math.sqrt(d_in)).to(ad_dtype)
        b = torch.zeros((*lead, lc.rank, d_out), dtype=ad_dtype, device=dev)
        # (L,): every leaf keeps the leading layer axis
        scale = torch.full(lead, lc.scale, dtype=torch.float32, device=dev)
        layers[name] = {"w": w, "lora_a": a, "lora_b": b, "scale": scale}
    out = dict(params)
    out["layers"] = layers
    return out


def merge_lora(params: Params) -> Params:
    """Fold every adapter into its base weight: a plain tree back. The
    delta is computed in f32 one layer at a time, scaled, rounded to the
    base's dtype and added there: the stacked base is never upcast (an f32
    copy of an 8B leaf is a multi-GB transient)."""
    def fold(w):
        if not is_lora(w):
            return w
        base = w["w"]
        out = torch.empty_like(base)
        for layer in range(base.shape[0]):
            delta = w["lora_a"][layer].float() @ w["lora_b"][layer].float()
            delta = delta * w["scale"][layer].float()
            out[layer] = base[layer] + delta.to(base.dtype)
        return out

    out = dict(params)
    out["layers"] = {k: fold(v) for k, v in params["layers"].items()}
    return out


def lora_mask(params: Params) -> Params:
    """A tree of the same structure, True only on adapter leaves (A and
    B): what an optimizer updates and what gradients are needed for."""
    def walk(node):
        if is_lora(node):
            return {"w": False, "lora_a": True, "lora_b": True,
                    "scale": False}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return False

    return walk(params)


def lora_param_count(params: Params) -> int:
    return sum(w["lora_a"].numel() + w["lora_b"].numel()
               for w in params["layers"].values() if is_lora(w))


def extract_adapter(params: Params) -> dict:
    """LoRA-wrapped params -> {target: {"a": (L, in, r), "b": (L, r, out),
    "scale": (L,)}}, the shape ``register_adapter`` and the adapter file
    share."""
    out = {name: {"a": w["lora_a"], "b": w["lora_b"], "scale": w["scale"]}
           for name, w in params["layers"].items() if is_lora(w)}
    if not out:
        raise ValueError("params carry no LoRA adapters")
    return out


def _to_numpy(x) -> np.ndarray:
    """A leaf as numpy; bf16 (which numpy lacks) widens to f32, exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def save_adapter(path: str, params_or_adapter) -> str:
    """Write an adapter to a portable ``.npz`` ("wq.a", "wq.b",
    "wq.scale", ...), the JAX package's file; returns the path written
    (".npz" appended when missing, as ``np.savez`` would)."""
    if not path.endswith(".npz"):
        path += ".npz"
    src = (extract_adapter(params_or_adapter)
           if "layers" in params_or_adapter else params_or_adapter)
    flat = {f"{t}.{k}": _to_numpy(ad[k])
            for t, ad in src.items() for k in ("a", "b", "scale")}
    np.savez(path, **flat)
    return path


def load_adapter(path: str) -> dict:
    """Read a ``save_adapter`` ``.npz`` (this package's or the JAX
    package's) back into {target: {"a", "b", "scale"}} numpy arrays. A
    2-byte void entry is the JAX package's bfloat16, which numpy stores as
    raw bits: it widens to f32 exactly."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            t, _, k = key.rpartition(".")
            if not t or k not in ("a", "b", "scale"):
                raise ValueError(f"{path}: unexpected entry {key!r}")
            arr = z[key]
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                arr = (arr.view(np.uint16).astype(np.uint32) << 16) \
                    .view(np.float32)
            out.setdefault(t, {})[k] = arr
    for t, ad in out.items():
        missing = {"a", "b", "scale"} - set(ad)
        if missing:
            raise ValueError(f"{path}: {t} missing {sorted(missing)}")
    return out
