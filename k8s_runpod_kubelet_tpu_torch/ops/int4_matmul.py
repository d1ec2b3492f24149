"""Matmul against int4-packed weights (port of the JAX package's
``ops/int4_matmul.py``).

Layout (``models/quant.py``): q4 (in/2, out) uint8, in-element 2i in the
low nibble and 2i+1 in the high, each offset by 8; scale (g, 1, out) f32,
one group per in/g contraction elements. Each group's partial sum over
its even and odd in-elements is formed in f32 and multiplied by the
group's scale; the sum over groups is cast to h's dtype once.

``int4_matmul`` launches ``csrc/int4_matmul.cu`` on a CUDA tensor (or
raises) and runs ``_int4_matmul_plain``, the port of ``_fallback_2d``, on a
CPU tensor. The kernel takes the quantizer's bytes as they are (out a
multiple of 16, groups of a multiple of 16 in-elements, every tensor
16-byte aligned). Forward only: training never sees int4 weights.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

__all__ = ["int4_matmul"]


def _int4_matmul_plain(h2: torch.Tensor, q4: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """f32 throughout (exact for the integer nibbles), cast to h's dtype
    at the end: h2 (B, in) -> (B, out)."""
    kin2, out = q4.shape
    g = scale.shape[0]
    half = kin2 // g
    lo = ((q4 & 0xF).to(torch.int8) - 8).float()
    hi = ((q4 >> 4).to(torch.int8) - 8).float()
    hf = h2.float()
    he = hf[:, 0::2].reshape(h2.shape[0], g, half)
    ho = hf[:, 1::2].reshape(h2.shape[0], g, half)
    part = (torch.einsum("bgk,gko->bgo", he, lo.reshape(g, half, out))
            + torch.einsum("bgk,gko->bgo", ho, hi.reshape(g, half, out)))
    return torch.einsum("bgo,go->bo", part, scale[:, 0, :]).to(h2.dtype)


@functools.cache
def _launchers():
    """The C entry and its split choice (``int4_matmul_splits``), which
    sizes the f32 scratch of a launch that splits its groups."""
    lib = _cuda.load("int4_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, splits = lib.int4_matmul_bf16, lib.int4_matmul_splits
    fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
    splits.argtypes = [i, i, i]
    fn.restype = splits.restype = i
    return fn, splits


def _check_cuda_args(h2, q4, scale) -> None:
    dev = h2.device
    for name, t, dtype in (("h", h2, torch.bfloat16), ("q4", q4, torch.uint8),
                           ("scale", scale, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"the CUDA kernel takes {dtype} {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:                   # 16-byte cp.async copies
            raise ValueError(f"{name} must be 16-byte aligned")
    if q4.shape[1] % 16:
        raise ValueError(f"out {q4.shape[1]} must be a multiple of 16")
    group = 2 * q4.shape[0] // scale.shape[0]
    if group % 16:
        raise ValueError(f"a group of {group} in-elements is not a multiple "
                         f"of 16 (the kernel's k16 steps)")


def int4_matmul(h: torch.Tensor, q4: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """h (..., in) @ packed int4 weight (in/2, out) -> (..., out) in h's
    dtype. A CUDA tensor launches the kernel (bf16 h) or raises; a CPU
    tensor takes the plain version."""
    kin = h.shape[-1]
    kin2, out = q4.shape
    if kin != 2 * kin2:
        raise ValueError(f"h has {kin} in-elements, q4 packs {2 * kin2}")
    if scale.dim() != 3 or scale.shape[1] != 1 or scale.shape[2] != out \
            or kin2 % scale.shape[0]:
        raise ValueError(f"scale {tuple(scale.shape)} does not group q4 "
                         f"{tuple(q4.shape)}")
    h2 = h.reshape(-1, kin)
    if h.device.type == "cpu":
        return _int4_matmul_plain(h2, q4, scale).reshape(*h.shape[:-1], out)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    _check_cuda_args(h2, q4, scale)
    rows, g = h2.shape[0], scale.shape[0]
    launch, splits_of = _launchers()
    y = torch.empty((rows, out), dtype=h.dtype, device=h.device)
    splits = splits_of(rows, out, g)
    partial = (torch.empty((splits, rows, out), dtype=torch.float32,
                           device=h.device) if splits > 1 else y)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    code = launch(h2.data_ptr(), q4.data_ptr(), scale.data_ptr(),
                  y.data_ptr(), partial.data_ptr(), rows, kin, out, g, stream)
    _cuda.check(code, "int4_matmul")
    int4_matmul.launches += 1
    return y.reshape(*h.shape[:-1], out)


# kernel launches made through the wrapper (the plain path never counts)
int4_matmul.launches = 0
