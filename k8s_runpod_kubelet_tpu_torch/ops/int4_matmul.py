"""Matmul against int4-packed weights (port of the JAX package's
``ops/int4_matmul.py``).

Layout (``models/quant.py``): q4 (in/2, out) uint8, in-element 2i in the
low nibble and 2i+1 in the high, each offset by 8; scale (g, 1, out) f32,
one group per in/g contraction elements. Each group's partial sum over
its even and odd in-elements is formed in f32 and multiplied by the
group's scale; the sum over groups is cast to h's dtype once.

``int4_matmul`` launches ``csrc/int4_matmul.cu`` on a CUDA tensor (or
raises) and runs ``_int4_matmul_plain``, the port of ``_fallback_2d``, on a
CPU tensor. ``int4_expert_matmul`` is the per-expert form of the MoE layers
(the JAX ``int4_expert_matmul``, there a ``lax.map`` of the 2-D kernel over
experts): one launch of ``csrc/int4_expert_matmul.cu`` for every expert at
once, a persistent walk over the row tiles an optional device count of
filled rows per expert leaves live. The kernels take the quantizer's bytes
as they are (out a multiple of 16, groups of a multiple of 16 in-elements,
every tensor 16-byte aligned). Forward only: training never sees int4
weights.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _cuda

__all__ = ["int4_expert_matmul", "int4_matmul", "int4_matmul_sharded"]


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


def _int4_expert_matmul_plain(h: torch.Tensor, q4: torch.Tensor,
                              scale: torch.Tensor,
                              counts: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``_int4_matmul_plain`` over the expert axis: h (X, C, in) -> (X, C,
    out) in h's dtype, rows at or past ``counts[x]`` zero."""
    y = torch.stack([_int4_matmul_plain(h[x], q4[x], scale[x])
                     for x in range(h.shape[0])])
    if counts is not None:
        rows = torch.arange(h.shape[1], device=h.device)
        y = torch.where(rows[None, :, None] < counts[:, None, None].long(),
                        y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y


def _int4_matmul_sharded_plain(h2: torch.Tensor, q4: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """``_int4_matmul_plain`` per shard, concatenated on out: h2 (B, in),
    q4 (N, in/2, out/N), scale (N, g, 1, out/N) -> (B, out)."""
    return torch.cat([_int4_matmul_plain(h2, q4[s], scale[s])
                      for s in range(q4.shape[0])], dim=-1)


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


@functools.cache
def _expert_launchers():
    """The expert entry of ``csrc/int4_expert_matmul.cu`` and the tile
    height it takes for a buffer of C rows an expert. One launch, no
    scratch."""
    lib = _cuda.load("int4_expert_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, tile_rows = lib.int4_expert_matmul_bf16, \
        lib.int4_expert_matmul_tile_rows
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    tile_rows.argtypes = [i]
    fn.restype = tile_rows.restype = i
    return fn, tile_rows


@functools.cache
def _sharded_launchers():
    """The tensor-parallel entry of the same library and its split
    choice."""
    lib = _cuda.load("int4_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, splits = lib.int4_matmul_sharded_bf16, lib.int4_matmul_sharded_splits
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    splits.argtypes = [i, i, i, i]
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
    if q4.shape[-1] % 16:
        raise ValueError(f"out {q4.shape[-1]} must be a multiple of 16")
    group = 2 * q4.shape[-2] // scale.shape[-3]
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


def int4_expert_matmul(h: torch.Tensor, q4: torch.Tensor,
                       scale: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-expert int4 matmul: h (X, C, in) @ q4 (X, in/2, out) with scale
    (X, g, 1, out) -> (X, C, out) in h's dtype. ``counts`` (X,) int32 on
    h's device, if given, is each expert's filled rows: rows at or past it
    come back as zeros, and the kernel runs no row tile that starts past
    it. A CUDA tensor launches the kernel once for every expert (bf16 h) or
    raises; a CPU tensor takes the plain version."""
    if h.dim() != 3 or q4.dim() != 3 or scale.dim() != 4:
        raise ValueError(f"h {tuple(h.shape)}, q4 {tuple(q4.shape)}, scale "
                         f"{tuple(scale.shape)}: expected (X, C, in), "
                         "(X, in/2, out), (X, g, 1, out)")
    x, rows, kin = h.shape
    if q4.shape[0] != x or scale.shape[0] != x:
        raise ValueError(f"h has {x} experts, q4 {q4.shape[0]}, scale "
                         f"{scale.shape[0]}")
    kin2, out = q4.shape[1:]
    if kin != 2 * kin2:
        raise ValueError(f"h has {kin} in-elements, q4 packs {2 * kin2}")
    if scale.shape[2] != 1 or scale.shape[3] != out \
            or kin2 % scale.shape[1]:
        raise ValueError(f"scale {tuple(scale.shape)} does not group q4 "
                         f"{tuple(q4.shape)}")
    if counts is not None and (counts.shape != (x,)
                               or counts.device != h.device):
        raise ValueError(f"counts {tuple(counts.shape)} on {counts.device}: "
                         f"expected ({x},) on {h.device}")
    if h.device.type == "cpu":
        return _int4_expert_matmul_plain(h, q4, scale, counts)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    _check_cuda_args(h, q4, scale)
    if counts is not None and (counts.dtype != torch.int32
                               or not counts.is_contiguous()):
        raise TypeError(f"the CUDA kernel takes contiguous int32 counts, "
                        f"got {counts.dtype}")
    g = scale.shape[1]
    launch = _expert_launchers()[0]
    y = torch.empty((x, rows, out), dtype=h.dtype, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    code = launch(h.data_ptr(), q4.data_ptr(), scale.data_ptr(),
                  counts.data_ptr() if counts is not None else None,
                  y.data_ptr(), x, rows, kin, out, g, stream)
    _cuda.check(code, "int4_expert_matmul")
    int4_expert_matmul.launches += 1
    return y


def int4_matmul_sharded(h: torch.Tensor, q4: torch.Tensor,
                        scale: torch.Tensor, mesh) -> torch.Tensor:
    """Tensor-parallel int4 matmul on out-sharded weights: h (..., in) ->
    (..., out), the shards' out-slices gathered in shard order. ``mesh``
    (``parallel.Mesh``) has ``tensor`` = N shards. In one process ``q4``
    (N, in/2, out/N) and ``scale`` (N, g, 1, out/N) stack every shard's
    slice (``parallel.shard_params``): a CUDA tensor launches the kernel
    once for every shard (bf16 h) or raises, a CPU tensor takes
    ``_int4_matmul_sharded_plain``. Over a process group they are this
    rank's (in/2, out/N) and (g, 1, out/N): ``int4_matmul`` runs on the
    slice (its own launch count) and the ranks' outputs are all-gathered
    (out/N a rank, in rank order)."""
    from ..parallel.sharding import all_gather

    kin = h.shape[-1]
    h2 = h.reshape(-1, kin)
    if not mesh.in_process:
        y = all_gather(int4_matmul(h2, q4, scale), -1, mesh)
        return y.reshape(*h.shape[:-1], y.shape[-1])
    if q4.dim() != 3 or scale.dim() != 4 or q4.shape[0] != mesh.tensor \
            or scale.shape[0] != mesh.tensor:
        raise ValueError(f"q4 {tuple(q4.shape)} and scale "
                         f"{tuple(scale.shape)} do not stack the "
                         f"{mesh.tensor} shards of {mesh}: expected "
                         "(N, in/2, out/N) and (N, g, 1, out/N)")
    n, kin2, out = q4.shape
    if kin != 2 * kin2:
        raise ValueError(f"h has {kin} in-elements, q4 packs {2 * kin2}")
    if scale.shape[2] != 1 or scale.shape[3] != out \
            or kin2 % scale.shape[1]:
        raise ValueError(f"scale {tuple(scale.shape)} does not group q4 "
                         f"{tuple(q4.shape)}")
    if h.device.type == "cpu":
        y = _int4_matmul_sharded_plain(h2, q4, scale)
        return y.reshape(*h.shape[:-1], n * out)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    _check_cuda_args(h2, q4, scale)
    rows, g = h2.shape[0], scale.shape[1]
    launch, splits_of = _sharded_launchers()
    y = torch.empty((rows, n * out), dtype=h.dtype, device=h.device)
    splits = splits_of(n, rows, out, g)
    partial = (torch.empty((splits, rows, n * out), dtype=torch.float32,
                           device=h.device) if splits > 1 else y)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    code = launch(h2.data_ptr(), q4.data_ptr(), scale.data_ptr(),
                  y.data_ptr(), partial.data_ptr(), n, rows, kin, out, g,
                  stream)
    _cuda.check(code, "int4_matmul_sharded")
    int4_matmul_sharded.launches += 1
    return y.reshape(*h.shape[:-1], n * out)


# kernel launches made through the wrappers (the plain path never counts)
int4_matmul.launches = 0
int4_expert_matmul.launches = 0
int4_matmul_sharded.launches = 0
