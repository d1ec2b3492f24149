"""Paged multi-token attention: the CUDA kernel and its plain version.

``paged_attention_multi`` is the port of the JAX package's
``ops/attention.py:paged_attention_multi``: K query tokens per sequence
attend page-table-indexed K/V with a causal mask inside the block, GQA,
an optional soft cap and an optional sliding window. On a CUDA tensor it
launches ``csrc/paged_attention_multi.cu`` (or raises); on a CPU tensor
it runs ``_paged_attention_multi_plain``, the gather-then-mask reference
of ``_paged_attention_multi_xla``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _cuda

NEG_INF = -1e30
_HEAD_DIMS = (64, 128, 256)


def _paged_valid_multi(n_tokens: int, lengths: torch.Tensor, kq: int,
                       window: Optional[int]) -> torch.Tensor:
    """(B, K, S) mask of attendable positions: query j sees positions
    <= lengths - kq + j and, under a window, only the ``window`` positions
    ending at its own."""
    dev = lengths.device
    pos = torch.arange(n_tokens, device=dev)[None, None, :]
    qpos = (lengths.long()[:, None] - kq
            + torch.arange(kq, device=dev)[None, :])[:, :, None]
    valid = pos <= qpos
    if window is not None:
        valid &= pos > qpos - window
    return valid


def _paged_attention_multi_plain(q, k_pages, v_pages, page_table, lengths, *,
                                 sm_scale: float,
                                 logit_soft_cap: Optional[float] = None,
                                 sliding_window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Gather the page table back into a contiguous view and run masked
    multi-query attention in f32; the output has q's dtype."""
    b, kq, hq, d = q.shape
    _, t, hkv, _ = k_pages.shape
    n = page_table.shape[1]
    group = hq // hkv
    idx = page_table.long()
    k = k_pages[idx].reshape(b, n * t, hkv, d).float()
    v = v_pages[idx].reshape(b, n * t, hkv, d).float()
    qg = (q.float() * sm_scale).reshape(b, kq, hkv, group, d)
    s = torch.einsum("bkhgd,bLhd->bkhgL", qg, k)
    if logit_soft_cap is not None:
        s = torch.tanh(s / logit_soft_cap) * logit_soft_cap
    valid = _paged_valid_multi(n * t, lengths, kq, sliding_window)
    s = torch.where(valid[:, :, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkhgL,bLhd->bkhgd", p, v)
    return o.reshape(b, kq, hq, d).to(q.dtype)


@functools.cache
def _launcher():
    fn = _cuda.load("paged_attention_multi").paged_attention_multi_bf16
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                   ctypes.c_float, ctypes.c_float, i, p]
    fn.restype = i
    return fn


def _check_cuda_args(q, k_pages, v_pages, page_table, lengths) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 {name}, got "
                            f"{t.dtype}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d, t = q.shape[3], k_pages.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernel "
                         f"(one of {_HEAD_DIMS})")
    if t % 8 or t * d > 8192:
        raise ValueError(f"page_tokens {t} must be a multiple of 8 with "
                         f"page_tokens * head_dim <= 8192")


def paged_attention_multi(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, *,
                          sm_scale: Optional[float] = None,
                          logit_soft_cap: Optional[float] = None,
                          sliding_window: Optional[int] = None
                          ) -> torch.Tensor:
    """q (B, K, Hq, D) over pages (P, T, Hkv, D) through ``page_table``
    (B, N). ``lengths`` (B,) counts valid tokens INCLUDING the K being
    attended: query j sits at lengths - K + j and sees positions <= that.
    Table entries at or after ceil(lengths / T) are never read but must be
    valid page ids. Returns (B, K, Hq, D) in q's dtype. A CUDA tensor
    launches the kernel (bf16 only) or raises; a CPU tensor takes the
    plain version."""
    b, kq, hq, d = q.shape
    _, t, hkv, _ = k_pages.shape
    if hq % hkv != 0:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if k_pages.shape[3] != d or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("q/pages/page_table/lengths shapes disagree")
    if logit_soft_cap is not None and logit_soft_cap <= 0:
        raise ValueError(f"logit_soft_cap must be positive, got "
                         f"{logit_soft_cap}")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got "
                         f"{sliding_window}")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return _paged_attention_multi_plain(
            q, k_pages, v_pages, page_table, lengths, sm_scale=scale,
            logit_soft_cap=logit_soft_cap, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, k_pages, v_pages, page_table, lengths)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, kq, hq, hkv, d, t, page_table.shape[1], float(scale),
        float(logit_soft_cap or 0.0), int(sliding_window or 0), stream)
    _cuda.check(code, "paged_attention_multi")
    paged_attention_multi.launches += 1
    return out


# kernel launches made through the wrapper (the plain path never counts)
paged_attention_multi.launches = 0
