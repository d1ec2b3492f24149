"""Attention: the CUDA kernels and their plain versions.

``paged_attention_multi`` is the port of the JAX package's
``ops/attention.py:paged_attention_multi``: K query tokens per sequence
attend page-table-indexed K/V with a causal mask inside the block, GQA,
an optional soft cap and an optional sliding window. On a CUDA tensor it
launches ``csrc/paged_attention_multi.cu`` (or raises); on a CPU tensor
it runs ``_paged_attention_multi_plain``, the gather-then-mask reference
of ``_paged_attention_multi_xla``. ``paged_attention_multi_quant`` is the
same over an int8 arena with per-(position, kv head) f32 scales
(``csrc/paged_attention_multi_quant.cu``). The single-token forms
``paged_attention`` and ``paged_attention_quant`` (q (B, Hq, D)) compute
the multi-token function at K = 1 and launch the same two kernels at
K = 1, each entry point with its own launch count.

``paged_attention_multi_mla`` is the port of the JAX
``paged_attention_multi_mla``: Multi-head Latent Attention in the absorbed
form over headless latent pages, c (P, T, R) and kr (P, T, Dr), every head
reading the same rows; the output is the softmax-weighted latent. A CUDA
tensor launches ``csrc/paged_attention_multi_mla.cu``, a CPU tensor runs
``_paged_attention_multi_mla_plain``. ``paged_attention_multi_mla_quant``
is the same over int8 latents with per-position f32 scales
(``csrc/paged_attention_multi_mla_quant.cu``). The single-token forms
``paged_attention_mla`` and ``paged_attention_mla_quant`` compute the
multi-token function at K = 1 and launch the same two kernels at K = 1,
each counted on its own wrapper.

``flash_attention`` is the port of ``ops/attention.py:flash_attention``,
contiguous attention with gradients: a ``torch.autograd.Function`` over the
three kernels of ``csrc/flash_attention.cu`` (``flash_fwd``, ``flash_dq``,
``flash_dkv``, each a wrapper with its own launch count), which take their
plain versions on a CPU tensor. The three wrappers also take ``q_offset``,
the position of query row 0 against key 0, as the JAX
``_flash_fwd_pallas``/``_flash_bwd_pallas`` do for ring attention's chunk
steps (``ops/ring_attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _cuda

NEG_INF = -1e30
# head widths the paged kernels take, and the flash kernels (192: MLA's
# direct form, head_dim 128 + rope 64)
_HEAD_DIMS = (64, 128, 256)
_FLASH_HEAD_DIMS = (64, 128, 192, 256)


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


def _gathered(pages, scales, page_table) -> torch.Tensor:
    """The working set ``page_table`` (B, N) names, as contiguous f32
    (B, N * T, Hkv, D); int8 pages are dequantized after the gather, the
    JAX reference's memory order."""
    b, n = page_table.shape
    _, t, hkv, d = pages.shape
    idx = page_table.long()
    x = pages[idx].float()
    if scales is not None:
        x = x * scales[idx][..., None]
    return x.reshape(b, n * t, hkv, d)


def _paged_multi_core(q, k, v, lengths, sm_scale, logit_soft_cap,
                      sliding_window) -> torch.Tensor:
    """Masked multi-query attention of q (B, K, Hq, D) over contiguous f32
    k, v (B, S, Hkv, D); the output has q's dtype."""
    b, kq, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    qg = (q.float() * sm_scale).reshape(b, kq, hkv, hq // hkv, d)
    s = torch.einsum("bkhgd,bLhd->bkhgL", qg, k)
    if logit_soft_cap is not None:
        s = torch.tanh(s / logit_soft_cap) * logit_soft_cap
    valid = _paged_valid_multi(s_len, lengths, kq, sliding_window)
    s = torch.where(valid[:, :, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkhgL,bLhd->bkhgd", p, v)
    return o.reshape(b, kq, hq, d).to(q.dtype)


def _paged_attention_multi_plain(q, k_pages, v_pages, page_table, lengths, *,
                                 sm_scale: float,
                                 logit_soft_cap: Optional[float] = None,
                                 sliding_window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Gather the page table back into a contiguous view and run masked
    multi-query attention in f32; the output has q's dtype."""
    return _paged_multi_core(q, _gathered(k_pages, None, page_table),
                             _gathered(v_pages, None, page_table), lengths,
                             sm_scale, logit_soft_cap, sliding_window)


def _paged_attention_multi_quant_plain(q, k_pages, v_pages, k_scale,
                                       v_scale, page_table, lengths, *,
                                       sm_scale: float,
                                       logit_soft_cap: Optional[float] = None,
                                       sliding_window: Optional[int] = None
                                       ) -> torch.Tensor:
    """Port of ``_paged_attention_multi_quant_xla``: gather the table's
    working set, dequantize only that, then the plain multi-token
    attention in f32."""
    return _paged_multi_core(q, _gathered(k_pages, k_scale, page_table),
                             _gathered(v_pages, v_scale, page_table),
                             lengths, sm_scale, logit_soft_cap,
                             sliding_window)


def _single(plain):
    """The single-token form of a multi-token plain: q (B, Hq, D) as K = 1.
    Its mask (positions below ``lengths``, under a window the last
    ``window`` of them) is the multi-token mask at K = 1."""
    def single(q, *args, **kw):
        return plain(q[:, None], *args, **kw)[:, 0]
    return single


# ports of ``_paged_attention_xla`` and ``_paged_attention_quant_xla``
_paged_attention_plain = _single(_paged_attention_multi_plain)
_paged_attention_quant_plain = _single(_paged_attention_multi_quant_plain)


@functools.cache
def _launchers():
    """The C entries of the bf16 and the int8-page kernel: (one pass,
    split-KV with its merge) each."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bf16 = _cuda.load("paged_attention_multi")
    int8 = _cuda.load("paged_attention_multi_quant")
    fns = (bf16.paged_attention_multi_bf16,
           bf16.paged_attention_multi_bf16_split,
           int8.paged_attention_multi_int8,
           int8.paged_attention_multi_int8_split)
    for fn, n_ptr, split in zip(fns, (6, 8, 8, 10), (False, True) * 2):
        fn.argtypes = [p] * n_ptr + [i] * 7 + [f, f, i] + [i, i] * split + [p]
        fn.restype = i
    return fns


# the paged kernels' row tiles: 64 query rows a warpgroup, one warpgroup a
# block when a sequence's rows fit in 64, else two
_TILE_ROWS = 64
# split-KV: a grid of fewer than _SPLIT_BELOW warpgroups an SM is split to
# about _SPLIT_TARGET warpgroups an SM
_SPLIT_BELOW, _SPLIT_TARGET = 2, 4


def _warpgroups(n_rows: int) -> int:
    return 1 if n_rows <= _TILE_ROWS else 2


def _split_plan(batch: int, n_q: int, group: int, hkv: int,
                table_width: int, sms: int) -> tuple[int, int]:
    """(splits, pages per split) of the paged kernels' split-KV. A grid of
    (row tiles x kv heads x sequences) blocks that holds fewer than
    ``_SPLIT_BELOW`` warpgroups an SM (decode: 8 x 8 = 64 one-warpgroup
    blocks on 132 SMs) cuts the table's columns into contiguous ranges of
    ``pages per split`` so that about ``_SPLIT_TARGET`` warpgroups an SM
    run; a fuller grid gets one split over every column. Computed from
    shapes alone (the lengths stay on the card): each block then takes its
    own range of the pages its rows see (``_split_ranges``) and skips the
    work of a split past them."""
    wg = _warpgroups(n_q * group)
    tiles = -(-n_q * group // (_TILE_ROWS * wg))
    blocks = batch * hkv * tiles * wg
    if blocks >= _SPLIT_BELOW * sms or table_width <= 1:
        return 1, max(table_width, 1)
    want = min(-(-_SPLIT_TARGET * sms // blocks), table_width)
    per = -(-table_width // want)
    return -(-table_width // per), per


def _split_ranges(length: int, first_row: int, last_row: int, n_q: int,
                  group: int, page_tokens: int, window: Optional[int],
                  pages_per_split: int, table_width: int
                  ) -> list[tuple[int, int]]:
    """The page ranges [begin, end) the kernel's splits of one block read:
    a block of rows first_row..last_row of a sequence of ``length`` tokens
    (K = n_q new) sees the pages up to its newest query's, none at or past
    ceil(length / T) or the table's ``table_width`` columns (positions
    past them are absent, as in the reference) and, under a window, none
    wholly behind its oldest query's window; split s takes the s-th run of
    ``pages_per_split`` of them. Empty splits are left out (the kernel's
    blocks for them write max -1e30 and sum 0, which the merge weighs as
    nothing)."""
    oldest = length - n_q + first_row // group
    newest = length - n_q + last_row // group
    live = -(-length // page_tokens)
    end = 0 if newest < 0 else min(live, newest // page_tokens + 1,
                                   table_width)
    begin = 0
    if window is not None and oldest - window + 1 > 0:
        begin = (oldest - window + 1) // page_tokens
    return [(s, min(end, s + pages_per_split))
            for s in range(begin, end, pages_per_split)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_paged_shapes(q4, k_pages, v_pages, page_table, lengths,
                        k_scale, v_scale, logit_soft_cap,
                        sliding_window) -> None:
    """The JAX entry points' argument checks, q as (B, K, Hq, D)."""
    b, _, hq, d = q4.shape
    hkv = k_pages.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if k_pages.shape[3] != d or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("q/pages/page_table/lengths shapes disagree")
    if k_scale is not None and (k_scale.shape != k_pages.shape[:3]
                                or v_scale.shape != v_pages.shape[:3]):
        raise ValueError(f"scale shapes {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)} must be the pages' "
                         f"(P, T, Hkv) = {tuple(k_pages.shape[:3])}")
    if logit_soft_cap is not None and logit_soft_cap <= 0:
        raise ValueError(f"logit_soft_cap must be positive, got "
                         f"{logit_soft_cap}")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got "
                         f"{sliding_window}")


def _check_cuda_args(q, k_pages, v_pages, page_table, lengths,
                     k_scale=None, v_scale=None) -> None:
    """What the kernels take: one card, contiguous, bf16 q, bf16 pages
    (int8 pages with f32 scales), int32 tables, D in {64, 128, 256}, T a
    multiple of 8 with a T x D page tile of at most 16 KB."""
    dev = q.device
    kv = torch.int8 if k_scale is not None else torch.bfloat16
    tensors = [("q", q, torch.bfloat16), ("k_pages", k_pages, kv),
               ("v_pages", v_pages, kv), ("page_table", page_table,
                                          torch.int32),
               ("lengths", lengths, torch.int32)]
    if k_scale is not None:
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    for name, t, dtype in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"the CUDA kernel takes {dtype} {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d, t = q.shape[-1], k_pages.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernel "
                         f"(one of {_HEAD_DIMS})")
    tile = t * d * k_pages.element_size()
    if t % 8 or tile > 16384:
        raise ValueError(f"page_tokens {t} must be a multiple of 8 with a "
                         f"page tile of at most 16384 bytes (got {tile})")


def _launch_paged(q4, k_pages, v_pages, page_table, lengths, k_scale,
                  v_scale, scale, logit_soft_cap, sliding_window, what: str
                  ) -> torch.Tensor:
    """One launch of the bf16 (``k_scale`` None) or the int8-page kernel
    on q (B, K, Hq, D), split-KV where ``_split_plan`` says; the caller
    counts it."""
    _check_cuda_args(q4, k_pages, v_pages, page_table, lengths, k_scale,
                     v_scale)
    b, kq, hq, d = q4.shape
    _, t, hkv, _ = k_pages.shape
    out = torch.empty_like(q4)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    cols = page_table.shape[1]
    inputs = [q4, k_pages, v_pages]
    if k_scale is not None:
        inputs += [k_scale, v_scale]
    head = [x.data_ptr() for x in (*inputs, page_table, lengths, out)]
    dims = (b, kq, hq, hkv, d, t, cols, float(scale),
            float(logit_soft_cap or 0.0), int(sliding_window or 0))
    one, split = _launchers()[2 * (k_scale is not None):][:2]
    splits, per = _split_plan(b, kq, hq // hkv, hkv, cols,
                              _sm_count(q4.device.index))
    if splits == 1:
        code = one(*head, *dims, stream)
    else:
        # scratch of the splits: the unnormalised f32 accumulator and the
        # (max, sum) of every output row, merged on the card
        part_o = torch.empty((b, splits, kq, hq, d), dtype=torch.float32,
                             device=q4.device)
        part_ml = torch.empty((b, splits, kq, hq, 2), dtype=torch.float32,
                              device=q4.device)
        code = split(*head, part_o.data_ptr(), part_ml.data_ptr(), *dims,
                     splits, per, stream)
    _cuda.check(code, what)
    return out


def _paged_entry(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
                 sm_scale, logit_soft_cap, sliding_window, wrapper
                 ) -> torch.Tensor:
    """The four paged entry points: q (B, K, Hq, D), or (B, Hq, D) for the
    single-token forms, run as K = 1. A CPU tensor runs the multi-token
    plain version (bf16 or int8 pages); a CUDA tensor launches the kernel,
    counted on ``wrapper``, or raises."""
    single = q.dim() == 3
    q4 = q[:, None] if single else q
    _check_paged_shapes(q4, k_pages, v_pages, page_table, lengths, k_scale,
                        v_scale, logit_soft_cap, sliding_window)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        out = _paged_multi_core(
            q4, _gathered(k_pages, k_scale, page_table),
            _gathered(v_pages, v_scale, page_table), lengths, scale,
            logit_soft_cap, sliding_window)
    elif q.device.type == "cuda":
        out = _launch_paged(q4, k_pages, v_pages, page_table, lengths,
                            k_scale, v_scale, scale, logit_soft_cap,
                            sliding_window, wrapper.__name__)
        wrapper.launches += 1
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out[:, 0] if single else out


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
    return _paged_entry(q, k_pages, v_pages, page_table, lengths, None, None,
                        sm_scale, logit_soft_cap, sliding_window,
                        paged_attention_multi)


def paged_attention_multi_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor, *,
                                sm_scale: Optional[float] = None,
                                logit_soft_cap: Optional[float] = None,
                                sliding_window: Optional[int] = None
                                ) -> torch.Tensor:
    """``paged_attention_multi`` over an int8 KV arena: pages int8
    (P, T, Hkv, D) with per-(position, kv head) f32 scales (P, T, Hkv),
    each position standing for int8 * scale. A CUDA tensor launches
    ``csrc/paged_attention_multi_quant.cu`` (bf16 q) or raises; a CPU
    tensor takes the plain version."""
    return _paged_entry(q, k_pages, v_pages, page_table, lengths, k_scale,
                        v_scale, sm_scale, logit_soft_cap, sliding_window,
                        paged_attention_multi_quant)


def paged_head_shards(tensor: int, hq: int, hkv: int) -> int:
    """The tensor-parallel layout of one paged dispatch (the JAX
    ``_paged_head_specs`` rule): the head axes shard over ``tensor`` when
    both counts divide, so a shard's contiguous q-head block maps exactly
    onto its contiguous kv-head block and each shard's kernels read only
    its own arena; otherwise the arena replicates and every shard's q
    heads attend all of it. Returns the number of head shards (1:
    replicated)."""
    if tensor > 1 and hq % tensor == 0 and hkv % tensor == 0:
        return tensor
    return 1


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    sm_scale: Optional[float] = None,
                    logit_soft_cap: Optional[float] = None,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode: q (B, Hq, D), ``lengths`` (B,) counting the
    query's own token (it sits at lengths - 1). Returns (B, Hq, D). The
    multi-token function at K = 1: a CUDA tensor launches the bf16 kernel
    at K = 1 (counted here, not on ``paged_attention_multi``)."""
    return _paged_entry(q, k_pages, v_pages, page_table, lengths, None, None,
                        sm_scale, logit_soft_cap, sliding_window,
                        paged_attention)


def paged_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, *,
                          sm_scale: Optional[float] = None,
                          logit_soft_cap: Optional[float] = None,
                          sliding_window: Optional[int] = None
                          ) -> torch.Tensor:
    """``paged_attention`` over an int8 KV arena (scales as in
    ``paged_attention_multi_quant``): a CUDA tensor launches the int8-page
    kernel at K = 1 (counted here)."""
    return _paged_entry(q, k_pages, v_pages, page_table, lengths, k_scale,
                        v_scale, sm_scale, logit_soft_cap, sliding_window,
                        paged_attention_quant)


# kernel launches made through each wrapper (the plain path never counts)
paged_attention_multi.launches = 0
paged_attention_multi_quant.launches = 0
paged_attention.launches = 0
paged_attention_quant.launches = 0


# -- MLA: absorbed latent attention over headless pages ---------------------------

def _latent_gathered(pages, scales, page_table) -> torch.Tensor:
    """The latent working set ``page_table`` (B, N) names, as contiguous
    f32 (B, N * T, W); int8 pages are dequantized per position after the
    gather, the JAX reference's memory order."""
    b, n = page_table.shape
    idx = page_table.long()
    x = pages[idx].float()
    if scales is not None:
        x = x * scales[idx][..., None]
    return x.reshape(b, n * pages.shape[1], pages.shape[2])


def _paged_mla_core(q_lat, q_rope, c, kr, lengths, sm_scale) -> torch.Tensor:
    """Absorbed MLA of q_lat (B, K, Hq, R) and q_rope (B, K, Hq, Dr) over
    contiguous f32 latents c (B, S, R) and rope keys kr (B, S, Dr), with the
    per-query causal mask; the weighted latent in q_lat's dtype."""
    kq = q_lat.shape[1]
    s = (torch.einsum("bkhr,bLr->bkhL", q_lat.float() * sm_scale, c)
         + torch.einsum("bkhd,bLd->bkhL", q_rope.float() * sm_scale, kr))
    valid = _paged_valid_multi(c.shape[1], lengths, kq, None)
    s = torch.where(valid[:, :, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkhL,bLr->bkhr", p, c).to(q_lat.dtype)


def _paged_attention_multi_mla_plain(q_lat, q_rope, c_pages, kr_pages,
                                     page_table, lengths, *,
                                     sm_scale: float) -> torch.Tensor:
    """Port of ``_paged_attention_multi_mla_xla``: gather the latent pages
    into a contiguous view, then the absorbed attention in f32."""
    return _paged_mla_core(q_lat, q_rope,
                           _latent_gathered(c_pages, None, page_table),
                           _latent_gathered(kr_pages, None, page_table),
                           lengths, sm_scale)


def _paged_attention_multi_mla_quant_plain(q_lat, q_rope, c_pages, kr_pages,
                                           c_scale, kr_scale, page_table,
                                           lengths, *,
                                           sm_scale: float) -> torch.Tensor:
    """Port of ``_paged_attention_multi_mla_quant_xla``: gather the
    working set, dequantize it per position, then the absorbed attention."""
    return _paged_mla_core(q_lat, q_rope,
                           _latent_gathered(c_pages, c_scale, page_table),
                           _latent_gathered(kr_pages, kr_scale, page_table),
                           lengths, sm_scale)


def _single_mla(plain):
    """The single-token form of a multi-token MLA plain: q_lat (B, Hq, R)
    and q_rope (B, Hq, Dr) as K = 1 (the single-token mask, positions below
    ``lengths``, is the multi-token one at K = 1)."""
    def single(q_lat, q_rope, *args, **kw):
        return plain(q_lat[:, None], q_rope[:, None], *args, **kw)[:, 0]
    return single


# ports of ``_paged_attention_mla_xla`` and ``_paged_attention_mla_quant_xla``
_paged_attention_mla_plain = _single_mla(_paged_attention_multi_mla_plain)
_paged_attention_mla_quant_plain = _single_mla(
    _paged_attention_multi_mla_quant_plain)

_MLA_LATENT_DIMS = (512,)   # the widths the kernels are instantiated at
_MLA_ROPE_DIMS = (64,)


@functools.cache
def _mla_launchers():
    """The C entries of the bf16 and the int8 latent kernels: (one pass,
    split-KV with its merge) each."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bf16 = _cuda.load("paged_attention_multi_mla")
    int8 = _cuda.load("paged_attention_multi_mla_quant")
    fns = (bf16.paged_attention_multi_mla_bf16,
           bf16.paged_attention_multi_mla_bf16_split,
           int8.paged_attention_multi_mla_int8,
           int8.paged_attention_multi_mla_int8_split)
    for fn, n_ptr, split in zip(fns, (7, 9, 9, 11), (False, True) * 2):
        fn.argtypes = [p] * n_ptr + [i] * 7 + [f] + [i, i] * split + [p]
        fn.restype = i
    return fns


# the MLA kernels' row tile: 64 query rows a block (two warpgroups that
# split the latent width), one block an SM (222 KB of shared memory)
_MLA_TILE_ROWS = 64


def _mla_split_plan(batch: int, n_q: int, hq: int, table_width: int,
                    sms: int) -> tuple[int, int]:
    """(splits, pages per split) of the MLA kernels' split-KV. A grid of
    (row tiles x sequences) blocks that leaves SMs idle (decode: 8
    one-tile sequences on 132 SMs) cuts the table's columns into
    contiguous ranges so that about one block an SM runs; a fuller grid
    gets one split over every column. Computed from shapes alone (the
    lengths stay on the card): each block takes its own range of the pages
    its rows see (``_split_ranges`` at group = Hq, no window) and skips
    the work of a split past them."""
    blocks = batch * -(-n_q * hq // _MLA_TILE_ROWS)
    if blocks >= sms or table_width <= 1:
        return 1, max(table_width, 1)
    want = min(-(-sms // blocks), table_width)
    per = -(-table_width // want)
    return -(-table_width // per), per


def _check_mla_shapes(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
                      page_table, lengths) -> None:
    """The JAX entry points' argument checks, q as (B, K, Hq, .)."""
    b, kq, hq, _ = q_lat.shape
    dr = kr_pages.shape[2]
    if q_rope.shape != (b, kq, hq, dr):
        raise ValueError(f"q_rope {tuple(q_rope.shape)} != (B, K, Hq, Dr) = "
                         f"{(b, kq, hq, dr)}")
    if c_pages.shape[:2] != kr_pages.shape[:2]:
        raise ValueError(f"c_pages {tuple(c_pages.shape)} / kr_pages "
                         f"{tuple(kr_pages.shape)} disagree on (P, T)")
    if c_pages.shape[2] != q_lat.shape[3] or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("q_lat/pages/page_table/lengths shapes disagree")
    if c_scale is not None and (c_scale.shape != c_pages.shape[:2]
                                or kr_scale.shape != kr_pages.shape[:2]):
        raise ValueError(f"scale shapes {tuple(c_scale.shape)}/"
                         f"{tuple(kr_scale.shape)} must be the pages' (P, T) "
                         f"= {tuple(c_pages.shape[:2])}")


def _check_mla_cuda(**tensors) -> None:
    """What the kernels take: one card, contiguous, 16-byte aligned; f32
    q_lat and q_rope (other dtypes are refused), bf16 latent pages (int8
    with f32 scales), int32 tables; R 512, Dr 64 (every MLA config's), T a
    multiple of 8."""
    quant = tensors["c_scale"] is not None
    want = {"q_lat": torch.float32, "q_rope": torch.float32,
            "c_pages": torch.int8 if quant else torch.bfloat16,
            "kr_pages": torch.int8 if quant else torch.bfloat16,
            "c_scale": torch.float32, "kr_scale": torch.float32,
            "page_table": torch.int32, "lengths": torch.int32}
    dev = tensors["q_lat"].device
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q_lat on {dev}")
        if t.dtype != want[name]:
            raise TypeError(f"the CUDA kernel takes {want[name]} {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _, t, r = tensors["c_pages"].shape
    dr = tensors["kr_pages"].shape[2]
    if r not in _MLA_LATENT_DIMS or dr not in _MLA_ROPE_DIMS:
        raise ValueError(f"latent {r} / rope {dr} not supported by the CUDA "
                         f"kernel (latent one of {_MLA_LATENT_DIMS}, rope "
                         f"one of {_MLA_ROPE_DIMS})")
    if t % 8:
        raise ValueError(f"page_tokens {t} must be a multiple of 8")


def _mla_entry(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
               page_table, lengths, sm_scale, wrapper) -> torch.Tensor:
    """The four MLA entry points: q_lat (B, K, Hq, R) and q_rope
    (B, K, Hq, Dr), or (B, Hq, .) for the single-token forms, run as
    K = 1. A CPU tensor runs the multi-token plain version (bf16 or int8
    latents); a CUDA tensor launches the kernel, counted on ``wrapper``,
    or raises."""
    single = q_lat.dim() == 3
    ql = q_lat[:, None] if single else q_lat
    qr = q_rope[:, None] if single else q_rope
    _check_mla_shapes(ql, qr, c_pages, kr_pages, c_scale, kr_scale,
                      page_table, lengths)
    scale = sm_scale if sm_scale is not None else \
        (c_pages.shape[2] + kr_pages.shape[2]) ** -0.5
    if q_lat.device.type == "cpu":
        out = _paged_mla_core(ql, qr,
                              _latent_gathered(c_pages, c_scale, page_table),
                              _latent_gathered(kr_pages, kr_scale,
                                               page_table), lengths, scale)
    elif q_lat.device.type == "cuda":
        ql, qr = ql.contiguous(), qr.contiguous()
        _check_mla_cuda(q_lat=ql, q_rope=qr, c_pages=c_pages,
                        kr_pages=kr_pages, c_scale=c_scale,
                        kr_scale=kr_scale, page_table=page_table,
                        lengths=lengths)
        b, kq, hq, r = ql.shape
        _, t, dr = kr_pages.shape
        cols = page_table.shape[1]
        out = torch.empty_like(ql)
        stream = torch.cuda.current_stream(ql.device).cuda_stream
        pages = [c_pages, kr_pages]
        if c_scale is not None:
            pages += [c_scale, kr_scale]
        head = (ql.data_ptr(), qr.data_ptr(), *(x.data_ptr() for x in pages),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr())
        dims = (b, kq, hq, r, dr, t, cols, float(scale))
        one, split = _mla_launchers()[2 * (c_scale is not None):][:2]
        splits, per = _mla_split_plan(b, kq, hq, cols,
                                      _sm_count(ql.device.index))
        if splits == 1:
            code = one(*head, *dims, stream)
        else:
            # scratch of the splits: the unnormalised f32 accumulator and
            # the (max, sum) of every output row, merged on the card
            part_o = torch.empty((b, splits, kq, hq, r), dtype=torch.float32,
                                 device=ql.device)
            part_ml = torch.empty((b, splits, kq, hq, 2),
                                  dtype=torch.float32, device=ql.device)
            code = split(*head, part_o.data_ptr(), part_ml.data_ptr(), *dims,
                         splits, per, stream)
        _cuda.check(code, wrapper.__name__)
        wrapper.launches += 1
    else:
        raise ValueError(f"unsupported device {q_lat.device}")
    return out[:, 0] if single else out


def paged_attention_multi_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                              c_pages: torch.Tensor, kr_pages: torch.Tensor,
                              page_table: torch.Tensor, lengths: torch.Tensor,
                              *, sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Absorbed MLA over K query tokens: q_lat (B, K, Hq, R) (the query
    folded through w_uk) and q_rope (B, K, Hq, Dr) attend the latent pages
    c (P, T, R) and kr (P, T, Dr) through ``page_table`` (B, N);
    ``lengths`` includes the K tokens (query j sits at lengths - K + j).
    Scores are sm_scale * (q_lat . c + q_rope . kr), sm_scale defaulting
    to (R + Dr)^-0.5. Returns the weighted latent (B, K, Hq, R) in q_lat's
    dtype. A CUDA tensor launches the kernel (f32 q, bf16 pages) or raises;
    a CPU tensor takes the plain version."""
    return _mla_entry(q_lat, q_rope, c_pages, kr_pages, None, None,
                      page_table, lengths, sm_scale,
                      paged_attention_multi_mla)


def paged_attention_multi_mla_quant(q_lat: torch.Tensor,
                                    q_rope: torch.Tensor,
                                    c_pages: torch.Tensor,
                                    kr_pages: torch.Tensor,
                                    c_scale: torch.Tensor,
                                    kr_scale: torch.Tensor,
                                    page_table: torch.Tensor,
                                    lengths: torch.Tensor, *,
                                    sm_scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """``paged_attention_multi_mla`` over int8 latent pages with
    per-position f32 scales c_scale/kr_scale (P, T). A CUDA tensor launches
    ``csrc/paged_attention_multi_mla_quant.cu`` or raises; a CPU tensor
    takes the plain version."""
    return _mla_entry(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
                      page_table, lengths, sm_scale,
                      paged_attention_multi_mla_quant)


def paged_attention_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                        c_pages: torch.Tensor, kr_pages: torch.Tensor,
                        page_table: torch.Tensor, lengths: torch.Tensor, *,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token MLA decode: q_lat (B, Hq, R), q_rope (B, Hq, Dr),
    ``lengths`` counting the query's own token. Returns (B, Hq, R). The
    multi-token function at K = 1: a CUDA tensor launches the bf16 latent
    kernel at K = 1 (counted here, not on ``paged_attention_multi_mla``)."""
    return _mla_entry(q_lat, q_rope, c_pages, kr_pages, None, None,
                      page_table, lengths, sm_scale, paged_attention_mla)


def paged_attention_mla_quant(q_lat: torch.Tensor, q_rope: torch.Tensor,
                              c_pages: torch.Tensor, kr_pages: torch.Tensor,
                              c_scale: torch.Tensor, kr_scale: torch.Tensor,
                              page_table: torch.Tensor,
                              lengths: torch.Tensor, *,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """``paged_attention_mla`` over int8 latent pages (scales as in
    ``paged_attention_multi_mla_quant``): a CUDA tensor launches the int8
    latent kernel at K = 1 (counted here)."""
    return _mla_entry(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
                      page_table, lengths, sm_scale,
                      paged_attention_mla_quant)


# kernel launches made through each wrapper (the plain path never counts)
paged_attention_multi_mla.launches = 0
paged_attention_multi_mla_quant.launches = 0
paged_attention_mla.launches = 0
paged_attention_mla_quant.launches = 0


# -- flash attention (contiguous, with gradients) ---------------------------------

def _check_q_offset(q_offset: int) -> None:
    if q_offset < 0:
        raise ValueError(f"q_offset must not be negative, got {q_offset}")


def _check_flash_shapes(q, k, v, causal: bool, sliding_window,
                        logit_soft_cap, q_offset: int = 0) -> None:
    """The JAX ``flash_attention``'s argument checks, plus the shapes its
    layout implies and a ``q_offset`` that is not negative."""
    _check_q_offset(q_offset)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected q (B, Hq, Sq, D) and "
                         "k, v (B, Hkv, Sk, D)")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    if hq % k.shape[1] != 0:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={k.shape[1]}")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal attention")
        if sliding_window <= 0:
            raise ValueError(f"sliding_window must be positive, "
                             f"got {sliding_window}")
    if logit_soft_cap is not None and logit_soft_cap <= 0:
        raise ValueError(f"logit_soft_cap must be positive, "
                         f"got {logit_soft_cap}")


def _flash_mask(sq: int, sk: int, causal: bool, window: Optional[int],
                device, q_offset: int = 0) -> Optional[torch.Tensor]:
    """(Sq, Sk) mask of the keys each query sees, or None for all. Query
    row i sits at position q_offset + i (the JAX ``_causal_mask``)."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def _attention_plain(q, k, v, *, causal: bool, sm_scale: float,
                     sliding_window: Optional[int] = None,
                     logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """Port of ``_attention_xla``: q scaled in its own dtype, scores and
    softmax in f32, p cast to q's dtype before p.v, f32 accumulation. A row
    that sees no key gives 0 (the kernels' choice; the XLA path would give
    the mean of v). Differentiable by autograd."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    qg = (q * torch.as_tensor(sm_scale, dtype=q.dtype)).reshape(
        b, hkv, group, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    if logit_soft_cap is not None:
        s = torch.tanh(s / logit_soft_cap) * logit_soft_cap
    mask = _flash_mask(sq, sk, causal, sliding_window, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(q.dtype).float(), v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def _flash_probs(q, k, lse, causal, scale, window, soft_cap, q_offset=0):
    """The kernels' recomputation in f32: scores of q (B, Hkv, G, Sq, D)
    against k, their soft-cap tanh (or None), and P = exp(s - lse) with
    masked entries zeroed (so a row that sees no key has P = 0)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float() * scale, k.float())
    th = None
    if soft_cap is not None:
        th = torch.tanh(s / soft_cap)
        s = th * soft_cap
    mask = _flash_mask(q.shape[3], k.shape[2], causal, window, q.device,
                       q_offset)
    if lse is None:
        m = s if mask is None else torch.where(mask, s,
                                               torch.full_like(s, NEG_INF))
        m = m.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        if mask is not None:
            e = torch.where(mask, e, torch.zeros_like(e))
        lse = m + torch.log(e.sum(-1, keepdim=True).clamp_min(1e-30))
    else:
        lse = lse[..., None]
    p = torch.exp(s - lse)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    return p, th, lse[..., 0]


def _grouped(t: torch.Tensor, hkv: int) -> torch.Tensor:
    b, hq, s, d = t.shape
    return t.reshape(b, hkv, hq // hkv, s, d)


def _flash_fwd_plain(q, k, v, *, causal, sm_scale, sliding_window=None,
                     logit_soft_cap=None, q_offset=0):
    """What ``flash_fwd``'s kernel computes, in f32: (o in q's dtype, lse
    (B, Hq, Sq) f32)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    p, _, lse = _flash_probs(_grouped(q, hkv), k, None, causal, sm_scale,
                             sliding_window, logit_soft_cap, q_offset)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq)


def _flash_ds(q, k, v, do, lse, delta, causal, scale, window, soft_cap,
              q_offset=0):
    hkv = k.shape[1]
    qg, dog = _grouped(q, hkv), _grouped(do, hkv)
    p, th, _ = _flash_probs(qg, k, _grouped(lse[..., None], hkv)[..., 0],
                            causal, scale, window, soft_cap, q_offset)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog.float(), v.float())
    ds = p * (dp - _grouped(delta[..., None], hkv))
    if th is not None:
        ds = ds * (1.0 - th * th)
    return p, ds, qg, dog


def _flash_dq_plain(q, k, v, do, lse, delta, *, causal, sm_scale,
                    sliding_window=None, logit_soft_cap=None, q_offset=0):
    """What ``flash_dq``'s kernel computes, in f32: dq = scale * dS k."""
    _, ds, _, _ = _flash_ds(q, k, v, do, lse, delta, causal, sm_scale,
                            sliding_window, logit_soft_cap, q_offset)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * sm_scale
    return dq.reshape(q.shape).to(q.dtype)


def _flash_dkv_plain(q, k, v, do, lse, delta, *, causal, sm_scale,
                     sliding_window=None, logit_soft_cap=None, q_offset=0):
    """What ``flash_dkv``'s kernel computes, in f32: dv = P^T dO and
    dk = scale * dS^T q, summed over each GQA group."""
    p, ds, qg, dog = _flash_ds(q, k, v, do, lse, delta, causal, sm_scale,
                               sliding_window, logit_soft_cap, q_offset)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog.float())
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _flash_launchers(defines: tuple = ()):
    """The three C launchers; ``defines`` bind a measurement variant of
    the source (``csrc/flash_attention.cu``'s knobs)."""
    lib = _cuda.load("flash_attention", defines)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # b hq hkv sq sk d, scale cap, causal window q_offset, stream
    dims = [i, i, i, i, i, i, f, f, i, i, i, p]
    fwd, dq, dkv = lib.flash_fwd_bf16, lib.flash_dq_bf16, lib.flash_dkv_bf16
    fwd.argtypes = [p] * 5 + dims
    dq.argtypes = [p] * 7 + dims
    dkv.argtypes = [p] * 8 + dims
    for fn in (fwd, dq, dkv):
        fn.restype = i
    return fwd, dq, dkv


def _check_flash_cuda(**tensors) -> None:
    """What the kernels take: tensors on one card, contiguous, 16-byte
    aligned, bf16 (f32 for lse and delta), D in {64, 128, 192, 256}."""
    dev = tensors["q"].device
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != want:
            raise TypeError(f"the CUDA kernel takes {want} {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    d = tensors["q"].shape[3]
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernel "
                         f"(one of {_FLASH_HEAD_DIMS})")


def _flash_dims(q, k, causal, sm_scale, sliding_window, logit_soft_cap,
                q_offset, stream) -> tuple:
    b, hq, sq, d = q.shape
    return (b, hq, k.shape[1], sq, k.shape[2], d, float(sm_scale),
            float(logit_soft_cap or 0.0), int(causal),
            int(sliding_window or 0), int(q_offset), stream)


def _flash_args(causal, sm_scale, sliding_window, logit_soft_cap,
                q_offset) -> dict:
    _check_q_offset(q_offset)
    return dict(causal=causal, sm_scale=sm_scale,
                sliding_window=sliding_window, logit_soft_cap=logit_soft_cap,
                q_offset=q_offset)


def flash_fwd(q, k, v, *, causal: bool, sm_scale: float,
              sliding_window: Optional[int] = None,
              logit_soft_cap: Optional[float] = None, q_offset: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (o (B, Hq, Sq, D) in q's dtype, lse (B, Hq, Sq)
    f32). Query row i sits at position ``q_offset`` + i, key j at j; a row
    that sees no key gives o = 0 and lse = -1e30. A CUDA tensor launches
    it or raises; a CPU tensor takes the plain version."""
    args = _flash_args(causal, sm_scale, sliding_window, logit_soft_cap,
                       q_offset)
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, **args)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_flash_cuda(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _flash_launchers()[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_flash_dims(q, k, stream=stream, **args))
    _cuda.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
             sliding_window: Optional[int] = None,
             logit_soft_cap: Optional[float] = None,
             q_offset: int = 0) -> torch.Tensor:
    """The dQ kernel: dq (B, Hq, Sq, D) in q's dtype, from the forward's
    lse and delta = rowsum(dO o) (B, Hq, Sq) f32 (under a ring, the global
    ones), positions as in ``flash_fwd``. A CUDA tensor launches it or
    raises; a CPU tensor takes the plain version."""
    args = _flash_args(causal, sm_scale, sliding_window, logit_soft_cap,
                       q_offset)
    if q.device.type == "cpu":
        return _flash_dq_plain(q, k, v, do, lse, delta, **args)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_flash_cuda(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _flash_launchers()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_flash_dims(q, k, stream=stream, **args))
    _cuda.check(code, "flash_dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
              sliding_window: Optional[int] = None,
              logit_soft_cap: Optional[float] = None, q_offset: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: (dk, dv) (B, Hkv, Sk, D) in k's dtype, summed over
    each GQA group, positions as in ``flash_fwd``. A CUDA tensor launches
    it or raises; a CPU tensor takes the plain version."""
    args = _flash_args(causal, sm_scale, sliding_window, logit_soft_cap,
                       q_offset)
    if q.device.type == "cpu":
        return _flash_dkv_plain(q, k, v, do, lse, delta, **args)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_flash_cuda(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _flash_launchers()[2](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_flash_dims(q, k, stream=stream, **args))
    _cuda.check(code, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


# kernel launches made through each wrapper (the plain path never counts)
flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Replaces the JAX package's ``_flash_diff`` custom_vjp: the forward
    kernel saves (q, k, v, o, lse); the backward computes delta =
    rowsum(dO o) in f32 torch, then launches the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, args: dict):
        o, lse = flash_fwd(q, k, v, **args)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = args
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_dq(q, k, v, do, lse, delta, **ctx.args)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, **ctx.args)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    sliding_window: Optional[int] = None,
                    logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with GQA and gradients. q (B, Hq, Sq, D), k/v
    (B, Hkv, Sk, D); returns (B, Hq, Sq, D) in q's dtype.
    ``sliding_window`` keeps each query to the last W positions (needs
    ``causal``); ``logit_soft_cap`` passes scores through cap*tanh(s/cap)
    before the mask. A CUDA tensor runs the kernels for any Sq, Sk >= 1
    (bf16, D in {64, 128, 192, 256}, contiguous) or raises; a CPU tensor runs
    the same autograd Function over the kernels' plain versions."""
    _check_flash_shapes(q, k, v, causal, sliding_window, logit_soft_cap)
    scale = sm_scale if sm_scale is not None else q.shape[3] ** -0.5
    args = dict(causal=causal, sm_scale=scale, sliding_window=sliding_window,
                logit_soft_cap=logit_soft_cap)
    return _FlashAttention.apply(q, k, v, args)
