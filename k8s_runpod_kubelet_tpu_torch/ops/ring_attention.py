"""Ring attention: sequence parallelism over a mesh's ``seq`` axis (port of
the JAX package's ``ops/ring_attention.py``).

The sequence is cut into n equal shards; each shard keeps its queries and
meets every K/V shard in turn, in the order of a ring: at step t the shard
of index idx holds the K/V chunk of shard idx - t, whose keys sit a fixed
t * s_local positions behind its queries. Two schedules, as in the JAX
package:

- ``use_flash=False``, the XLA ring's counterpart (JAX ``:288-335``): each
  relevant chunk folds into an online softmax, ``_chunk_update``, in plain
  f32 torch, differentiated by autograd. The JAX package computes this
  path outside any Pallas kernel, so it stays plain PyTorch here.
- ``use_flash=True``, ring flash attention (JAX ``_ring_flash``): step t
  runs the flash forward kernel at ``q_offset = t * s_local`` on the shards
  with idx >= t and merges the chunk results by their log-sum-exp in f32;
  the backward runs the ring again, feeding the dQ and dK/dV kernels the
  global (o, lse), so each chunk's gradients are exact and sum to the
  whole. A sliding window truncates the ring once the band has left it
  (``_ring_steps``).

Two forms share those schedules:

- in one process (an in-process ``Mesh``): the tensors are the global
  ones, and the n shards are stacked on a leading axis, so step t is one
  launch of each kernel over q[t:] against k[:n - t] (batch (n - t) B):
  nothing rotates, dq accumulates into [t:] and dk, dv into [:n - t];
- over a process group (one shard a rank): the tensors are the rank's
  shard; K/V rotate to rank + 1 by ``batch_isend_irecv`` (the JAX
  ``ppermute``), the dK/dV accumulators travel with their chunks, and the
  final ``hops`` send them home. A rank with idx < t skips the launch but
  takes part in the shift.

Both compute the same chunks, in the same order, with the same sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import (NEG_INF, _check_flash_shapes, flash_attention,
                        flash_dkv, flash_dq, flash_fwd)


def _ring_steps(n: int, s_local: int, window: Optional[int]) -> int:
    """How many ring steps carry any in-band work: step t's chunk sits
    t * s_local behind the local queries, so under a window it is fully
    out of band once (t - 1) * s_local + 1 > window - 1."""
    if window is None:
        return n
    t_max = (window + s_local - 2) // s_local  # last relevant step index
    return min(n, t_max + 1)


def _chunk_update(q, kc, vc, acc, m, l, *, q_offset: int, k_offset: int,
                  causal: bool, sm_scale: float,
                  soft_cap: Optional[float] = None,
                  window: Optional[int] = None):
    """One online-softmax step in f32: fold the K/V chunk kc/vc (B, Hkv,
    Sk, D) at global offset ``k_offset`` into the running (acc, m, l) of
    q (B, Hq, Sq, D) at ``q_offset``; scale, then soft cap, then the mask,
    as ``flash_attention``. The running max is taken without a gradient:
    o = acc / l does not depend on it, and autograd then keeps no copy of
    the scores for it."""
    b, hq, sq, d = q.shape
    hkv, sk = kc.shape[1], kc.shape[2]
    qg = (q.float() * sm_scale).reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc.float())
    s = s.reshape(b, hq, sq, sk)
    if soft_cap is not None:
        s = torch.tanh(s / soft_cap) * soft_cap
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(sk, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window is not None:
            keep &= (q_pos - k_pos) < window
        s = s.masked_fill(~keep, NEG_INF)
    m_new = torch.maximum(m, s.detach().amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd",
                     p.reshape(b, hkv, hq // hkv, sq, sk), vc.float())
    return acc * corr + o.reshape(b, hq, sq, d), m_new, l_new


def _merge(o_acc, lse_acc, o_c, lse_c):
    """Fold a chunk's (o, lse) into the running ones by their log-sum-exp,
    in f32 (the JAX ``_ring_flash`` merge)."""
    new = torch.logaddexp(lse_acc, lse_c)
    o_acc = (o_acc * torch.exp(lse_acc - new)[..., None]
             + o_c.float() * torch.exp(lse_c - new)[..., None])
    return o_acc, new


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where a slice starts off the kernels' 16 bytes."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


# -- in one process: the shards stacked on a leading axis ----------------------

def _stack(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, H, S, D) -> the n shards of S stacked: (n, B, H, S / n, D)."""
    b, h, s, d = x.shape
    return x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()


def _unstack(x: torch.Tensor) -> torch.Tensor:
    n, b, h, s, d = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(b, h, n * s, d)


def _rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Shards [lo, hi) of a stacked tensor, their batches flattened."""
    return _aligned(x[lo:hi].flatten(0, 1))


class _RingFlashStacked(torch.autograd.Function):
    """Ring flash attention over stacked shards (n, B, H, s, D): step t is
    one launch of each kernel over the shards t.. against the chunks ..n-t
    at ``q_offset = t * s``. Replaces the JAX ``_ring_flash`` custom VJP
    for a mesh inside one process."""

    @staticmethod
    def forward(ctx, qs, ks, vs, steps: int, args: dict):
        n, s = qs.shape[0], qs.shape[3]
        o_acc = lse_acc = None
        for t in range(steps):
            o_c, lse_c = flash_fwd(_rows(qs, t, n), _rows(ks, 0, n - t),
                                   _rows(vs, 0, n - t), q_offset=t * s,
                                   **args)
            o_c = o_c.unflatten(0, (n - t, -1))
            lse_c = lse_c.unflatten(0, (n - t, -1))
            if t == 0:
                o_acc, lse_acc = o_c.float(), lse_c
            else:
                o_acc[t:], lse_acc[t:] = _merge(o_acc[t:], lse_acc[t:], o_c,
                                                lse_c)
        o = o_acc.to(qs.dtype)
        ctx.save_for_backward(qs, ks, vs, o, lse_acc)
        ctx.steps, ctx.args = steps, args
        return o

    @staticmethod
    def backward(ctx, do):
        qs, ks, vs, o, lse = ctx.saved_tensors
        n, s = qs.shape[0], qs.shape[3]
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)
        dk = torch.zeros(ks.shape, dtype=torch.float32, device=ks.device)
        dv = torch.zeros_like(dk)
        for t in range(ctx.steps):
            chunk = (_rows(qs, t, n), _rows(ks, 0, n - t), _rows(vs, 0, n - t),
                     _rows(do, t, n), _rows(lse, t, n), _rows(delta, t, n))
            dq_c = flash_dq(*chunk, q_offset=t * s, **ctx.args)
            dq[t:] += dq_c.unflatten(0, (n - t, -1)).float()
            del dq_c
            dk_c, dv_c = flash_dkv(*chunk, q_offset=t * s, **ctx.args)
            dk[:n - t] += dk_c.unflatten(0, (n - t, -1)).float()
            dv[:n - t] += dv_c.unflatten(0, (n - t, -1)).float()
        return (dq.to(qs.dtype), dk.to(ks.dtype), dv.to(vs.dtype), None,
                None)


def _ring_plain_stacked(qs, ks, vs, *, causal, scale, soft_cap, window):
    """The XLA ring over stacked shards: for each step, every shard whose
    chunk is relevant folds it in, all in one batched update (the relevance
    test of the JAX ring depends on t alone for idx >= t, and causal
    attention finds nothing in the chunks of shards past idx)."""
    n, b, _, s, _ = qs.shape
    q = qs.flatten(0, 1)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:3], 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    args = dict(causal=causal, sm_scale=scale, soft_cap=soft_cap,
                window=window)
    for t in range(n):
        if not causal:
            # shard idx holds chunk (idx - t) mod n; no mask to place it
            acc, m, l = _chunk_update(q, ks.roll(t, 0).flatten(0, 1),
                                      vs.roll(t, 0).flatten(0, 1), acc, m,
                                      l, q_offset=0, k_offset=0, **args)
            continue
        # relevant: the chunk's first key precedes the shard's last query
        # (idx >= t) and, windowed, its last key is inside some query's band
        if window is not None and not t * s - (s - 1) < window:
            continue
        lo = t * b
        a, mm, ll = _chunk_update(q[lo:], ks[:n - t].flatten(0, 1),
                                  vs[:n - t].flatten(0, 1), acc[lo:],
                                  m[lo:], l[lo:], q_offset=t * s, k_offset=0,
                                  **args)
        acc = torch.cat([acc[:lo], a])
        m = torch.cat([m[:lo], mm])
        l = torch.cat([l[:lo], ll])
    o = (acc / l.clamp_min(1e-30)).to(qs.dtype)
    return o.unflatten(0, (n, b))


# -- over a process group: one shard a rank ----------------------------------

def _shift(tensors: list[torch.Tensor], mesh, hops: int
           ) -> list[torch.Tensor]:
    """Send each tensor ``hops`` ranks forward along the ring and take the
    ones from ``hops`` ranks behind (hops < 0 goes backward), in one
    batch: every rank posts the same operations in the same order."""
    import torch.distributed as dist

    n, rank, group = mesh.seq, mesh.rank, mesh.group
    dst = dist.get_global_rank(group, (rank + hops) % n)
    src = dist.get_global_rank(group, (rank - hops) % n)
    out = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
           for x in tensors]
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group)
           for x in tensors]
    ops += [dist.P2POp(dist.irecv, y, src, group) for y in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingFlashGroup(torch.autograd.Function):
    """Ring flash attention with one shard a rank: the JAX ``_ring_flash``
    custom VJP, its ``ppermute``s as ``batch_isend_irecv``."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, steps: int, args: dict):
        s, idx = q.shape[2], mesh.rank
        kc, vc = k, v
        o_acc = lse_acc = None
        for t in range(steps):
            if idx >= t:    # t = 0, the rank's own chunk, always is
                o_c, lse_c = flash_fwd(q, kc, vc, q_offset=t * s, **args)
                if t == 0:
                    o_acc, lse_acc = o_c.float(), lse_c
                else:
                    o_acc, lse_acc = _merge(o_acc, lse_acc, o_c, lse_c)
            if t + 1 < steps:
                kc, vc = _shift([kc, vc], mesh, 1)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse_acc)
        ctx.mesh, ctx.steps, ctx.args = mesh, steps, args
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, steps = ctx.mesh, ctx.steps
        n, s, idx = mesh.seq, q.shape[2], mesh.rank
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # dk/dv ride with their chunks: after the loop each holds every
        # rank's contribution to the chunk it travels with
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for t in range(steps):
            if idx >= t:
                chunk = (q, kc, vc, do, lse, delta)
                dq += flash_dq(*chunk, q_offset=t * s, **ctx.args).float()
                dk_c, dv_c = flash_dkv(*chunk, q_offset=t * s, **ctx.args)
                dk += dk_c.float()
                dv += dv_c.float()
            if t + 1 < steps:
                kc, vc, dk, dv = _shift([kc, vc, dk, dv], mesh, 1)
        # each chunk's sums have moved steps - 1 hops forward; the rest of
        # the cycle brings them home
        hops = (n - (steps - 1)) % n
        if hops:
            dk, dv = _shift([dk, dv], mesh, hops)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


class _Rotations(torch.autograd.Function):
    """The K/V chunks a rank holds at steps 0..n-1 of the XLA ring (step t:
    the chunk of rank idx - t), by n - 1 shifts forward. The backward
    sends the gradients back the same way, summed as they go, so every
    rank runs the same shifts whichever chunks it used."""

    @staticmethod
    def forward(ctx, k, v, mesh):
        ctx.mesh = mesh
        ks, vs = [k], [v]
        for _ in range(mesh.seq - 1):
            kc, vc = _shift([ks[-1], vs[-1]], mesh, 1)
            ks.append(kc)
            vs.append(vc)
        return (*ks, *vs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.seq
        gk, gv = grads[n - 1], grads[2 * n - 1]
        for t in range(n - 1, 0, -1):
            gk, gv = _shift([gk, gv], ctx.mesh, -1)
            gk, gv = gk + grads[t - 1], gv + grads[n + t - 1]
        return gk, gv, None


def _ring_plain_group(q, k, v, mesh, *, causal, scale, soft_cap, window):
    """The XLA ring with one shard a rank (JAX ``:288-335``)."""
    n, s, idx = mesh.seq, q.shape[2], mesh.rank
    chunks = _Rotations.apply(k, v, mesh)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:3], 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    q_off = idx * s
    for t in range(n):
        k_off = (idx - t) % n * s
        if causal:
            relevant = k_off <= q_off + (s - 1)
            if window is not None:
                relevant &= q_off - (k_off + s - 1) < window
            if not relevant:
                continue
        acc, m, l = _chunk_update(q, chunks[t], chunks[n + t], acc, m, l,
                                  q_offset=q_off, k_offset=k_off,
                                  causal=causal, sm_scale=scale,
                                  soft_cap=soft_cap, window=window)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   *, causal: bool = True, sm_scale: Optional[float] = None,
                   logit_soft_cap: Optional[float] = None,
                   sliding_window: Optional[int] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Attention over a sequence sharded on ``mesh``'s ``seq`` axis, with
    gradients. In one process q (B, Hq, S, D) and k/v (B, Hkv, S, D) are
    the global tensors, S divisible by the axis size; over a process group
    they are this rank's shard of S / n positions, which start at rank *
    S / n. Returns the attention output in q's layout and dtype.

    ``logit_soft_cap`` and ``sliding_window`` keep ``flash_attention``'s
    meaning. ``use_flash`` runs each chunk through the flash kernels (their
    plain versions on CPU tensors) and needs ``causal``; otherwise the
    plain online-softmax ring runs. With one shard this is
    ``flash_attention``."""
    scale = sm_scale if sm_scale is not None else q.shape[3] ** -0.5
    _check_flash_shapes(q, k, v, causal, sliding_window, logit_soft_cap)
    if use_flash and not causal:
        raise ValueError("ring flash attention requires causal=True")
    n = mesh.seq
    if n == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=scale,
                               logit_soft_cap=logit_soft_cap,
                               sliding_window=sliding_window)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"q holds {q.shape[2]} positions, k {k.shape[2]}: "
                         "a ring shards one sequence for both")
    if mesh.in_process and q.shape[2] % n:
        raise ValueError(f"S = {q.shape[2]} is not divisible by the "
                         f"{n} shards of the seq axis")
    s_local = q.shape[2] // n if mesh.in_process else q.shape[2]
    if use_flash:
        steps = _ring_steps(n, s_local, sliding_window)
        args = dict(causal=True, sm_scale=scale,
                    sliding_window=sliding_window,
                    logit_soft_cap=logit_soft_cap)
        if not mesh.in_process:
            return _RingFlashGroup.apply(q, k, v, mesh, steps, args)
        o = _RingFlashStacked.apply(_stack(q, n), _stack(k, n),
                                    _stack(v, n), steps, args)
        return _unstack(o)
    plain = dict(causal=causal, scale=scale, soft_cap=logit_soft_cap,
                 window=sliding_window)
    if not mesh.in_process:
        return _ring_plain_group(q, k, v, mesh, **plain)
    return _unstack(_ring_plain_stacked(_stack(q, n), _stack(k, n),
                                        _stack(v, n), **plain))
