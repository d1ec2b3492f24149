"""Chunked-vocab fused cross-entropy: the LM-head loss without the logits
(port of the JAX package's ``ops/fused_ce.py``).

The train step's largest activation is the (B, S, V) logits tensor: at
llama3-8b's vocab (128256) and a batch of 8 x 2048 it is 4.2 GB in bf16
and 8.4 GB once the naive loss widens it to f32. This op computes

    ce  = mean_n( logsumexp_v(h_n . W) - (h_n . W)[t_n] )
    z   = z_loss_coef * mean_n( logsumexp_v(h_n . W)^2 )

by streaming the vocab axis in chunks, an online (max, sumexp) reduction
as in flash attention, so no (N, V) tensor ever exists. The backward
recomputes each chunk's logits from the saved logsumexp (softmax_k =
exp(logits_k - lse)): one more head product in exchange for the logits'
memory.

The tied head (W = tok_embed^T, scanned over the embedding's rows, so no
transposed copy of the table is made), the untied (E, V) ``lm_head`` and
Gemma 2's logit soft cap (whose exact Jacobian 1 - (logits / cap)^2 rides
the recompute) are supported. The chunk products are plain ``torch.mm``
with f32 accumulation and f32 output (bf16 operands on the card); the
JAX package computes them outside any Pallas kernel too, so this op is
not a ported TPU kernel. The chunks run as a Python loop that frees each
(N, V/K) block before the next, and never stacks them. The forward holds
one f32 block at a time. The backward holds one f32 block and one block
in the compute dtype (the bf16 operand of the two gradient products,
allocated once and reused): 1.5 f32 blocks in bf16. With the soft cap
its Jacobian is taken a strip of rows at a time, one strip on top.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fused_cross_entropy"]


def _pick_chunks(v: int, requested: int) -> int:
    """Largest chunk count <= requested that divides the vocab evenly
    (every chunk product the same shape, as the JAX scan needs)."""
    for k in range(min(requested, v), 0, -1):
        if v % k == 0:
            return k
    return 1


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and an f32 result, the JAX
    ``preferred_element_type=float32``: on the card bf16 operands through
    cuBLAS with an f32 output; on the CPU the operands widened (exact
    products, f32 sums)."""
    if a.dtype == torch.float32:
        return a @ b.float()
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_w(w: torch.Tensor, tied: bool, start: int, size: int,
             dtype: torch.dtype) -> torch.Tensor:
    """The head's columns [start, start + size) as a (E, size) operand in
    the compute dtype: rows of the (V, E) table when tied (a transposed
    view, no copy of the table), columns of the (E, V) head otherwise."""
    if tied:
        return w[start:start + size].to(dtype).t()
    return w[:, start:start + size].to(dtype)


def _chunk_logits(h2: torch.Tensor, wk: torch.Tensor,
                  softcap: Optional[float]) -> torch.Tensor:
    """f32 logits (N, size) of one chunk, soft-capped in place."""
    logits = _mm_f32(h2, wk)
    if softcap:
        logits.div_(softcap).tanh_().mul_(softcap)
    return logits


def _vocab(w: torch.Tensor, tied: bool) -> int:
    return w.shape[0] if tied else w.shape[1]


def _forward(h2, w, t1, tied, n_chunks, softcap):
    """Online logsumexp and the target logit over the vocab chunks: (lse,
    picked), each (N,) f32."""
    n = h2.shape[0]
    size = _vocab(w, tied) // n_chunks
    m = torch.full((n,), -torch.inf, dtype=torch.float32, device=h2.device)
    s = torch.zeros((n,), dtype=torch.float32, device=h2.device)
    picked = torch.zeros((n,), dtype=torch.float32, device=h2.device)
    for k in range(n_chunks):
        start = k * size
        logits = _chunk_logits(h2, _chunk_w(w, tied, start, size, h2.dtype),
                               softcap)
        idx = t1 - start
        in_chunk = (idx >= 0) & (idx < size)
        got = logits.gather(1, idx.clamp(0, size - 1)[:, None])[:, 0]
        picked = picked + torch.where(in_chunk, got, 0.0)
        m_new = torch.maximum(m, logits.amax(dim=1))
        # the block becomes exp(logits - m_new) in place: one block live
        s = s * torch.exp(m - m_new) + logits.sub_(m_new[:, None]).exp_() \
            .sum(dim=1)
        m = m_new
        del logits
    return m + torch.log(s), picked


def _cap_jac(x: torch.Tensor, softcap: float) -> torch.Tensor:
    """1 - (x / cap)^2, the soft cap's Jacobian at post-cap logits x."""
    return x.div(softcap).square_().neg_().add_(1.0)


def _softmax_grad_(logits: torch.Tensor, lse: torch.Tensor,
                   row_coef: torch.Tensor, softcap: Optional[float]) -> None:
    """In place: logits (N, size) -> exp(logits - lse) * row_coef, times
    the soft cap's Jacobian. The Jacobian needs the logits beside the
    result, so under the cap it runs a strip of rows at a time: one
    (N/8, size) strip lives beside the block, never a second block."""
    n = logits.shape[0]
    strip = max(1, -(-n // 8) if softcap else n)
    for r in range(0, n, strip):
        x = logits[r:r + strip]
        jac = _cap_jac(x, softcap) if softcap else None
        x.sub_(lse[r:r + strip, None]).exp_().mul_(row_coef[r:r + strip, None])
        if jac is not None:
            x.mul_(jac)


def _ce_z(lse: torch.Tensor, picked: torch.Tensor, z_loss_coef: float):
    ce = (lse - picked).mean()
    z = (z_loss_coef * lse.square().mean() if z_loss_coef
         else torch.zeros((), dtype=torch.float32, device=lse.device))
    return ce, z


class _FusedCE(torch.autograd.Function):
    """(ce, z) of h2 (N, E) against the head, saving only h2, the head,
    the targets and the lse for the backward."""

    @staticmethod
    def forward(ctx, h2, w, t1, tied, z_loss_coef, softcap, n_chunks):
        lse, picked = _forward(h2, w, t1, tied, n_chunks, softcap)
        ctx.save_for_backward(h2, w, t1, lse)
        ctx.cfg = (tied, z_loss_coef, softcap, n_chunks)
        return _ce_z(lse, picked, z_loss_coef)

    @staticmethod
    def backward(ctx, g_ce, g_z):
        """Recompute each chunk's logits from the saved lse; dh
        accumulates in f32, dW is written chunk by chunk into one
        full-size buffer (only when the head needs a gradient)."""
        h2, w, t1, lse = ctx.saved_tensors
        tied, z_loss_coef, softcap, n_chunks = ctx.cfg
        n = h2.shape[0]
        size = _vocab(w, tied) // n_chunks
        # d(loss)/d(logits)[n, v] = softmax * (g_ce + 2 coef lse_n g_z) / N
        #                           - onehot[target] * g_ce / N
        row_coef = (g_ce + (2.0 * z_loss_coef) * lse * g_z) / n
        g_pick = -g_ce / n
        need_w = ctx.needs_input_grad[1]
        dh = torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
        dw = torch.zeros_like(w) if need_w else None
        # the bf16 operand of the two gradient products, reused by every
        # chunk (f32 compute uses the f32 block itself)
        d16 = (torch.empty((n, size), dtype=h2.dtype, device=h2.device)
               if h2.dtype != torch.float32 else None)
        for k in range(n_chunks):
            start = k * size
            wk = _chunk_w(w, tied, start, size, h2.dtype)
            d = _chunk_logits(h2, wk, softcap)
            idx = (t1 - start).clamp(0, size - 1)[:, None]
            in_chunk = (t1 >= start) & (t1 < start + size)
            pick = torch.where(in_chunk, g_pick, 0.0)
            if softcap:
                # chain through cap * tanh(x / cap): the logits here are
                # post-cap, so the Jacobian is exactly 1 - (logits/cap)^2,
                # at the target too
                pick = pick * _cap_jac(d.gather(1, idx)[:, 0], softcap)
            _softmax_grad_(d, lse, row_coef, softcap)
            # the -onehot term as a scatter-add: no (N, V/K) one-hot
            d.scatter_add_(1, idx, pick[:, None])
            if d16 is not None:
                d = d16.copy_(d)
            dh.add_(_mm_f32(d, wk.t()))
            if need_w:
                if tied:
                    dw[start:start + size] = _mm_f32(d.t(), h2)
                else:
                    dw[:, start:start + size] = _mm_f32(h2.t(), d)
            del d
        return dh.to(h2.dtype), dw, None, None, None, None, None


def fused_cross_entropy(hidden: torch.Tensor, head_w: torch.Tensor,
                        targets: torch.Tensor, *, tied: bool = False,
                        z_loss_coef: float = 0.0,
                        logit_softcap: Optional[float] = None,
                        n_chunks: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean NLL, z-loss) of softmax(hidden @ head) against targets,
    never materializing the (N, V) logits.

    hidden (..., E); targets (...) int matching hidden's leading shape;
    head_w is ``lm_head`` (E, V), or ``tok_embed`` (V, E) with
    ``tied=True``. The semantics of ``workloads.train._ce_and_zloss``
    (one logsumexp feeding both terms); the numerics differ only by the
    f32 result of the head products. Differentiable in hidden and head_w
    (the head's gradient is computed only when it requires one)."""
    n_chunks = _pick_chunks(_vocab(head_w, tied), n_chunks)
    h2 = hidden.reshape(-1, hidden.shape[-1])
    t1 = targets.reshape(-1).long()
    return _FusedCE.apply(h2, head_w, t1, tied, float(z_loss_coef),
                          logit_softcap, n_chunks)
