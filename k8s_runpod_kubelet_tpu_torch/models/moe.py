"""Sparse Mixture-of-Experts MLP, Mixtral-style top-k routing (port of the
JAX package's ``models/moe.py``).

Every token picks its top-k experts from an f32 router; its copies scatter
into a fixed (X, capacity, E) buffer at their running position within
their expert (an assignment past the capacity is dropped: it lands in a
sink row past the buffer's end and contributes nothing), each projection
runs once for all experts, and the results gather back weighted by the
routing probabilities. Every shape is static and nothing is read back to
the host, so a step that runs this can be captured as a CUDA graph.

Expert leaves are raw (X, in, out) arrays, int8 ``{"q8", "scale"}`` with
the scale applied after the product, or int4 ``{"q4", "scale"}``, which go
through the ``int4_expert_matmul`` kernel with each expert's filled-row
count, so row tiles past it read no weights. DeepSeek-V3's sigmoid
routing (``route_top_k_v3``) selects with a correction bias over groups of
experts.

Serving under an ``expert`` x ``tensor`` mesh (``mesh=``) runs the
counterpart of the JAX ``_expert_ffn_sharded``: each expert shard runs
gate, up and down over its slice of the dispatch buffer with its slice of
the filled-row counts; raw and int8 experts shard their mlp axis over
``tensor`` and sum the down product's partials; int4 experts are
replicated over ``tensor``. Over a process group the shards' outputs are
all-gathered over ``expert`` and the partials all-reduced over
``tensor``; in one process the expert shard is the outer part of the
expert axis, so every shard's experts run in one call (one
``int4_expert_matmul`` launch a product, the shard the outer part of its
walk) and the partials add over the stacked shard axis. Routing, dispatch
and combine are the same on every shard.

Training differentiates ``moe_mlp`` by autograd, as the JAX package takes
``jax.grad`` of its own: gradients reach the experts through the three
products, the tokens through the gather and the dispatch's ``index_put``
(a dropped assignment, written to the sink row, gets none), and the
router through the combine weights and the two losses. V3's correction
bias only selects, so no gradient path reaches it (``jax.grad`` gives it
an exact zero; the trainer fills one in).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import int4_expert_matmul
from ..parallel.mesh import AXES
from ..parallel.sharding import all_gather, all_reduce

__all__ = ["dispatch_positions", "load_balance_loss", "moe_capacity",
           "moe_mlp", "route_top_k", "route_top_k_v3", "router_z_loss"]


def moe_capacity(n_tokens: int, n_experts: int, k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity: ceil(k·G/X · factor), floor 4."""
    return max(4, int(math.ceil(k * n_tokens / n_experts * capacity_factor)))


def route_top_k(router_logits: torch.Tensor, k: int, norm_topk: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(G, X) f32 logits -> (weights (G, k), expert ids (G, k), probs
    (G, X)): softmax over all experts, then the top k; ``norm_topk``
    renormalizes the k weights to sum to 1 (Mixtral), else they stay the
    raw probabilities."""
    probs = torch.softmax(router_logits, dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, top_idx, probs


def route_top_k_v3(router_logits: torch.Tensor, k: int, *,
                   correction_bias: torch.Tensor, n_group: int,
                   topk_group: int, norm_topk: bool, routed_scaling: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DeepSeek-V3 routing (the JAX ``route_top_k_v3``): sigmoid scores;
    selection adds the aux-free load-balancing correction bias and is
    group-limited (a group scores the sum of its top-2 biased scores; only
    the best ``topk_group`` groups' experts are eligible, the others score
    0); the combine weights are the raw sigmoid scores at the chosen
    experts, renormalized over the k (+1e-20) with ``norm_topk``, times
    ``routed_scaling``. Returns (weights (G, k), ids (G, k), raw scores
    (G, X))."""
    g_tokens, x = router_logits.shape
    scores = torch.sigmoid(router_logits)
    biased = scores + correction_bias[None, :]
    per_group = biased.view(g_tokens, n_group, x // n_group)
    group_scores = torch.topk(per_group, 2, dim=-1).values.sum(dim=-1)
    group_idx = torch.topk(group_scores, topk_group, dim=-1).indices
    group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1.0)
    eligible = group_mask.repeat_interleave(x // n_group, dim=-1)
    choice = torch.where(eligible > 0, biased, 0.0)
    top_idx = torch.topk(choice, k, dim=-1).indices
    top_w = torch.gather(scores, 1, top_idx)
    if norm_topk:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    return top_w * routed_scaling, top_idx, scores


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot over a new last axis, by comparison (no host check of
    the ids, so a capture can hold it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def load_balance_loss(probs: torch.Tensor, top_idx: torch.Tensor,
                      n_experts: int, k: int) -> torch.Tensor:
    """Switch-style aux loss over top-k: X · Σ_x f_x · p_x, f_x the share
    of (token, slot) assignments routed to x divided by k (a uniform router
    scores 1), p_x the mean router probability."""
    f = _one_hot(top_idx, n_experts).float().sum(dim=1).mean(dim=0) / k
    return n_experts * torch.sum(f * probs.mean(dim=0))


def dispatch_positions(top_idx: torch.Tensor, n_experts: int, cap: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, k) expert ids -> (each (token, slot) assignment's position in
    its expert's buffer (G·k,) int32: the running count of earlier
    assignments to the same expert; each expert's filled rows (X,) int32,
    at most ``cap``). The JAX ``moe_mlp``'s integers, from an int32 running
    sum along the assignments of the (X, G·k) one-hot, the contiguous axis
    (a sum down the (G·k, X) int64 one-hot is a strided scan on the card:
    11.06 ms of a Mixtral-8x7B 1024-token chunk on an H100, PERF.md §5)."""
    eid = top_idx.reshape(-1)
    onehot = (torch.arange(n_experts, device=eid.device)[:, None]
              == eid[None, :]).to(torch.int32)                  # (X, G·k)
    running = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = running.gather(0, eid[None, :])[0] - 1
    counts = running[:, -1].clamp(max=cap).contiguous()
    return pos, counts


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """Mean squared logsumexp of the router logits."""
    return torch.logsumexp(router_logits, dim=-1).pow(2).mean()


def _expert_matmul(x: torch.Tensor, w, dtype: torch.dtype,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (X, C, in) @ w (X, in, out) -> (X, C, out) for a raw leaf, an
    int8 ``{"q8", "scale"}`` leaf (scale (X, 1, out) after the product) or
    an int4 ``{"q4", "scale"}`` leaf (the ``int4_expert_matmul`` kernel,
    told each expert's filled rows by ``counts``)."""
    if isinstance(w, dict):
        if "q4" in w:
            return int4_expert_matmul(x.to(dtype), w["q4"], w["scale"],
                                      counts)
        return torch.bmm(x, w["q8"].to(dtype)) * w["scale"].to(dtype)
    return torch.bmm(x, w if w.dtype == dtype else w.to(dtype))


def _is_int4(w) -> bool:
    return isinstance(w, dict) and "q4" in w


def _expert_ffn(buf: torch.Tensor, counts: torch.Tensor, we_gate, we_up,
                we_down, dtype: torch.dtype) -> torch.Tensor:
    """The SwiGLU expert FFN over the dispatch buffer (X, C, E) of the
    experts whose leaves are given, with their filled-row counts."""
    gate = _expert_matmul(buf, we_gate, dtype, counts)
    up = _expert_matmul(buf, we_up, dtype, counts)
    return _expert_matmul(F.silu(gate) * up, we_down, dtype, counts)


def _expert_matmul_shards(x: torch.Tensor, w, dtype: torch.dtype,
                          row: bool) -> torch.Tensor:
    """An in-process tensor mesh's expert product: x (X, C, in) or
    (N, X, C, in) @ a raw or int8 leaf whose shards stack on its leading
    axis, (N, X, in, out/N) split by columns or (N, X, in/N, out) by rows.
    Columns give (N, X, C, out/N), each shard's slice; rows the sum over
    the shards' partials, (X, C, out). An int8 leaf's scale multiplies
    its shard's columns, or the summed rows."""
    q8 = isinstance(w, dict)
    y = torch.matmul(x, (w["q8"] if q8 else w).to(dtype))
    if row:
        y = y.sum(0)
    return y * w["scale"].to(dtype) if q8 else y


def _expert_ffn_sharded(buf: torch.Tensor, counts: torch.Tensor, we_gate,
                        we_up, we_down, *, mesh, dtype: torch.dtype
                        ) -> torch.Tensor:
    """The expert FFN under an expert x tensor mesh (the JAX
    ``_expert_ffn_sharded``; see the module docstring): buf (X, C, E) and
    counts (X,) whole, the leaves as ``parallel.shard_params`` lays them
    out. Returns (X, C, E), every expert's rows."""
    x_experts, ep = buf.shape[0], mesh.expert
    if x_experts % ep:
        raise ValueError(f"expert mesh axis {ep} must divide n_experts "
                         f"{x_experts}")
    split = mesh.tensor > 1 and not _is_int4(we_gate)
    if mesh.in_process:
        if split:
            gate = _expert_matmul_shards(buf, we_gate, dtype, row=False)
            up = _expert_matmul_shards(buf, we_up, dtype, row=False)
            return _expert_matmul_shards(F.silu(gate) * up, we_down, dtype,
                                         row=True)
        # every shard's experts in one call (int4: replicated over tensor,
        # held and computed once)
        return _expert_ffn(buf, counts, we_gate, we_up, we_down, dtype)
    # a rank: its expert shard's slice of the buffer and of the counts
    n = x_experts // ep
    lo = mesh.expert_rank * n
    out = _expert_ffn(buf[lo:lo + n], counts[lo:lo + n], we_gate, we_up,
                      we_down, dtype)
    if split:
        out = all_reduce(out, mesh)    # the down product's partial sums
    if ep > 1:
        out = all_gather(out, 0, mesh, AXES.EXPERT)
    return out


def moe_mlp(h: torch.Tensor, router_w: torch.Tensor, we_gate, we_up,
            we_down, *, n_experts_per_tok: int, capacity_factor: float,
            dtype: torch.dtype, norm_topk: bool = True,
            router_bias: Optional[torch.Tensor] = None,
            router_n_group: int = 0, router_topk_group: int = 0,
            routed_scaling: float = 1.0, with_losses: bool = True,
            mesh=None) -> tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """The SwiGLU expert MLP on normed activations h (..., E): router_w
    (E, X), we_gate/we_up (X, E, M) and we_down (X, M, E) leaves. Routing
    is ``route_top_k``, or with ``router_bias`` (X,) DeepSeek-V3's
    ``route_top_k_v3`` over ``router_n_group`` groups keeping
    ``router_topk_group``, its weights times ``routed_scaling``. Returns
    (y (..., E) in h's dtype, the load-balance aux loss, the router z-loss),
    both unscaled and both 0 under V3 routing (its balance comes from the
    bias, adjusted outside the gradient); with ``with_losses=False``
    (serving) they are None and not computed. ``mesh`` (serving) with an
    ``expert`` or ``tensor`` axis above 1 runs the expert FFN sharded
    (``_expert_ffn_sharded``) over leaves ``parallel.shard_params`` laid
    out; training passes none, as in JAX."""
    e = h.shape[-1]
    x_experts = router_w.shape[-1]
    k = n_experts_per_tok
    ht = h.reshape(-1, e)
    g = ht.shape[0]
    cap = moe_capacity(g, x_experts, k, capacity_factor)
    router_logits = ht.float() @ router_w.float()
    if router_bias is not None:
        top_p, top_idx, probs = route_top_k_v3(
            router_logits, k, correction_bias=router_bias.float(),
            n_group=router_n_group, topk_group=router_topk_group,
            norm_topk=norm_topk, routed_scaling=routed_scaling)
    else:
        top_p, top_idx, probs = route_top_k(router_logits, k, norm_topk)

    # each (token, slot) assignment's position in its expert's buffer, and
    # each expert's filled rows
    pos, counts = dispatch_positions(top_idx, x_experts, cap)
    keep = pos < cap
    slot = torch.where(keep, top_idx.reshape(g * k) * cap + pos,
                       x_experts * cap)     # dropped: the sink row
    buf = torch.zeros((x_experts * cap + 1, e), dtype=h.dtype,
                      device=h.device)
    buf[slot] = ht[:, None].expand(g, k, e).reshape(g * k, e)
    buf = buf[:-1].view(x_experts, cap, e)

    if mesh is not None and (mesh.expert > 1 or mesh.tensor > 1):
        out = _expert_ffn_sharded(buf, counts, we_gate, we_up, we_down,
                                  mesh=mesh, dtype=dtype)
    else:
        out = _expert_ffn(buf, counts, we_gate, we_up, we_down, dtype)

    gathered = out.reshape(x_experts * cap, e)[
        slot.clamp(max=x_experts * cap - 1)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=h.device))
    y = (gathered.view(g, k, e) * top_p.view(g, k, 1).to(h.dtype)).sum(dim=1)
    y = y.reshape(h.shape)
    if not with_losses:
        return y, None, None
    if router_bias is not None:
        zero = torch.zeros((), device=h.device)
        return y, zero, zero
    return (y, load_balance_loss(probs, top_idx, x_experts, k),
            router_z_loss(router_logits))
