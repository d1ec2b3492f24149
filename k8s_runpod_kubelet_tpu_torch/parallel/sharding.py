"""Tensor- and expert-parallel placement of a serving tree: the port's own
copy of the JAX package's logical-axis rules (``parallel/sharding.py``
``LOGICAL_RULES``) and of ``models/llama.py``'s ``_layer_axes`` and
``param_logical_axes``, and ``shard_params``, which lays a tree out over a
mesh's ``tensor`` and ``expert`` axes as those rules place it.

Under JAX a leaf whose logical axis maps to ``tensor`` is one array sharded
over the mesh's devices. The port holds the shards itself:

- in one process (``mesh.group`` None), a split leaf becomes one tensor
  that stacks every shard's slice on a shard axis, inserted right after
  the layer axis of a stacked leaf (first for the embedding and the LM
  head): a column-split (L, in, out) leaf becomes (L, N, in, out/N), a
  row-split one (L, N, in/N, out). Each (layer, shard) slice is
  contiguous, as the slice a rank of an N-way deployment holds;
- over a process group, a split leaf becomes the rank's own slice.

Replicated leaves (the norms, an int8 leaf's scales of a row-split
weight, int4 expert leaves over ``tensor``) stay as they are: held and
computed once in one process. The ``expert`` axis of the expert weights
(``we_*``) is, in one process, left whole: expert shard e is the outer
part of it, experts e X/ep onwards, so no byte moves; over a process
group each rank keeps its expert shard's X/ep experts. The router and
V3's correction bias keep every expert on every shard (the routing reads
every expert's logit). ``all_gather`` and ``all_reduce`` are the
collectives the process-group form runs between the shards.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .mesh import AXES

Params = dict[str, Any]

# logical axis -> mesh axis (None: replicated): the JAX package's table.
# Serving meshes are expert x tensor, so of the mesh axes ``tensor`` and
# ``expert`` are honoured here: heads, kv_heads, mlp and vocab shard over
# tensor, every int4-packed weight shards its out axis (``int4_out``) with
# the packed contraction replicated (int4 expert leaves excepted:
# ``models/quant.quantized_logical_axes`` gives them the expert axis only),
# and the expert weights' leading axis shards over expert.
LOGICAL_RULES: dict[str, object] = {
    "batch": (AXES.DATA, AXES.FSDP),
    "seq": AXES.SEQ,
    "act_embed": None,
    "act_mlp": AXES.TENSOR,
    "act_heads": AXES.TENSOR,
    "act_vocab": AXES.TENSOR,
    "embed": AXES.FSDP,
    "mlp": AXES.TENSOR,
    "heads": AXES.TENSOR,
    "kv_heads": AXES.TENSOR,
    "qkv": None,
    "head_dim": None,
    "latent": None,
    "int4_out": AXES.TENSOR,
    "vocab": AXES.TENSOR,
    "expert": AXES.EXPERT,
    "stage": AXES.STAGE,
    "norm": None,
    "layer": AXES.STAGE,
}


def layer_axes(cfg) -> dict:
    """Logical axes of one stacked layer's leaves (the JAX ``_layer_axes``
    for the fields the port has: dense attention with its q/k norms and
    q/k/v biases, or MLA; a dense or sparse MoE MLP)."""
    if cfg.is_mla:
        if cfg.mla_q_lora_rank is not None:
            q_axes = {"w_qa": ("layer", "embed", "latent"),
                      "q_a_norm": ("layer", "norm"),
                      "w_qb": ("layer", "latent", "heads")}
        else:
            q_axes = {"wq": ("layer", "embed", "heads")}
        layer = {"attn_norm": ("layer", "norm"), **q_axes,
                 "w_dkv": ("layer", "embed", "latent"),
                 "c_norm": ("layer", "norm"),
                 "w_uk": ("layer", "latent", "heads"),
                 "w_uv": ("layer", "latent", "heads"),
                 "wo": ("layer", "heads", "embed"),
                 "mlp_norm": ("layer", "norm")}
    else:
        layer = {"attn_norm": ("layer", "norm"),
                 "wq": ("layer", "embed", "heads"),
                 "wk": ("layer", "embed", "kv_heads"),
                 "wv": ("layer", "embed", "kv_heads"),
                 "wo": ("layer", "heads", "embed"),
                 "mlp_norm": ("layer", "norm")}
    if cfg.qk_norm:
        layer.update({"q_norm": ("layer", "norm"),
                      "k_norm": ("layer", "norm")})
    if cfg.post_norms:
        layer.update({"attn_post_norm": ("layer", "norm"),
                      "mlp_post_norm": ("layer", "norm")})
    if cfg.qkv_bias:
        layer.update({"wq_b": ("layer", "heads"),
                      "wk_b": ("layer", "kv_heads"),
                      "wv_b": ("layer", "kv_heads")})
    if cfg.n_experts:
        layer.update({"router": ("layer", "embed", "expert"),
                      "we_gate": ("layer", "expert", "embed", "mlp"),
                      "we_up": ("layer", "expert", "embed", "mlp"),
                      "we_down": ("layer", "expert", "mlp", "embed")})
        if cfg.router_sigmoid_bias:
            layer["router_bias"] = ("layer", "expert")
        if cfg.n_shared_experts:
            layer.update({"ws_gate": ("layer", "embed", "mlp"),
                          "ws_up": ("layer", "embed", "mlp"),
                          "ws_down": ("layer", "mlp", "embed")})
    else:
        layer.update({"w_gate": ("layer", "embed", "mlp"),
                      "w_up": ("layer", "embed", "mlp"),
                      "w_down": ("layer", "mlp", "embed")})
    return layer


def param_logical_axes(cfg) -> Params:
    """The tree of logical-axis tuples matching ``init_params`` (the JAX
    ``param_logical_axes``)."""
    tree: Params = {"tok_embed": ("vocab", "embed"),
                    "final_norm": ("norm",),
                    "layers": layer_axes(cfg.main_cfg())}
    if cfg.n_dense_prefix:
        tree["prefix_layers"] = layer_axes(cfg.prefix_cfg())
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    return tree


def tensor_axis(axes) -> Optional[int]:
    """The index of the axis that ``LOGICAL_RULES`` places on ``tensor``,
    or None for a replicated leaf."""
    for i, name in enumerate(axes):
        if name is not None and LOGICAL_RULES.get(name) == AXES.TENSOR:
            return i
    return None


def check_tensor_parallel(cfg, tensor: int) -> None:
    """The configurations the port serves at ``tensor`` > 1: dense
    attention over a dense MLP or a sparse MoE MLP (raw and int8 experts
    shard their mlp axis, int4 experts are replicated). DeepSeek-MoE and
    MLA raise, naming their fields and ROADMAP item."""
    if tensor <= 1:
        return
    deepseek = cfg.deepseek_fields
    if deepseek:
        raise ValueError(f"{cfg.name}: DeepSeek-MoE ({deepseek}) under "
                         "tensor parallelism is not ported (ROADMAP Queue 1 "
                         "#9, with its latent attention); it serves expert-"
                         "parallel at tensor 1")
    if cfg.is_mla:
        raise ValueError(f"{cfg.name}: MLA under tensor parallelism is not "
                         "ported (ROADMAP Queue 1 #9)")


def check_expert_parallel(cfg, expert: int) -> None:
    """An ``expert`` degree above 1 needs a sparse-MoE model whose expert
    count it divides (the JAX ``_expert_ffn_sharded``'s words)."""
    if expert <= 1:
        return
    if not cfg.n_experts or cfg.n_experts % expert:
        raise ValueError(f"expert mesh axis {expert} must divide n_experts "
                         f"{cfg.n_experts} ({cfg.name}: an MoE model whose "
                         "expert count the degree divides)")


# expert-axis leaves held whole on every expert shard: the routing needs
# every expert's logit (under JAX, GSPMD gathers the sharded router)
_WHOLE_OVER_EXPERT = ("router", "router_bias")


def expert_axis(name: str, axes) -> Optional[int]:
    """The index of a leaf's ``expert`` axis that the expert shards split
    (the expert weights'), or None."""
    if name in _WHOLE_OVER_EXPERT or "expert" not in axes:
        return None
    return list(axes).index("expert")


def _tree_axes(cfg, params: Params) -> Params:
    """Logical axes of ``params`` as it is: base axes for raw leaves,
    ``quantized_logical_axes`` for a quantized tree."""
    from ..models.quant import quantized_logical_axes

    kinds = {k for w in params["layers"].values() if isinstance(w, dict)
             for k in w}
    if "q4" in kinds:
        return quantized_logical_axes(cfg, bits=4)
    if "q8" in kinds:
        return quantized_logical_axes(cfg, bits=8)
    return param_logical_axes(cfg)


def _expert_shard(t: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    """Over a process group, this rank's expert shard of ``axis``: experts
    expert_rank X/ep onwards (in one process the axis stays whole)."""
    size = t.shape[axis] // mesh.expert
    return t.narrow(axis, mesh.expert_rank * size, size).contiguous()


def _split(t: torch.Tensor, axis: int, lead: int, mesh) -> torch.Tensor:
    """One leaf's shards: in one process every shard's slice of ``axis``,
    stacked on a new axis at ``lead`` and made contiguous; over a process
    group the rank's slice."""
    n = mesh.tensor
    size = t.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of a {tuple(t.shape)} leaf does not "
                         f"split into {n} shards")
    if not mesh.in_process:
        return t.narrow(axis, mesh.rank * (size // n), size // n).contiguous()
    t = t.unflatten(axis, (n, size // n))
    return t.movedim(axis, lead).contiguous()


def shard_params(cfg, params: Params, mesh) -> Params:
    """``params`` laid out over ``mesh``'s ``tensor`` and ``expert`` axes
    (see the module docstring), IN PLACE: each leaf of the given tree is
    replaced by its shards as soon as they exist, so the source leaf is
    freed at once when the caller holds no other reference and the peak
    stays about one leaf above the weights (8B bf16 weights are 16 GB).
    Returns the same dict. A mesh with ``tensor`` and ``expert`` 1, or an
    in-process one with ``tensor`` 1, leaves the tree as it is."""
    if mesh is None:
        return params
    check_tensor_parallel(cfg, mesh.tensor)
    check_expert_parallel(cfg, mesh.expert)
    if mesh.tensor == 1 and (mesh.expert == 1 or mesh.in_process):
        return params
    axes = _tree_axes(cfg, params)

    def split(t: torch.Tensor, ax, name: str) -> torch.Tensor:
        e_axis = expert_axis(name, ax)
        if e_axis is not None and not mesh.in_process and mesh.expert > 1:
            t = _expert_shard(t, e_axis, mesh)
        axis = tensor_axis(ax) if mesh.tensor > 1 else None
        if axis is None:
            return t
        return _split(t, axis, 1 if ax[0] == "layer" else 0, mesh)

    def place(tree: dict, tree_axes: dict, name: str) -> None:
        leaf, ax = tree[name], tree_axes[name]
        # a quantized leaf becomes a new dict: the given one may be shared
        # (quantize_params keeps a leaf already quantized as it is)
        tree[name] = ({k: split(v, ax[k], name) for k, v in leaf.items()}
                      if isinstance(leaf, dict) else split(leaf, ax, name))

    for name in list(params):
        if name == "layers":
            for lname in list(params["layers"]):
                place(params["layers"], axes["layers"], lname)
        else:
            place(params, axes, name)
    return params


def all_gather(local: torch.Tensor, dim: int, mesh,
               axis: str = AXES.TENSOR) -> torch.Tensor:
    """The ranks' ``local`` tensors concatenated along ``dim`` in rank
    order over the mesh's ``axis`` (``tensor`` or ``expert``; a
    process-group mesh)."""
    import torch.distributed as dist

    expert = axis == AXES.EXPERT
    parts = [torch.empty_like(local)
             for _ in range(mesh.expert if expert else mesh.tensor)]
    dist.all_gather(parts, local.contiguous(),
                    group=mesh.expert_group if expert else mesh.group)
    return torch.cat(parts, dim=dim)


def all_reduce(partial: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the ``tensor`` ranks' ``partial`` tensors (a
    process-group mesh)."""
    import torch.distributed as dist

    partial = partial.contiguous()
    dist.all_reduce(partial, group=mesh.group)
    return partial
