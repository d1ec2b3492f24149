"""Tensor-parallel placement of a serving tree: the port's own copy of the
JAX package's logical-axis rules (``parallel/sharding.py``
``LOGICAL_RULES``) and of ``models/llama.py``'s ``_layer_axes`` and
``param_logical_axes``, and ``shard_params``, which lays a tree out over a
mesh's ``tensor`` axis as those rules place it.

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
weight) stay as they are. ``all_gather`` and ``all_reduce`` are the
collectives the process-group form runs between the shards.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .mesh import AXES

Params = dict[str, Any]

# logical axis -> mesh axis (None: replicated): the JAX package's table.
# Serving meshes are tensor-only, so of the mesh axes only ``tensor`` is
# honoured here: heads, kv_heads, mlp and vocab shard over it, and every
# int4-packed weight shards its out axis (``int4_out``) with the packed
# contraction replicated.
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
    attention and a dense MLP. DeepSeek-MoE, MLA and MoE raise, naming
    their fields and ROADMAP items."""
    if tensor <= 1:
        return
    deepseek = cfg.deepseek_fields
    if deepseek:
        raise ValueError(f"{cfg.name}: DeepSeek-MoE ({deepseek}) under "
                         "tensor parallelism is not ported (ROADMAP Queue 1 "
                         "#6 and #9 for its latent attention, #8 for expert "
                         "parallelism)")
    if cfg.is_mla:
        raise ValueError(f"{cfg.name}: MLA under tensor parallelism is not "
                         "ported (ROADMAP Queue 1 #9)")
    if cfg.n_experts:
        raise ValueError(f"{cfg.name}: MoE under tensor parallelism is not "
                         "ported (ROADMAP Queue 1 #8, expert parallelism)")


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
    """``params`` laid out over ``mesh``'s ``tensor`` axis (see the module
    docstring), IN PLACE: each leaf of the given tree is replaced by its
    shards as soon as they exist, so the source leaf is freed at once when
    the caller holds no other reference and the peak stays about one leaf
    above the weights (8B bf16 weights are 16 GB). Returns the same dict.
    A mesh with ``tensor`` 1 leaves the tree as it is."""
    if mesh is None or mesh.tensor == 1:
        return params
    check_tensor_parallel(cfg, mesh.tensor)
    axes = _tree_axes(cfg, params)

    def split(t: torch.Tensor, ax) -> torch.Tensor:
        axis = tensor_axis(ax)
        if axis is None:
            return t
        return _split(t, axis, 1 if ax[0] == "layer" else 0, mesh)

    def place(tree: dict, tree_axes: dict, name: str) -> None:
        leaf, ax = tree[name], tree_axes[name]
        # a quantized leaf becomes a new dict: the given one may be shared
        # (quantize_params keeps a leaf already quantized as it is)
        tree[name] = ({k: split(v, ax[k]) for k, v in leaf.items()}
                      if isinstance(leaf, dict) else split(leaf, ax))

    for name in list(params):
        if name == "layers":
            for lname in list(params["layers"]):
                place(params["layers"], axes["layers"], lname)
        else:
            place(params, axes, name)
    return params


def all_gather(local: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The ranks' ``local`` tensors concatenated along ``dim`` in rank
    order (a process-group mesh)."""
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(mesh.tensor)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def all_reduce(partial: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the ranks' ``partial`` tensors (a process-group mesh)."""
    import torch.distributed as dist

    partial = partial.contiguous()
    dist.all_reduce(partial, group=mesh.group)
    return partial
