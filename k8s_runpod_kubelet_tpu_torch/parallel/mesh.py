"""The port's mesh: the JAX package's axis names and ``MeshConfig``
(``parallel/mesh.py``), and a ``Mesh`` that honours the ``seq`` axis
(ring attention in training), the ``tensor`` axis (tensor-parallel
serving) and the ``expert`` axis beside ``tensor`` (expert-parallel
serving, the JAX serving mesh ``expert`` x ``tensor``). ``seq`` shares a
mesh with neither: the JAX serving meshes have no sequence axis, its
sequence-parallel training meshes no tensor or expert axis.

A JAX mesh lays the axes over the devices of one program; the port has two
counterparts for each axis:

- the in-process mesh (``group=None``): the shards live in one process,
  on the caller's device, as a JAX mesh over the devices of one process
  does. Ring attention then runs every sequence shard's schedule at once
  (``ops/ring_attention.py``); a tensor mesh stacks every shard's weights
  and KV heads and launches each shard's kernels (``parallel/sharding.py``,
  ``models/llama.py``); an expert shard is the outer part of the expert
  axis, which no weight leaves (``models/moe.py``), which is what one card
  can hold;
- the process-group mesh: one shard a process of a ``torch.distributed``
  group (NCCL across cards, gloo on the CPU). Rank r of an ``expert`` x
  ``tensor`` group sits at expert index r // tensor and tensor index
  r % tensor (the JAX mesh's axis order, tensor innermost); its tensor
  collectives run over the ranks of its expert index (``group``), its
  expert collectives over the ranks of its tensor index
  (``expert_group``).

Every other axis above 1 raises, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


class AXES:
    """Canonical mesh axis names (order = outermost to innermost), as the
    JAX package names them."""

    DATA = "data"        # pure data parallel (replicated params)
    FSDP = "fsdp"        # data parallel with sharded params/optimizer
    STAGE = "stage"      # pipeline parallel
    EXPERT = "expert"    # MoE expert parallel
    SEQ = "seq"          # sequence/context parallel (ring attention)
    TENSOR = "tensor"    # tensor (megatron-style) parallel

    ALL = (DATA, FSDP, STAGE, EXPERT, SEQ, TENSOR)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Per-axis parallel degrees. -1 on data means "absorb remaining
    devices"."""

    data: int = -1
    fsdp: int = 1
    stage: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        fixed = self.fsdp * self.stage * self.expert * self.seq * self.tensor
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes product {fixed}")
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh {self} needs {total} devices, have {n_devices}")
        return dataclasses.replace(self, data=data)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.stage, self.expert, self.seq,
                self.tensor)


# the ROADMAP (Queue 1) item that brings each axis the port refuses
_LATER = {
    AXES.DATA: "Queue 1 #7.8 (data parallelism over NCCL, with FSDP)",
    AXES.FSDP: "Queue 1 #7.8 (FSDP/TP over NCCL)",
    AXES.STAGE: "Queue 1 #8 (pipeline stages)",
}


class Mesh:
    """A mesh whose axes above 1 are ``seq`` alone, or ``expert`` and
    ``tensor``: ``seq`` is the number of sequence shards, ``tensor`` of
    tensor-parallel shards, ``expert`` of expert shards; ``rank`` this
    process's index on the ``seq`` or ``tensor`` axis and ``expert_rank``
    on the ``expert`` axis (0 in one process); ``group`` the process group
    of the ``seq`` or ``tensor`` collectives and ``expert_group`` of the
    ``expert`` ones (None: the in-process mesh)."""

    def __init__(self, config: MeshConfig, group: Optional[Any] = None):
        for axis in AXES.ALL:
            size = getattr(config, axis)
            if (axis in (AXES.SEQ, AXES.TENSOR, AXES.EXPERT)
                    or size in (1, -1)):
                continue
            raise ValueError(f"mesh axis {axis!r} = {size} is not ported; "
                             f"it comes with ROADMAP {_LATER[axis]}")
        for axis in (AXES.SEQ, AXES.TENSOR, AXES.EXPERT):
            if getattr(config, axis) < 1:
                raise ValueError(f"{axis} must be at least 1, got "
                                 f"{getattr(config, axis)}")
        if config.seq > 1 and config.expert > 1:
            raise ValueError(f"mesh axis 'expert' = {config.expert} beside "
                             f"seq = {config.seq} is not ported (expert "
                             "parallelism is a serving mesh, expert x "
                             "tensor; sequence shards are a training "
                             "mesh); it comes with ROADMAP Queue 1 #8 "
                             "and #7.8 (MoE training over a mesh)")
        if config.seq > 1 and config.tensor > 1:
            raise ValueError(f"mesh axis 'tensor' = {config.tensor} beside "
                             f"seq = {config.seq} is not ported (a mesh "
                             "shards one axis: serving meshes tensor, "
                             "training meshes seq); it comes with ROADMAP "
                             "Queue 1 #6 and #7.8 (tensor-parallel "
                             "training)")
        self.group = group
        self.expert_group = None
        self.seq = config.seq
        self.tensor = config.tensor
        self.expert = config.expert
        self.rank = 0
        self.expert_rank = 0
        if group is not None:
            import torch.distributed as dist

            size = dist.get_world_size(group)
            if size != self.shards:
                raise ValueError(f"a process group of {size} ranks cannot "
                                 f"hold {self.shards} shards ({self})")
            self.expert_rank, self.rank = divmod(dist.get_rank(group),
                                                 self.tensor * self.seq)
            if self.expert > 1:
                self._subgroups(dist, group)

    def _subgroups(self, dist, group) -> None:
        """The tensor and expert subgroups of an expert x tensor group,
        made by every rank in one order (``new_group`` is collective)."""
        ranks = dist.get_process_group_ranks(group)
        t, e = self.tensor, self.expert
        for i in range(e):
            sub = dist.new_group([ranks[i * t + j] for j in range(t)])
            if i == self.expert_rank:
                self.group = sub
        for j in range(t):
            sub = dist.new_group([ranks[i * t + j] for i in range(e)])
            if j == self.rank:
                self.expert_group = sub

    @property
    def shards(self) -> int:
        """The number of shards over every axis (1 when none is above
        1)."""
        return self.seq * self.tensor * self.expert

    @property
    def in_process(self) -> bool:
        return self.group is None

    def __repr__(self) -> str:
        where = ("in one process" if self.in_process
                 else f"rank {self.rank} of a process group")
        axes = f"seq={self.seq}, tensor={self.tensor}"
        if self.expert > 1:
            axes += f", expert={self.expert}"
            if not self.in_process:
                where = (f"tensor rank {self.rank}, expert rank "
                         f"{self.expert_rank} of a process group")
        return f"Mesh({axes}, {where})"


def make_mesh(config: MeshConfig, group: Optional[Any] = None) -> Mesh:
    """The port's ``make_mesh``: a ``Mesh`` over one process (``group``
    None) or over a ``torch.distributed`` process group, one sequence
    shard, or one (expert, tensor) shard, a rank."""
    return Mesh(config, group)
