"""The port's mesh: the JAX package's axis names and ``MeshConfig``
(``parallel/mesh.py``), and a ``Mesh`` that honours the ``seq`` axis
(ring attention in training) and the ``tensor`` axis (tensor-parallel
serving), never both above 1 in one mesh: the JAX serving meshes are
tensor-only, its sequence-parallel training meshes have no tensor axis.

A JAX mesh lays the axes over the devices of one program; the port has two
counterparts for either axis:

- the in-process mesh (``group=None``): the n shards live in one process,
  on the caller's device, as a JAX mesh over the devices of one process
  does. Ring attention then runs every sequence shard's schedule at once
  (``ops/ring_attention.py``); a tensor mesh stacks every shard's weights
  and KV heads and launches each shard's kernels (``parallel/sharding.py``,
  ``models/llama.py``), which is what one card can hold;
- the process-group mesh: one shard a process of a ``torch.distributed``
  group (NCCL across cards, gloo on the CPU), the rank's index on the
  mesh's axis being its rank in the group.

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
    AXES.EXPERT: "Queue 1 #8 (expert parallelism)",
    AXES.STAGE: "Queue 1 #8 (pipeline stages)",
}


class Mesh:
    """A mesh whose only axes above 1 are ``seq`` or ``tensor`` (one of
    them): ``seq`` is the number of sequence shards, ``tensor`` the number
    of tensor-parallel shards, ``rank`` this process's index on the axis
    above 1 (0 in one process), ``group`` the process group (None: the
    in-process mesh)."""

    def __init__(self, config: MeshConfig, group: Optional[Any] = None):
        for axis in AXES.ALL:
            size = getattr(config, axis)
            if axis in (AXES.SEQ, AXES.TENSOR) or size in (1, -1):
                continue
            raise ValueError(f"mesh axis {axis!r} = {size} is not ported; "
                             f"it comes with ROADMAP {_LATER[axis]}")
        for axis in (AXES.SEQ, AXES.TENSOR):
            if getattr(config, axis) < 1:
                raise ValueError(f"{axis} must be at least 1, got "
                                 f"{getattr(config, axis)}")
        if config.seq > 1 and config.tensor > 1:
            raise ValueError(f"mesh axis 'tensor' = {config.tensor} beside "
                             f"seq = {config.seq} is not ported (a mesh "
                             "shards one axis: serving meshes tensor, "
                             "training meshes seq); it comes with ROADMAP "
                             "Queue 1 #6 and #7.8 (tensor-parallel "
                             "training)")
        self.group = group
        self.seq = config.seq
        self.tensor = config.tensor
        self.rank = 0
        if group is not None:
            import torch.distributed as dist

            size = dist.get_world_size(group)
            if size != self.shards:
                raise ValueError(f"a process group of {size} ranks cannot "
                                 f"hold {self.shards} shards ({self})")
            self.rank = dist.get_rank(group)

    @property
    def shards(self) -> int:
        """The degree of the mesh's one axis above 1 (1 when none is)."""
        return self.seq * self.tensor

    @property
    def in_process(self) -> bool:
        return self.group is None

    def __repr__(self) -> str:
        where = ("in one process" if self.in_process
                 else f"rank {self.rank} of a process group")
        return f"Mesh(seq={self.seq}, tensor={self.tensor}, {where})"


def make_mesh(config: MeshConfig, group: Optional[Any] = None) -> Mesh:
    """The port's ``make_mesh``: a ``Mesh`` over one process (``group``
    None) or over a ``torch.distributed`` process group, one sequence or
    tensor shard a rank."""
    return Mesh(config, group)
