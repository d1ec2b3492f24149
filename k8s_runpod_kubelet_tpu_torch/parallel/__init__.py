"""Meshes of the port: the axis names and degrees of the JAX package's
``parallel/mesh.py``, the ``Mesh`` the model, trainer and engine take (the
``seq`` axis for ring attention, the ``tensor`` axis for tensor-parallel
serving), and the rules that place a serving tree over ``tensor``
(``parallel/sharding.py``)."""

from .mesh import AXES, Mesh, MeshConfig, make_mesh
from .sharding import (LOGICAL_RULES, param_logical_axes, shard_params,
                       tensor_axis)

__all__ = ["AXES", "LOGICAL_RULES", "Mesh", "MeshConfig", "make_mesh",
           "param_logical_axes", "shard_params", "tensor_axis"]
