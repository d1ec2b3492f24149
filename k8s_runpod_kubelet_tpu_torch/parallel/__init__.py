"""Meshes of the port: the axis names and degrees of the JAX package's
``parallel/mesh.py``, and the ``Mesh`` the model and trainer take. Only
the ``seq`` axis (ring attention) is honoured so far."""

from .mesh import AXES, Mesh, MeshConfig, make_mesh

__all__ = ["AXES", "Mesh", "MeshConfig", "make_mesh"]
