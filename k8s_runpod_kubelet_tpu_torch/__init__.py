"""PyTorch/CUDA port of the serving path of ``k8s_runpod_kubelet_tpu``.

The JAX package stays the reference; this package serves the same dense
Llama-family models through the same paged loop on an NVIDIA H100, with
hand-written kernels for the two Pallas kernels on that path
(``ops/attention.py`` paged multi-token attention in CUDA C++,
``ops/rmsnorm.py`` in Triton). It imports ``torch`` and never ``jax`` or
anything of the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of continuing on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
