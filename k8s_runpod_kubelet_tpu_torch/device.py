"""Device resolution for the port's entry points.

Every entry point (``LlamaModel``, ``init_params``, ``ServingEngine``, the
serve CLI) defaults to ``cuda``. A caller that wants the CPU says so
(``device="cpu"``, as the tests do); a CUDA request on a machine without a
card raises rather than quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises RuntimeError for a CUDA device when
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
