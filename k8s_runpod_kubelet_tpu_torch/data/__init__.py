"""Input pipeline: the native (C++) and Python token-batch loaders."""

from .loader import (NativeTokenLoader, PyTokenLoader, device_batches,
                     make_loader, native_available)

__all__ = ["NativeTokenLoader", "PyTokenLoader", "device_batches",
           "make_loader", "native_available"]
