"""Training-data input pipeline: the native C++ loader and its pure-Python
twin (the port's own copy of the JAX package's ``data/loader.py``).

``NativeTokenLoader`` binds the repository's ``native/tokenloader.cc``
through ctypes, built with g++ at first use (never at import) into the
port's build directory ``_build/`` (gitignored), named by a hash of the
source and the flags. Both loaders yield the identical deterministic
batch stream for a (seed, seq_len, batch, shard, start_batch) tuple: the
native one from background threads through a reorder buffer, the Python
one inline; the JAX package's loaders yield the same stream.

Data format: raw little-endian int32 tokens on disk (a pre-tokenized
corpus). ``path=None`` gives the synthetic xorshift stream: infinite,
seeded, no disk. Each process opens its own (shard_id, num_shards)
loader over a disjoint window range; ``start_batch`` seeks the stream
past what a resumed run already consumed.

``device_batches`` hands the trainer each batch on its device, moved to
the card from pinned memory.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parents[2] / "native" / "tokenloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_build_lock = threading.Lock()
_lib_handle = None
_MASK64 = (1 << 64) - 1


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtokenloader-{digest[:16]}.so"


def _build_native() -> Optional[Path]:
    """The loader's shared library, compiled with g++ if missing; None
    without a toolchain or a source (callers take the Python loader)."""
    if not SRC.is_file():
        return None
    out = _target()
    if out.exists():
        return out
    with _build_lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{os.getpid()}.{out.name}")
        cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)   # a concurrent build sees old or new
        except (OSError, subprocess.SubprocessError) as exc:
            log.warning("native tokenloader build failed (%s); "
                        "using the Python loader", exc)
            tmp.unlink(missing_ok=True)
            return None
    return out


def _native_lib():
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    path = _build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        # a truncated or stale library: drop it so a later call rebuilds
        log.warning("%s unloadable (%s); using the Python loader", path, exc)
        path.unlink(missing_ok=True)
        return None
    lib.tl_open.restype = ctypes.c_void_p
    lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_uint64]
    lib.tl_next.restype = ctypes.c_int32
    lib.tl_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int32)]
    lib.tl_num_tokens.restype = ctypes.c_int64
    lib.tl_num_tokens.argtypes = [ctypes.c_void_p]
    lib.tl_batches_per_epoch.restype = ctypes.c_int64
    lib.tl_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.tl_close.restype = None
    lib.tl_close.argtypes = [ctypes.c_void_p]
    _lib_handle = lib
    return lib


def native_available() -> bool:
    return _native_lib() is not None


class NativeTokenLoader:
    """Background-threaded batch producer over the C++ loader."""

    def __init__(self, path: Optional[str], seq_len: int, batch_size: int,
                 seed: int = 0, vocab_size: int = 32768, threads: int = 2,
                 capacity: int = 8, shard_id: int = 0, num_shards: int = 1,
                 start_batch: int = 0):
        lib = _native_lib()
        if lib is None:
            raise RuntimeError("native tokenloader unavailable (no g++?)")
        self._lib = lib
        self.seq_len = seq_len
        self.batch_size = batch_size
        # the range guard applies to file corpora only: the synthetic
        # stream emits `s % vocab`, in range by construction
        self._check_range = bool(path)
        self._vocab_size = vocab_size
        self._h = lib.tl_open(path.encode() if path else None, seq_len,
                              batch_size, seed & _MASK64, threads, capacity,
                              vocab_size, shard_id, num_shards, start_batch)
        if not self._h:
            raise ValueError(
                f"tl_open failed: path={path!r} seq_len={seq_len} "
                f"batch={batch_size} shard={shard_id}/{num_shards} "
                "(missing/short file, or shard smaller than one batch?)")
        # a loader dropped without close() still stops its threads
        self._finalizer = weakref.finalize(self, lib.tl_close, self._h)

    @property
    def num_tokens(self) -> int:
        return self._lib.tl_num_tokens(self._h)

    @property
    def batches_per_epoch(self) -> int:
        return self._lib.tl_batches_per_epoch(self._h)

    def next(self) -> np.ndarray:
        out = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        rc = self._lib.tl_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError("tokenloader stopped")
        if self._check_range:
            _check_token_range(out, self._vocab_size)
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def close(self):
        if self._h:
            self._finalizer.detach()
            self._lib.tl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _check_token_range(batch: np.ndarray, vocab_size: int):
    """A corpus tokenized with a bigger-vocab tokenizer must fail loudly,
    not train on out-of-range embedding rows."""
    lo, hi = int(batch.min()), int(batch.max())
    if lo < 0 or hi >= vocab_size:
        raise ValueError(
            f"corpus token id range [{lo}, {hi}] outside model vocab "
            f"[0, {vocab_size}) — wrong tokenizer for this model?")


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class PyTokenLoader:
    """Pure-Python twin of NativeTokenLoader: the bit-identical stream."""

    def __init__(self, path: Optional[str], seq_len: int, batch_size: int,
                 seed: int = 0, vocab_size: int = 32768, threads: int = 0,
                 capacity: int = 0, shard_id: int = 0, num_shards: int = 1,
                 start_batch: int = 0):
        del threads, capacity  # the native loader's signature
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.seq_len, self.batch_size = seq_len, batch_size
        self.seed = seed & _MASK64
        self.vocab_size, self.shard_id = vocab_size, shard_id
        self._tokens: Optional[np.ndarray] = None
        if path:
            # memmap: multi-GB corpora page in lazily, as the native mmap
            self._tokens = np.memmap(path, np.int32, mode="r")
            if self._tokens.size < seq_len + 1:
                raise ValueError(f"{path}: fewer than seq_len+1 tokens")
            total_windows = (self._tokens.size - 1) // seq_len
        else:
            total_windows = 1 << 40
        self._shard_windows = (total_windows // num_shards
                               if num_shards > 1 else total_windows)
        if self._shard_windows < batch_size:
            raise ValueError(f"shard has {self._shard_windows} windows < "
                             f"batch {batch_size}")
        self._i = start_batch

    @property
    def num_tokens(self) -> int:
        return (self._shard_windows * self.seq_len
                if self._tokens is not None else -1)

    @property
    def batches_per_epoch(self) -> int:
        return self._shard_windows // self.batch_size

    def _window_for(self, gs: int) -> int:
        # the cycle-walked affine bijection of tokenloader.cc's WindowFor
        n = self._shard_windows
        m = 1
        while m < n:
            m <<= 1
        epoch, i = divmod(gs, n)
        sh = (self.shard_id * 0x9E3779B97F4A7C15) & _MASK64
        a = _splitmix64(self.seed ^ ((epoch * 2654435761) & _MASK64) ^ sh) | 1
        b = _splitmix64((self.seed + epoch + 0x51ED270B + sh) & _MASK64)
        w = i
        while True:
            w = ((a * w + b) & _MASK64) & (m - 1)
            if w < n:
                break
        return w + self.shard_id * self._shard_windows

    def _fill(self, gs: int, dst: np.ndarray):
        span = self.seq_len + 1
        if self._tokens is not None:
            w = self._window_for(gs)
            dst[:] = self._tokens[w * self.seq_len: w * self.seq_len + span]
        else:
            s = _splitmix64(self.seed ^ ((gs * 0x9E3779B9) & _MASK64)
                            ^ ((self.shard_id << 48) & _MASK64))
            for t in range(span):
                s = (s ^ (s << 13)) & _MASK64
                s ^= s >> 7
                s = (s ^ (s << 17)) & _MASK64
                dst[t] = s % self.vocab_size  # vocab < 2^31: fits int32

    def next(self) -> np.ndarray:
        out = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        for s in range(self.batch_size):
            self._fill(self._i * self.batch_size + s, out[s])
        self._i += 1
        if self._tokens is not None:
            _check_token_range(out, self.vocab_size)
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_loader(path: Optional[str], seq_len: int, batch_size: int, **kw):
    """The native loader if it builds, else the Python one: the same
    stream either way."""
    if native_available():
        return NativeTokenLoader(path, seq_len, batch_size, **kw)
    return PyTokenLoader(path, seq_len, batch_size, **kw)


def device_batches(loader, device=None) -> Iterator[torch.Tensor]:
    """A loader's batches as int32 tensors on ``device`` (default
    ``cuda``; raises without a card): on the card each batch is copied
    into pinned memory and moved without blocking the host. One
    process; the port trains over no process group yet."""
    dev = resolve_device(device)
    for batch in loader:
        t = torch.from_numpy(batch)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        yield t
