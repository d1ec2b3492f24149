"""Build and bind the package's CUDA C++ kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``: no PyTorch headers,
so a build takes seconds. Libraries land in ``_build/`` beside the
package (listed in ``.gitignore``), named by a hash of the source and the
flags (and of the shared ``csrc/*.cuh`` headers), so an edited source
rebuilds and an unchanged one is reused.
Nothing here runs at import: a kernel's first launch builds its source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()                    # guards _locks
_locks: dict[str, threading.Lock] = {}      # one per source: builds of
_libs: dict[str, ctypes.CDLL] = {}          # different sources overlap
# ptxas register/spill report of each build, by source name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build on the card's "
                           "machine only")
    return found


def _target(name: str) -> Path:
    # the source and every shared header it may include
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed. Sources build concurrently when loaded from several threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                _build(name, out)
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def _build(name: str, out: Path) -> None:
    """One nvcc build into a temporary name, renamed into place once it
    succeeded (a concurrent process never loads a half-written file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{os.getpid()}.{out.name}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)


def check(code: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` (or the kernels' own codes)
    returned by a C launcher."""
    if code != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {code}")
