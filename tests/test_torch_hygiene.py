"""The port stands alone: it imports ``torch`` and never ``jax``, nothing
of the JAX package, and builds nothing when it is imported.

- a fresh interpreter imports every module of the port and finds no
  ``jax``, no ``triton`` and no JAX-package module in ``sys.modules``;
- an AST scan finds no import of ``k8s_runpod_kubelet_tpu`` (or jax) in
  any file of the port or in ``chip_smoke.py``;
- every CUDA source the build compiles carries its note (the TPU kernel it
  replaces, what bounds it, what its design does about that) and the
  ``sm_90a`` target stays in the build flags.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "k8s_runpod_kubelet_tpu_torch"
JAX_PKG = "k8s_runpod_kubelet_tpu"


def _modules() -> list[str]:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax_and_no_triton():
    mods = _modules()
    assert len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'triton'))\n"
        f"             or m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r}))\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", JAX_PKG), \
            f"{path.name} imports {name}"


def test_cuda_sources_carry_their_note_and_build_for_sm90a():
    from k8s_runpod_kubelet_tpu_torch.ops import _cuda
    sources = sorted((PKG / "csrc").glob("*.cu"))
    assert {"paged_attention_multi.cu", "paged_attention_multi_quant.cu",
            "int4_matmul.cu", "flash_attention.cu"} <= {s.name
                                                        for s in sources}
    for src in sources:
        head = src.read_text()[:4000]
        assert "Replaces:" in head and "k8s_runpod_kubelet_tpu/" in head
        assert "bounds it" in head and "Design" in head
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
