"""The port stands alone: no JAX and nothing of the JAX package, kernels
that exist as CUDA sources with launch counters, and entry points that run
on the card unless the caller asks for the CPU."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels import _build, conv2d, lrn, matmul, pooling
from repro_torch.models.alexnet import AlexNet

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
_BANNED = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports():
    offending = [
        (str(p.relative_to(REPO)), m) for p in _port_files()
        for m in _imported_modules(p)
        if m.split(".")[0] in _BANNED]
    assert not offending, offending


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch.")]
    assert "repro_torch.models.alexnet" in modules
    code = ("import importlib, sys\n"
            "for banned in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[banned] = None\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


def test_alexnet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlexNet()
    assert AlexNet(device="cpu").plan.network == "alexnet-full"


@pytest.mark.parametrize("module,wrapper,entry", [
    (matmul, "matmul_cuda", "repro_matmul"),
    (conv2d, "conv2d_cuda", "repro_conv2d"),
    (pooling, "pool_cuda", "repro_pool"),
    (lrn, "lrn_cuda", "repro_lrn"),
])
def test_every_kernel_wrapper_has_a_source_and_a_counter(module, wrapper,
                                                         entry):
    src = _build.CSRC / module.SOURCE
    text = src.read_text(encoding="utf-8")
    assert f'extern "C" int {entry}(' in text
    assert "Replaces: src/repro/kernels/" in text     # the note on its origin
    assert "What bounds it on the H100" in text
    assert isinstance(getattr(module, wrapper).launches, int)
    assert f'"{entry}"' in Path(module.__file__).read_text(encoding="utf-8")


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == REPO / "build" / "repro_torch_kernels"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
