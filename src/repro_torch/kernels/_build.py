"""Build the CUDA sources in ``csrc/`` and call into them.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads.  The library
is kept under ``build/repro_torch_kernels/`` in the checkout, named by a hash
of the sources and flags, so a later process that finds it skips the build.
A failed build raises with nvcc's messages.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# dtype codes the C entry points take
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda), the
    lookup torch.utils.cpp_extension uses."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        if (home / "bin" / "nvcc").is_file():
            nvcc = str(home / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under CUDA_HOME")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library; return its path."""
    lib = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if lib.is_file():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, _, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {src.name} (exit {proc.returncode})\n"
                              f"{out}{err}")
        if failed:
            raise RuntimeError("nvcc failed to compile the kernels:\n"
                               + "\n".join(failed))
        linked = tmp / lib.name
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(linked),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernels:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(linked, lib)     # atomic: a racing build sees all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.repro_error_string.argtypes = (INT,)
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _function(name: str, argtypes: tuple):
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = INT
    return fn


def launch(name: str, argtypes: tuple, *args) -> None:
    """Call C entry point ``name``; raise if it reports a CUDA error."""
    rc = _function(name, argtypes)(*args)
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device`` (the raw handle, as
    Triton's launcher reads it: a Stream object costs microseconds)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_SAME_DEVICE = contextlib.nullcontext()


def device_scope(device: torch.device):
    """``torch.cuda.device(device)``, or a no-op context when ``device`` is
    already current (the usual case; entering the former costs a few
    microseconds per launch)."""
    if device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def check_cuda(name: str, *tensors: Optional[torch.Tensor]) -> torch.device:
    """Raise unless every tensor given is a contiguous CUDA tensor of one
    dtype in ``DTYPES`` on one device; ``None`` entries are skipped."""
    given = [t for t in tensors if t is not None]
    first = given[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{first.device} (CPU tensors go through ops.{name})")
    for t in given:
        if t.device != first.device:
            raise ValueError(f"{name}: operands on {first.device} and "
                             f"{t.device}")
        if t.dtype != first.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{name}: dtypes {[g.dtype for g in given]}; "
                             f"the kernel takes one of {list(DTYPES)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is "
                             "not contiguous")
    return first.device
