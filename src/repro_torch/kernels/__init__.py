"""Hand-written CUDA kernels for Hopper, one per FPGA module of the paper's
Table III (Conv, LRN, FC/matmul, Pooling).

Sources live in ``csrc/``; ``_build`` compiles them with ``nvcc`` at first
use.  ``ops`` exposes the public wrappers, which launch a kernel for a CUDA
tensor and run the plain PyTorch version in ``ref`` for a CPU tensor.
"""
from . import ops, ref  # noqa: F401
