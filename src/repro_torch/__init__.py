"""repro_torch: the CNNLab reproduction in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A sibling of the JAX package ``repro``, which stays the reference: module
names match their counterparts there.  This package imports neither JAX nor
``repro``.
"""
__version__ = "0.1.0"
