"""Model configurations, the port's own copies of the JAX package's
``configs`` (which import the JAX ``ModelConfig``), and the shape
registry."""
from .registry import (ARCH_NAMES, SHAPES, ArchSpec, ShapeSpec, all_archs,  # noqa
                       get, input_specs, runnable_cells, supports)
