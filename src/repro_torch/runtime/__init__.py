"""Fault-tolerance runtime: straggler detection and preemption handling."""
from .fault_tolerance import (PreemptionHandler, StepTimer,  # noqa: F401
                              StragglerReport)
