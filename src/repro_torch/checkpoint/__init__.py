"""Checkpointing: atomic publish, keep-k, restore onto a device."""
from .manager import (CheckpointManager, latest_step,  # noqa: F401
                      restore_latest, save_checkpoint)
