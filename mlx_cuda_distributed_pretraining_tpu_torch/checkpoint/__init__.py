"""Checkpoint file format (safetensors), the run-directory manager and its
fault-injection plane."""
from . import faults
from .manager import (
    CheckpointIntegrityError,
    CheckpointManager,
    StaleBackgroundWriteError,
)
from .safetensors_io import load_safetensors, save_safetensors

__all__ = [
    "CheckpointIntegrityError",
    "CheckpointManager",
    "StaleBackgroundWriteError",
    "faults",
    "load_safetensors",
    "save_safetensors",
]
