"""Checkpoint file format (safetensors) and the run-directory manager."""
