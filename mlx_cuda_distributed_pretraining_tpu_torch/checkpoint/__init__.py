"""Checkpoint file format (safetensors)."""
