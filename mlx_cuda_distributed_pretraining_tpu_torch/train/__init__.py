"""Training-side helpers (only run loading is ported so far)."""
