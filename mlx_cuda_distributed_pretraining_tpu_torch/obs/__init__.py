"""Run logging and FLOPs accounting."""
