"""Tensor ops: reference attention and the grouped expert GEMM kernel."""
