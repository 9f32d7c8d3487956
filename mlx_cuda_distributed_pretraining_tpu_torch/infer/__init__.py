"""Inference: samplers, shape bucketing and the HTTP server."""
