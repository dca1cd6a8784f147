"""Serving-side metrics registry (copied from the JAX package)."""
