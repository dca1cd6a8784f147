"""Observability: the serving metrics registry and the publish quality
gate (copied from the JAX package)."""
