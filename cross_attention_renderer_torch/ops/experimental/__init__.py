"""Opt-in ops, where the JAX package keeps their counterparts:
``banded_gather`` (kernel K8)."""
