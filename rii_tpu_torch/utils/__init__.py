"""Recall metrics and conversion from the JAX package's arrays."""
