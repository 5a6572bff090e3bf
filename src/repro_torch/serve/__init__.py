"""Serving vocabulary shared with the JAX package's launcher and simulator."""
