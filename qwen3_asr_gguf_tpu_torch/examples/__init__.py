"""Minimal usage of the port's engine and forced aligner (twins of the
repo-root examples/ of the JAX package)."""
