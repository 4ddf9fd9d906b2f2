"""Checkpoints in the JAX package's on-disk format (``manager``)."""
