"""Optimizer, gradient compression and the two-tier hierarchical trainer."""
