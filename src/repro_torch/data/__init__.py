"""Deterministic synthetic data for LM training."""
