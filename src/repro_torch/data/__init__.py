"""Synthetic data pipelines (the JAX package's `repro.data`)."""
