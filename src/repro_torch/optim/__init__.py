"""Optimizers of the training step (the JAX package's `repro.optim`)."""
