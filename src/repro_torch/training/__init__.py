"""The training step (the JAX package's `repro.training`)."""
