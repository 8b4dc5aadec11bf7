"""Crash-safe checkpoints of tensor trees: atomic npz files
(`checkpoint.io`) and a checksummed store of retained generations
(`checkpoint.manifest`), in the JAX package's file format."""
