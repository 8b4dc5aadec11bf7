"""Serving steps and the batched greedy engine."""
