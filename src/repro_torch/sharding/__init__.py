"""Sharding rules (`rules.py`) and the trees of DTensors they place
(`place.py`)."""
