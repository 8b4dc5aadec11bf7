"""Plain reference of what the cells' timed paths compute."""
