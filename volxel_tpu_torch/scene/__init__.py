"""Camera, volume placement and environment lighting."""
