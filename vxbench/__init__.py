"""The benchmark of volxel_tpu_torch on the NVIDIA H100 (see README.md)."""
