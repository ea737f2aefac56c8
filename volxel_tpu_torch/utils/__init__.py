"""Host-side helpers (numpy copies of volxel_tpu.utils)."""
