"""Transfer-function LUTs (numpy, copied from volxel_tpu.transfer)."""
