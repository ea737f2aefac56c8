from volxel_tpu_torch.native.loader import get_native, native_available  # noqa: F401
