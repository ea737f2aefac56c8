"""The default-mode path tracer and its kernels."""
