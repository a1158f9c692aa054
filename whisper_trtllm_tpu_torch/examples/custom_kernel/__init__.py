"""A custom fused kernel, written by hand for Hopper, beside its plain
version (``custom_gelu_kernel``)."""
