"""Error types for zen-tpu's PyTorch port (counterpart of
``zen_tpu/errors.py``): parameter validation raises ``ZenError``;
runtime CUDA failures raise ``RuntimeError`` from the kernel
wrappers."""


class ZenError(ValueError):
    """Raised on invalid configuration or parameters."""
