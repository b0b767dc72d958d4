"""Analysis windows (counterpart of ``zen_tpu/ops/windows.py``).

Periodic windows computed in numpy exactly as the JAX package does
(float32 samples, float64 COLA sum), so both packages start from the
same bits. The drivers move the window to the device once.
"""
from __future__ import annotations

import numpy as np


def periodic_hann(n: int) -> np.ndarray:
    """Periodic von Hann window of length ``n`` (float32)."""
    k = np.arange(n, dtype=np.float32)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / np.float32(n)))).astype(
        np.float32
    )


def sqrt_hann(n: int) -> np.ndarray:
    """Square-root periodic von Hann: the HPR analysis/synthesis window."""
    return np.sqrt(periodic_hann(n)).astype(np.float32)


def cola_factor(win: np.ndarray, nfft: int) -> float:
    """COLA normalization factor: nfft / sum(win**2), summed in float64."""
    s = float(np.sum(win.astype(np.float64) ** 2))
    return float(nfft) / s
