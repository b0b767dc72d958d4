"""FFT conventions matching the reference, on ``torch.fft``.

Counterpart of ``zen_tpu/ops/fft.py:20-40``. The forward transforms
are unnormalized (cuFFT C2C, fftw.h:35-43), which is torch's default.
The reference's backward transform is unnormalized too; as in the JAX
engine, its factor nfft is folded into the synthesis scale
(``HPRConfig.synth_scale``), so the inverses here are the normalized
ones. On CUDA tensors these run cuFFT; the JAX package likewise leaves
its transform to the XLA FFT outside any Pallas kernel.
"""
from __future__ import annotations

import torch


def fft_forward(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Unnormalized C2C forward FFT over the last dim, zero-padded to
    nfft (the reference zero-fills fft_vec[nwin:nfft], hps.cu:461-462)."""
    return torch.fft.fft(x, n=nfft, dim=-1)


def rfft_forward(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Real-input forward FFT (half spectrum, nfft//2+1 bins)."""
    return torch.fft.rfft(x, n=nfft, dim=-1)


def ifft_real(x: torch.Tensor) -> torch.Tensor:
    """Real part of the normalized C2C inverse over the last dim."""
    return torch.fft.ifft(x, dim=-1).real


def irfft(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Normalized real inverse of a Hermitian half spectrum."""
    return torch.fft.irfft(x, n=nfft, dim=-1)
