"""FFT conventions matching the reference, on ``torch.fft``.

Counterpart of ``zen_tpu/ops/fft.py:20-40``. The forward transforms
are unnormalized (cuFFT C2C, fftw.h:35-43), which is torch's default.
The reference's backward transform is unnormalized too; as in the JAX
engine, its factor nfft is folded into the synthesis scale
(``HPRConfig.synth_scale``), so the inverses here are the normalized
ones. On CUDA tensors these run cuFFT; the JAX package likewise leaves
its transform to the XLA FFT outside any Pallas kernel. The DFT-matmul
transform (``fft_impl='dft*'``) follows.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
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


# ---------------- DFT as matmul (fft_impl='dft*') ----------------
#
# Counterpart of zen_tpu/ops/fft.py:50-136. Each frame is nwin windowed
# samples zero-padded to nfft = 2 nwin (hps.cu:461-462), and the inverse
# keeps only its first nwin samples (hps.cu:526): one real matmul with
# the nwin live rows of the half-spectrum DFT does the forward
# transform, packed as [re | im] columns, and one with the packed
# inverse does the truncated inverse; the spectra between the two are
# complex, as torch.fft's. Each mode fixes its arithmetic
# here, whatever the global TF32 flags say (zen_tpu's matmul precisions):
#
#   dft_f32   float32 products, TF32 off (Precision.HIGHEST)
#   dft_bf16  bf16-rounded operands, exact products, float32 sums and
#             output (Precision.DEFAULT)
#   dft       bf16x3: hi = bf16(x), lo = bf16(x - hi), hi.hi + hi.lo +
#             lo.hi, one matmul over the three stacked along K
#             (Precision.HIGH)
#
# On the card the bf16 operands go through torch.mm(..., out_dtype=
# torch.float32), a bf16 tensor-core product with float32 sums and no
# bf16 rounding of the output. On the CPU the same bf16 values go
# through a float32 matmul, where a product of two bf16 values is exact.

DFT_MODES = ("dft", "dft_bf16", "dft_f32")


@functools.lru_cache(maxsize=8)
def _dft_mats(nwin: int, nfft: int):
    """(w [nwin, 2 bins], wi [2 bins, nwin]) float32: the forward DFT of
    the live rows and the packed truncated inverse (normalized), built in
    float64 and cast, as zen_tpu/ops/fft.py:70-91 builds them."""
    bins = nfft // 2 + 1
    n = np.arange(nwin)[:, None]
    k = np.arange(bins)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    w = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    wk = np.ones(bins)
    wk[1:] = 2.0
    if nfft % 2 == 0:
        wk[-1] = 1.0
    angi = 2.0 * np.pi * k.T * np.arange(nwin)[None, :] / nfft
    wi = np.concatenate([np.cos(angi) * wk[:, None], -np.sin(angi) * wk[:, None]], axis=0) / nfft
    return w.astype(np.float32), wi.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _operand(nwin: int, nfft: int, inverse: bool, mode: str, device: torch.device):
    """The mode's right-hand matrix on ``device``, uploaded once: float32
    for dft_f32; bf16 for dft_bf16, and [hi; lo; hi] stacked along K for
    dft; on the CPU the bf16 values are held as float32."""
    w = torch.from_numpy(_dft_mats(nwin, nfft)[int(inverse)]).to(device)
    if mode == "dft_f32":
        return w
    hi = w.to(torch.bfloat16)
    if mode == "dft":  # lo = bf16(w - hi); w - hi is exact in float32
        w = torch.cat([hi, (w - hi).to(torch.bfloat16), hi], dim=0)
    else:
        w = hi
    return w if device.type == "cuda" else w.float()


# dft_f32 switches TF32 off through torch's process-wide flag, the only
# switch cuBLAS reads; the lock keeps two dft_f32 calls from restoring
# each other's flag in the middle of a product.
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def _tf32_off():
    """cuBLAS float32 products for the block, whatever the global TF32
    switch says; the switch is restored after. The switch is global:
    while the block runs (the host's enqueue of one GEMM), a float32
    matmul enqueued by another thread runs without TF32 too, and one
    that sets the switch itself is not held off by the lock. Callers
    that share the process with threads of their own float32 matmuls
    and need them to keep TF32 serialize around dft_f32."""
    with _TF32_LOCK:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


def dft_matmul(x: torch.Tensor, nwin: int, nfft: int, inverse: bool, mode: str) -> torch.Tensor:
    """x [..., K] float32 times the mode's forward (K = nwin) or inverse
    (K = 2 bins) DFT matrix, float32 [..., N]: the forward gives the half
    spectrum packed as [re | im] columns, the inverse takes it so."""
    if mode not in DFT_MODES:
        raise ValueError(f"unknown DFT mode: {mode}")
    w = _operand(nwin, nfft, inverse, mode, x.device)
    rows = x.reshape(-1, x.shape[-1])
    if mode == "dft_f32":
        with _tf32_off() if rows.is_cuda else contextlib.nullcontext():
            y = torch.mm(rows, w)
    else:
        hi = rows.to(torch.bfloat16)
        a = torch.cat([hi, hi, (rows - hi).to(torch.bfloat16)], dim=1) if mode == "dft" else hi
        if rows.is_cuda:
            y = torch.mm(a, w, out_dtype=torch.float32)
        else:
            y = torch.mm(a.float(), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def rfft_forward_dft(xw: torch.Tensor, nfft: int, mode: str) -> torch.Tensor:
    """Forward half-spectrum DFT of the zero-padded frames xw [..., nwin]:
    complex [..., bins]."""
    packed = dft_matmul(xw, xw.shape[-1], nfft, False, mode)
    bins = nfft // 2 + 1
    return torch.complex(packed[..., :bins], packed[..., bins:])


def irfft_head_dft(s: torch.Tensor, nfft: int, nwin: int, mode: str) -> torch.Tensor:
    """First nwin samples of the normalized inverse real DFT of a
    Hermitian half spectrum s [..., bins]: one matmul on its packed
    [re | im] rows."""
    return dft_matmul(torch.cat([s.real, s.imag], dim=-1), nwin, nfft, True, mode)
