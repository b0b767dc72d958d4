"""McLeod Pitch Method (MPM) pitch detection (counterpart of
``zen_tpu/apps/mpm.py``).

From-scratch reimplementation of the reference pitch-tracking demo
(reference: demos/pitch-tracking/pitch.cpp, pitch_detection.h): FFT
autocorrelation (pitch.cpp:38-60), NSDF peak picking (pitch.cpp:62-97),
parabolic interpolation (pitch.cpp:16-36) and the 0.93-of-max cutoff with
an 80 Hz lower pitch bound (pitch.cpp:12-14, 99-135).

The autocorrelation is batched torch on the caller's device (all chunks of
a track in one call: cuFFT on the card); the scalar peak-picking walk runs
on the host, as in zen_tpu: O(N) branchy control flow over one 4096-vector
per 93 ms chunk.

Deviation, zen_tpu's: the reference's real_autocorrelation applies
|X|^2/(2N) to only the first N of its 2N FFT bins before the inverse
(pitch.cpp:49-52), which mixes O(|X|) leakage into the "ACF" and biases
the pitch. The textbook ACF (power over all bins) is the default;
``MPM(..., strict_ref=True)`` reproduces the reference's half-scaled
spectrum.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

MPM_CUTOFF = 0.93
MPM_SMALL_CUTOFF = 0.5
MPM_LOWER_PITCH_CUTOFF = 80.0


def _autocorr_batch(chunks: torch.Tensor, n: int, strict_ref: bool = False) -> torch.Tensor:
    """Real autocorrelation via a zero-padded FFT, [..., N] -> [..., N],
    on the chunks' device.

    Mirrors real_autocorrelation (pitch.cpp:38-60): X = FFT(x, 2N),
    X <- X * conj(X) / (2N), acf = Re(IFFT(X))[:N], with the reference's
    unnormalized inverse folded in (x 2N), in zen_tpu's order of
    operations. The divisor is a tensor (made by a fill on the device,
    no host copy): torch multiplies a CUDA tensor by the reciprocal of a
    Python scalar divisor.

    strict_ref=True reproduces the reference's quirk: the |X|^2/(2N)
    scaling touches only bins [0, N) of the 2N C2C spectrum, leaving
    [N, 2N) as the raw forward spectrum.
    """
    two_n = torch.full((), 2 * n, dtype=torch.float32, device=chunks.device)
    if strict_ref:
        x = torch.fft.fft(chunks.to(torch.complex64), n=2 * n, dim=-1)
        scaled = x * torch.conj(x) / two_n
        mixed = torch.cat([scaled[..., :n], x[..., n:]], dim=-1)
        acf = torch.fft.ifft(mixed, dim=-1).real * two_n
        return acf[..., :n]
    x = torch.fft.rfft(chunks, n=2 * n, dim=-1)
    power = (x * torch.conj(x)).real / two_n
    acf = torch.fft.irfft(power, n=2 * n, dim=-1) * two_n
    return acf[..., :n]


def _parabolic_interpolation(array: np.ndarray, x: int):
    """(pitch.cpp:16-36)."""
    if x < 1:
        xa = x if array[x] <= array[x + 1] else x + 1
        return float(xa), float(array[xa])
    if x > len(array) - 2:
        xa = x if array[x] <= array[x - 1] else x - 1
        return float(xa), float(array[xa])
    den = array[x + 1] + array[x - 1] - 2 * array[x]
    delta = array[x - 1] - array[x + 1]
    if den == 0:
        return float(x), float(array[x])
    return (
        float(x + delta / (2 * den)),
        float(array[x] - delta * delta / (8 * den)),
    )


def _peak_picking(nsdf: np.ndarray) -> list:
    """(pitch.cpp:62-97)."""
    max_positions = []
    pos = 0
    cur_max_pos = 0
    size = len(nsdf)
    while pos < (size - 1) // 3 and nsdf[pos] > 0:
        pos += 1
    while pos < size - 1 and nsdf[pos] <= 0.0:
        pos += 1
    if pos == 0:
        pos = 1
    while pos < size - 1:
        if (
            nsdf[pos] > nsdf[pos - 1]
            and nsdf[pos] >= nsdf[pos + 1]
            and (cur_max_pos == 0 or nsdf[pos] > nsdf[cur_max_pos])
        ):
            cur_max_pos = pos
        pos += 1
        if pos < size - 1 and nsdf[pos] <= 0:
            if cur_max_pos > 0:
                max_positions.append(cur_max_pos)
                cur_max_pos = 0
            while pos < size - 1 and nsdf[pos] <= 0.0:
                pos += 1
    if cur_max_pos > 0:
        max_positions.append(cur_max_pos)
    return max_positions


def pitch_from_acf(acf: np.ndarray, sample_rate: float) -> float:
    """Pitch decision from one chunk's autocorrelation (pitch.cpp:
    99-135). Returns -1.0 when no pitch is detected."""
    max_positions = _peak_picking(acf)
    estimates = []
    highest_amplitude = -np.inf
    for i in max_positions:
        highest_amplitude = max(highest_amplitude, acf[i])
        if acf[i] > MPM_SMALL_CUTOFF:
            est = _parabolic_interpolation(acf, i)
            estimates.append(est)
            highest_amplitude = max(highest_amplitude, est[1])
    if not estimates:
        return -1.0
    actual_cutoff = MPM_CUTOFF * highest_amplitude
    period = 0.0
    for x, y in estimates:
        if y >= actual_cutoff:
            period = x
            break
    if period == 0.0:
        return -1.0
    pitch = sample_rate / period
    return pitch if pitch > MPM_LOWER_PITCH_CUTOFF else -1.0


class MPM:
    """Chunk-wise pitch detector, API analog of the reference MPM class
    (pitch_detection.h:14-94). The autocorrelation runs on ``device``
    (the card unless ``device="cpu"``), the decisions on the host."""

    def __init__(self, n: int, sample_rate: float, strict_ref: bool = False, device="cuda"):
        if n <= 0:
            raise ValueError("chunk size must be positive")
        self.n = n
        self.sample_rate = float(sample_rate)
        self.strict_ref = bool(strict_ref)
        self.device = resolve_device(device)

    def acf_batch(self, chunks) -> np.ndarray:
        """[C, N] chunks -> their autocorrelations [C, N] on the host."""
        x = torch.from_numpy(np.ascontiguousarray(chunks, np.float32)).to(self.device)
        return _autocorr_batch(x, self.n, self.strict_ref).cpu().numpy()

    def pitch(self, audio_chunk) -> float:
        chunk = np.zeros(self.n, np.float32)
        a = np.asarray(audio_chunk, np.float32)[: self.n]
        chunk[: len(a)] = a
        return pitch_from_acf(self.acf_batch(chunk), self.sample_rate)

    def pitch_batch(self, chunks) -> np.ndarray:
        """All chunks' ACFs in one device call, then host decisions."""
        return np.array(
            [pitch_from_acf(acf, self.sample_rate) for acf in self.acf_batch(chunks)],
            np.float32,
        )
