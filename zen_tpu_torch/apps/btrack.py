"""BTrack real-time beat tracker (counterpart of ``zen_tpu/apps/btrack.py``).

From-scratch reimplementation of the reference beat-tracking demo
(reference: demos/beat-tracking/{BTrack,OnsetDetection}.cpp,
BTrackPrecomputed.h):

* the onset detection function (complex spectral difference with
  half-wave rectification, OnsetDetection.cpp:85-131) is batchable:
  frame magnitudes and phases depend only on frames n, n-1, n-2, so a
  whole track's ODF is one torch call on the frames' device
  (``odf_batch``: cuFFT on the card);
* the beat state machine (cumulative score, beat prediction, tempo
  Viterbi step, BTrack.cpp:100-260) is sequential scalar logic over
  512-float buffers at ~172 Hz: host numpy, a copy of zen_tpu's.

The reference's precomputed tables (BTrackPrecomputed.h) are regenerated
from their generating formulas: a Rayleigh weighting with beta=43 and a
Gaussian tempo transition matrix with sigma 5.

Deviation, zen_tpu's: the reference's tempo observation indexing reads
combFilterBankOutput[t_index-1] where t_index can be 129 for fs=44100,
one past the end of the 128-length array (undefined behavior in C++,
BTrack.cpp:217-223). It is clamped to the last bin.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..engine.config import _roundf as _cround  # C round(): half away
# from zero; Python's round() is banker's and drifts from the
# reference for odd beat periods (e.g. round(42.5))

FRAME_SIZE = 512
HOP_SIZE = 256
ONSET_DF_BUFFER_SIZE = 512
FFT_LEN_ACF = 1024
TIGHTNESS = 5.0
ALPHA = 0.9
EPSILON = 0.0001


def rayleigh_weighting(n: int = 128, beta: float = 43.0) -> np.ndarray:
    """R[v] = v/beta^2 * exp(-v^2 / (2 beta^2)) — regenerates
    BTrackPrecomputed.h RayleighWeightingVector128."""
    v = np.arange(n, dtype=np.float64)
    return (v / beta**2 * np.exp(-(v**2) / (2 * beta**2))).astype(np.float32)


def tempo_transition_matrix(n: int = 41) -> np.ndarray:
    """T[i][j] = N(j+1; mu=i+1, sigma=5) — regenerates
    BTrackPrecomputed.h TempoTransitionMatrix (fitted: the header was
    generated with sigma exactly 5, not classic BTrack's 41/8)."""
    sig = 5.0
    i = np.arange(1, n + 1, dtype=np.float64)[:, None]
    j = np.arange(1, n + 1, dtype=np.float64)[None, :]
    t = (1.0 / (sig * np.sqrt(2 * np.pi))) * np.exp(
        -((j - i) ** 2) / (2 * sig**2)
    )
    return t.astype(np.float32)


def _hanning_symmetric(n: int) -> np.ndarray:
    """Symmetric hann (denominator n-1) — the demo window
    (demos/beat-tracking/Window.h:31-40), unlike the engine's
    periodic window."""
    k = np.arange(n, dtype=np.float32)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / np.float32(n - 1)))).astype(
        np.float32
    )


@functools.lru_cache(maxsize=1)
def _odf_window() -> np.ndarray:
    """The 512-point demo window, computed once (the streaming ODF runs at
    ~172 Hz per stream; recomputing the constant per hop is host waste).
    Read-only: every caller shares this one array, so a write raises."""
    window = _hanning_symmetric(FRAME_SIZE)
    window.setflags(write=False)
    return window


@functools.lru_cache(maxsize=4)
def _device_window(device: torch.device) -> torch.Tensor:
    # one copy per device, not one per call; a copy on the CPU too, so the
    # tensor never shares the numpy window's storage
    return torch.tensor(_odf_window(), device=device)


def odf_batch(frames: torch.Tensor) -> torch.Tensor:
    """Complex-spectral-difference-HWR onset detection function [T] for a
    batch of frames [T, 512] (each frame = 2 consecutive 256 hops), on
    the frames' device: ``odf_from_spectrum(odf_spectrum(frames))``.

    Mirrors OnsetDetection.cpp:70-131 in zen_tpu's order of operations:
    window, swap halves (zero-phase trick, OnsetDetection.cpp:74-78),
    FFT, then per-bin
    sqrt(m^2 + m_prev^2 - 2 m m_prev cos(phi - 2 phi_prev + phi_prev2))
    summed over bins where the magnitude increased. Frames n-1, n-2 are
    zeros for the first frames (the reference's zeroed state).
    """
    return odf_from_spectrum(odf_spectrum(frames))


def odf_fft_input(frames: torch.Tensor) -> torch.Tensor:
    """The rows [T, 512] ``odf_spectrum`` transforms: each frame windowed,
    its halves swapped."""
    xw = frames.to(torch.float32) * _device_window(frames.device)
    return torch.cat([xw[:, HOP_SIZE:], xw[:, :HOP_SIZE]], dim=-1)


def odf_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """The complex spectra [T, 512] the ODF reads: ``odf_fft_input``'s
    rows, transformed."""
    return torch.fft.fft(odf_fft_input(frames), dim=-1)


def odf_from_spectrum(spec: torch.Tensor) -> torch.Tensor:
    """The ODF [T] of ``odf_spectrum``'s spectra: frame n reads spectrum
    rows n, n-1 and n-2."""
    mag = spec.abs()
    # + 0.0 turns -0.0 into +0.0: the phase of a zero (an all-zero frame,
    # the DC and Nyquist bins' imaginary part) is atan2 of signed zeros,
    # 0 or +-pi, and torch's FFTs return -0.0 where zen_tpu's (and numpy's)
    # return +0.0
    phase = torch.atan2(spec.imag + 0.0, spec.real + 0.0)
    zero = mag.new_zeros((1, FRAME_SIZE))
    mag_p = torch.cat([zero, mag[:-1]], dim=0)
    ph_p = torch.cat([zero, phase[:-1]], dim=0)
    # slice back to T rows: for T=1, cat([zero, zero, empty]) would carry
    # a phantom second frame through the whole ODF
    ph_p2 = torch.cat([zero, zero, phase[:-2]], dim=0)[: mag.shape[0]]
    dev = phase - 2.0 * ph_p + ph_p2
    mag_diff = mag - mag_p
    csd = torch.sqrt(
        torch.clamp(mag * mag + mag_p * mag_p - 2.0 * mag * mag_p * torch.cos(dev), min=0.0)
    )
    return torch.where(mag_diff > 0, csd, torch.zeros_like(csd)).sum(dim=-1)


def _adaptive_threshold(x: np.ndarray) -> np.ndarray:
    """(BTrack.cpp:327-366), including its boundary quirks (the first
    segment averages from index 1)."""
    n = len(x)
    p_post, p_pre = 7, 8
    t = min(n, p_post)
    thresh = np.zeros(n, np.float32)

    def mean(a, s, e):
        s, e = int(s), int(e)
        return float(np.mean(a[s:e])) if e > s else 0.0

    for i in range(0, t + 1):
        k = min(i + p_pre, n)
        thresh[i] = mean(x, 1, k)
    for i in range(t + 1, n - p_post):
        thresh[i] = mean(x, i - p_pre, i + p_post)
    for i in range(n - p_post, n):
        k = max(i - p_post, 1)
        thresh[i] = mean(x, k, n)
    return np.maximum(x - thresh, 0.0)


class BTrack:
    """Beat tracking state machine (BTrack.cpp:22-260)."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self.tempo_to_lag_factor = 60.0 * sample_rate / HOP_SIZE
        self.beat_period = _cround(
            60.0 / ((HOP_SIZE / sample_rate) * 120.0)
        )
        self.m0 = 10
        self.beat_counter = -1
        self.beat_due_in_frame = False
        self.estimated_tempo = 120.0
        self.latest_cumulative_score = 0.0
        self.onset_df = np.zeros(ONSET_DF_BUFFER_SIZE, np.float32)
        self.cumulative_score = np.zeros(ONSET_DF_BUFFER_SIZE, np.float32)
        # init: a click train at the prior beat period (BTrack.cpp:46-50)
        idx = np.arange(ONSET_DF_BUFFER_SIZE)
        self.onset_df[idx % int(_cround(self.beat_period)) == 0] = 1.0
        self.prev_delta = np.ones(41, np.float32)
        self.rayleigh = rayleigh_weighting()
        self.transition = tempo_transition_matrix()
        # frame ring for the streaming ODF path
        self._frame = np.zeros(FRAME_SIZE, np.float32)
        self._prev_mag = np.zeros(FRAME_SIZE, np.float32)
        self._prev_phase = np.zeros(FRAME_SIZE, np.float32)
        self._prev_phase2 = np.zeros(FRAME_SIZE, np.float32)
        self.last_onset = 0.0

    # ---- streaming API (one 256-sample hop per call) ----
    def process_hop(self, samples) -> None:
        self._frame[:HOP_SIZE] = self._frame[HOP_SIZE:]
        self._frame[HOP_SIZE:] = np.asarray(samples, np.float32)[:HOP_SIZE]
        sample = self._odf_sample()
        self.last_onset = sample
        self.process_odf_sample(sample)

    def _odf_sample(self) -> float:
        win = _odf_window()
        xw = self._frame * win
        fft_in = np.concatenate([xw[HOP_SIZE:], xw[:HOP_SIZE]])
        spec = np.fft.fft(fft_in)
        mag = np.abs(spec).astype(np.float32)
        phase = np.arctan2(spec.imag, spec.real).astype(np.float32)
        dev = phase - 2.0 * self._prev_phase + self._prev_phase2
        mag_diff = mag - self._prev_mag
        csd = np.sqrt(
            np.maximum(
                mag**2
                + self._prev_mag**2
                - 2.0 * mag * self._prev_mag * np.cos(dev),
                0.0,
            )
        )
        s = float(np.sum(np.where(mag_diff > 0, csd, 0.0)))
        self._prev_phase2 = self._prev_phase
        self._prev_phase = phase
        self._prev_mag = mag
        return s

    # ---- core state machine ----
    def process_odf_sample(self, sample: float) -> None:
        sample = abs(sample) + EPSILON
        self.m0 -= 1
        self.beat_counter -= 1
        self.beat_due_in_frame = False

        self.onset_df = np.roll(self.onset_df, -1)
        self.onset_df[-1] = sample
        self._update_cumulative_score(sample)
        if self.m0 == 0:
            self._predict_beat()
        if self.beat_counter == 0:
            self.beat_due_in_frame = True
            self._calculate_tempo()

    def _w1(self, start: int, end: int) -> np.ndarray:
        v = -2.0 * self.beat_period + np.arange(end - start + 1)
        return np.exp(
            -((TIGHTNESS * np.log(-v / self.beat_period)) ** 2) / 2.0
        ).astype(np.float32)

    def _update_cumulative_score(self, odf_sample: float) -> None:
        """(BTrack.cpp:120-134). Deviation: the reference indexes
        cumulativeScore[start..] with start possibly negative when
        beat_period > buffer/2 (fs >= ~88.2 kHz -> C++ out-of-bounds
        read / numpy broadcast crash); clamp the window to the buffer
        and trim the weights to match."""
        start = int(ONSET_DF_BUFFER_SIZE - _cround(2.0 * self.beat_period))
        end = int(ONSET_DF_BUFFER_SIZE - _cround(self.beat_period / 2.0))
        w1 = self._w1(start, end)
        if start < 0:
            w1 = w1[-start:]
            start = 0
        if end >= ONSET_DF_BUFFER_SIZE:  # beat_period <= 1 degenerate
            w1 = w1[: ONSET_DF_BUFFER_SIZE - start]
            end = ONSET_DF_BUFFER_SIZE - 1
        window = self.cumulative_score[start : end + 1] * w1
        m = float(window.max(initial=0.0))
        self.latest_cumulative_score = (1.0 - ALPHA) * odf_sample + ALPHA * m
        self.cumulative_score = np.roll(self.cumulative_score, -1)
        self.cumulative_score[-1] = self.latest_cumulative_score

    def _predict_beat(self) -> None:
        """(BTrack.cpp:136-194)."""
        window_size = int(self.beat_period)
        future = np.zeros(ONSET_DF_BUFFER_SIZE + window_size, np.float32)
        future[:ONSET_DF_BUFFER_SIZE] = self.cumulative_score
        v = 1.0 + np.arange(window_size)
        w2 = np.exp(
            -((v - self.beat_period / 2.0) ** 2)
            / (2.0 * (self.beat_period / 2.0) ** 2)
        )
        start0 = int(ONSET_DF_BUFFER_SIZE - _cround(2.0 * self.beat_period))
        end0 = int(ONSET_DF_BUFFER_SIZE - _cround(self.beat_period / 2.0))
        w1 = self._w1(start0, end0)
        for i in range(
            ONSET_DF_BUFFER_SIZE, ONSET_DF_BUFFER_SIZE + window_size
        ):
            start = int(i - _cround(2.0 * self.beat_period))
            end = int(i - _cround(self.beat_period / 2.0))
            w = w1
            if start < 0:  # same clamp as _update_cumulative_score
                w = w1[-start:]
                start = 0
            seg = future[start : end + 1]
            k = min(len(seg), len(w))
            future[i] = float((seg[:k] * w[:k]).max(initial=0.0))
        fut = future[ONSET_DF_BUFFER_SIZE:] * w2
        self.beat_counter = int(np.argmax(fut))
        self.m0 = int(self.beat_counter + _cround(self.beat_period / 2.0))

    def _calculate_tempo(self) -> None:
        """(BTrack.cpp:196-260)."""
        df = _adaptive_threshold(self.onset_df.copy())
        acf = self._balanced_acf(df)
        comb = np.zeros(128, np.float32)
        for i in range(2, 128):
            for a in range(1, 5):
                for b in range(1 - a, a):
                    comb[i - 1] += (
                        acf[a * i + b - 1] * self.rayleigh[i - 1]
                    ) / (2 * a - 1)
        comb = _adaptive_threshold(comb)
        tov = np.zeros(41, np.float32)
        for i in range(41):
            t_index = int(_cround(self.tempo_to_lag_factor / (2.0 * i + 80.0)))
            t_index2 = t_index // 2
            # clamp: the reference reads comb[t_index-1] which can be
            # one past the end (C++ UB, BTrack.cpp:217-223)
            tov[i] = (
                comb[min(t_index - 1, 127)] + comb[min(t_index2 - 1, 127)]
            )
        delta = np.max(
            self.prev_delta[:, None] * self.transition, axis=0
        ) * tov
        pos = delta[delta > 0]
        if pos.sum() > 0:
            delta = delta / pos.sum()
        self.prev_delta = delta.astype(np.float32)
        maxind = int(np.argmax(delta))
        self.beat_period = _cround(
            (60.0 * self.sample_rate)
            / ((2.0 * maxind + 80.0) * HOP_SIZE)
        )
        if self.beat_period > 0:
            self.estimated_tempo = 60.0 / (
                (HOP_SIZE / self.sample_rate) * self.beat_period
            )

    @staticmethod
    def _balanced_acf(df: np.ndarray) -> np.ndarray:
        """(BTrack.cpp:282-305): FFT(1024) of the zero-padded ODF,
        power spectrum, unnormalized inverse, lag-balanced."""
        buf = np.zeros(FFT_LEN_ACF, np.float32)
        buf[:ONSET_DF_BUFFER_SIZE] = df
        spec = np.fft.fft(buf)
        power = (spec * np.conj(spec)).real
        y = np.fft.ifft(power) * FFT_LEN_ACF  # unnormalized inverse
        lags = np.arange(ONSET_DF_BUFFER_SIZE)
        return (
            np.abs(y[:ONSET_DF_BUFFER_SIZE])
            / (ONSET_DF_BUFFER_SIZE - lags)
        ).astype(np.float32)


def track_beats_from_odf(odf: np.ndarray, sample_rate: int):
    """Run the beat state machine over a precomputed ODF sequence (e.g.
    from the batched ``odf_batch``). Returns (beat_flags, tempo_curve)."""
    bt = BTrack(sample_rate)
    beats = np.zeros(len(odf), bool)
    tempi = np.zeros(len(odf), np.float32)
    for n, s in enumerate(odf):
        bt.process_odf_sample(float(s))
        beats[n] = bt.beat_due_in_frame
        tempi[n] = bt.estimated_tempo
    return beats, tempi


def frames_from_hops(audio: np.ndarray) -> np.ndarray:
    """[L] -> [T, 512] frames of consecutive 256 hops (the reference
    ODF's internal ring, OnsetDetection.cpp:59-66)."""
    audio = np.asarray(audio, np.float32)
    t = len(audio) // HOP_SIZE
    frames = np.zeros((t, FRAME_SIZE), np.float32)
    for n in range(t):
        lo = (n - 1) * HOP_SIZE
        if lo >= 0:
            frames[n, :HOP_SIZE] = audio[lo : lo + HOP_SIZE]
        frames[n, HOP_SIZE:] = audio[n * HOP_SIZE : (n + 1) * HOP_SIZE]
    return frames
