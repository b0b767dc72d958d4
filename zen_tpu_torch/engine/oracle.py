"""Hop-by-hop numpy oracle — a direct transcription of the reference
per-hop state machine, used only as a test oracle.

This mirrors HPR<B>::process_next_hop / apply_median_filter /
apply_sse_filter (reference: libzen/hps.cu:429-652) operation by
operation: nwin input ring, sliding stft_width x nfft STFT matrix,
full-matrix median/box filtering per hop, lag-column masking, and
rotating overlap-add output buffers. It is deliberately slow and
simple; the batched engine (engine/spectral.py) must reproduce its
output stream exactly (see tests/test_torch_engine_parity.py).

Independent implementation in numpy (no jax) so the comparison is a
genuine cross-check, mirroring the reference's dual-backend testing
strategy (fftw.test.cu cross-validates cuFFT against IPP).

The port's copy of ``zen_tpu/engine/oracle.py``, line for line: the
card's machine has no JAX, and importing any ``zen_tpu`` module imports
it, so the port carries its own. It takes the port's ``HPRConfig``,
whose derived fields equal zen_tpu's bit for bit, and gives the same
arrays as zen_tpu's oracle on the same inputs
(tests/test_torch_oracle.py holds them bitwise).
"""
from __future__ import annotations

import numpy as np

from ..ops.median import (
    FREQUENCY,
    REPLICATE,
    TIME_ANTICAUSAL,
    TIME_CAUSAL,
    VALID,
    WRAP,
    odd_filter_len,
)
from .config import EPS, HPRConfig


def _np_taps(x: np.ndarray, offsets, axis: int, boundary: str) -> np.ndarray:
    n = x.shape[axis]
    taps = []
    idx = np.arange(n)
    for off in offsets:
        if boundary == "wrap":
            take = (idx + off) % n
        elif boundary == "clamp":
            take = np.clip(idx + off, 0, n - 1)
        else:  # zero
            take = np.clip(idx + off, 0, n - 1)
            tap = np.take(x, take, axis=axis)
            mask = (idx + off >= 0) & (idx + off < n)
            shape = [1] * x.ndim
            shape[axis] = n
            tap = tap * mask.reshape(shape)
            taps.append(tap)
            continue
        taps.append(np.take(x, take, axis=axis))
    return np.stack(taps, axis=0)


def np_filter2d(
    x: np.ndarray,
    filter_len: int,
    direction: str,
    border: str,
    op: str = "median",
) -> np.ndarray:
    """Numpy model of MedianFilterGPU/CPU::filter and BoxFilter*::filter
    on a [T, F] matrix. See ops/median.py for the decoded geometry."""
    t, f = x.shape
    fl = odd_filter_len(filter_len)
    fm = fl // 2
    axis = 1 if direction == FREQUENCY else 0
    reduce = np.median if op == "median" else np.mean

    if border == WRAP:
        return reduce(_np_taps(x, range(-fm, fm + 1), axis, "wrap"), axis=0)
    if border == REPLICATE:
        return reduce(_np_taps(x, range(-fm, fm + 1), axis, "clamp"), axis=0)

    assert op == "median", "reference GPU box filter always pads borders"
    out = np.zeros_like(x)
    if direction == TIME_CAUSAL:
        med = reduce(_np_taps(x, range(-fl, 0), axis, "zero"), axis=0)
        out[fl:, :] = med[fl:, :]
    elif direction == TIME_ANTICAUSAL:
        med = reduce(_np_taps(x, range(-fm, fm + 1), axis, "zero"), axis=0)
        out[fm : t - fm - 1, :] = med[fm : t - fm - 1, :]
    else:
        med = reduce(_np_taps(x, range(0, fl), axis, "zero"), axis=0)
        # no column is written where fl >= f (zen_tpu's copy slices to
        # f - fl < 0 there, which counts from the end and writes columns)
        out[:, : max(0, f - fl)] = med[:, : max(0, f - fl)]
    return out


def oracle_offline_pass(audio: np.ndarray, cfg: HPRConfig) -> dict:
    """One offline pass via the hop loop, replicating the per-pass part
    of HPRIOffline<GPU>::process (hps.cu:128-178): chunk padding with
    lag prefill, per-hop streaming, lag-shift, truncate."""
    audio = np.asarray(audio, np.float32)
    length = len(audio)
    n_chunks = int(np.ceil(length / cfg.hop)) + cfg.lag
    padded = np.zeros(n_chunks * cfg.hop, np.float32)
    padded[:length] = audio
    sim = HPROracle(cfg)
    outs = {k: np.zeros(n_chunks * cfg.hop, np.float32) for k in sim.outs}
    for n in range(n_chunks):
        hop_out = sim.process_next_hop(
            padded[n * cfg.hop : (n + 1) * cfg.hop]
        )
        for k, v in hop_out.items():
            outs[k][n * cfg.hop : (n + 1) * cfg.hop] = v
    shift = cfg.lag * cfg.hop
    return {k: v[shift : shift + length].copy() for k, v in outs.items()}


def oracle_realtime_stream(audio: np.ndarray, cfg: HPRConfig) -> dict:
    """Causal hop-by-hop stream: chunk n in, chunk n out (fakert path,
    zen/fakert.h:217-251, with clean zero tail-padding)."""
    audio = np.asarray(audio, np.float32)
    n_chunks = int(np.ceil(len(audio) / cfg.hop))
    padded = np.zeros(n_chunks * cfg.hop, np.float32)
    padded[: len(audio)] = audio
    sim = HPROracle(cfg)
    outs = {k: np.zeros(n_chunks * cfg.hop, np.float32) for k in sim.outs}
    for n in range(n_chunks):
        hop_out = sim.process_next_hop(
            padded[n * cfg.hop : (n + 1) * cfg.hop]
        )
        for k, v in hop_out.items():
            outs[k][n * cfg.hop : (n + 1) * cfg.hop] = v
    return outs


class HPROracle:
    """Stateful per-hop simulator of HPR<B> (hps.h:152-322)."""

    def __init__(self, cfg: HPRConfig):
        self.cfg = cfg
        c = cfg
        self.direction = TIME_CAUSAL if c.causal else TIME_ANTICAUSAL
        self.input = np.zeros(c.nwin, np.float32)
        self.window = c.window.astype(np.float32)
        self.stft = np.zeros((c.stft_width, c.nfft), np.complex64)
        self.outs = {
            k: np.zeros(c.nwin, np.float32)
            for k in ("harmonic", "percussive", "residual")
        }
        # mask buffers persist (only ever written at the lag row)
        self.masks = {
            k: np.zeros((c.stft_width, c.nfft), np.float32)
            for k in ("harmonic", "percussive")
        }

    def reset(self):
        self.__init__(self.cfg)

    def process_next_hop(self, hop_samples: np.ndarray) -> dict:
        c = self.cfg
        # rotate OLA buffers (hps.cu:435-449)
        for k, buf in self.outs.items():
            if getattr(c, f"output_{k}"):
                buf[: c.hop] = buf[c.hop :]
                buf[c.hop :] = 0.0
        # input ring (hps.cu:452-453)
        self.input[: c.hop] = self.input[c.hop :]
        self.input[c.hop :] = np.asarray(hop_samples, np.float32)
        # window + zero-pad + forward FFT (hps.cu:455-465)
        fft_vec = np.zeros(c.nfft, np.complex64)
        fft_vec[: c.nwin] = (self.input * self.window).astype(np.complex64)
        fft_vec = np.fft.fft(fft_vec).astype(np.complex64)
        # slide STFT matrix (hps.cu:467-472)
        self.stft[:-1] = self.stft[1:]
        self.stft[-1] = fft_vec

        if c.use_sse:
            self._apply_sse_filter()
        else:
            self._apply_median_filter()
        return {
            k: self.outs[k][: c.hop].copy()
            for k in ("harmonic", "percussive", "residual")
        }

    # -- filters --
    def _lag_row(self):
        return self.cfg.stft_width - self.cfg.lag

    def _mask_and_ola(self, name, mask_row):
        c = self.cfg
        r = self._lag_row()
        masked = np.zeros(c.nfft, np.complex64)
        masked[:] = self.stft[r] * mask_row
        y = np.fft.ifft(masked) * c.nfft  # unnormalized backward
        self.outs[name][: c.nwin] += np.real(y[: c.nwin]).astype(
            np.float32
        ) * np.float32(c.cola_factor)

    def _apply_median_filter(self):
        c = self.cfg
        r = self._lag_row()
        s_mag = np.abs(self.stft).astype(np.float32)
        h_mat = np_filter2d(s_mag, c.l_harm, self.direction, c.border)
        p_mat = np_filter2d(s_mag, c.l_perc, FREQUENCY, c.border)
        eps = np.float32(EPS)
        hrow, prow = h_mat[r], p_mat[r]
        if c.output_percussive:
            if not c.soft_mask:
                pm = (prow / (hrow + eps) >= np.float32(c.beta)).astype(
                    np.float32
                )
            else:
                pw = c.soft_power
                pm = prow**pw / (prow**pw + hrow**pw + eps)
            self.masks["percussive"][r] = pm
            self._mask_and_ola("percussive", pm)
        if c.output_harmonic:
            if not c.soft_mask:
                hm = (
                    hrow / (prow + eps) >= np.float32(c.beta) - eps
                ).astype(np.float32)
            else:
                pw = c.soft_power
                hm = hrow**pw / (hrow**pw + prow**pw + eps)
            self.masks["harmonic"][r] = hm
            self._mask_and_ola("harmonic", hm)
        if c.output_residual and not c.soft_mask:
            rm = (
                1.0
                - (self.masks["harmonic"][r] + self.masks["percussive"][r])
            ).astype(np.float32)
            self._mask_and_ola("residual", rm)

    def _apply_sse_filter(self):
        c = self.cfg
        r = self._lag_row()
        with np.errstate(divide="ignore"):
            power = np.abs(self.stft).astype(np.float32) ** 2
            recip = (1.0 / power).astype(np.float32)
            border = WRAP if c.border == VALID else c.border
            h_mat = np_filter2d(recip, c.l_harm, self.direction, border, "mean")
            p_mat = np_filter2d(recip, c.l_perc, FREQUENCY, border, "mean")
            h_mat = (1.0 / h_mat) * np.float32(c.l_harm + 1.0)
            p_mat = (1.0 / p_mat) * np.float32(c.l_perc + 1.0)
        eps = np.float32(EPS)
        hrow, prow = h_mat[r], p_mat[r]
        if c.output_percussive:
            pm = prow * prow / (prow * prow + hrow * hrow + eps)
            self._mask_and_ola("percussive", pm)
        if c.output_harmonic:
            hm = hrow * hrow / (hrow * hrow + prow * prow + eps)
            self._mask_and_ola("harmonic", hm)
