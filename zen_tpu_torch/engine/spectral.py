"""Batched spectral HPR core on PyTorch (counterpart of
``zen_tpu/engine/spectral.py``).

Every function takes tensors with arbitrary leading batch dims
([..., T, F]); the streaming driver passes [streams, frames, bins], the
offline driver [..., frames, bins] over a whole clip.
The two median directions go through the kernel wrappers of
``ops/median_cuda.py``: the CUDA kernels on CUDA tensors, their plain
twins on CPU tensors. ``median_impl`` only pins which of the two the
caller expects, and a mismatch raises, so no median on CUDA tensors
ever runs the plain twin. The SSE variant (``use_sse``) replaces both
medians by box means of 1/|S|^2 (``ops/box.py``) and runs no median.
The transform is ``torch.fft`` (cuFFT on the card), or the DFT matmuls
of ``ops/fft.py`` under ``fft_impl='dft*'``. The masks meet the spectrum
in one seam, ``masked_spectra``: hard masks go through the mask-and-apply
kernel of ``ops/mask_cuda.py`` (its plain twin on CPU tensors), which
writes S * mask of each live stem straight into the inverse's input and
stores no mask; soft and SSE masks are float32 tensor math. Both round
as the JAX engine does.
Each phase of a pass opens its span (``runtime/profiling.span``):
``zen.analyze`` (``analyze_features``), ``zen.k1`` (``time_filtered_tail``
and its pair form), ``zen.k2`` (``freq_filtered``), ``zen.mask``
(``masked_spectra``) and ``zen.synth`` (``synthesize_masked``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ZenError
from ..ops import box
from ..ops import fft as zfft
from ..ops import mask_cuda, median_cuda, windows
from ..runtime.profiling import span
from .config import EPS, VALID, HPRConfig

STEMS = ("harmonic", "percussive", "residual")


def num_bins(cfg: HPRConfig) -> int:
    """Frequency bins carried through the pipeline."""
    return cfg.nfft // 2 + 1 if cfg.fast_rfft else cfg.nfft


def prefill_value(cfg: HPRConfig) -> float:
    """Feature value of a zero prefill frame: |0| = 0 for the median
    path, 1/0^2 = +inf for the SSE reciprocal feature (IEEE, as the
    reference's CUDA float math)."""
    return float("inf") if cfg.use_sse else 0.0


def dft_mode(cfg: HPRConfig) -> str | None:
    """The transform seam (zen_tpu's ``_dft_precision``): the DFT mode
    of ``fft_impl`` ('dft', 'dft_bf16', 'dft_f32'), or None for
    torch.fft. The DFT matmuls compute the half spectrum only, so the
    exact C2C path (fast_rfft off) always takes torch.fft, as in
    zen_tpu."""
    return cfg.fft_impl if cfg.fast_rfft and cfg.fft_impl in zfft.DFT_MODES else None


@functools.lru_cache(maxsize=16)
def _window(nwin: int, device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (size, device), not one per step
    return torch.from_numpy(windows.sqrt_hann(nwin)).to(device)


def _windowed(frames: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    return frames.to(torch.float32) * _window(cfg.nwin, frames.device)


def analyze(frames: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """Window + FFT: [..., T, nwin] -> complex spectra [..., T, bins]
    (hps.cu:455-465)."""
    xw = _windowed(frames, cfg)
    mode = dft_mode(cfg)
    if mode is not None:
        return zfft.rfft_forward_dft(xw, cfg.nfft, mode)
    if cfg.fast_rfft:
        return zfft.rfft_forward(xw, cfg.nfft)
    return zfft.fft_forward(xw.to(torch.complex64), cfg.nfft)


def analyze_features(frames: torch.Tensor, cfg: HPRConfig, dtype=None) -> tuple:
    """(spectra, features) of frames [..., T, nwin]: ``analyze``, |S| and
    ``feature_transform``, the features cast to ``dtype`` where given."""
    with span("zen.analyze", frames):
        s = analyze(frames, cfg)
        feats = feature_transform(s.abs(), cfg)
        return s, feats if dtype is None else feats.to(dtype)


def feature_transform(mag: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """The quantity the directional filters run on: |S| for the median
    path (hps.cu:492-493), 1/|S|^2 for the SSE path (hps.cu:586-592)."""
    if cfg.use_sse:
        return 1.0 / (mag * mag)
    return mag


def _check_median_route(cfg: HPRConfig, x: torch.Tensor) -> None:
    """Raise when the tensors' device contradicts ``median_impl``:
    'cuda' takes CUDA tensors only, 'torch' (the plain reference) CPU
    tensors only, 'auto' either."""
    if cfg.median_impl == "cuda" and not x.is_cuda:
        raise ZenError("median_impl='cuda' needs CUDA tensors")
    if cfg.median_impl == "torch" and x.is_cuda:
        raise ZenError(
            "median_impl='torch' runs the plain reference on CPU tensors "
            "only; CUDA tensors take 'auto' or 'cuda'"
        )


def _time_median(
    a: torch.Tensor, b: torch.Tensor, cfg: HPRConfig, start: int
) -> torch.Tensor:
    _check_median_route(cfg, a)
    return median_cuda.tap_median_time(
        a, b, cfg.time_offsets, start, prefill_value(cfg)
    )


def time_filtered(feats: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """Time-direction filter over all T rows of feats [..., T, bins]
    (the offline passes); out-of-range frames read the zero-prefill
    feature."""
    return time_filtered_tail(feats, cfg, 0)


def time_filtered_tail(
    feats: torch.Tensor, cfg: HPRConfig, start: int
) -> torch.Tensor:
    """Time-direction filter of feats [..., T, bins] for output rows
    start..T-1 as float32; taps before row 0 read the zero-prefill
    feature (K1's one-input form). Zeros where the reference never
    writes the lag row (offline 'valid', ``cfg.lag_row_written``). The
    SSE mean always sums float32 taps: a bf16 sum would round
    otherwise."""
    with span("zen.k1", feats):
        return _time_filtered_tail(feats, cfg, start)


def _time_filtered_tail(feats: torch.Tensor, cfg: HPRConfig, start: int) -> torch.Tensor:
    if not cfg.lag_row_written:
        return feats.new_zeros(feats[..., start:, :].shape, dtype=torch.float32)
    if cfg.use_sse:
        return box.sliding_mean(
            feats.float(), cfg.time_offsets, -2, "zero", prefill_value(cfg)
        )[..., start:, :]
    return _time_median(feats, feats[..., :0, :], cfg, start).float()


def time_filtered_tail_pair(
    hist: torch.Tensor, fresh: torch.Tensor, cfg: HPRConfig
) -> torch.Tensor:
    """time_filtered_tail over the virtual concat [hist ++ fresh] for
    the fresh rows (start = hist rows): the streaming step's form, as
    float32. On the kernel route the concat is never materialized. A
    bf16 history yields bf16-exact values (the median is selection).
    The SSE mean takes the materialized concat, as zen_tpu's does."""
    with span("zen.k1", fresh):
        if cfg.use_sse:
            feats = torch.cat([hist, fresh.to(hist.dtype)], dim=-2)
            return _time_filtered_tail(feats, cfg, hist.shape[-2])
        return _time_median(hist, fresh, cfg, hist.shape[-2]).float()


_FREQ_MODE = {"wrap": "wrap", "clamp": "edge"}


def freq_filtered(feats: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """Frequency-direction median along the last dim (per frame), as
    float32 (the median runs on the features' dtype, the SSE mean on
    float32 taps, as the time filter's does). The half spectrum's reflect boundary evaluates the
    full spectrum's wrap window (zen_tpu/engine/spectral.py:284);
    replicate clamps ('edge'); 'valid' runs the forward window over k-1
    zeros padded on the right and zeroes every bin above nb-k-1, which
    NPP's valid ROI never writes (mfilt.h:152). The SSE box mean runs
    under the same boundary rule (its border is never 'valid')."""
    with span("zen.k2", feats):
        if cfg.use_sse:
            boundary = "reflect" if cfg.fast_rfft else cfg.freq_boundary
            return box.sliding_mean(feats.float(), cfg.freq_offsets, -1, boundary)
        _check_median_route(cfg, feats)
        k = cfg.freq_filter_len
        if cfg.border == VALID:
            nb = feats.shape[-1]
            xp = torch.nn.functional.pad(feats, (0, k - 1))
            p = median_cuda.sliding_median_boundary(xp, k, "valid")
            p[..., nb - k :] = 0.0
            return p.float()
        mode = "reflect" if cfg.fast_rfft else _FREQ_MODE[cfg.freq_boundary]
        return median_cuda.sliding_median_boundary(feats, k, mode).float()


def finalize_features(h: torch.Tensor, p: torch.Tensor, cfg: HPRConfig):
    """Filtered features as the masks read them: the medians as they
    are; the SSE means re-reciprocated and scaled by (l + 1)
    (hps.cu:598-604)."""
    if cfg.use_sse:
        h = (1.0 / h) * _f32(cfg.l_harm + 1.0)
        p = (1.0 / p) * _f32(cfg.l_perc + 1.0)
    return h, p


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(np.float32(v))


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by repeated squaring in the order jax.lax.integer_pow uses,
    so soft masks round as the JAX engine's do."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def compute_masks(h: torch.Tensor, p: torch.Tensor, cfg: HPRConfig):
    """(pm, hm, rm) percussive / harmonic / residual masks, float32.

    Hard mask (hps.h:100-113): ``mask_cuda.hard_masks``, (x / (y + eps))
    >= beta, the harmonic mask against beta - eps so ties go percussive
    (hps.cu:540); residual 1 - (hm + pm) with a disabled stem's mask taken
    as 0 (hps.cu:562-567). Soft/Wiener mask (hps.h:116-129): x^n / (x^n +
    y^n + eps) with n = int(beta); SSE mask (hps.h:132-140): x^2 / (x^2 +
    y^2 + eps); neither has a residual (None). Constants are float32
    scalars.
    """
    eps = _f32(EPS)
    if cfg.use_sse:
        pp, hh = p * p, h * h
        return pp / (pp + hh + eps), hh / (hh + pp + eps), None
    if cfg.soft_mask:
        n = cfg.soft_power
        hp, pp = _integer_pow(h, n), _integer_pow(p, n)
        return pp / (pp + hp + eps), hp / (hp + pp + eps), None
    return mask_cuda.hard_masks(h, p, cfg.beta, EPS, cfg.output_harmonic,
                                cfg.output_percussive)


def feature_masks(h: torch.Tensor, p: torch.Tensor, cfg: HPRConfig):
    """``compute_masks`` of the filtered features h and p as the masks
    read them (``finalize_features``): (pm, hm, rm)."""
    return compute_masks(*finalize_features(h, p, cfg), cfg)


def stem_masks(h: torch.Tensor, p: torch.Tensor, cfg: HPRConfig) -> tuple:
    """``feature_masks`` in STEMS order: (harmonic, percussive, residual)."""
    pm, hm, rm = feature_masks(h, p, cfg)
    return hm, pm, rm


def live_stems(cfg: HPRConfig) -> tuple:
    """Indices into STEMS of the enabled stems that have a mask (the
    residual has none under soft and SSE masks)."""
    return tuple(i for i, name in enumerate(STEMS) if getattr(cfg, f"output_{name}")
                 and not (name == "residual" and (cfg.use_sse or cfg.soft_mask)))


def masked_spectra(s: torch.Tensor, h: torch.Tensor, p: torch.Tensor, cfg: HPRConfig,
                   live: tuple, dim: int) -> torch.Tensor:
    """S * mask of each stem of ``live`` (indices into STEMS, each with a
    mask) under the masks of the filtered features h and p, stacked along
    a new axis at ``dim`` of s [..., T, bins]; each stem's slice is
    contiguous. Hard masks take ``mask_cuda.mask_apply`` (the kernel on
    CUDA tensors, which stores no mask; its twin on CPU tensors), soft and
    SSE masks the tensor path. Span ``zen.mask``."""
    with span("zen.mask", s):
        if not (cfg.use_sse or cfg.soft_mask):
            return mask_cuda.mask_apply(s, h, p, cfg.beta, EPS, live, cfg.output_harmonic,
                                        cfg.output_percussive, dim)
        masks = stem_masks(h, p, cfg)
        return torch.stack([s * masks[i] for i in live], dim=dim)


def synthesize_spectrum(masked: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """Inverse FFT of a masked spectrum, scaled, truncated to nwin:
    [..., T, nwin].

    y = Re(IFFT(masked)) * nfft * COLA — the unnormalized backward
    transform (fftw.h:40-43) folded with the OLA COLA factor
    (hps.h:68-80) into one float32 scale.
    """
    mode = dft_mode(cfg)
    if mode is not None:
        return zfft.irfft_head_dft(masked, cfg.nfft, cfg.nwin, mode) * _f32(cfg.synth_scale)
    if cfg.fast_rfft:
        y = zfft.irfft(masked, cfg.nfft)
    else:
        y = zfft.ifft_real(masked)
    return y[..., : cfg.nwin] * _f32(cfg.synth_scale)


class FrameMasks(NamedTuple):
    """The masks half of a pass: the spectra and the filtered features
    whose masks the synthesis half applies."""

    spectra: torch.Tensor  # [..., T, bins] complex
    h: torch.Tensor  # [..., T, bins] time-filtered features, float32
    p: torch.Tensor  # [..., T, bins] frequency-filtered features, float32
    cfg: HPRConfig

    @property
    def masks(self) -> tuple:
        """(harmonic, percussive, residual) masks [..., T, bins], the
        residual None under soft and SSE masks: formed on demand, for the
        instruments; the synthesis half never forms them."""
        return stem_masks(self.h, self.p, self.cfg)


def frame_masks(frames: torch.Tensor, cfg: HPRConfig) -> FrameMasks:
    """The masks half of zen_tpu's ``separate_frames``: window + FFT,
    |S| and both medians of frames [..., T, nwin]. Split from the
    synthesis half so that a flip recount runs the very masks the stems
    come from."""
    s, feats = analyze_features(frames, cfg)
    return FrameMasks(s, time_filtered(feats, cfg), freq_filtered(feats, cfg), cfg)


def synthesize_masked(fm: FrameMasks) -> dict:
    """The synthesis half of zen_tpu's ``separate_frames``: per-frame
    scaled iFFTs [..., T, nwin] of each enabled stem with a mask, None
    otherwise. The masked spectra of the live stems are formed at once
    (``masked_spectra``, [L, ..., T, bins]); each stem's inverse runs on
    its own slice, as a batch's rows change cuFFT's bits."""
    cfg, out = fm.cfg, dict.fromkeys(STEMS)
    live = live_stems(cfg)
    if live:
        masked = masked_spectra(fm.spectra, fm.h, fm.p, cfg, live, 0)
    with span("zen.synth", fm.spectra):
        for row, i in enumerate(live):
            out[STEMS[i]] = synthesize_spectrum(masked[row], cfg)
    return out
