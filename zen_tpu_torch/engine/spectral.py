"""Batched spectral HPR core on PyTorch (counterpart of
``zen_tpu/engine/spectral.py``).

Every function takes tensors with arbitrary leading batch dims
([..., T, F]); the streaming driver passes [streams, frames, bins], the
offline driver [..., frames, bins] over a whole clip.
The two median directions go through the kernel wrappers of
``ops/median_cuda.py``: the CUDA kernels on CUDA tensors, their plain
twins on CPU tensors. ``median_impl`` only pins which of the two the
caller expects, and a mismatch raises, so no median on CUDA tensors
ever runs the plain twin. The transform is ``torch.fft`` (cuFFT on the
card); masks and synthesis are float32 tensor math, written to round
as the JAX engine does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ZenError
from ..ops import fft as zfft
from ..ops import median_cuda, windows
from .config import EPS, VALID, HPRConfig

STEMS = ("harmonic", "percussive", "residual")


def num_bins(cfg: HPRConfig) -> int:
    """Frequency bins carried through the pipeline."""
    return cfg.nfft // 2 + 1 if cfg.fast_rfft else cfg.nfft


def prefill_value(cfg: HPRConfig) -> float:
    """Feature value of a zero prefill frame: |0| = 0 for the median
    path (the SSE slice will add its +inf)."""
    return 0.0


@functools.lru_cache(maxsize=16)
def _window(nwin: int, device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (size, device), not one per step
    return torch.from_numpy(windows.sqrt_hann(nwin)).to(device)


def analyze(frames: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """Window + FFT: [..., T, nwin] -> complex spectra [..., T, bins]
    (hps.cu:455-465)."""
    xw = frames.to(torch.float32) * _window(cfg.nwin, frames.device)
    if cfg.fast_rfft:
        return zfft.rfft_forward(xw, cfg.nfft)
    return zfft.fft_forward(xw.to(torch.complex64), cfg.nfft)


def feature_transform(mag: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """The quantity the directional filters run on: |S| for the median
    path (hps.cu:492-493)."""
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
    """Time-direction median over all T rows of feats [..., T, bins]
    (the offline passes); out-of-range frames read the zero-prefill
    feature."""
    return time_filtered_tail(feats, cfg, 0)


def time_filtered_tail(
    feats: torch.Tensor, cfg: HPRConfig, start: int
) -> torch.Tensor:
    """Time-direction median of feats [..., T, bins] for output rows
    start..T-1 as float32; taps before row 0 read the zero-prefill
    feature (K1's one-input form). Zeros where the reference never
    writes the lag row (offline 'valid', ``cfg.lag_row_written``)."""
    if not cfg.lag_row_written:
        return feats.new_zeros(feats[..., start:, :].shape, dtype=torch.float32)
    return _time_median(feats, feats[..., :0, :], cfg, start).float()


def time_filtered_tail_pair(
    hist: torch.Tensor, fresh: torch.Tensor, cfg: HPRConfig
) -> torch.Tensor:
    """time_filtered_tail over the virtual concat [hist ++ fresh] for
    the fresh rows (start = hist rows): the streaming step's form, as
    float32. On the kernel route the concat is never materialized. A
    bf16 history yields bf16-exact values (the median is selection)."""
    return _time_median(hist, fresh, cfg, hist.shape[-2]).float()


_FREQ_MODE = {"wrap": "wrap", "clamp": "edge"}


def freq_filtered(feats: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """Frequency-direction median along the last dim (per frame), in the
    features' dtype. The half spectrum's reflect boundary evaluates the
    full spectrum's wrap window (zen_tpu/engine/spectral.py:284);
    replicate clamps ('edge'); 'valid' runs the forward window over k-1
    zeros padded on the right and zeroes every bin above nb-k-1, which
    NPP's valid ROI never writes (mfilt.h:152)."""
    _check_median_route(cfg, feats)
    k = cfg.freq_filter_len
    if cfg.border == VALID:
        nb = feats.shape[-1]
        xp = torch.nn.functional.pad(feats, (0, k - 1))
        p = median_cuda.sliding_median_boundary(xp, k, "valid")
        p[..., nb - k :] = 0.0
        return p
    mode = "reflect" if cfg.fast_rfft else _FREQ_MODE[cfg.freq_boundary]
    return median_cuda.sliding_median_boundary(feats, k, mode)


def finalize_features(h: torch.Tensor, p: torch.Tensor, cfg: HPRConfig):
    """Filtered features as the masks read them; the median path uses
    them as they are (the SSE slice adds its re-reciprocation,
    hps.cu:598-604)."""
    return h, p


def filter_features(mag: torch.Tensor, cfg: HPRConfig):
    """Time- and frequency-direction filtered features (H, P) of |S|
    [..., T, bins] for every frame at once: the reference's harmonic and
    percussive matrices at the lag row (hps.cu:488-496)."""
    feats = feature_transform(mag, cfg)
    h, p = time_filtered(feats, cfg), freq_filtered(feats, cfg)
    return finalize_features(h, p, cfg)


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

    Hard mask (hps.h:100-113): (x / (y + eps)) >= beta, the harmonic
    mask against beta - eps so ties go percussive (hps.cu:540); residual
    1 - (hm + pm) with a disabled stem's mask taken as 0 (hps.cu:562-567).
    Soft/Wiener mask (hps.h:116-129): x^n / (x^n + y^n + eps) with
    n = int(beta), and no residual (None). Constants are float32 scalars.
    """
    eps = _f32(EPS)
    if cfg.soft_mask:
        n = cfg.soft_power
        hp, pp = _integer_pow(h, n), _integer_pow(p, n)
        return pp / (pp + hp + eps), hp / (hp + pp + eps), None
    beta = _f32(cfg.beta)
    pm = (p / (h + eps) >= beta).to(torch.float32)
    hm = (h / (p + eps) >= beta - eps).to(torch.float32)
    hm_eff = hm if cfg.output_harmonic else torch.zeros_like(hm)
    pm_eff = pm if cfg.output_percussive else torch.zeros_like(pm)
    return pm, hm, 1.0 - (hm_eff + pm_eff)


def synthesize(s: torch.Tensor, mask: torch.Tensor, cfg: HPRConfig) -> torch.Tensor:
    """Masked inverse FFT, scaled, truncated to nwin: [..., T, nwin].

    y = Re(IFFT(S * mask)) * nfft * COLA — the unnormalized backward
    transform (fftw.h:40-43) folded with the OLA COLA factor
    (hps.h:68-80) into one float32 scale.
    """
    masked = s * mask
    if cfg.fast_rfft:
        y = zfft.irfft(masked, cfg.nfft)
    else:
        y = zfft.ifft_real(masked)
    return y[..., : cfg.nwin] * _f32(cfg.synth_scale)


class FrameMasks(NamedTuple):
    spectra: torch.Tensor  # [..., T, bins] complex
    masks: tuple  # (harmonic, percussive, residual) [..., T, bins]; the
    # residual is None under soft masks


def frame_masks(frames: torch.Tensor, cfg: HPRConfig) -> FrameMasks:
    """The masks half of zen_tpu's ``separate_frames``: window + FFT,
    |S|, both medians and the masks of frames [..., T, nwin]. Split from
    the synthesis half so that a flip recount runs the very masks the
    stems come from."""
    s = analyze(frames, cfg)
    pm, hm, rm = compute_masks(*filter_features(s.abs(), cfg), cfg)
    return FrameMasks(s, (hm, pm, rm))


def synthesize_masked(fm: FrameMasks, cfg: HPRConfig) -> dict:
    """The synthesis half of zen_tpu's ``separate_frames``: per-frame
    scaled iFFTs [..., T, nwin] of each enabled stem with a mask, None
    otherwise."""
    out = {}
    for name, mask in zip(STEMS, fm.masks):
        enabled = getattr(cfg, f"output_{name}") and mask is not None
        out[name] = synthesize(fm.spectra, mask, cfg) if enabled else None
    return out
