"""Plain PyTorch reference of HPR separation, for judging the port's outputs.

Written from the reference C++ engine's per-hop state machine
(sevagh/Zen, libzen/hps.cu:429-565, hps.h:152-322): an input ring of
nwin = 2 hop samples, a sliding matrix of stft_width = 2 l_harm full
spectra (nfft = 4 hop bins, complex), a median filter over the whole
matrix per hop in time (l_harm taps, wrapped in the matrix's rows) and
in frequency (l_perc taps, wrapped over all nfft bins), hard masks at
the lag row, and an overlap-add of the masked, unnormalized inverse
spectra times the COLA factor. Here the hop loop is unrolled into batch
operations on whole frame stacks, in float32, with the full C2C
spectrum (the port runs the Hermitian half spectrum).

Imports torch and numpy only: nothing of the program, and no weights,
tables or state that the program made. Runs on whatever device its
inputs lie on; the callers give it blocks of rows that fit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)  # std::numeric_limits<float>::epsilon
STEMS = ("harmonic", "percussive", "residual")
TAP_BYTES = 1 << 28  # most bytes of gathered taps a median block holds


def _roundf(x) -> int:
    """C roundf in float32: half away from zero."""
    x = np.float32(x)
    half = np.float32(0.5)
    return int(np.floor(x + half)) if x >= 0 else -int(np.floor(-x + half))


def _odd(n: int) -> int:
    return n + (1 - n % 2)


@dataclass(frozen=True)
class Stage:
    """One HPR stage's derived sizes (hps.h:216-285)."""

    fs: float
    hop: int
    beta: float
    causal: bool
    stems: tuple  # names of the stems it emits
    border: str = "wrap"  # copy_bord, the reference GPU drivers' default; the only one here

    def __post_init__(self):
        if self.border != "wrap":
            raise ValueError(f"the reference implements the 'wrap' border, not {self.border!r}")

    @property
    def nwin(self) -> int:
        return 2 * self.hop

    @property
    def nfft(self) -> int:
        return 4 * self.hop

    @property
    def l_harm(self) -> int:
        return _roundf(np.float32(0.2) / (np.float32(self.nfft - self.hop) / np.float32(self.fs)))

    @property
    def l_perc(self) -> int:
        return _roundf(np.float32(500) / (np.float32(self.fs) / np.float32(self.nfft)))

    @property
    def lag(self) -> int:
        return 1 if self.causal else self.l_harm

    @property
    def time_taps(self) -> tuple:
        """Frame offsets, relative to the masked frame, that the time
        median reads. The matrix holds frames n - sw + 1 .. n at hop n;
        its row r = sw - lag is masked and holds frame m = n - lag + 1,
        and the centred window around r wraps in the matrix's rows
        (copy_bord): row (r + o) mod sw holds frame m - r + (r + o) mod sw."""
        sw, fm = 2 * self.l_harm, _odd(self.l_harm) // 2
        r = sw - self.lag
        return tuple(((r + o) % sw) - r for o in range(-fm, fm + 1))

    @property
    def history(self) -> int:
        """Frames before the masked one that its taps reach."""
        return max(0, -min(self.time_taps))

    @property
    def freq_taps(self) -> int:
        return _odd(self.l_perc)


def sqrt_hann(n: int, device) -> torch.Tensor:
    k = np.arange(n, dtype=np.float64)
    return torch.from_numpy(np.sqrt(0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)).to(device)


def synth_scale(st: Stage) -> float:
    """nfft (the unnormalized inverse) times the COLA factor nfft / sum(w^2)."""
    w = sqrt_hann(st.nwin, "cpu").double()
    return st.nfft * st.nfft / float((w * w).sum())


def _time_median(mag: torch.Tensor, taps: tuple, first: int, count: int) -> torch.Tensor:
    """Medians over ``taps`` of frames first .. first + count - 1 of mag
    [..., T, F]; frames before 0 read 0 (the zeroed matrix)."""
    lead = -min(0, first + min(taps))
    padded = torch.nn.functional.pad(mag, (0, 0, lead, 0))
    idx = torch.tensor([[first + lead + i + o for o in taps] for i in range(count)])
    taps_x = padded[..., idx.to(mag.device), :]  # [..., count, K, F]
    return taps_x.median(dim=-2).values


def _freq_median(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Centred median of k bins over the last dim, wrapped (copy_bord)."""
    fm = k // 2
    ext = torch.cat([mag[..., -fm:], mag, mag[..., :fm]], dim=-1) if fm else mag
    return ext.unfold(-1, k, 1).median(dim=-1).values


def _masks(st: Stage, hrow: torch.Tensor, prow: torch.Tensor) -> dict:
    """hps.h:100-113 and hps.cu:530-567: ties go percussive; the residual
    takes the masks of the enabled stems only."""
    eps, beta = np.float32(EPS), np.float32(st.beta)
    pm = (prow / (hrow + eps) >= beta).float()
    hm = (hrow / (prow + eps) >= np.float32(beta - eps)).float()
    zero = torch.zeros_like(pm)
    used = (hm if "harmonic" in st.stems else zero) + (pm if "percussive" in st.stems else zero)
    return {"harmonic": hm, "percussive": pm, "residual": 1.0 - used}


def frames_of(chunks: torch.Tensor) -> torch.Tensor:
    """[..., N, hop] chunks -> [..., N, 2 hop] frames: frame n is the
    ring after chunk n, chunks n - 1 and n (chunk -1 is the zeroed ring)."""
    prev = torch.nn.functional.pad(chunks, (0, 0, 1, 0))[..., :-1, :]
    return torch.cat([prev, chunks], dim=-1)


def stage_frames(st: Stage, frames: torch.Tensor, first: int, count: int) -> dict:
    """Scaled masked inverse spectra y [..., count, nwin] of frames first ..
    first + count - 1 of frames [..., T, nwin], per emitted stem. The
    frames' spectra are taken whole; the medians and the inverse run
    in blocks of rows."""
    win = sqrt_hann(st.nwin, frames.device)
    spec = torch.fft.fft(frames * win, n=st.nfft, dim=-1)
    mag = spec.abs()
    scale = np.float32(synth_scale(st))
    lead = frames.shape[:-2]
    rows_per = max(1, TAP_BYTES // (4 * st.nfft * max(len(st.time_taps), st.freq_taps)
                                   * max(1, math.prod(lead))))
    out = {name: [] for name in st.stems}
    for lo in range(first, first + count, rows_per):
        n = min(rows_per, first + count - lo)
        h = _time_median(mag, st.time_taps, lo, n)
        p = _freq_median(mag[..., lo : lo + n, :], st.freq_taps)
        masks = _masks(st, h, p)
        for name in st.stems:
            y = torch.fft.ifft(spec[..., lo : lo + n, :] * masks[name], dim=-1)
            out[name].append(y.real[..., : st.nwin] * scale)
    return {name: torch.cat(ys, dim=-2) for name, ys in out.items()}


def overlap_add(y: torch.Tensor, hop: int) -> torch.Tensor:
    """Chunk j = y[j][:hop] + y[j - 1][hop:] (y[-1] = 0): [..., T, 2 hop] -> [..., T hop]."""
    tail = torch.nn.functional.pad(y[..., hop:], (0, 0, 1, 0))[..., :-1, :]
    return (y[..., :hop] + tail).flatten(-2)


def causal_stream(st: Stage, chunks: torch.Tensor, warm: int) -> dict:
    """The causal engine (zen fakert) over chunks [S, N, hop], each row a
    stream whose earlier audio is silence: {stem: [S, (N - warm) hop]},
    the output hops warm .. N - 1 (output hop n = y_n[:hop] + y_{n-1}[hop:])."""
    frames = frames_of(chunks)
    ys = stage_frames(st, frames, warm - 1, chunks.shape[-2] - warm + 1)
    return {name: overlap_add(y, st.hop)[..., st.hop :] for name, y in ys.items()}


def mixture(st: Stage, chunks: torch.Tensor, warm: int) -> torch.Tensor:
    """What the stems of a hard mask add up to, the same hops as
    ``causal_stream``: the overlap-added windowed frames times the scale
    (the inverse of an unmasked spectrum is its frame)."""
    frames = frames_of(chunks)[..., warm - 1 :, :]
    y = frames * sqrt_hann(st.nwin, frames.device) * np.float32(synth_scale(st))
    return overlap_add(y, st.hop)[..., st.hop :]


def offline_pass(st: Stage, audio: torch.Tensor) -> dict:
    """One anticausal pass over audio [L] (hps.cu:128-178): the track is
    chunked and padded with ``lag`` chunks of zeros, streamed, shifted
    back by ``lag`` hops and cut to L. Output chunk j = y_{j+1}[:hop] +
    y_j[hop:], y_m the masked frame m."""
    length = audio.shape[-1]
    whole = -(-length // st.hop)
    padded = torch.nn.functional.pad(audio, (0, (whole + st.lag) * st.hop - length))
    frames = frames_of(padded.view(-1, st.hop))
    ys = stage_frames(st, frames, 0, whole + 1)
    return {name: overlap_add(y, st.hop)[st.hop : st.hop + length] for name, y in ys.items()}


def hpri_offline(fs: float, hop_h: int, hop_p: int, beta_h: float, beta_p: float,
                 audio: torch.Tensor) -> dict:
    """HPR-I (hps.cu:128-221): pass 1 at hop_h gives the harmonic stem;
    pass 2 at hop_p over pass 1's percussive + residual gives the
    percussive and residual stems (pass 2 emits percussive and residual)."""
    p1 = offline_pass(Stage(fs, hop_h, beta_h, False, STEMS), audio)
    inter = p1["percussive"] + p1["residual"]
    harmonic = p1["harmonic"]
    del p1
    p2 = offline_pass(Stage(fs, hop_p, beta_p, False, ("percussive", "residual")), inter)
    return {"harmonic": harmonic, **p2}
