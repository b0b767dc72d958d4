"""HPR engine configuration and derived parameters, without JAX.

Counterpart of ``zen_tpu/engine/config.py`` (which imports jax through
``zen_tpu.ops.median``). Every derived field is computed the same way,
bit for bit: ``_roundf`` rounds half away from zero in numpy float32,
as C ``roundf`` does in the reference (libzen/hps.h:216-285).

Scope of this slice: ``border='wrap'`` with the median filters, hard or
soft masks, ``fast_rfft`` on or off. The SSE box filter, the 'valid'
and 'replicate' borders and the bf16 stream state raise
``NotImplementedError`` until their slices land (ROADMAP queue 1,
item 7), so their tap geometry and fast_rfft demotions are not carried
here.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..errors import ZenError
from ..ops import windows

# output flags — mirror zen::hps::OUTPUT_* (libzen/libzen/hps.h:25-27)
OUTPUT_HARMONIC = 1
OUTPUT_PERCUSSIVE = 1 << 1
OUTPUT_RESIDUAL = 1 << 2
OUTPUT_ALL = OUTPUT_HARMONIC | OUTPUT_PERCUSSIVE | OUTPUT_RESIDUAL

EPS = float(np.finfo(np.float32).eps)  # std::numeric_limits<float>::epsilon

WRAP = "wrap"
_LATER_BORDERS = ("valid", "replicate")


def _roundf(x: float) -> int:
    """C roundf: round half away from zero, float32 arithmetic."""
    x = np.float32(x)
    return int(np.floor(x + np.float32(0.5))) if x >= 0 else -int(
        np.floor(-x + np.float32(0.5))
    )


def odd_filter_len(filter_len: int) -> int:
    """Force filter length odd, as the reference does (mfilt.h:89)."""
    return filter_len + (1 - filter_len % 2)


@dataclasses.dataclass(frozen=True)
class HPRConfig:
    """Static configuration for one HPR separation stage."""

    fs: float
    hop: int
    beta: float = 2.0
    causal: bool = False  # False = TimeAnticausal (offline), True = realtime
    border: str = WRAP
    outputs: int = OUTPUT_ALL
    use_sse: bool = False
    soft_mask: bool = False  # Wiener soft mask (hps.h:116-129)
    fast_rfft: bool = True  # Hermitian half-spectrum fast path
    median_impl: str = "auto"  # 'auto' | 'torch' | 'cuda': 'auto' runs
    # the CUDA kernels on CUDA tensors and their plain twins on CPU
    # tensors; 'torch' (the plain reference) takes CPU tensors only and
    # 'cuda' CUDA tensors only; the other device raises
    fft_impl: str = "auto"  # 'auto' | 'torch': stored as 'torch', the
    # one transform ported (torch.fft)
    stream_state: str = "f32"

    def __post_init__(self):
        if self.hop <= 0 or (self.hop & (self.hop - 1)) != 0:
            raise ZenError("hop must be a positive power of two")
        if self.border in _LATER_BORDERS:
            raise NotImplementedError(
                f"border={self.border!r} is not ported yet "
                "(ROADMAP queue 1, item 7: causal variants)"
            )
        if self.border != WRAP:
            raise ZenError(f"unknown border mode: {self.border}")
        if self.use_sse:
            raise NotImplementedError(
                "the SSE box filter is not ported yet "
                "(ROADMAP queue 1, item 7: causal variants)"
            )
        if self.l_harm < 1:
            raise ZenError("hop too large for fs: l_harm < 1")
        if self.time_filter_len > self.stft_width:
            raise ZenError("median filter bigger than matrix dimension")
        if self.freq_filter_len > self.nfft:
            raise ZenError("median filter bigger than matrix dimension")
        if self.median_impl not in ("auto", "torch", "cuda"):
            raise ZenError(f"unknown median_impl: {self.median_impl}")
        if self.fft_impl in ("dft", "dft_bf16", "dft_f32"):
            raise NotImplementedError(
                f"fft_impl={self.fft_impl!r}: the DFT-matmul transform is "
                "not ported yet (ROADMAP queue 1, item 3: transform)"
            )
        if self.fft_impl not in ("auto", "torch"):
            raise ZenError(f"unknown fft_impl: {self.fft_impl}")
        object.__setattr__(self, "fft_impl", "torch")
        if self.stream_state == "bf16":
            raise NotImplementedError(
                "stream_state='bf16' is not ported yet "
                "(ROADMAP queue 1, item 7: causal variants)"
            )
        if self.stream_state != "f32":
            raise ZenError(f"unknown stream_state: {self.stream_state}")
        # zen_tpu's low-fs fast_rfft demotion (config.py:114-119, fm >=
        # bins) cannot fire: freq_filter_len = 2 fm + 1 <= nfft, checked
        # above, already gives fm < nfft // 2 + 1, so the half-spectrum
        # reflect window always fits and fast_rfft is kept as given.

    # ---- derived parameters (hps.h:222-268) ----
    @property
    def nwin(self) -> int:
        return 2 * self.hop

    @property
    def nfft(self) -> int:
        return 4 * self.hop

    @functools.cached_property
    def l_harm(self) -> int:
        return _roundf(
            np.float32(0.2)
            / (np.float32(self.nfft - self.hop) / np.float32(self.fs))
        )

    @functools.cached_property
    def l_perc(self) -> int:
        return _roundf(
            np.float32(500) / (np.float32(self.fs) / np.float32(self.nfft))
        )

    @property
    def lag(self) -> int:
        return 1 if self.causal else self.l_harm

    @property
    def stft_width(self) -> int:
        return 2 * self.l_harm

    @property
    def time_filter_len(self) -> int:
        return odd_filter_len(self.l_harm)

    @property
    def freq_filter_len(self) -> int:
        return odd_filter_len(self.l_perc)

    @functools.cached_property
    def window(self) -> np.ndarray:
        return windows.sqrt_hann(self.nwin)

    @functools.cached_property
    def cola_factor(self) -> float:
        return windows.cola_factor(self.window, self.nfft)

    @property
    def synth_scale(self) -> float:
        """Scale on the (normalized) iFFT output: the reference backward
        FFT is unnormalized (x nfft) and the OLA multiplies by COLA
        (hps.h:68-80), so y = ifft * nfft * COLA."""
        return float(self.nfft) * self.cola_factor

    # ---- decoded engine tap patterns (wrap border) ----
    @functools.cached_property
    def time_offsets(self) -> tuple:
        """Frame-index offsets (relative to the output frame) whose
        median gives the time-direction filtered value at the lag row
        (decode: zen_tpu/ops/median.py header)."""
        fm = self.time_filter_len // 2
        if not self.causal:
            return tuple(range(-fm, fm + 1))
        # centered window at the newest row; the future half wraps
        # around to the *oldest* frames of the sliding window
        sw = self.stft_width
        wrapped = tuple(range(-(sw - 1), -(sw - 1) + fm))
        return wrapped + tuple(range(-fm, 1))

    @property
    def time_history(self) -> int:
        """Frames of magnitude history a causal stream must carry."""
        return max(0, -min(self.time_offsets))

    @functools.cached_property
    def freq_offsets(self) -> tuple:
        """Bin offsets for the frequency-direction filter (per frame)."""
        fm = self.freq_filter_len // 2
        return tuple(range(-fm, fm + 1))

    @property
    def freq_boundary(self) -> str:
        """Boundary rule along the full frequency axis."""
        return "wrap"

    @property
    def output_harmonic(self) -> bool:
        return bool(self.outputs & OUTPUT_HARMONIC)

    @property
    def output_percussive(self) -> bool:
        return bool(self.outputs & OUTPUT_PERCUSSIVE)

    @property
    def output_residual(self) -> bool:
        return bool(self.outputs & OUTPUT_RESIDUAL)

    @property
    def soft_power(self) -> int:
        """The reference soft-mask functor truncates beta to int
        (hps.h:117-121 'const int power' constructed from float beta)."""
        return int(self.beta)
