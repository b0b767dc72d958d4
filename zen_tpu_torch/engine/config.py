"""HPR engine configuration and derived parameters, without JAX.

Counterpart of ``zen_tpu/engine/config.py`` (which imports jax through
``zen_tpu.ops.median``). Every derived field is computed the same way,
bit for bit: ``_roundf`` rounds half away from zero in numpy float32,
as C ``roundf`` does in the reference (libzen/hps.h:216-285).

The reference's backend/border variants collapse to one ``border``
knob, as in zen_tpu:
  'wrap'      == reference GPU with copy_bord (default of both drivers)
  'valid'     == reference GPU --nocopybord
  'replicate' == reference CPU (IPP) backend
Each reduces to a static list of time tap offsets (``time_offsets``)
plus a frequency window and boundary rule. ``stream_state`` 'f32' or
'bf16' is the dtype of the streaming drivers' feature history.
``use_sse`` selects the SSE box filter, and as in zen_tpu turns the
'valid' border into 'wrap' (the reference's box filter always pads).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..errors import ZenError
from ..ops import windows
from ..ops.median import REPLICATE, VALID, WRAP, odd_filter_len

# output flags — mirror zen::hps::OUTPUT_* (libzen/libzen/hps.h:25-27)
OUTPUT_HARMONIC = 1
OUTPUT_PERCUSSIVE = 1 << 1
OUTPUT_RESIDUAL = 1 << 2
OUTPUT_ALL = OUTPUT_HARMONIC | OUTPUT_PERCUSSIVE | OUTPUT_RESIDUAL

EPS = float(np.finfo(np.float32).eps)  # std::numeric_limits<float>::epsilon


def _roundf(x: float) -> int:
    """C roundf: round half away from zero, float32 arithmetic."""
    x = np.float32(x)
    return int(np.floor(x + np.float32(0.5))) if x >= 0 else -int(
        np.floor(-x + np.float32(0.5))
    )


@dataclasses.dataclass(frozen=True)
class HPRConfig:
    """Static configuration for one HPR separation stage."""

    fs: float
    hop: int
    beta: float = 2.0
    causal: bool = False  # False = TimeAnticausal (offline), True = realtime
    border: str = WRAP  # 'wrap' | 'valid' | 'replicate'
    outputs: int = OUTPUT_ALL
    use_sse: bool = False  # SSE box-filter variant (hps.cu:582-652)
    soft_mask: bool = False  # Wiener soft mask (hps.h:116-129)
    fast_rfft: bool = True  # Hermitian half-spectrum fast path
    median_impl: str = "auto"  # 'auto' | 'torch' | 'cuda': 'auto' runs
    # the CUDA kernels on CUDA tensors and their plain twins on CPU
    # tensors; 'torch' (the plain reference) takes CPU tensors only and
    # 'cuda' CUDA tensors only; the other device raises
    fft_impl: str = "auto"  # 'auto' | 'torch' | 'dft' | 'dft_bf16' |
    # 'dft_f32': 'auto' is stored as 'torch' (torch.fft, cuFFT on the
    # card), as zen_tpu's 'auto' is XLA's FFT off the TPU; the 'dft*'
    # names are the DFT-matmul transform at its precision (ops/fft.py),
    # taken where fast_rfft holds
    stream_state: str = "f32"  # 'f32' | 'bf16': dtype of the streaming
    # drivers' carried feature history; 'bf16' quantizes the features
    # both medians see (selection, so the kernels pick exactly what f32
    # would on those values) while masks and synthesis stay float32

    def __post_init__(self):
        if self.hop <= 0 or (self.hop & (self.hop - 1)) != 0:
            raise ZenError("hop must be a positive power of two")
        if self.border not in (WRAP, VALID, REPLICATE):
            raise ZenError(f"unknown border mode: {self.border}")
        if self.l_harm < 1:
            raise ZenError("hop too large for fs: l_harm < 1")
        if self.time_filter_len > self.stft_width:
            raise ZenError("median filter bigger than matrix dimension")
        if self.freq_filter_len > self.nfft:
            raise ZenError("median filter bigger than matrix dimension")
        if self.median_impl not in ("auto", "torch", "cuda"):
            raise ZenError(f"unknown median_impl: {self.median_impl}")
        if self.fft_impl not in ("auto", "torch", "dft", "dft_bf16", "dft_f32"):
            raise ZenError(f"unknown fft_impl: {self.fft_impl}")
        if self.fft_impl == "auto":
            object.__setattr__(self, "fft_impl", "torch")
        if self.stream_state not in ("f32", "bf16"):
            raise ZenError(f"unknown stream_state: {self.stream_state}")
        if self.use_sse and self.border == VALID:
            # the reference's BoxFilterGPU always pads (box.h:154-180);
            # before the fast_rfft demotion, so SSE keeps the half spectrum
            object.__setattr__(self, "border", WRAP)
        if self.fast_rfft and self.border in (VALID, REPLICATE):
            # nocopybord zeroes high bins asymmetrically; replicate
            # clamps at DC, which the half spectrum's reflect boundary
            # cannot emulate near bin 0: both need the full C2C path
            object.__setattr__(self, "fast_rfft", False)
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

    # ---- decoded engine tap patterns ----
    @functools.cached_property
    def time_offsets(self) -> tuple:
        """Frame-index offsets (relative to the output frame) whose
        median gives the time-direction filtered value at the lag row
        (decode: zen_tpu/ops/median.py header)."""
        fl = self.time_filter_len
        fm = fl // 2
        if not self.causal:
            # the lag row is interior for every border: pure centered
            return tuple(range(-fm, fm + 1))
        if self.border == WRAP:
            # centered window at the newest row; the future half wraps
            # around to the *oldest* frames of the sliding window
            sw = self.stft_width
            wrapped = tuple(range(-(sw - 1), -(sw - 1) + fm))
            return wrapped + tuple(range(-fm, 1))
        if self.border == VALID:
            # anchor at the mask tip: strictly the previous fl frames
            return tuple(range(-fl, 0))
        # REPLICATE: centered at the last row, future half clamps to it
        return tuple(range(-fm, 0)) + (0,) * (fm + 1)

    @property
    def time_history(self) -> int:
        """Frames of magnitude history a causal stream must carry."""
        return max(0, -min(self.time_offsets))

    @property
    def lag_row_written(self) -> bool:
        """Whether the reference's time-direction filter ever writes the
        lag row. NPP valid-ROI anticausal writes only rows
        [fm, stft_width-fm-2] (mfilt.h:123-145); when the lag row falls
        outside, the reference masks against an all-zero harmonic
        matrix. Causal valid, wrap and replicate always write it."""
        if self.border != VALID or self.causal:
            return True
        fm = self.time_filter_len // 2
        return fm <= self.l_harm <= self.stft_width - fm - 2

    @functools.cached_property
    def freq_offsets(self) -> tuple:
        """Bin offsets for the frequency-direction filter (per frame)."""
        fl = self.freq_filter_len
        fm = fl // 2
        if self.border == VALID:
            return tuple(range(0, fl))  # forward window (mfilt.h:146-160)
        return tuple(range(-fm, fm + 1))

    @property
    def freq_boundary(self) -> str:
        """Boundary rule along the full frequency axis."""
        if self.border == WRAP:
            return "wrap"
        if self.border == REPLICATE:
            return "clamp"
        return "zero"  # valid: plus output zeroing of the high bins

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
