"""Offline HPR drivers on PyTorch (counterpart of
``zen_tpu/drivers/offline.py``).

``hpr_separate`` is one anticausal HPR pass batched over all frames of a
clip; ``HPRIOffline`` mirrors zen::hps::HPRIOffline (libzen/hps.cu:
21-221), Driedger's iterative HPR-I: pass 1 at a large hop separates the
harmonic stem, pass 2 at a small hop runs over pass 1's percussive +
residual. ``hpr_separate_blocked`` is the same pass as overlap-save over
time blocks, whose spectrogram working set is one block.

As in zen_tpu, pass 2 runs with OUTPUT_PERCUSSIVE | OUTPUT_RESIDUAL, so
the residual stem carries the non-percussive remainder; ``strict_ref``
reproduces the reference binary's percussive-only pass 2, whose residual
stem is silence (hps.cu:45-48, 200-204).

zen_tpu buckets clip lengths to powers of two (``_bucket_len``) and
resolves its 'auto' transform per clip (``_resolve_auto_fft``) for XLA's
compile cache and the TPU's matmul transform; the port runs eagerly,
every clip at its true length, and its 'auto' is torch.fft ('dft*' is
taken as given). The padded frames zen_tpu adds are all-zero audio,
whose feature is the prefill value (0, or +inf under SSE) that
out-of-range taps read, so the two agree.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..engine.config import OUTPUT_ALL, OUTPUT_PERCUSSIVE, OUTPUT_RESIDUAL, HPRConfig
from ..engine.spectral import (
    STEMS,
    FrameMasks,
    analyze,
    compute_masks,
    feature_transform,
    finalize_features,
    frame_masks,
    freq_filtered,
    synthesize_masked,
    time_filtered_tail,
)
from ..device import resolve_device
from ..errors import ZenError
from ..ops.framing import frame_signal, overlap_add_stream

# Above this many samples the CLI and corpus drivers route a track to the
# blocked pass (zen_tpu/drivers/offline.py:137): the batched pass holds
# the whole spectrogram, ~160 bytes per input sample over the default
# cascade.
LONG_TRACK_SAMPLES = 600 * 48000


def _as_audio(audio) -> torch.Tensor:
    """A tensor stays on its device (as float32); anything else becomes a
    float32 CPU tensor."""
    if isinstance(audio, torch.Tensor):
        return audio.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32))


def _n_frames(length: int, cfg: HPRConfig) -> int:
    """hpss_chunk_padder (hps.cu:109-126): whole hops plus ``lag``
    warm-up frames, whose output the advance=1 assembly shifts away."""
    return math.ceil(length / cfg.hop) + cfg.lag


def pass_masks(audio: torch.Tensor, cfg: HPRConfig) -> FrameMasks:
    """The masks half of one offline pass over audio [..., L]: the
    padded frames' spectra and masks [..., frames, bins]. Frame t feeds
    output chunks t - 1 and t."""
    return frame_masks(frame_signal(audio, cfg.hop, _n_frames(audio.shape[-1], cfg)), cfg)


def pass_stems(fm: FrameMasks, cfg: HPRConfig, audio: torch.Tensor) -> dict:
    """The synthesis half of one offline pass over audio [..., L]: dict
    of [..., L] stems from the pass's masks (zeros for a disabled stem)."""
    length = audio.shape[-1]
    return {
        name: torch.zeros_like(audio) if y is None
        else overlap_add_stream(y, cfg.hop, advance=1)[..., :length]
        for name, y in synthesize_masked(fm, cfg).items()
    }


def hpr_separate(audio, cfg: HPRConfig) -> dict:
    """One offline HPR pass on [..., L] audio -> dict of [..., L] stems
    (zeros for a disabled stem), on the audio's device."""
    audio = _as_audio(audio)
    return pass_stems(pass_masks(audio, cfg), cfg, audio)


# ---------------- blocked overlap-save ----------------


@dataclasses.dataclass(frozen=True)
class _Blocking:
    """Geometry of the overlap-save pass over one track: ``n_blocks``
    blocks of ``bf`` frames, each read with ``back`` frames of tap
    context before it and ``fwd`` after it."""

    bf: int
    n_blocks: int
    back: int
    fwd: int

    @classmethod
    def of(cls, length: int, cfg: HPRConfig, block_frames: int) -> "_Blocking":
        n_frames = _n_frames(length, cfg)
        # a short track shrinks the block to its own power of two, and
        # the block count is a power of two (zen_tpu's compile sharing;
        # extra blocks process guard zeros and are cut away)
        bf = min(block_frames, 1 << (max(1, n_frames) - 1).bit_length())
        n_blocks = 1 << (max(1, -(-n_frames // bf)) - 1).bit_length()
        return cls(bf, n_blocks, cfg.time_history, max(max(cfg.time_offsets), 0))


def _blocks(audio: torch.Tensor, cfg: HPRConfig, blk: _Blocking):
    """Each block's samples [(back + bf + fwd + 1) * hop]: the raw audio
    of frames [s - back, s + bf + fwd), with frame t = samples at global
    [(t - 1) * hop, (t + 1) * hop); guard pads of zeros cover the global
    edges and the last partial block."""
    hop, length = cfg.hop, audio.shape[-1]
    guard_lo = (blk.back + 1) * hop
    guard_hi = max((blk.n_blocks * blk.bf + blk.fwd + 1) * hop - length, 0)
    padded = torch.nn.functional.pad(audio, (guard_lo, guard_hi))
    span = (blk.back + blk.bf + blk.fwd + 1) * hop
    for j in range(blk.n_blocks):
        yield padded[j * blk.bf * hop : j * blk.bf * hop + span]


def _block_masks(cfg: HPRConfig, blk: _Blocking, samples: torch.Tensor) -> FrameMasks:
    """The masks half of one block: spectra and masks of its bf core
    frames. Halo rows are tap context only: the time median runs on rows
    from ``back`` on, and the kept rows' forward taps stay inside the
    extended block."""
    seg = samples.view(blk.back + blk.bf + blk.fwd + 1, cfg.hop)
    s = analyze(torch.cat([seg[:-1], seg[1:]], dim=-1), cfg)
    feat = feature_transform(s.abs(), cfg)
    core = slice(blk.back, blk.back + blk.bf)
    h = time_filtered_tail(feat, cfg, blk.back)[: blk.bf]
    h, p = finalize_features(h, freq_filtered(feat[core], cfg), cfg)
    pm, hm, rm = compute_masks(h, p, cfg)
    return FrameMasks(s[core], (hm, pm, rm))


def blocked_pass_masks(audio: torch.Tensor, cfg: HPRConfig, block_frames: int = 2048):
    """Masks (harmonic, percussive, residual) [n_blocks * bf, bins] of
    the blocked pass over audio [L], frame-indexed as ``pass_masks``'s,
    through the same block function ``hpr_separate_blocked`` runs."""
    blk = _Blocking.of(audio.shape[-1], cfg, block_frames)
    per_block = [_block_masks(cfg, blk, x).masks for x in _blocks(audio, cfg, blk)]
    return tuple(
        None if m[0] is None else torch.cat(m) for m in zip(*per_block)
    )


def hpr_separate_blocked(audio, cfg: HPRConfig, block_frames: int = 2048) -> dict:
    """``hpr_separate`` on [L] audio as sequential overlap-save over
    blocks of ``block_frames`` frames (the reference's bounded sliding
    window has the same property, hps.h:233-234): each block carries one
    OLA tail per stem into the next, so the spectrogram working set is
    one block while the waveforms stay whole. Same stems as
    ``hpr_separate`` up to the transform's batch rounding."""
    audio = _as_audio(audio)
    if audio.ndim != 1:
        raise ZenError("hpr_separate_blocked expects [L] audio")
    hop, length = cfg.hop, audio.shape[-1]
    blk = _Blocking.of(length, cfg, block_frames)
    tails = audio.new_zeros((len(STEMS), hop))
    outs = []
    for samples in _blocks(audio, cfg, blk):
        ys = synthesize_masked(_block_masks(cfg, blk, samples), cfg)
        rows, new_tails = [], []
        for tail, y in zip(tails, ys.values()):
            if y is None:
                rows.append(audio.new_zeros(blk.bf * hop))
                new_tails.append(tail)
                continue
            # chunk j = y[j][:hop] + y[j-1][hop:], the carried tail as
            # frame -1's second half
            prev = torch.nn.functional.pad(tail, (hop, 0))[None]
            rows.append(overlap_add_stream(torch.cat([prev, y]), hop, advance=1))
            new_tails.append(y[-1, hop:])
        outs.append(torch.stack(rows))
        tails = torch.stack(new_tails)
    full = torch.cat(outs, dim=1)
    # the blocked chunk of frame t lands at t * hop; the unblocked
    # advance=1 assembly starts one hop later (frame 0's chunk is the
    # warm-up it never emits)
    return {name: full[i, hop : hop + length] for i, name in enumerate(STEMS)}


# ---------------- the two-pass driver ----------------


class HPRIOffline:
    """2-pass offline HPR-I separation (hps.cu:128-221, GPU semantics).

    process(audio[..., L]) -> (harmonic, percussive, residual), each
    [..., L] float32 on ``device`` (the card unless ``device="cpu"`` is
    passed): harmonic from pass 1 (hop_h),
    percussive and residual from pass 2 (hop_p) over pass 1's
    percussive + residual. Numpy input is moved to ``device``; a tensor
    must already lie there. Further keywords (use_sse, soft_mask,
    fast_rfft, fft_impl, median_impl, ...) go to both passes' HPRConfig.
    """

    def __init__(
        self,
        fs: float,
        hop_h: int = 4096,
        hop_p: int = 256,
        beta_h: float = 2.0,
        beta_p: float = 2.0,
        strict_ref: bool = False,
        device="cuda",
        **cfg_kw,
    ):
        if hop_h % hop_p != 0:
            raise ZenError("hop_h and hop_p should be evenly divisible")
        self.device = resolve_device(device)
        self.strict_ref = bool(strict_ref)
        common = dict(fs=fs, causal=False, **cfg_kw)
        self.cfg_h = HPRConfig(hop=hop_h, beta=beta_h, outputs=OUTPUT_ALL, **common)
        p_outputs = OUTPUT_PERCUSSIVE | (0 if self.strict_ref else OUTPUT_RESIDUAL)
        self.cfg_p = HPRConfig(hop=hop_p, beta=beta_p, outputs=p_outputs, **common)

    def use_sse_filter(self):
        self._reconfig(use_sse=True)

    def use_soft_mask(self):
        self._reconfig(soft_mask=True)

    def _reconfig(self, **kw):
        self.cfg_h = dataclasses.replace(self.cfg_h, **kw)
        self.cfg_p = dataclasses.replace(self.cfg_p, **kw)

    def _on_device(self, audio) -> torch.Tensor:
        if not isinstance(audio, torch.Tensor):
            return _as_audio(audio).to(self.device)
        if audio.device != self.device:
            raise ZenError(
                f"audio lies on {audio.device}, this separator runs on {self.device}"
            )
        return audio.to(torch.float32)

    def process(self, audio):
        audio = self._on_device(audio)
        pass1 = hpr_separate(audio, self.cfg_h)
        # xp1 + xr1 feeds pass 2 (hps.cu:152-158), cut to the clip
        inter = pass1["percussive"] + pass1["residual"]
        pass2 = hpr_separate(inter, self.cfg_p)
        return pass1["harmonic"], pass2["percussive"], pass2["residual"]

    def process_blocked(
        self,
        audio,
        block_frames_h: int = 512,
        block_frames_p: int = 8192,
        ckpt_dir: str | None = None,
    ):
        """``process`` on [L] audio with both passes as overlap-save
        blocks (``hpr_separate_blocked``), for tracks whose batched
        spectrogram would not fit the card."""
        if ckpt_dir is not None:
            raise NotImplementedError(
                "mid-track checkpoints (ckpt_dir) are not ported yet "
                "(ROADMAP queue 1, item 5: host runtime)"
            )
        audio = self._on_device(audio)
        if audio.ndim != 1:
            raise ZenError("process_blocked expects [L] audio")
        pass1 = hpr_separate_blocked(audio, self.cfg_h, block_frames_h)
        inter = pass1["percussive"] + pass1["residual"]
        pass2 = hpr_separate_blocked(inter, self.cfg_p, block_frames_p)
        return pass1["harmonic"], pass2["percussive"], pass2["residual"]
