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
import hashlib
import math
import os
import zipfile

import numpy as np
import torch

from ..engine.config import OUTPUT_ALL, OUTPUT_PERCUSSIVE, OUTPUT_RESIDUAL, HPRConfig
from ..engine.spectral import (
    STEMS,
    FrameMasks,
    analyze_features,
    frame_masks,
    freq_filtered,
    synthesize_masked,
    time_filtered_tail,
)
from ..device import resolve_device
from ..errors import ZenError
from ..ops.framing import frame_signal, overlap_add_stream
from ..runtime.checkpoint import load_stream_state, save_stream_state_durable
from ..runtime.profiling import span

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


def on_device(audio, device: torch.device) -> torch.Tensor:
    """Audio for a driver on ``device``: anything but a tensor is moved
    there as float32; a tensor must already lie there."""
    if not isinstance(audio, torch.Tensor):
        return _as_audio(audio).to(device)
    if audio.device != device:
        raise ZenError(f"audio lies on {audio.device}, this separator runs on {device}")
    return audio.to(torch.float32)


def _n_frames(length: int, cfg: HPRConfig) -> int:
    """hpss_chunk_padder (hps.cu:109-126): whole hops plus ``lag``
    warm-up frames, whose output the advance=1 assembly shifts away."""
    return math.ceil(length / cfg.hop) + cfg.lag


def pass_masks(audio: torch.Tensor, cfg: HPRConfig) -> FrameMasks:
    """The masks half of one offline pass over audio [..., L]: the
    padded frames' spectra and filtered features [..., frames, bins]
    (``FrameMasks``; its ``masks`` on demand). Frame t feeds output
    chunks t - 1 and t."""
    return frame_masks(frame_signal(audio, cfg.hop, _n_frames(audio.shape[-1], cfg)), cfg)


def pass_stems(fm: FrameMasks, cfg: HPRConfig, audio: torch.Tensor) -> dict:
    """The synthesis half of one offline pass over audio [..., L]: dict
    of [..., L] stems from the pass's masks (zeros for a disabled stem)."""
    length = audio.shape[-1]
    ys = synthesize_masked(fm)
    with span("zen.ola", audio):
        return {
            name: torch.zeros_like(audio) if y is None
            else overlap_add_stream(y, cfg.hop, advance=1)[..., :length]
            for name, y in ys.items()
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


def _padded(audio: torch.Tensor, cfg: HPRConfig, blk: _Blocking) -> torch.Tensor:
    """The audio inside guard pads of zeros that cover the global edges
    and the last partial block."""
    guard_lo = (blk.back + 1) * cfg.hop
    guard_hi = max((blk.n_blocks * blk.bf + blk.fwd + 1) * cfg.hop - audio.shape[-1], 0)
    return torch.nn.functional.pad(audio, (guard_lo, guard_hi))


def _block_samples(padded: torch.Tensor, cfg: HPRConfig, blk: _Blocking, j: int):
    """Block j's samples [(back + bf + fwd + 1) * hop]: the raw audio of
    frames [s - back, s + bf + fwd), with frame t = samples at global
    [(t - 1) * hop, (t + 1) * hop)."""
    start = j * blk.bf * cfg.hop
    return padded[start : start + (blk.back + blk.bf + blk.fwd + 1) * cfg.hop]


def _blocks(audio: torch.Tensor, cfg: HPRConfig, blk: _Blocking):
    """Every block's samples (``_block_samples``), in order."""
    padded = _padded(audio, cfg, blk)
    for j in range(blk.n_blocks):
        yield _block_samples(padded, cfg, blk, j)


def _block_masks(cfg: HPRConfig, blk: _Blocking, samples: torch.Tensor) -> FrameMasks:
    """The masks half of one block: spectra and filtered features of its
    bf core frames. Halo rows are tap context only: the time median runs on rows
    from ``back`` on, and the kept rows' forward taps stay inside the
    extended block."""
    with span("zen.frame", samples):
        seg = samples.view(blk.back + blk.bf + blk.fwd + 1, cfg.hop)
        frames = torch.cat([seg[:-1], seg[1:]], dim=-1)
    s, feat = analyze_features(frames, cfg)
    core = slice(blk.back, blk.back + blk.bf)
    h = time_filtered_tail(feat, cfg, blk.back)[: blk.bf]
    return FrameMasks(s[core], h, freq_filtered(feat[core], cfg), cfg)


def blocked_pass_masks(audio: torch.Tensor, cfg: HPRConfig, block_frames: int = 2048):
    """Masks (harmonic, percussive, residual) [n_blocks * bf, bins] of
    the blocked pass over audio [L], frame-indexed as ``pass_masks``'s,
    through the same block function ``hpr_separate_blocked`` runs."""
    blk = _Blocking.of(audio.shape[-1], cfg, block_frames)
    per_block = [_block_masks(cfg, blk, x).masks for x in _blocks(audio, cfg, blk)]
    return tuple(
        None if m[0] is None else torch.cat(m) for m in zip(*per_block)
    )


def _block_step(cfg: HPRConfig, blk: _Blocking, samples: torch.Tensor, tails: torch.Tensor):
    """One block of the overlap-save pass: (stems [3, bf * hop], the OLA
    tails [3, hop] it carries into the next block)."""
    hop = cfg.hop
    ys = synthesize_masked(_block_masks(cfg, blk, samples))
    rows, new_tails = [], []
    with span("zen.ola", samples):
        for tail, y in zip(tails, ys.values()):
            if y is None:
                rows.append(samples.new_zeros(blk.bf * hop))
                new_tails.append(tail)
                continue
            # chunk j = y[j][:hop] + y[j-1][hop:], the carried tail as
            # frame -1's second half
            prev = torch.nn.functional.pad(tail, (hop, 0))[None]
            rows.append(overlap_add_stream(torch.cat([prev, y]), hop, advance=1))
            new_tails.append(y[-1, hop:])
        return torch.stack(rows), torch.stack(new_tails)


def _blocked_audio(audio, what: str) -> torch.Tensor:
    audio = _as_audio(audio)
    if audio.ndim != 1:
        raise ZenError(f"{what} expects [L] audio")
    return audio


def _stems(full, hop: int, length: int) -> dict:
    """The blocked chunk of frame t lands at t * hop; the unblocked
    advance=1 assembly starts one hop later (frame 0's chunk is the
    warm-up it never emits)."""
    return {name: full[i, hop : hop + length] for i, name in enumerate(STEMS)}


def hpr_separate_blocked(audio, cfg: HPRConfig, block_frames: int = 2048) -> dict:
    """``hpr_separate`` on [L] audio as sequential overlap-save over
    blocks of ``block_frames`` frames (the reference's bounded sliding
    window has the same property, hps.h:233-234): each block carries one
    OLA tail per stem into the next, so the spectrogram working set is
    one block while the waveforms stay whole. Same stems as
    ``hpr_separate`` up to the transform's batch rounding."""
    audio = _blocked_audio(audio, "hpr_separate_blocked")
    blk = _Blocking.of(audio.shape[-1], cfg, block_frames)
    tails = audio.new_zeros((len(STEMS), cfg.hop))
    outs = []
    for samples in _blocks(audio, cfg, blk):
        out, tails = _block_step(cfg, blk, samples, tails)
        outs.append(out)
    return _stems(torch.cat(outs, dim=1), cfg.hop, audio.shape[-1])


# ---------------- mid-track checkpoints ----------------


def _cfg_digest(cfg: HPRConfig) -> str:
    """Fingerprint of a config, so that a resumed run never continues a
    track started under other parameters (zen_tpu's: its config's repr
    differs, so its checkpoints restart here)."""
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:16]


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _resume_point(ckpt_path: str, stems_path: str, meta_want: dict, tails, n_blocks: int,
                  stems_bytes: int):
    """(next block, OLA tails) of a checkpoint that matches ``meta_want``
    and whose stems file is whole; (0, zero tails) for a missing, stale or
    corrupt one. next_block is read before the tails are taken, so a
    corrupt one never seeds block 0 with a mid-track carry."""
    if not (os.path.exists(ckpt_path) and os.path.exists(stems_path)):
        return 0, tails
    if os.path.getsize(stems_path) != stems_bytes:
        return 0, tails
    try:
        state, meta = load_stream_state(ckpt_path, like=tails)
        if any(meta.get(k) != v for k, v in meta_want.items()):
            return 0, tails
        start = int(meta["next_block"])
    except (OSError, ValueError, KeyError, TypeError, EOFError, zipfile.BadZipFile):
        return 0, tails
    if not 0 <= start <= n_blocks:
        return 0, tails
    return start, state


def hpr_separate_blocked_checkpointed(
    audio,
    cfg: HPRConfig,
    block_frames: int = 2048,
    ckpt_dir: str | None = None,
    tag: str = "track",
    ckpt_every_blocks: int = 8,
    on_segment=None,
) -> dict:
    """``hpr_separate_blocked`` that a crash costs at most one segment.
    The block loop runs in segments of ``ckpt_every_blocks`` blocks; after
    each, the segment's stems land in ``<ckpt_dir>/<tag>.stems.f32`` (a
    float32 memmap [3, n_blocks * bf * hop], fsynced) and only then the
    OLA tails and the next block go to ``<tag>.ckpt.npz``
    (``save_stream_state_durable``, meta ``cfg``, ``bf``, ``nb``,
    ``length``, ``next_block``). A later call with the same arguments
    resumes after the last durable segment, with stems bitwise equal to
    an uninterrupted run; a checkpoint of another config or geometry, or
    a corrupt one, restarts from zero. ``on_segment(next_block,
    n_blocks)`` is called after each durable segment. Returns the same
    dict of [L] stems on the audio's device; ``ckpt_dir=None`` is
    ``hpr_separate_blocked``. ``clear_track_checkpoint`` removes the
    files once the caller has consumed the stems."""
    if ckpt_dir is None:
        return hpr_separate_blocked(audio, cfg, block_frames)
    audio = _blocked_audio(audio, "hpr_separate_blocked_checkpointed")
    hop, length = cfg.hop, audio.shape[-1]
    blk = _Blocking.of(length, cfg, block_frames)
    total = blk.n_blocks * blk.bf * hop
    os.makedirs(ckpt_dir, exist_ok=True)
    stems_path = os.path.join(ckpt_dir, f"{tag}.stems.f32")
    ckpt_path = os.path.join(ckpt_dir, f"{tag}.ckpt.npz")
    meta_want = {"cfg": _cfg_digest(cfg), "bf": blk.bf, "nb": blk.n_blocks, "length": length}
    b, tails = _resume_point(ckpt_path, stems_path, meta_want,
                             audio.new_zeros((len(STEMS), hop)), blk.n_blocks,
                             len(STEMS) * total * 4)
    if b == 0 and os.path.exists(ckpt_path):
        # a restart drops the old checkpoint first: once the stems file is
        # recreated, it no longer holds the segments that checkpoint claims
        os.remove(ckpt_path)
        _fsync_file(ckpt_dir)
    mm = np.memmap(stems_path, np.float32, mode="r+" if b > 0 else "w+",
                   shape=(len(STEMS), total))
    padded = _padded(audio, cfg, blk)
    while b < blk.n_blocks:
        ng = min(ckpt_every_blocks, blk.n_blocks - b)
        outs = []
        for j in range(b, b + ng):
            out, tails = _block_step(cfg, blk, _block_samples(padded, cfg, blk, j), tails)
            outs.append(out)
        mm[:, b * blk.bf * hop : (b + ng) * blk.bf * hop] = torch.cat(outs, dim=1).cpu().numpy()
        mm.flush()
        _fsync_file(stems_path)  # the stems are durable before a checkpoint claims them
        b += ng
        save_stream_state_durable(ckpt_path, tails, {**meta_want, "next_block": b})
        if on_segment is not None:
            on_segment(b, blk.n_blocks)
    full = torch.from_numpy(np.array(mm[:, : hop + length])).to(audio.device)
    del mm
    return _stems(full, hop, length)


def clear_track_checkpoint(ckpt_dir: str, tag: str) -> None:
    """Remove a track's mid-track checkpoint files (once its stems are
    durably written)."""
    for suffix in (".stems.f32", ".ckpt.npz", ".ckpt.npz.tmp"):
        try:
            os.remove(os.path.join(ckpt_dir, tag + suffix))
        except FileNotFoundError:
            pass


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

    def process(self, audio, lengths=None):
        """``lengths`` (for [C, L] audio whose rows are tracks zero-padded
        to one length, each row's true length) zeroes pass 1's OLA spill
        past each track before pass 2, as the reference truncates between
        passes (hps.cu:171-178) and zen_tpu's ``sharded_hpri_offline``
        masks: a track's stems then do not depend on the longer tracks
        that share its batch. Spans: ``zen.track`` over ``zen.pass1``,
        ``zen.handoff`` and ``zen.pass2``."""
        audio = on_device(audio, self.device)
        with span("zen.track", audio):
            with span("zen.pass1", audio):
                pass1 = pass_stems(pass_masks(audio, self.cfg_h), self.cfg_h, audio)
            with span("zen.handoff", audio):
                # xp1 + xr1 feeds pass 2 (hps.cu:152-158), cut to the clip
                inter = pass1["percussive"] + pass1["residual"]
                if lengths is not None:
                    if inter.ndim != 2 or len(lengths) != inter.shape[0]:
                        raise ZenError(
                            f"lengths {list(lengths)} for audio of shape {tuple(inter.shape)}")
                    for row, n in zip(inter, lengths):
                        row[n:] = 0.0
            with span("zen.pass2", audio):
                pass2 = pass_stems(pass_masks(inter, self.cfg_p), self.cfg_p, inter)
        return pass1["harmonic"], pass2["percussive"], pass2["residual"]

    def process_blocked(
        self,
        audio,
        block_frames_h: int = 512,
        block_frames_p: int = 8192,
        ckpt_dir: str | None = None,
        tag: str = "track",
        ckpt_every_blocks: int = 8,
        on_segment=None,
    ):
        """``process`` on [L] audio with both passes as overlap-save
        blocks (``hpr_separate_blocked``), for tracks whose batched
        spectrogram would not fit the card.

        With ``ckpt_dir``, both passes are checkpointed mid-track
        (``hpr_separate_blocked_checkpointed``, tags ``<tag>.p1`` and
        ``<tag>.p2``): a kill at any point resumes from the last durable
        segment of the pass it hit, with the same stems bit for bit, and
        the same return type. ``clear_track_checkpoint(ckpt_dir,
        f"{tag}.p1")`` and ``.p2`` remove the files once the stems are
        consumed."""
        audio = on_device(audio, self.device)
        if audio.ndim != 1:
            raise ZenError("process_blocked expects [L] audio")
        ck = dict(ckpt_dir=ckpt_dir, ckpt_every_blocks=ckpt_every_blocks, on_segment=on_segment)
        pass1 = hpr_separate_blocked_checkpointed(audio, self.cfg_h, block_frames_h,
                                                  tag=f"{tag}.p1", **ck)
        inter = pass1["percussive"] + pass1["residual"]
        harmonic = pass1["harmonic"]
        del pass1  # free pass 1's other stems before pass 2 allocates its own
        pass2 = hpr_separate_blocked_checkpointed(inter, self.cfg_p, block_frames_p,
                                                  tag=f"{tag}.p2", **ck)
        return harmonic, pass2["percussive"], pass2["residual"]
