"""Sharded HPR drivers: channel-DP x time-block SP, and frequency TP
(counterpart of ``zen_tpu/parallel/sharded.py``).

zen_tpu runs each driver as one ``jax.shard_map`` program with explicit
collectives. The port runs one Python loop over the shards of a
``Mesh`` (``parallel/mesh.py``): each shard's tensors live on its
device, and every stage is issued for every shard before the next
stage reads a neighbour's result, so nothing waits on the host and
shards on different cards run at once (on one card, one after
another). The collectives become:

* ``ppermute``: the neighbour's tensor moved to this shard's device
  (``x.to(device, non_blocking=True)``: a peer copy between cards,
  nothing on one device); shards at the ends of the ring get zeros, as
  ``ppermute`` gives, or the prefill feature where zen_tpu patches it;
* ``psum``: the shards' tensors summed in shard order on the first
  shard's device.

* DP: channels split over 'dp', no communication.
* SP: the time axis split in frame blocks, three halo exchanges a pass:
  one hop of samples from the left (the STFT frame crossing the seam),
  ``back`` / ``fwd`` rows of features for the time median's taps, and one
  synthesized row from the right for the overlap-add seam. The blocked
  scan (``sharded_separate_blocked``) needs none: each shard scans its
  own run of overlap-save blocks from an overlapping sample window, one
  block longer than zen_tpu's (``_prime``).
* TP: see ``tp_separate``.

Every median of a shard goes through the port's kernel wrappers (K1 and
K2 on CUDA tensors, their plain twins on CPU tensors), at the shard's
own shapes.

Over several processes (a mesh from ``make_mesh`` under a process group)
each process issues only the shards it owns. A ring (a dp row's sp
blocks, or the tp bins) either lies inside one process, where dp takes
the process split, or is cut across processes, where it does not
(``{"dp": 1, "sp": 2}`` over two). At a cut edge a halo goes over gloo
(``multihost.ring_shift``) and a tp sum gathers its partials in shard
order (``multihost.ordered_sum``), so every process computes the bits
one process would. The dp x sp drivers join every shard's stems on
every process at the end (``multihost.allgather``), and the cascade
gathers pass 1's stems before pass 2 where a ring is cut; the blocked
scan runs each process's own shards, gathers their stems after, and its
checkpointed form writes from process 0 alone. tp runs the ring through
each process's first entry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import numpy as np
import torch

from ..drivers.offline import (
    _as_audio,
    _block_step,
    _blocked_audio,
    _Blocking,
    _cfg_digest,
    _fsync_file,
    _n_frames,
    _resume_point,
    _stems,
)
from ..engine.config import WRAP, HPRConfig
from ..engine.spectral import (
    STEMS,
    _check_median_route,
    _windowed,
    analyze,
    compute_masks,
    feature_transform,
    finalize_features,
    freq_filtered,
    prefill_value,
    synthesize,
    time_filtered,
    time_filtered_tail,
)
from ..errors import ZenError
from ..ops import box, median_cuda
from ..ops.fft import _tf32_off
from ..ops.framing import frame_signal, overlap_add_stream
from ..runtime.checkpoint import save_stream_state_durable
from . import multihost
from .mesh import Mesh


def _moved(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class _Shards:
    """The shards of a mesh's rings that this process issues: ``ks``
    their numbers (ring r, position j: k = r * n + j; for dp x sp the
    ring is the dp row, k = i * n_sp + j), ``devs`` their devices,
    ``owners`` [n_rings, n] the rank owning each shard of every ring;
    ``wrap`` closes the rings (tp's circular bins). In one process it
    holds every shard, and a halo is a move between devices."""

    ks: list
    devs: list
    owners: np.ndarray
    wrap: bool = False

    @property
    def n(self) -> int:
        return self.owners.shape[1]

    @property
    def cut(self) -> bool:
        """Whether some ring has shards of several processes (the same on
        every process: make_mesh's blocks are all one shape)."""
        return bool((self.owners != self.owners[:, :1]).any())

    def from_left(self, xs: list, fill: float = 0.0) -> list:
        """Shard k receives its left neighbour's x; an open ring's first
        shard gets ``fill``."""
        return multihost.ring_shift(xs, self.ks, self.devs, self.owners, 1, fill, self.wrap)

    def from_right(self, xs: list, fill: float = 0.0) -> list:
        """Shard k receives its right neighbour's x; an open ring's last
        shard gets ``fill``."""
        return multihost.ring_shift(xs, self.ks, self.devs, self.owners, -1, fill, self.wrap)

    def everywhere(self, xs: list, device: torch.device) -> list:
        """Every shard's x (equal shapes), in shard order on ``device``:
        this process's own, and where it does not own them all, every
        other process's, gathered from every process (``allgather``;
        each process owns as many; one whose shards lie on another ring,
        a replica of this one, sends its own all the same, unread)."""
        xs = [_moved(x, device) for x in xs]
        if len(xs) == self.owners.size:
            return xs
        flat = self.owners.ravel()
        gathered = multihost.allgather(torch.stack(xs)).split(len(xs))
        by_k = {}
        for p, parts in enumerate(gathered):
            ks = np.flatnonzero(flat == p).tolist()
            if ks and len(ks) != len(xs):
                raise ZenError(f"every process must own as many shards: {self.owners.tolist()}")
            by_k.update(zip(ks, parts))
        return [by_k[k] for k in range(flat.size)]


def _ring(mesh: Mesh, axis: str, wrap: bool = False) -> _Shards:
    """The ring along ``axis`` through this process's first entry (the
    other axes' replicas compute the same; zen_tpu's ``P()``): the
    positions this process owns, as one ring (r = 0)."""
    at = mesh.local_coords()
    coords = [{**at, axis: j} for j in range(mesh.size(axis))]
    owners = np.array([[mesh.owner(**c) for c in coords]])
    ks = [j for j in range(len(coords)) if owners[0, j] == mesh.process_index]
    return _Shards(ks, [mesh.device(**coords[j]) for j in ks], owners, wrap)


def _masks_by_stem(h, p, cfg: HPRConfig) -> tuple:
    pm, hm, rm = compute_masks(h, p, cfg)
    return hm, pm, rm


def _enabled(cfg: HPRConfig, name: str, mask) -> bool:
    return getattr(cfg, f"output_{name}") and mask is not None


# ---------------- dp x sp: the batched pass ----------------


def _sp_masks(local: list, sh: _Shards, cfg: HPRConfig) -> tuple:
    """The masks half of one pass over this process's shards (zen_tpu's
    ``_sp_shard_fn`` up to its masks): local[i] [rows, tl*hop], shard
    sh.ks[i] on sh.devs[i] -> (spectra [rows, tl, bins] per shard,
    (harmonic, percussive, residual) masks per shard). Split from the
    synthesis half so that a flip count can read the very masks the stems
    come from."""
    hop = cfg.hop
    tl = local[0].shape[-1] // hop
    back = cfg.time_history
    fwd = max(max(cfg.time_offsets), 0)
    if back > tl or fwd > tl:
        raise ZenError("time shards smaller than the median halo; use fewer sp shards")

    # (1) framing halo: the left neighbour's last hop of samples
    lead = sh.from_left([x[..., -hop:] for x in local])
    spectra, feats = [], []
    for x, t in zip(local, lead):
        blocks = torch.cat([t, x], dim=-1).view(x.shape[:-1] + (tl + 1, hop))
        s = analyze(torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1), cfg)
        spectra.append(s)
        feats.append(feature_transform(s.abs(), cfg))

    # (2) feature halos for the time median's taps; the global edges read
    # the prefill feature (+inf under SSE), as the unsharded pass does
    fill = prefill_value(cfg)
    left = sh.from_left([f[..., f.shape[-2] - back :, :] for f in feats], fill)
    right = sh.from_right([f[..., :fwd, :] for f in feats], fill)
    masks = []
    for f, lh, rh in zip(feats, left, right):
        ext = torch.cat([lh, f, rh], dim=-2) if back or fwd else f
        # the kept rows only: the back halo is tap context, and the kept
        # rows' forward taps stay inside ext
        h = time_filtered_tail(ext, cfg, back)[..., :tl, :]
        masks.append(_masks_by_stem(*finalize_features(h, freq_filtered(f, cfg), cfg), cfg))
    return spectra, masks


def _sp_stems(spectra: list, masks: list, local: list, sh: _Shards, cfg: HPRConfig) -> list:
    """The synthesis half: stems [3, rows, tl*hop] per shard, with (3)
    the overlap-add seam, the right neighbour's first synthesized row."""
    outs = [[] for _ in local]
    for i, name in enumerate(STEMS):
        if not _enabled(cfg, name, masks[0][i]):
            for o, x in zip(outs, local):
                o.append(torch.zeros_like(x))
            continue
        ys = [synthesize(s, m[i], cfg) for s, m in zip(spectra, masks)]
        nxt = sh.from_right([y[..., :1, :] for y in ys])
        for o, y, n in zip(outs, ys, nxt):
            o.append(overlap_add_stream(torch.cat([y, n], dim=-2), cfg.hop, advance=1))
    return [torch.stack(o) for o in outs]


def _dp_sp(audio, mesh: Mesh, dp_axis: str, sp_axis: str) -> tuple:
    """([C, L] audio, the dp x sp shards this process issues, channels a
    dp row): over several processes the shards it owns, whose rings may
    cross into other processes' (their halos then go over gloo)."""
    audio = _as_audio(audio)
    if audio.ndim == 1:
        audio = audio[None]
    n_dp, n_sp = mesh.size(dp_axis), mesh.size(sp_axis)
    if audio.shape[0] % n_dp:
        raise ZenError(f"channels ({audio.shape[0]}) not divisible by dp ({n_dp})")
    coords = [{dp_axis: k // n_sp, sp_axis: k % n_sp} for k in range(n_dp * n_sp)]
    owners = np.array([mesh.owner(**c) for c in coords]).reshape(n_dp, n_sp)
    ks = [k for k in range(n_dp * n_sp) if owners.flat[k] == mesh.process_index]
    sh = _Shards(ks, [mesh.device(**coords[k]) for k in ks], owners)
    return audio, sh, audio.shape[0] // n_dp


def _sp_local(audio: torch.Tensor, row0: int, rows: int, cfg: HPRConfig, sh: _Shards) -> list:
    """Each of this process's shards' samples on its device for a dp x sp
    pass over [C', L] audio whose first row is dp row ``row0``'s, ``rows``
    channels a dp row. The frame count is rounded up to a multiple of the
    sp width (the extra frames are zero audio, whose feature is the
    prefill the unsharded taps read)."""
    n_sp = sh.n
    n_frames = -(-_n_frames(audio.shape[-1], cfg) // n_sp) * n_sp
    padded = torch.nn.functional.pad(audio, (0, n_frames * cfg.hop - audio.shape[-1]))
    span = n_frames // n_sp * cfg.hop
    return [_moved(padded[(k // n_sp - row0) * rows : (k // n_sp - row0 + 1) * rows,
                          k % n_sp * span : (k % n_sp + 1) * span], dev)
            for k, dev in zip(sh.ks, sh.devs)]


def _sp_gather(parts: list, n_sp: int, time_dim: int, row_dim: int,
               device: torch.device) -> torch.Tensor:
    """Whole rings' pieces as one tensor on ``device``: each dp row's sp
    blocks joined along ``time_dim``, the rows along ``row_dim``."""
    rows = [torch.cat([_moved(p, device) for p in parts[i : i + n_sp]], dim=time_dim)
            for i in range(0, len(parts), n_sp)]
    return torch.cat(rows, dim=row_dim)


def _own_pass(audio: torch.Tensor, row0: int, rows: int, cfg: HPRConfig, sh: _Shards) -> tuple:
    """One dp x sp pass over this process's shards: (stems [3, rows,
    span] per shard, each shard's masks)."""
    local = _sp_local(audio, row0, rows, cfg, sh)
    spectra, masks = _sp_masks(local, sh, cfg)
    return _sp_stems(spectra, masks, local, sh, cfg), masks


def _joined(pieces: list, sh: _Shards, length: int, time_dim: int = -1,
            row_dim: int = 1) -> torch.Tensor:
    """Every shard's piece joined into [..., C, L] on this process's first
    device (zen_tpu's ``process_allgather(tiled=True)`` over several
    processes); ``length`` None keeps the padded frames."""
    out = _sp_gather(sh.everywhere(pieces, sh.devs[0]), sh.n, time_dim, row_dim, sh.devs[0])
    return out if length is None else out[..., :length]


def sharded_separate(audio, cfg: HPRConfig, mesh: Mesh, dp_axis: str = "dp",
                     sp_axis: str = "sp") -> dict:
    """Offline HPR pass on [C, L] (or [L]) audio, channels over
    ``dp_axis`` and time blocks over ``sp_axis``: dict of [C, L] stems on
    this process's first device, equal to ``hpr_separate`` per channel up
    to the transforms' batch rounding. Over several processes each issues
    the shards it owns, and every process gets every row."""
    audio, sh, rows = _dp_sp(audio, mesh, dp_axis, sp_axis)
    pieces, _ = _own_pass(audio, 0, rows, cfg, sh)
    return dict(zip(STEMS, _joined(pieces, sh, audio.shape[-1])))


def sharded_pass_masks(audio, cfg: HPRConfig, mesh: Mesh, dp_axis: str = "dp",
                       sp_axis: str = "sp") -> tuple:
    """``sharded_separate``'s stems and the (harmonic, percussive) masks
    [C, frames, bins] they came from, both on this process's first
    device: what a flip count between two runs of a pass reads."""
    audio, sh, rows = _dp_sp(audio, mesh, dp_axis, sp_axis)
    pieces, masks = _own_pass(audio, 0, rows, cfg, sh)
    stems = dict(zip(STEMS, _joined(pieces, sh, audio.shape[-1])))
    return stems, tuple(_joined([m[i] for m in masks], sh, None, -2, 0) for i in (0, 1))


def sharded_hpri_offline(audio, cfg_h: HPRConfig, cfg_p: HPRConfig, mesh: Mesh,
                         lengths=None, dp_axis: str = "dp", sp_axis: str = "sp") -> tuple:
    """Sharded two-pass HPR-I: (harmonic, percussive, residual) [C, L].

    ``lengths`` ([C] ints): each channel's true length where channels are
    tracks zero-padded to one batch length. Pass 1's spill past a track
    is zeroed before pass 2, as the reference truncates between passes
    (hps.cu:171-178) and ``HPRIOffline.process(lengths=)`` does, so a
    track's stems do not depend on the tracks that share its batch. Where
    every ring lies inside one process, pass 2 reads the process's own
    pass-1 rows and only the stems cross processes, at the end; where a
    ring is cut, pass 2's shards span other times than pass 1's (another
    hop), so pass 1's stems are gathered before it."""
    audio, sh, rows = _dp_sp(audio, mesh, dp_axis, sp_axis)
    length = audio.shape[-1]
    if lengths is not None and len(lengths) != audio.shape[0]:
        raise ZenError(f"lengths {list(lengths)} for audio of shape {tuple(audio.shape)}")
    pieces1, _ = _own_pass(audio, 0, rows, cfg_h, sh)
    if sh.cut:
        row0, pass1 = 0, _joined(pieces1, sh, length)
    else:
        row0 = sh.ks[0] // sh.n
        pass1 = _sp_gather(pieces1, sh.n, -1, 1, sh.devs[0])[..., :length]
    inter = pass1[1] + pass1[2]
    if lengths is not None:
        for row, n in zip(inter, lengths[row0 * rows : row0 * rows + inter.shape[0]]):
            row[int(n):] = 0.0
    pieces2, _ = _own_pass(inter, row0, rows, cfg_p, sh)
    harmonic = pass1[0] if sh.cut else _joined([p[0] for p in pieces1], sh, length, row_dim=0)
    pass2 = _joined([p[1:] for p in pieces2], sh, length)
    return harmonic, pass2[0], pass2[1]


# ---------------- sp: the blocked overlap-save scan ----------------


def _sharded_blocking(length: int, cfg: HPRConfig, block_frames: int, n_sp: int) -> tuple:
    """(the scan's geometry over all n_sp * nbl blocks, nbl): zen_tpu's
    block size, and a power-of-two count of blocks a shard."""
    n_frames = _n_frames(length, cfg)
    bf = min(block_frames, 1 << (max(1, n_frames) - 1).bit_length())
    nbl = 1 << (max(1, -(-n_frames // (bf * n_sp))) - 1).bit_length()
    return _Blocking(bf, nbl * n_sp, cfg.time_history, max(max(cfg.time_offsets), 0)), nbl


def _windows(audio: torch.Tensor, cfg: HPRConfig, blk: _Blocking, nbl: int, sh: _Shards) -> list:
    """Each of this process's shards' samples [((nbl + 1) * bf + back +
    fwd + 1) * hop] on its device: the block before its span, then its
    nbl blocks, each with its halo context, cut from a stream padded by
    one block more than the unsharded scan's; consecutive windows overlap
    by one block and back + fwd + 1 hops."""
    hop = cfg.hop
    guard_lo = (blk.bf + blk.back + 1) * hop
    guard_hi = (blk.n_blocks * blk.bf + blk.fwd) * hop - audio.shape[-1]
    padded = torch.nn.functional.pad(audio, (guard_lo, max(guard_hi, 0)))
    w = ((nbl + 1) * blk.bf + blk.back + blk.fwd + 1) * hop
    step = nbl * blk.bf * hop
    return [_moved(padded[d * step : d * step + w], dev) for d, dev in zip(sh.ks, sh.devs)]


def _block_window(window: torch.Tensor, cfg: HPRConfig, blk: _Blocking, b: int) -> torch.Tensor:
    """Local block b's samples in a shard's window (``_block_samples`` of
    the unsharded scan); b = -1 is the block before the shard's span."""
    lo = (b + 1) * blk.bf * cfg.hop
    return window[lo : lo + (blk.back + blk.bf + blk.fwd + 1) * cfg.hop]


def _prime(window: torch.Tensor, d: int, cfg: HPRConfig, blk: _Blocking) -> torch.Tensor:
    """Shard d's OLA tails [3, hop] entering its first block: zeros for
    the first shard, as the unsharded scan starts; else the tails the
    block before its span leaves. That block runs whole, not as zen_tpu's
    one priming frame: cuFFT's bits can depend on a transform's batch, and
    a whole block has the unsharded scan's shapes (a block's tails do not
    depend on the tails it is given)."""
    zeros = window.new_zeros((len(STEMS), cfg.hop))
    if d == 0:
        return zeros
    return _block_step(cfg, blk, _block_window(window, cfg, blk, -1), zeros)[1]


def _scan(windows: list, tails: list, cfg: HPRConfig, blk: _Blocking, b0: int, b1: int):
    """Local blocks b0..b1-1 of every shard, block b of every shard before
    block b+1 of any: (stems [3, (b1-b0)*bf*hop] per shard, the tails
    after). The one block body is the unsharded scan's ``_block_step``."""
    outs = [[] for _ in windows]
    tails = list(tails)
    for b in range(b0, b1):
        for d, w in enumerate(windows):
            out, tails[d] = _block_step(cfg, blk, _block_window(w, cfg, blk, b), tails[d])
            outs[d].append(out)
    return [torch.cat(o, dim=1) for o in outs], tails


def sharded_separate_blocked(audio, cfg: HPRConfig, mesh: Mesh, block_frames: int = 2048,
                             sp_axis: str = "sp") -> dict:
    """``hpr_separate_blocked`` on [L] audio with its blocks split over
    ``sp_axis``: each shard primes its OLA tails from the block before its
    span, then scans its own contiguous run of blocks, with no exchange
    at all.
    Bitwise equal to ``hpr_separate_blocked`` at the same block size on
    the same device type. The mesh's other axes are not used (their
    replicas would compute the same): each process scans the shards it
    owns of the ring through its first entry (its dp row's whole ring
    where dp takes the process split), and where the ring is cut the
    shards' stems are gathered after. Stems on this process's first
    device."""
    audio = _blocked_audio(audio, "sharded_separate_blocked")
    sh = _ring(mesh, sp_axis)
    blk, nbl = _sharded_blocking(audio.shape[-1], cfg, block_frames, sh.n)
    windows = _windows(audio, cfg, blk, nbl, sh)
    tails = [_prime(w, d, cfg, blk) for d, w in zip(sh.ks, windows)]
    outs, _ = _scan(windows, tails, cfg, blk, 0, nbl)
    full = torch.cat(sh.everywhere(outs, sh.devs[0]), dim=1)
    return _stems(full, cfg.hop, audio.shape[-1])


def sharded_separate_blocked_checkpointed(
    audio,
    cfg: HPRConfig,
    mesh: Mesh,
    block_frames: int = 2048,
    sp_axis: str = "sp",
    ckpt_dir: str | None = None,
    tag: str = "track",
    ckpt_every_blocks: int = 8,
    on_segment=None,
) -> dict:
    """``sharded_separate_blocked`` that a crash costs at most one
    segment: every shard scans ``ckpt_every_blocks`` of its blocks a
    segment; then the segment's stems land in ``<ckpt_dir>/<tag>.stems.f32``
    (float32 memmap [3, n_sp * nbl * bf * hop], flushed and fsynced) and
    only then every shard's OLA tails [n_sp, 3, hop] and the next local
    block go to ``<tag>.ckpt.npz`` (meta ``cfg``, ``bf``, ``nbl``,
    ``n_sp``, ``length``, ``next_block``). A later call with the same
    arguments resumes after the last durable segment, bitwise; a
    checkpoint of another config or geometry, or a corrupt one, restarts
    from freshly primed tails. ``on_segment(next_block, nbl)`` is called
    after each durable segment. ``ckpt_dir=None`` is
    ``sharded_separate_blocked``.

    Over several processes (``ckpt_dir`` on a filesystem they share) each
    scans the shards it owns; where the ring is cut, each segment's stems
    and tails are gathered on every process after it. Process 0 alone
    writes the stems file and the checkpoint, and the others keep the
    stems in memory, reading the resumed segments from the file; a resumed
    scan takes every shard's tails from the checkpoint on every process.
    Before any segment the processes agree on the block to resume from,
    and all refuse together if they disagree or one cannot read the file:
    a process that ran a segment the others skip would leave them
    waiting, and stems it failed to read are never taken for zeros."""
    if ckpt_dir is None:
        return sharded_separate_blocked(audio, cfg, mesh, block_frames, sp_axis)
    audio = _blocked_audio(audio, "sharded_separate_blocked_checkpointed")
    hop, length = cfg.hop, audio.shape[-1]
    sh = _ring(mesh, sp_axis)
    n_sp = sh.n
    blk, nbl = _sharded_blocking(length, cfg, block_frames, n_sp)
    windows = _windows(audio, cfg, blk, nbl, sh)
    total = blk.n_blocks * blk.bf * hop
    os.makedirs(ckpt_dir, exist_ok=True)
    stems_path = os.path.join(ckpt_dir, f"{tag}.stems.f32")
    ckpt_path = os.path.join(ckpt_dir, f"{tag}.ckpt.npz")
    meta_want = {"cfg": _cfg_digest(cfg), "bf": blk.bf, "nbl": nbl, "n_sp": n_sp,
                 "length": length}
    b, state = _resume_point(ckpt_path, stems_path, meta_want,
                             torch.zeros((n_sp, len(STEMS), hop)), nbl,
                             len(STEMS) * total * 4)
    writes = mesh.process_index == 0
    acc = None
    if mesh.spans_processes:
        unread = None
        if not writes and b > 0:
            # read before the agreement: process 0 may drop the file once
            # every process has agreed
            try:
                acc = np.fromfile(stems_path, np.float32).reshape(len(STEMS), total)
            except (OSError, ValueError) as e:
                unread = e
        try:
            b = multihost.agree(-1 if unread else b, f"mid-track checkpoint of {tag!r}, the "
                                "next block (ckpt_dir must be a shared filesystem)")
        except ZenError:
            if unread is None:
                raise
        if unread is not None:
            raise ZenError(f"process {mesh.process_index} cannot read the resumed stems buffer "
                           f"{stems_path!r}: ckpt_dir must be a shared filesystem") from unread
    if b == 0:
        if writes and os.path.exists(ckpt_path):
            # the stems file is about to be recreated: drop the checkpoint
            # that claims its segments first
            os.remove(ckpt_path)
            _fsync_file(ckpt_dir)
        tails = [_prime(w, d, cfg, blk) for d, w in zip(sh.ks, windows)]
    else:
        tails = [_moved(state[d], dev) for d, dev in zip(sh.ks, sh.devs)]
    if writes:
        acc = np.memmap(stems_path, np.float32, mode="r+" if b > 0 else "w+",
                        shape=(len(STEMS), total))
    elif acc is None:
        acc = np.zeros((len(STEMS), total), np.float32)
    shard_span = nbl * blk.bf * hop
    while b < nbl:
        ng = min(ckpt_every_blocks, nbl - b)
        outs, tails = _scan(windows, tails, cfg, blk, b, b + ng)
        # one exchange a segment where the ring is cut: each shard's
        # stems with its tails after them
        both = sh.everywhere([torch.cat([o, t], dim=1) for o, t in zip(outs, tails)],
                             sh.devs[0])
        span = ng * blk.bf * hop
        for d, x in enumerate(both):
            lo = d * shard_span + b * blk.bf * hop
            acc[:, lo : lo + span] = x[:, :span].cpu().numpy()
        b += ng
        if writes:
            acc.flush()
            _fsync_file(stems_path)  # the stems are durable before a checkpoint claims them
            save_stream_state_durable(ckpt_path, torch.stack([x[:, span:].cpu() for x in both]),
                                      {**meta_want, "next_block": b})
        if on_segment is not None:
            on_segment(b, nbl)
    full = torch.from_numpy(np.array(acc[:, : hop + length])).to(sh.devs[0])
    del acc
    return _stems(full, hop, length)


def sharded_hpri_blocked(
    audio,
    cfg_h: HPRConfig,
    cfg_p: HPRConfig,
    mesh: Mesh,
    block_frames_h: int = 512,
    block_frames_p: int = 8192,
    sp_axis: str = "sp",
    ckpt_dir: str | None = None,
    tag: str = "track",
    ckpt_every_blocks: int = 8,
    on_segment=None,
) -> tuple:
    """Two-pass HPR-I on [L] audio with both passes as the sharded blocked
    scan: ``HPRIOffline.process_blocked`` over an sp mesh, bitwise equal
    to it at the same block sizes. With ``ckpt_dir`` both passes are
    checkpointed mid-track (tags ``<tag>.p1`` and ``<tag>.p2``): a kill
    resumes from the last durable segment of the pass it hit."""
    ck = dict(ckpt_dir=ckpt_dir, ckpt_every_blocks=ckpt_every_blocks, on_segment=on_segment)
    pass1 = sharded_separate_blocked_checkpointed(audio, cfg_h, mesh, block_frames_h, sp_axis,
                                                  tag=f"{tag}.p1", **ck)
    inter = pass1["percussive"] + pass1["residual"]
    harmonic = pass1["harmonic"]
    del pass1
    pass2 = sharded_separate_blocked_checkpointed(inter, cfg_p, mesh, block_frames_p, sp_axis,
                                                  tag=f"{tag}.p2", **ck)
    return harmonic, pass2["percussive"], pass2["residual"]


# ---------------- frequency tensor parallelism ----------------


def _partial_dft(cfg: HPRConfig, start: int, fb: int, device: torch.device) -> tuple:
    """cos and sin [nwin, fb] of the angles 2 pi k n / nfft for the
    shard's bins k = start .. start+fb-1, reduced as int32 (k n) mod nfft
    before the float cast: a raw float32 k n reaches 2^27 at nfft 16384."""
    n = torch.arange(cfg.nwin, dtype=torch.int32, device=device)[:, None]
    k = torch.arange(start, start + fb, dtype=torch.int32, device=device)[None, :]
    ang = (2.0 * math.pi / cfg.nfft) * torch.remainder(k * n, cfg.nfft).to(torch.float32)
    return torch.cos(ang), torch.sin(ang)


def _tp_masks(audio: torch.Tensor, cfg: HPRConfig, sh: _Shards, n_frames: int) -> tuple:
    """The masks half of one frequency-sharded pass (zen_tpu's
    ``_tp_shard_fn`` up to its masks): (spectra [..., T, fb], (harmonic,
    percussive, residual) masks, the inverse DFT matrices), one entry per
    shard this process issues."""
    hop, nfft, n_tp = cfg.hop, cfg.nfft, sh.n
    fb = nfft // n_tp
    fm = cfg.freq_filter_len // 2
    if fm > fb:
        raise ZenError("tp shards smaller than the frequency halo")

    # the partial forward DFT of each shard's fb bins: two float32 matmuls
    # (the zero-padded rows nwin..nfft contribute nothing, hps.cu:461-462),
    # and its inverse: the transposed matrices times the synthesis scale
    scale = float(np.float32(cfg.synth_scale / nfft))
    spectra, feats, hs, inverse = [], [], [], []
    for t, dev in zip(sh.ks, sh.devs):
        xw = _windowed(frame_signal(_moved(audio, dev), hop, n_frames), cfg)
        cos, sin = _partial_dft(cfg, t * fb, fb, dev)
        s = torch.complex(xw @ cos, -(xw @ sin))
        inverse.append((cos.T * scale, sin.T * scale))
        del cos, sin
        spectra.append(s)
        feats.append(feature_transform(s.abs(), cfg))
        hs.append(time_filtered(feats[-1], cfg))  # per bin: local

    # the frequency median over fm-bin halos from both ring neighbours
    # (around the ring): zen_tpu's zero-border median over [lh, own, rh]
    # cropped to the own bins, which is K2's 'valid' route on the
    # extended bins
    if fm:
        left = sh.from_left([f[..., fb - fm :] for f in feats])
        right = sh.from_right([f[..., :fm] for f in feats])
        exts = [torch.cat([lh, f, rh], dim=-1) for f, lh, rh in zip(feats, left, right)]
    else:  # feats[..., -0:] would be the whole block
        exts = feats
    masks = []
    for h, ext in zip(hs, exts):
        if cfg.use_sse:
            p = box.sliding_mean(ext, cfg.freq_offsets, -1, "zero")[..., fm : fm + fb]
        else:
            _check_median_route(cfg, ext)
            p = median_cuda.sliding_median_boundary(ext, 2 * fm + 1, "valid")
        masks.append(_masks_by_stem(*finalize_features(h, p, cfg), cfg))
    return spectra, masks, inverse


def _tp_stems(spectra: list, masks: list, inverse: list, cfg: HPRConfig, sh: _Shards,
              n_frames: int) -> torch.Tensor:
    """The synthesis half: stems [3, ..., (n_frames-1)*hop] on this
    process's first shard's device. Each shard's partial inverse DFT
    covers its own bins; by linearity the stem's frame is their sum
    (zen_tpu's psum), taken in shard order on every process."""
    hop = cfg.hop
    lead = spectra[0].shape[:-2]
    outs = []
    for i, name in enumerate(STEMS):
        if not _enabled(cfg, name, masks[0][i]):
            outs.append(torch.zeros(lead + ((n_frames - 1) * hop,), device=sh.devs[0]))
            continue
        ys = []
        for s, m, (inv_c, inv_s) in zip(spectra, masks, inverse):
            masked = s * m[i]
            ys.append(masked.real @ inv_c - masked.imag @ inv_s)
        y = multihost.ordered_sum(ys, sh.ks, sh.owners, sh.devs[0])
        outs.append(overlap_add_stream(y, hop, advance=1))
    return torch.stack(outs)


def tp_separate(audio, cfg: HPRConfig, mesh: Mesh, tp_axis: str = "tp") -> dict:
    """Frequency-sharded offline pass on [L] audio: each of the n_tp
    shards transforms, filters, masks and synthesizes nfft/n_tp bins,
    through partial-DFT matmuls at float32 (TF32 off, zen_tpu's
    Precision.HIGHEST). Needs the exact C2C spectrum (``fast_rfft`` is
    forced off) and the wrap border (the frequency halo ring is
    circular); n_tp must divide nfft. Stems on this process's first device,
    equal to ``hpr_separate`` with ``fast_rfft`` off up to the
    transforms' rounding.

    Over several processes each runs the ring through its first entry (a
    dp x tp mesh whose split dp takes: its own dp row's whole ring, with
    no exchange, zen_tpu's ``P()`` replicas); where the ring is cut, the
    frequency halos at its cut edges and the partial inverses cross
    processes (``multihost.ring_shift``, ``ordered_sum``), and every
    process gets the stems."""
    if cfg.border != WRAP:
        raise ZenError("tp_separate supports the wrap border only")
    sh = _ring(mesh, tp_axis, wrap=True)
    if cfg.nfft % sh.n:
        raise ZenError(
            f"tp width {sh.n} must divide nfft {cfg.nfft} (a remainder "
            "would silently drop the top bins from every shard)"
        )
    if cfg.fast_rfft:
        cfg = dataclasses.replace(cfg, fast_rfft=False)
    audio = _as_audio(audio)
    length = audio.shape[-1]
    on_card = any(d.type == "cuda" for d in sh.devs)
    n_frames = _n_frames(length, cfg)
    with _tf32_off() if on_card else contextlib.nullcontext():
        out = _tp_stems(*_tp_masks(audio, cfg, sh, n_frames), cfg, sh, n_frames)
    return {name: out[i, ..., :length] for i, name in enumerate(STEMS)}


def tp_hpri_offline(audio, cfg_h: HPRConfig, cfg_p: HPRConfig, mesh: Mesh,
                    tp_axis: str = "tp") -> tuple:
    """Frequency-sharded two-pass HPR-I (``zen-torch offline --mesh
    tp=N``): both passes ``tp_separate``, the intermediate pass 1's
    percussive + residual. n_tp must divide both passes' nfft."""
    pass1 = tp_separate(audio, cfg_h, mesh, tp_axis)
    inter = pass1["percussive"] + pass1["residual"]
    pass2 = tp_separate(inter, cfg_p, mesh, tp_axis)
    return pass1["harmonic"], pass2["percussive"], pass2["residual"]
