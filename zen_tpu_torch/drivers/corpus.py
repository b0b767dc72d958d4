"""Resumable offline corpus driver over a device mesh (counterpart of
``zen_tpu/drivers/corpus.py``).

Separates a list of tracks into three stems each under ``out_dir``,
with crash-safe resume through a ``ProgressJournal``
(runtime/checkpoint.py): the reference's missing failure-recovery story
(SURVEY.md §5.3). The mesh (``parallel/mesh.py``) shards the work:

* ``dp``: up to n_dp tracks of one sample rate go through one
  ``sharded_hpri_offline`` call, one track a dp shard, zero-padded to the
  batch's longest and to n_dp rows (drivers/offline.py's docstring says
  why the padding agrees; pass 1's spill past each track is zeroed before
  pass 2). zen_tpu also pads the length to a power-of-two bucket for
  XLA's compile cache; the port runs each batch at its own length.
* ``sp``: each track's time blocks. A track past ``LONG_TRACK_SAMPLES``
  x sp takes the checkpointed ``sharded_hpri_blocked`` when sp > 1 and
  the checkpointed ``process_blocked`` otherwise, zen_tpu's two branches.

Over several processes (a mesh from ``make_mesh`` under a process group,
``zen-torch corpus --nprocs``) every process reads the same tracks and
builds the same batches, so that all enter the same exchanges in the
same order; each computes the shards it owns and gets every row's
stems, but only process 0 writes stems and journal lines (the others
read the journal once, at the start, and count what they would have
written). Any dp x sp mesh ``make_mesh`` takes will do: where dp does
not take the whole process split (``--mesh sp=N``, or the default mesh
of a short corpus), sp rings cross processes and their halos go over
gloo, and a long track at sp > 1 is the checkpointed blocked scan over
the cut ring. A long track at sp = 1 is computed by process 0 alone.
``pp`` refuses several processes, as zen_tpu's does. Stem names, journal keys
(``_jkey``) and journal lines are zen_tpu's, so a journal either package
wrote resumes in the other.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from ..errors import ZenError
from ..parallel.mesh import default_mesh
from ..parallel.sharded import sharded_hpri_blocked, sharded_hpri_offline
from ..runtime.checkpoint import ProgressJournal
from ..runtime.loader import OrderedAsyncWriter, PrefetchReader
from .offline import HPRIOffline, clear_track_checkpoint
from .pipeline import PipelinedHPRIOffline

STEM_FORMATS = ("wav", "flac", "wv")


def stem_bases(track_paths) -> dict:
    """Track path -> the base of its stem file names: the basename, with
    a short sha1 of the path where tracks in different directories share
    one (their stems would otherwise overwrite each other)."""
    seen: dict = {}
    for p in track_paths:
        seen.setdefault(os.path.splitext(os.path.basename(p))[0], []).append(p)
    bases = {}
    for base, paths in seen.items():
        for p in paths:
            bases[p] = base if len(paths) == 1 else f"{base}-{hashlib.sha1(p.encode()).hexdigest()[:8]}"
    return bases


def journal_key(path: str, stem_format: str) -> str:
    """A track's journal key: the path, suffixed with the stem format
    unless it is wav (zen_tpu's keys), so that a run resumed with another
    format re-separates the tracks that only have the old format's stems."""
    return path if stem_format == "wav" else f"{path}::{stem_format}"


def _no_write(path, fs, audio):
    """The writer of every process but 0."""


class _ReadOnlyJournal:
    """The journal as every process but 0 holds it: read at the start,
    never written."""

    def __init__(self, inner: ProgressJournal):
        self._inner = inner

    def is_done(self, key: str) -> bool:
        return self._inner.is_done(key)

    def mark_done(self, key: str, info: dict | None = None) -> None:
        pass


def separate_corpus(
    track_paths,
    out_dir: str,
    mesh=None,
    hop_h: int = 4096,
    hop_p: int = 256,
    beta_h: float = 2.0,
    beta_p: float = 2.0,
    journal_path: str | None = None,
    reader=None,
    writer=None,
    pp: bool = False,
    pp_run: int = 8,
    prefetch: int = 2,
    fft_impl: str = "auto",
    median_impl: str = "auto",
    stream_state: str = "f32",
    stem_format: str = "wav",
):
    """Separate every track into 3 stems under out_dir, resumably; returns
    ``{"done": tracks the journal already held, "processed": tracks
    separated now}``.

    reader(path) -> (fs, audio[np.float32]); writer(path, fs, audio).
    ``stem_format`` ('wav'|'flac'|'wv') picks the default writer's
    container; a custom ``writer`` sees the extension in its path.
    Tracks of one sample rate are separated n_dp at a time over the
    mesh's dp axis (a batch ends when it is full or the rate changes);
    ``mesh=None`` is ``default_mesh`` over the visible cards.

    ``prefetch`` (default 2) overlaps host I/O with the card: a
    background thread decodes up to ``prefetch`` tracks ahead, and stem
    encode and journal run on one ordered writer thread
    (runtime/loader.py), each track's stems durable before its journal
    line. ``prefetch=0`` is fully synchronous I/O; a custom ``reader`` or
    ``writer`` must be thread-safe unless ``prefetch=0``.

    ``pp=True`` routes the short tracks through the pipelined cascade
    (drivers/pipeline.py) over the mesh's devices, pass 1 on the first
    and pass 2 on the second (two CUDA streams where that is the same
    card): pass 1 of track i+1 runs while pass 2 of track i does, in runs
    of up to ``pp_run`` tracks of one sample rate. Long tracks take the
    blocked route either way. ``pp`` refuses a mesh that spans processes.
    """
    from ..io.audio import peak_normalize, read_audio_mono, write_audio_pcm16
    from .offline import LONG_TRACK_SAMPLES

    if stem_format not in STEM_FORMATS:
        raise ValueError(f"stem_format must be wav|flac|wv, got {stem_format!r}")
    if mesh is None:
        mesh = default_mesh(n_channels_hint=len(track_paths))
    if pp and mesh.spans_processes:
        raise ZenError("corpus pp mode is single-host; pods should use dp/sp meshes")
    # process 0 writes; the others compute their rows and discard
    writes = mesh.process_index == 0
    device = mesh.first
    n_dp, n_sp = mesh.size("dp"), mesh.size("sp")
    reader = reader or read_audio_mono
    writer = (writer or write_audio_pcm16) if writes else _no_write
    os.makedirs(out_dir, exist_ok=True)
    journal = ProgressJournal(journal_path or os.path.join(out_dir, "progress.jsonl"))
    if not writes:
        journal = _ReadOnlyJournal(journal)
    # the op-seam knobs flow into every config this driver builds
    impl_kw = dict(fft_impl=fft_impl, median_impl=median_impl, stream_state=stream_state)
    bases = stem_bases(track_paths)
    ckpt_dir = os.path.join(out_dir, ".ckpt")

    pending = [p for p in track_paths if not journal.is_done(journal_key(p, stem_format))]
    done = len(track_paths) - len(pending)
    results = {"done": done, "processed": 0}

    # a crash can land between a track's journal fsync and its (async)
    # .ckpt cleanup; the resume skips the journal-done track and nothing
    # else would ever delete its checkpoint files
    for p in track_paths:
        if writes and journal.is_done(journal_key(p, stem_format)):
            for tag in (f"{bases[p]}.p1", f"{bases[p]}.p2"):
                clear_track_checkpoint(ckpt_dir, tag)

    separators: dict = {}

    def separator(fs) -> HPRIOffline:
        if fs not in separators:
            separators[fs] = HPRIOffline(fs, hop_h, hop_p, beta_h, beta_p, device=device, **impl_kw)
        return separators[fs]

    writer_pool = OrderedAsyncWriter() if prefetch > 0 else None

    def write_track(fs, path, h, p, r, n_samples, after=None):
        """The one per-track output contract: three peak-normalized stems
        (the reference CLI normalizes before its clipping PCM16 encode,
        offline.h:182-191), then the journal line, in that order, on the
        writer thread when there is one."""

        def job():
            for stem, data in (("harm", h), ("perc", p), ("residual", r)):
                if writes:
                    data = peak_normalize(np.asarray(data))
                writer(os.path.join(out_dir, f"{bases[path]}_{stem}.{stem_format}"), fs, data)
            journal.mark_done(journal_key(path, stem_format), {"samples": int(n_samples)})
            results["processed"] += 1
            if after is not None:
                after()

        if writer_pool is not None:
            writer_pool.submit(job)
        else:
            job()

    def flush(fs, batch_paths, batch_audio):
        lengths = [len(a) for a in batch_audio] + [0] * (n_dp - len(batch_audio))
        batch = np.zeros((n_dp, max(lengths)), np.float32)
        for row, a in zip(batch, batch_audio):
            row[: len(a)] = a
        sep = separator(fs)
        stems = sharded_hpri_offline(batch, sep.cfg_h, sep.cfg_p, mesh, lengths=lengths)
        h, p, r = (x.cpu().numpy() for x in stems)
        for j, (path, n) in enumerate(zip(batch_paths, lengths)):
            write_track(fs, path, h[j, :n], p[j, :n], r[j, :n], n)

    def flush_long(fs, path, audio):
        # the batched spectrogram holds ~160 bytes per sample; the blocked
        # pass holds one block, checkpointed mid-track so that a crash
        # hours into a track resumes from its last durable segment; with
        # sp > 1 every sp shard scans its own run of blocks
        tag = bases[path]
        sep = separator(fs)
        if n_sp > 1:
            stems = sharded_hpri_blocked(audio, sep.cfg_h, sep.cfg_p, mesh, ckpt_dir=ckpt_dir,
                                         tag=tag)
        elif writes:
            stems = sep.process_blocked(audio, ckpt_dir=ckpt_dir, tag=tag)
        else:
            # one device's scan: process 0 computes it, the others count
            # the track (on the writer thread, as the writes count theirs)
            write_track(fs, path, None, None, None, len(audio))
            return
        h, p, r = (x.cpu().numpy() for x in stems)

        def drop_ckpt():  # after the journal line: the stems are durable
            if writes:
                for p_tag in (f"{tag}.p1", f"{tag}.p2"):
                    clear_track_checkpoint(ckpt_dir, p_tag)

        write_track(fs, path, h, p, r, len(audio), after=drop_ckpt)

    pipes: dict = {}

    def flush_pp(fs, batch_paths, batch_audio):
        # pass 1 of track i+1 overlaps pass 2 of track i; the run's end
        # drains the pipeline
        if fs not in pipes:
            sep = separator(fs)
            pipes[fs] = PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, devices=list(mesh.devices.flat))
        for path, audio, stems in zip(batch_paths, batch_audio,
                                      pipes[fs].process_stream(batch_audio)):
            h, p, r = (x.cpu().numpy() for x in stems)
            write_track(fs, path, h, p, r, len(audio))

    do_flush = flush_pp if pp else flush
    cap = pp_run if pp else n_dp
    # sp shards the time axis, so a wider sp keeps longer tracks batched
    long_samples = LONG_TRACK_SAMPLES * n_sp
    items = (PrefetchReader(pending, reader, depth=prefetch) if prefetch > 0
             else ((p, reader(p)) for p in pending))
    batch_paths, batch_audio, batch_fs = [], [], None
    try:
        for path, (fs, audio) in items:
            if len(audio) > long_samples:
                flush_long(fs, path, audio)
                continue
            if batch_paths and (fs != batch_fs or len(batch_paths) == cap):
                do_flush(batch_fs, batch_paths, batch_audio)
                batch_paths, batch_audio = [], []
            batch_fs = fs
            batch_paths.append(path)
            batch_audio.append(audio)
        if batch_paths:
            do_flush(batch_fs, batch_paths, batch_audio)
    except BaseException:
        # let queued writes finish (their tracks did compute) but do not
        # mask the original error with a writer-side one
        if writer_pool is not None:
            try:
                writer_pool.close()
            except BaseException:  # noqa: BLE001 — the original error is re-raised
                pass
        raise
    finally:
        if isinstance(items, PrefetchReader):
            items.close()
    if writer_pool is not None:
        writer_pool.close()
    return results
