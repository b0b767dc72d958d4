"""Pipelined 2-pass HPR-I over a stream of tracks (counterpart of
``zen_tpu/drivers/pipeline.py``).

The cascade's two passes (the hop_h pass feeding the hop_p pass,
hps.cu:128-221) have independent state, so a stream of tracks pipelines:
pass 1 of track i+1 runs while pass 2 of track i runs. zen_tpu puts the
passes on two devices; on one card they run on two CUDA streams: pass 1
in a worker thread under stream A, pass 2 in the consumer under stream
B. The median kernels and torch's ops launch on the current stream,
which is per thread, so each thread enters its own.

Hand-offs between the streams, with no host synchronization:

* both streams first wait for what the caller's stream has enqueued;
* the worker records an event after pass 1 of a track, and stream B
  waits on it before pass 2 reads the intermediate;
* the caller's stream waits on an event recorded after pass 2 before it
  is handed the stems;
* every tensor that crosses to another stream is ``record_stream``-ed
  there, so that the caching allocator does not hand its memory to new
  work of the stream that made it while the other stream still reads it.

On the CPU it is the same two threads with no streams (torch's CPU ops
release the interpreter lock, so the passes overlap there too). The
worker's keep-alive, abort and join logic is zen_tpu's.
"""
from __future__ import annotations

import contextlib
import queue
import threading

import torch

from ..device import resolve_device
from ..engine.config import HPRConfig
from .offline import hpr_separate, on_device


def _stream(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _event(stream):
    """An event recorded on ``stream`` (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


class PipelinedHPRIOffline:
    """2-pass HPR-I with the passes on two CUDA streams of ``device``
    (the card unless ``device="cpu"``), or two threads on the CPU."""

    def __init__(self, cfg_h: HPRConfig, cfg_p: HPRConfig, device="cuda"):
        self.cfg_h = cfg_h
        self.cfg_p = cfg_p
        self.device = resolve_device(device)
        # one pair for the pipeline's life: the caching allocator pools
        # memory per stream, and fresh streams on every call would start
        # from empty pools (a cudaMalloc, which synchronizes the card, for
        # every tensor of the call)
        cuda = self.device.type == "cuda"
        self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device)) if cuda \
            else (None, None)

    def process_stream(self, tracks, prefetch: int = 2):
        """tracks: iterable of [L] audio (numpy, or tensors on ``device``).
        Yields (h, p, r) [L] tensors on ``device`` per track, in order,
        ready on the caller's current stream. Pass 1 of track i+1 runs in
        a worker thread while this thread runs pass 2 of track i;
        ``prefetch`` bounds the tracks in flight (backpressure on the
        worker)."""
        cuda = self.device.type == "cuda"
        caller = torch.cuda.current_stream(self.device) if cuda else None
        stream_a, stream_b = self._streams
        if cuda:  # the caller's inputs and cached constants come first
            stream_a.wait_stream(caller)
            stream_b.wait_stream(caller)
        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        DONE, ERR = object(), object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that aborts when the consumer is gone: an
            # abandoned generator must not leave this thread blocked
            # forever, pinning prefetched device buffers
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage1():
            try:
                with _stream(stream_a):
                    for audio in tracks:
                        if stop.is_set():
                            return
                        x = on_device(audio, self.device)
                        if cuda and isinstance(audio, torch.Tensor):
                            audio.record_stream(stream_a)
                        p1 = hpr_separate(x, self.cfg_h)
                        inter = p1["percussive"] + p1["residual"]
                        if not put((p1["harmonic"], inter, _event(stream_a))):
                            return
                put(DONE)
            except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
                put((ERR, e))

        t = threading.Thread(target=stage1, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    break
                if isinstance(item, tuple) and item[0] is ERR:
                    raise item[1]
                h, inter, pass1_done = item
                with _stream(stream_b):
                    if cuda:
                        stream_b.wait_event(pass1_done)
                        inter.record_stream(stream_b)
                    p2 = hpr_separate(inter, self.cfg_p)
                    del inter
                    pass2_done = _event(stream_b)
                out = (h, p2["percussive"], p2["residual"])
                if cuda:  # pass 2 waited on pass 1: one event covers all three
                    caller.wait_event(pass2_done)
                    for x in out:
                        x.record_stream(caller)
                yield out
        finally:
            stop.set()
            while True:  # unblock a worker stuck mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
