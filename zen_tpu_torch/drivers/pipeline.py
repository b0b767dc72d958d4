"""Pipelined 2-pass HPR-I over a stream of tracks (counterpart of
``zen_tpu/drivers/pipeline.py``).

The cascade's two passes (the hop_h pass feeding the hop_p pass,
hps.cu:128-221) have independent state, so a stream of tracks pipelines:
pass 1 of track i+1 runs while pass 2 of track i runs. zen_tpu puts the
passes on two devices (``devices[0]`` and ``devices[1 % n]``), as the
port does when given ``devices``: pass 1 in a worker thread under stream
A of the first, pass 2 in the consumer under stream B of the second; the
same card given twice (or ``device=``) is two streams of that card. The
median kernels and torch's ops launch on the current stream, which is
per thread, so each thread enters its own.

Hand-offs between the streams, with no host synchronization:

* both streams first wait for what the caller's streams have enqueued;
* the worker records an event after pass 1 of a track, and stream B
  waits on it before pass 2 reads the intermediate; across two cards the
  intermediate then crosses with ``.to(dev_b, non_blocking=True)``, which
  torch orders after stream B's wait (a barrier both ways);
* the caller's streams wait on the events recorded after pass 2 (and,
  across two cards, pass 1) before they are handed the stems;
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
    """2-pass HPR-I with pass 1 on ``devices[0]`` and pass 2 on
    ``devices[1 % n]`` (zen_tpu's placement), or both on ``device`` (the
    card unless ``device="cpu"``) when ``devices`` is not given. On one
    card the passes run on two CUDA streams of it; on two cards on a
    stream of each, the intermediate crossing with a peer copy; on the
    CPU in two threads."""

    def __init__(self, cfg_h: HPRConfig, cfg_p: HPRConfig, device="cuda", devices=None):
        self.cfg_h = cfg_h
        self.cfg_p = cfg_p
        devs = [resolve_device(d) for d in devices] if devices else [resolve_device(device)]
        self.dev_a, self.dev_b = devs[0], devs[1 % len(devs)]
        # one pair for the pipeline's life: the caching allocator pools
        # memory per stream, and fresh streams on every call would start
        # from empty pools (a cudaMalloc, which synchronizes the card, for
        # every tensor of the call)
        cuda = self.dev_a.type == "cuda"
        self._streams = (torch.cuda.Stream(self.dev_a), torch.cuda.Stream(self.dev_b)) if cuda \
            else (None, None)

    def process_stream(self, tracks, prefetch: int = 2):
        """tracks: iterable of [L] audio (numpy, or tensors on
        ``devices[0]``). Yields (h, p, r) [L] tensors per track, in order,
        ready on the caller's current streams: h on ``devices[0]``, p and r
        on ``devices[1 % n]``. Pass 1 of track i+1 runs in a worker thread
        while this thread runs pass 2 of track i; ``prefetch`` bounds the
        tracks in flight (backpressure on the worker)."""
        dev_a, dev_b = self.dev_a, self.dev_b
        cuda = dev_a.type == "cuda"
        peer = dev_a != dev_b
        caller_a = torch.cuda.current_stream(dev_a) if cuda else None
        caller_b = torch.cuda.current_stream(dev_b) if cuda else None
        stream_a, stream_b = self._streams
        if cuda:  # the caller's inputs and cached constants come first
            stream_a.wait_stream(caller_a)
            stream_b.wait_stream(caller_b)
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
                        x = on_device(audio, dev_a)
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
                        if peer:
                            # the peer copy runs on this thread's current
                            # stream of dev_a, after a barrier on stream_b
                            inter.record_stream(torch.cuda.current_stream(dev_a))
                            inter = inter.to(dev_b, non_blocking=True)
                        else:
                            inter.record_stream(stream_b)
                    p2 = hpr_separate(inter, self.cfg_p)
                    del inter
                    pass2_done = _event(stream_b)
                out = (h, p2["percussive"], p2["residual"])
                if cuda:  # pass 2 waited on pass 1: on one card one event covers all three
                    caller_b.wait_event(pass2_done)
                    if peer:
                        caller_a.wait_event(pass1_done)
                    for x, caller in zip(out, (caller_a, caller_b, caller_b)):
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
