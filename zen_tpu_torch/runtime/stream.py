"""Live streaming runtime: native ring buffers around the card
(counterpart of ``zen_tpu/runtime/stream.py``).

A producer (an audio callback, a network source) pushes samples into
the input ring; the feeder pops whole blocks of ``block_hops`` hops,
runs one ``HPRRealtime.process_block`` step on the device, reads the
block's stems back once and pushes them into one output ring per stem.
The block bounds the latency it adds to ``block_hops`` hops. This is
what the reference approximates with pinned zero-copy buffers and a
launch per hop (fakert.h:217-251).
"""
from __future__ import annotations

import threading

import numpy as np

from ..drivers.realtime import HPRRealtime
from ..engine.spectral import STEMS
from .native import RingBuffer


class LiveStream:
    """Real-time separation service around HPRRealtime, on ``device`` (the
    card unless ``device="cpu"`` is passed). Further keywords go to
    HPRRealtime's config."""

    def __init__(
        self,
        fs: float,
        hop: int = 256,
        beta: float = 2.0,
        outputs: int = 0,
        block_hops: int = 16,
        ring_capacity: int = 1 << 16,
        device="cuda",
        **cfg_kw,
    ):
        self.rt = HPRRealtime(fs, hop, beta, outputs=outputs, device=device, **cfg_kw)
        self.hop = hop
        self.block_hops = block_hops
        self.in_ring = RingBuffer(ring_capacity)
        self.out_rings = {k: RingBuffer(ring_capacity) for k in STEMS}
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread: threading.Thread | None = None
        self.blocks_processed = 0
        self.dropped_out_samples = 0

    # -- producer side (the audio callback) --
    def push(self, samples: np.ndarray) -> int:
        return self.in_ring.write(samples)

    # -- consumer side --
    def pull(self, stem: str, n: int):
        return self.out_rings[stem].read(n)

    def warmup(self):
        """Build the kernels and cuFFT plans for the block size, once."""
        if not self._ready.is_set():
            self.rt.warmup(block_sizes=(self.block_hops,))
            self._ready.set()
        return self

    def poll(self) -> bool:
        """Process at most one pending block on the calling thread; True
        if one was processed."""
        block = self.in_ring.read(self.block_hops * self.hop)
        if block is None:
            return False
        outs = self.rt.process_block(block.reshape(-1, self.hop)).cpu().numpy()
        for i, k in enumerate(STEMS):
            wrote = self.out_rings[k].write(outs[i])
            if wrote != len(outs[i]):
                # a lagging consumer lost samples, so every later pull is
                # shifted in time: count it rather than desynchronize silently
                self.dropped_out_samples += len(outs[i]) - wrote
        self.blocks_processed += 1
        return True

    def _run(self):
        self.warmup()
        while not self._stop.is_set():
            if not self.poll():
                self._stop.wait(0.0005)

    def start(self, wait_ready: bool = True, timeout: float = 300.0):
        """Start the feeder thread; by default wait until it has warmed up
        (a real-time producer must not start before the kernels are built)."""
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if wait_ready and not self._ready.wait(timeout):
            raise RuntimeError("LiveStream warmup did not complete")
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
