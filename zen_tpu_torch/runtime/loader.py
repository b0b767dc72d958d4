"""Host-side corpus data loader: prefetching reader + ordered async writer.

A copy of ``zen_tpu/runtime/loader.py`` (no JAX inside, but the port
imports nothing of the JAX package). Change both copies together.

The reference loads its single input wav synchronously and encodes the
stems afterwards (zen/offline.h:88-117, 193-253): nothing to overlap on
a seconds-long clip. At corpus scale the host decode and encode become a
serial tax between device calls: the card idles while the host decodes
the next track and encodes the previous stems. The corpus driver
overlaps all three with two small primitives:

* ``PrefetchReader``: a bounded background thread that decodes track
  i+k while the batch containing track i computes on the card.
* ``OrderedAsyncWriter``: a single worker thread that executes write
  jobs strictly in submit order. The crash-resume contract (stems
  durable BEFORE the journal line that marks them done,
  runtime/checkpoint.ProgressJournal) is preserved exactly because the
  same single thread performs both steps of every job in order.

Both propagate worker exceptions to the caller: the reader at the
``next()`` that would have returned the failed item, the writer at the
next ``submit()``/``close()``. Used by drivers/corpus.py (``prefetch=``,
``zen-torch corpus --prefetch``).
"""
from __future__ import annotations

import queue
import threading


class PrefetchReader:
    """Iterate ``(item, fn(item))`` over ``items`` with ``fn`` running
    ``depth`` items ahead in a background thread.

    ``fn`` must be safe to call off the main thread (the default corpus
    readers — scipy / the native RIFF codec — are). Order is preserved.
    Dropping the iterator stops the producer promptly (it parks on a
    bounded queue and checks a stop flag between items).
    """

    _DONE = object()

    def __init__(self, items, fn, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(list(items), fn), daemon=True
        )
        self._thread.start()

    def _produce(self, items, fn):
        try:
            for item in items:
                if self._stop.is_set():
                    return
                value = fn(item)
                while not self._stop.is_set():
                    try:
                        self._q.put((item, value), timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._put_forever(self._DONE)
        except BaseException as exc:  # noqa: BLE001 — forwarded to consumer
            self._put_forever(exc)

    def _put_forever(self, obj):
        while not self._stop.is_set():
            try:
                self._q.put(obj, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        try:
            while True:
                got = self._q.get()
                if got is self._DONE:
                    return
                if isinstance(got, BaseException):
                    raise got
                yield got
        finally:
            self.close()

    def close(self):
        self._stop.set()
        # drain one slot so a producer blocked on put() can observe stop
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class OrderedAsyncWriter:
    """Execute zero-arg jobs on one worker thread, strictly in submit
    order. The queue is bounded (``max_pending``): ``submit`` blocks
    when the worker falls behind, so queued stem arrays cannot pin
    unbounded host memory behind a slow disk. A job exception is
    re-raised at EVERY subsequent ``submit()`` and at ``close()``
    (failure is sticky — jobs queued after a failed one are discarded,
    never silently run out of order; their tracks are simply never
    journaled and the resume picks them up)."""

    _DONE = object()

    def __init__(self, max_pending: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, max_pending))
        self._exc: BaseException | None = None
        self._failed = False  # sticky: once a job fails, discard the rest
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is self._DONE:
                return
            if self._failed:
                continue
            try:
                job()
            except BaseException as exc:  # noqa: BLE001 — re-raised in submit/close
                self._exc = exc
                self._failed = True

    def _raise_pending(self):
        if self._exc is not None:
            # do NOT clear: every later submit()/close() must keep
            # failing loudly — a caller that swallows one raise and
            # keeps submitting would otherwise lose jobs silently
            raise self._exc

    def submit(self, job) -> None:
        self._raise_pending()
        self._q.put(job)

    def close(self) -> None:
        """Drain the queue, stop the worker, re-raise any job failure."""
        self._q.put(self._DONE)
        self._thread.join()
        self._raise_pending()
