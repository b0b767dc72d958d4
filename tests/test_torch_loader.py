"""The port's corpus I/O overlap (zen_tpu_torch/runtime/loader.py:
PrefetchReader, OrderedAsyncWriter) against zen_tpu's, on the CPU.

The port's loader is a copy of zen_tpu's: every case of
tests/test_loader.py runs on both packages' classes (parametrized), so
the port is held to zen_tpu's behaviour: order, a producer error raised at
the next() that would have returned its item, sticky writer failures,
bounded queues, an early close that stops the producer. Then through the
port's corpus driver: stems bitwise equal with prefetch on and off (one
package, one arithmetic), overlap measured as intervals with injected
delays, crash consistency after a writer failure, and parity under random
reader and writer delays.
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zen_tpu.runtime import loader as jloader  # noqa: E402
from zen_tpu_torch.drivers import corpus as tcorpus  # noqa: E402
from zen_tpu_torch.drivers.corpus import separate_corpus  # noqa: E402
from zen_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from zen_tpu_torch.runtime import loader as tloader  # noqa: E402
from zen_tpu_torch.runtime.checkpoint import ProgressJournal  # noqa: E402

LOADERS = pytest.mark.parametrize("mod", [jloader, tloader], ids=["zen_tpu", "port"])
HOPS = dict(hop_h=16, hop_p=8)


def _mesh(dp=1):
    return make_mesh({"dp": dp, "sp": 1}, device="cpu")


def _store(n_tracks, fs=1000, length=400, seed=0):
    rng = np.random.default_rng(seed)
    return {
        f"/virt/track{i}.wav": (fs, rng.standard_normal(length).astype(np.float32) * 0.5)
        for i in range(n_tracks)
    }


@LOADERS
def test_prefetch_reader_order_and_values(mod):
    items = list(range(20))
    out = list(mod.PrefetchReader(items, lambda i: i * i, depth=3))
    assert out == [(i, i * i) for i in items]


@LOADERS
def test_prefetch_reader_propagates_producer_error(mod):
    def fn(i):
        if i == 3:
            raise ValueError("decode failed")
        return i

    got = []
    with pytest.raises(ValueError, match="decode failed"):
        for item, _ in mod.PrefetchReader(range(10), fn, depth=2):
            got.append(item)
    assert got == [0, 1, 2]  # everything before the failing item, in order


@LOADERS
def test_prefetch_reader_early_close_stops_producer(mod):
    started = []

    def fn(i):
        started.append(i)
        time.sleep(0.01)
        return i

    it = iter(mod.PrefetchReader(range(1000), fn, depth=2))
    next(it)
    it.close()
    time.sleep(0.1)
    n = len(started)
    time.sleep(0.1)
    assert len(started) == n  # the producer stopped, not racing ahead
    assert n < 1000


@LOADERS
def test_prefetch_reader_queue_is_bounded(mod):
    """A consumer that does not read leaves the producer parked at most
    ``depth`` items ahead (plus the one it holds)."""
    started = []
    reader = mod.PrefetchReader(range(100), lambda i: started.append(i) or i, depth=2)
    try:
        deadline = time.time() + 5.0
        while len(started) < 3 and time.time() < deadline:
            time.sleep(0.005)
        time.sleep(0.1)
        assert len(started) == 3  # two queued, one parked on put
    finally:
        reader.close()
    assert not reader._thread.is_alive()


@LOADERS
def test_ordered_async_writer_order_and_close(mod):
    done = []
    w = mod.OrderedAsyncWriter()
    for i in range(50):
        w.submit(lambda i=i: done.append(i))
    w.close()
    assert done == list(range(50))


@LOADERS
def test_ordered_async_writer_failure_discards_rest(mod):
    done = []
    w = mod.OrderedAsyncWriter()
    w.submit(lambda: done.append(0))
    w.submit(lambda: (_ for _ in ()).throw(RuntimeError("disk full")))
    w.submit(lambda: done.append(2))  # must be discarded, not run
    with pytest.raises(RuntimeError, match="disk full"):
        w.close()
    assert done == [0]


@LOADERS
def test_ordered_async_writer_failure_is_persistent(mod):
    """Every later submit re-raises: a caller that swallows one raise
    must not silently lose later jobs."""
    done = []
    w = mod.OrderedAsyncWriter()
    w.submit(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    deadline = time.time() + 5.0
    while w._exc is None and time.time() < deadline:
        time.sleep(0.005)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="boom"):
            w.submit(lambda: done.append(1))
    with pytest.raises(RuntimeError, match="boom"):
        w.close()
    assert done == []


def test_corpus_prefetch_parity(tmp_path):
    """Stems bitwise equal between prefetch=2 and prefetch=0."""
    store = _store(5, seed=7)

    def run(prefetch, tag):
        out = {}

        def writer(p, fs, a):
            out[os.path.basename(p)] = np.asarray(a).copy()

        res = separate_corpus(list(store), str(tmp_path / tag), _mesh(dp=2),
                              reader=lambda p: store[p], writer=writer, prefetch=prefetch, **HOPS)
        assert res["processed"] == 5
        return out

    a, b = run(0, "sync"), run(2, "pre")
    assert a.keys() == b.keys() and len(a) == 15
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_corpus_io_overlap_measured(tmp_path, monkeypatch):
    """With injected decode, separation and encode delays, the measured
    intervals show the prefetching run's I/O overlapping the separation
    (a decode and an encode each run while a batch's sharded_hpri_offline
    call does), and the synchronous run's never. Intervals, not a
    wall-clock margin: the suite shares the host's cores with other
    workers."""
    import threading

    store = _store(6, seed=3)
    real = tcorpus.sharded_hpri_offline
    spans = {"read": [], "process": [], "write": []}
    lock = threading.Lock()

    def timed(kind, fn, delay):
        t0 = time.perf_counter()
        time.sleep(delay)
        out = fn()
        with lock:
            spans[kind].append((t0, time.perf_counter()))
        return out

    monkeypatch.setattr(tcorpus, "sharded_hpri_offline", lambda *a, **kw: timed(
        "process", lambda: real(*a, **kw), 0.03))

    def overlaps(kind):
        return sum(a0 < b1 and b0 < a1 for a0, a1 in spans[kind] for b0, b1 in spans["process"])

    for prefetch in (0, 2):
        for v in spans.values():
            v.clear()
        res = separate_corpus(list(store), str(tmp_path / f"pf{prefetch}"), _mesh(),
                              prefetch=prefetch,
                              reader=lambda p: timed("read", lambda: store[p], 0.06),
                              writer=lambda p, fs, a: timed("write", lambda: None, 0.02), **HOPS)
        assert res["processed"] == 6
        assert [len(v) for v in spans.values()] == [6, 6, 18]
        if prefetch:
            assert overlaps("read") > 0 and overlaps("write") > 0, spans
        else:
            assert overlaps("read") == 0 and overlaps("write") == 0, spans


def test_corpus_writer_failure_is_crash_consistent(tmp_path):
    """A stem-encode failure mid-run surfaces to the caller; the journal
    holds exactly the durably written tracks, and a rerun with the writer
    fixed completes only the rest."""
    store = _store(6, seed=9)
    paths = sorted(store)
    out = str(tmp_path / "out")
    fail_on = os.path.basename(paths[3])[:-4]

    def writer(p, fs, a):
        if fail_on in os.path.basename(p):
            raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        separate_corpus(paths, out, _mesh(), reader=lambda p: store[p], writer=writer,
                        prefetch=2, **HOPS)
    j = ProgressJournal(os.path.join(out, "progress.jsonl"))
    assert all(j.is_done(p) for p in paths[:3])
    assert not any(j.is_done(p) for p in paths[3:])

    ok = []
    res = separate_corpus(paths, out, _mesh(), reader=lambda p: store[p],
                          writer=lambda p, fs, a: ok.append(os.path.basename(p)), prefetch=2,
                          **HOPS)
    assert res["done"] == 3 and res["processed"] == 3
    assert len(ok) == 9  # 3 remaining tracks x 3 stems


def test_corpus_prefetch_stress_jitter_parity(tmp_path):
    """Random per-call reader and writer delays: whatever interleaving
    they produce, the prefetching run's stems and journal equal the
    synchronous run's (order, names, bits)."""
    n = 12
    store = _store(n, length=220, seed=21)
    delay_rng = np.random.default_rng(77)

    def run(prefetch, tag, jitter):
        out = {}

        def reader(p):
            if jitter:
                time.sleep(float(delay_rng.uniform(0, 0.01)))
            return store[p]

        def writer(p, fs, a):
            if jitter:
                time.sleep(float(delay_rng.uniform(0, 0.004)))
            out[os.path.basename(p)] = np.asarray(a).copy()

        res = separate_corpus(sorted(store), str(tmp_path / tag), _mesh(dp=2), reader=reader,
                              writer=writer, prefetch=prefetch, **HOPS)
        assert res["processed"] == n
        j = ProgressJournal(str(tmp_path / tag / "progress.jsonl"))
        assert all(j.is_done(p) for p in store)
        return out

    base = run(0, "sync", jitter=False)
    jittered = run(3, "jit", jitter=True)
    assert base.keys() == jittered.keys() and len(base) == 3 * n
    for k in base:
        np.testing.assert_array_equal(base[k], jittered[k], err_msg=k)
