"""The port's phase spans (``zen_tpu_torch/runtime/profiling.span``) on the
CPU: off, nothing is recorded; on, under torch.profiler, one streaming
step and one two-pass track record each named span as often as the
phases run, inside their parents, with every ATen op of a unit under
exactly one leaf, and the outputs bitwise those of an untraced run. CPU
spans carry no device time."""
import json
import sys
import threading
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.drivers.realtime import StreamState, block_step, init_state  # noqa: E402
from zen_tpu_torch.runtime import profiling  # noqa: E402

STEP_LEAVES = ("zen.frame", "zen.analyze", "zen.k1", "zen.k2", "zen.mask", "zen.synth",
               "zen.ola", "zen.advance")
PASS_LEAVES = ("zen.frame", "zen.analyze", "zen.k1", "zen.k2", "zen.mask", "zen.synth",
               "zen.ola")
PASSES = ("zen.pass1", "zen.handoff", "zen.pass2")


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.drain_spans()
    yield
    profiling.drain_spans()


def _stream(streams=3, hops=4, seed=0, **kw):
    cfg = T.MultiStreamHPR(streams, 1000.0, 8, device="cpu", **kw).cfg
    rng = np.random.default_rng(seed)
    blocks = torch.from_numpy(rng.standard_normal((streams, hops, cfg.hop)).astype(np.float32))
    state = init_state(cfg, streams, "cpu")
    state.ring.copy_(torch.from_numpy(rng.standard_normal(state.ring.shape).astype(np.float32)))
    return cfg, state, blocks


def _track(seconds=1.5, seed=1):
    sep = T.HPRIOffline(1000.0, 64, 16, device="cpu")
    audio = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        int(1000 * seconds)).astype(np.float32))
    return sep, audio


def _clone(state):
    return StreamState(*(t.clone() for t in state))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def test_off_is_one_shared_noop_that_records_and_allocates_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("zen.step") is profiling.span("zen.k1", torch.zeros(1))
    cfg, state, blocks = _stream()
    block_step(cfg, state, blocks)
    assert profiling.span_totals() == {}
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("zen.step", blocks):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename == profiling.__file__]
    assert not grown, grown
    assert profiling.span_totals() == {}


def test_block_step_records_each_phase_once_a_step():
    cfg, state, blocks = _stream()
    _traced(lambda: block_step(cfg, state, blocks))
    totals = profiling.span_totals()
    assert set(totals) == {"zen.step", *STEP_LEAVES}
    assert totals["zen.step"]["calls"] == 1 and totals["zen.step"]["parents"] == {}
    for leaf in STEP_LEAVES:
        assert totals[leaf]["calls"] == 1, leaf
        assert totals[leaf]["parents"] == {"zen.step": 1}, leaf
    for t in totals.values():
        assert t["device_s"] is None and t["host_s"] > 0.0
    assert sum(totals[leaf]["host_s"] for leaf in STEP_LEAVES) <= totals["zen.step"]["host_s"]


def test_process_records_each_leaf_once_a_pass():
    sep, audio = _track()
    _traced(lambda: sep.process(audio))
    totals = profiling.span_totals()
    assert set(totals) == {"zen.track", *PASSES, *PASS_LEAVES}
    assert totals["zen.track"]["calls"] == 1 and totals["zen.track"]["parents"] == {}
    for name in PASSES:
        assert totals[name]["calls"] == 1 and totals[name]["parents"] == {"zen.track": 1}
    for leaf in PASS_LEAVES:
        assert totals[leaf]["calls"] == 2, leaf
        assert totals[leaf]["parents"] == {"zen.pass1": 1, "zen.pass2": 1}, leaf
    assert all(t["device_s"] is None for t in totals.values())


def _ranges(events, names):
    return [(e.name, e.time_range.start, e.time_range.end) for e in events if e.name in names]


@pytest.mark.parametrize("unit", ["step", "track"])
def test_every_aten_op_of_a_unit_lies_under_exactly_one_leaf(unit):
    if unit == "step":
        cfg, state, blocks = _stream()
        _, events = _traced(lambda: block_step(cfg, state, blocks))
        parent, leaves = "zen.step", STEP_LEAVES
    else:
        sep, audio = _track()
        _, events = _traced(lambda: sep.process(audio))
        parent, leaves = "zen.track", PASS_LEAVES + ("zen.handoff",)
    (_, lo, hi), = _ranges(events, {parent})
    spans = _ranges(events, set(leaves))
    ops = [e for e in events if e.name.startswith("aten::")
           and lo <= e.time_range.start and e.time_range.end <= hi]
    assert len(ops) > 20
    for e in ops:
        holders = [name for name, a, b in spans if a <= e.time_range.start and e.time_range.end <= b]
        assert len(holders) == 1, (e.name, holders)
    # leaves never nest in one another
    for i, (n1, a1, b1) in enumerate(spans):
        for n2, a2, b2 in spans[i + 1:]:
            assert b1 <= a2 or b2 <= a1, (n1, n2)


@pytest.mark.parametrize("kw", [{}, {"stream_state": "bf16"}, {"use_sse": True},
                                {"soft_mask": True}])
def test_step_outputs_and_state_bitwise_with_spans_on_and_off(kw):
    cfg, state, blocks = _stream(**kw)
    other = _clone(state)
    for _ in range(2):
        want = block_step(cfg, state, blocks)
        got, _ = _traced(lambda: block_step(cfg, other, blocks))
        assert torch.equal(got, want)
    for a, b in zip(state, other):
        assert torch.equal(a, b)
    assert profiling.drain_spans()["zen.step"]["calls"] == 2


def test_track_stems_bitwise_with_spans_on_and_off():
    sep, audio = _track()
    want = sep.process(audio)
    got, _ = _traced(lambda: sep.process(audio))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_blocked_pass_carries_the_leaf_names():
    sep, audio = _track(seconds=2.0)
    want = sep.process_blocked(audio, block_frames_h=8, block_frames_p=32)
    got, _ = _traced(lambda: sep.process_blocked(audio, block_frames_h=8, block_frames_p=32))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    totals = profiling.span_totals()
    assert set(PASS_LEAVES) <= set(totals)
    assert totals["zen.k1"]["calls"] == totals["zen.k2"]["calls"] == totals["zen.synth"]["calls"]


def test_drain_leaves_the_recorder_empty():
    cfg, state, blocks = _stream()
    _traced(lambda: block_step(cfg, state, blocks))
    first = profiling.drain_spans()
    assert first["zen.step"]["calls"] == 1
    assert profiling.span_totals() == {} and profiling.drain_spans() == {}


def test_threads_keep_their_own_parents():
    """More threads than cores, each opening spans under its own parent
    while the interpreter switches often: no span is lost, and each
    leaf's parent is its own thread's."""
    n_threads, n_spans = 32, 50
    x = torch.ones(2)
    errors = []

    def work(k):
        try:
            for _ in range(n_spans):
                with profiling.span(f"zen.t{k}", x):
                    with profiling.span("zen.leaf", x):
                        x.add(1)
        except Exception as exc:  # reported below, with the thread's number
            errors.append((k, exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    totals = profiling.drain_spans()
    assert totals["zen.leaf"]["calls"] == n_threads * n_spans
    assert totals["zen.leaf"]["parents"] == {f"zen.t{k}": n_spans for k in range(n_threads)}


def test_trace_writes_the_spans_beside_the_chrome_trace(tmp_path):
    cfg, state, blocks = _stream()
    with profiling.trace(tmp_path / "t"):
        block_step(cfg, state, blocks)
    spans = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert "traceEvents" in json.loads((tmp_path / "t" / "trace.json").read_text())
    assert set(spans) == {"zen.step", *STEP_LEAVES}
    assert spans["zen.frame"] == {"calls": 1, "device_us": None,
                                  "host_us": spans["zen.frame"]["host_us"],
                                  "parents": {"zen.step": 1}}
    assert spans["zen.frame"]["host_us"] > 0
    assert spans["zen.step"]["host_us"] >= sum(spans[n]["host_us"] for n in STEP_LEAVES)
    # inside trace() a span is its RecordFunction alone: nothing is recorded
    assert profiling.span_totals() == {}


def test_inside_trace_a_span_opens_a_record_function_alone(tmp_path):
    with profiling.trace(tmp_path):
        held = profiling.span("zen.k1", torch.zeros(1))
        assert not isinstance(held, profiling._Span) and held is not profiling._OFF
        with held:
            torch.ones(3).add(1)
    assert not profiling._ranges_only
    assert json.loads((tmp_path / "spans.json").read_text())["zen.k1"]["calls"] == 1
    assert profiling.span_totals() == {}


class _Op:
    """A host op of a profiler's event list, with the device operations it
    launched (``kernels``: (name, duration µs))."""

    def __init__(self, name, parent=None, kernels=(), cpu_us=1.0):
        from types import SimpleNamespace

        self.name, self.cpu_parent, self.cpu_time_total = name, parent, cpu_us
        self.device_type = torch.autograd.DeviceType.CPU
        self.kernels = [SimpleNamespace(name=n, duration=d) for n, d in kernels]


@pytest.mark.parametrize("on_card", [True, False])
def test_profiled_spans_give_each_span_the_operations_launched_inside_it(on_card):
    """A span holds the device operations of the ops under it and its own
    launches, never the device-side record of a span's range; a parent
    holds its children's; device events themselves are read through the
    ops that launched them."""
    step = _Op("zen.step", cpu_us=100.0, kernels=[("Memcpy DtoD", 1.0)])
    k1 = _Op("zen.k1", step, kernels=[("zen.k1", 50.0), ("median_k1", 7.0)], cpu_us=10.0)
    add = _Op("aten::add", k1, kernels=[("add_kernel", 3.0)])
    mask = _Op("zen.mask", step, cpu_us=20.0)
    div = _Op("aten::div", mask, kernels=[("div_kernel", 5.0)])
    device = _Op("add_kernel")
    device.device_type = torch.autograd.DeviceType.CUDA
    outside = _Op("aten::mul", kernels=[("mul_kernel", 9.0)])
    got = profiling.profiled_spans([step, k1, add, mask, div, device, outside], on_card)
    assert set(got) == {"zen.step", "zen.k1", "zen.mask"}
    want = {"zen.step": 16.0, "zen.k1": 10.0, "zen.mask": 5.0}
    for name, us in want.items():
        assert got[name]["device_us"] == (us if on_card else None), name
        assert got[name]["calls"] == 1
    assert got["zen.k1"]["parents"] == {"zen.step": 1} and got["zen.step"]["parents"] == {}
    assert got["zen.mask"]["host_us"] == 20.0


def test_a_long_profiled_session_keeps_the_recorder_bounded(monkeypatch):
    """Under a profiler that is not trace()'s, and that no one drains, the
    recorder keeps at most SPANS_KEPT spans with their events; the totals
    of the rest stay exact."""
    monkeypatch.setattr(profiling, "SPANS_KEPT", 8)
    x = torch.ones(2)
    held = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(100):
            with profiling.span("zen.step", x):
                with profiling.span("zen.k1", x):
                    x.add(1)
            held.append(len(profiling._RECORDER._closed))
    assert max(held) <= 8
    first = profiling.span_totals()  # a read keeps what it read
    totals = profiling.drain_spans()
    assert first == totals
    assert totals["zen.step"]["calls"] == totals["zen.k1"]["calls"] == 100
    assert totals["zen.k1"]["parents"] == {"zen.step": 100}
    assert profiling.drain_spans() == {}


def test_spans_fall_back_to_record_function_without_the_private_guard(monkeypatch):
    """A torch without ``torch._C._profiler._RecordFunctionFast`` opens its
    spans with ``record_function``; the port imports either way."""
    import types

    from torch.profiler import record_function

    monkeypatch.setitem(sys.modules, "torch._C._profiler", types.ModuleType("torch._C._profiler"))
    profiling._range_guard.cache_clear()
    try:
        assert profiling._range_guard() is record_function
        _, events = _traced(lambda: profiling.span("zen.k1", torch.zeros(1)).__enter__()
                            .__exit__(None, None, None))
        assert [e.name for e in events if e.name == "zen.k1"] == ["zen.k1"]
    finally:
        profiling._range_guard.cache_clear()  # the next span imports the guard anew


class _FakeEvent:
    """A timing event whose record time is a counter (ms)."""

    clock = 0

    def __init__(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_consecutive_spans_share_their_events(monkeypatch):
    """With a card's stream faked: a first child starts at its parent's
    start event, a sibling at the previous sibling's end, a span without a
    parent and a span on another stream at an event of their own; each span
    records one new event at its end."""
    made = []

    def recorded(stream):
        made.append(_FakeEvent())
        return made[-1]

    streams = {"card": object(), "other": object()}
    monkeypatch.setattr(profiling, "_recorded", recorded)
    monkeypatch.setattr(profiling._RECORDER, "stream", lambda on: streams.get(on))

    def unit():
        with profiling.span("zen.step", "card"):
            with profiling.span("zen.frame", "card"):
                pass
            with profiling.span("zen.analyze", "card"):
                pass
            with profiling.span("zen.k1", "other"):
                pass
            with profiling.span("zen.mask", None):  # on the host: no event
                pass

    _traced(unit)
    _traced(unit)
    # a unit: step start, frame end, analyze end, k1 start and end, step end
    assert len(made) == 12
    totals = profiling.drain_spans()
    # each span of a unit is one clock tick long but k1 (its own start) and
    # the step (its end after k1's); the second unit starts on its own event
    assert totals["zen.frame"]["device_s"] == pytest.approx(2e-3)
    assert totals["zen.analyze"]["device_s"] == pytest.approx(2e-3)
    assert totals["zen.k1"]["device_s"] == pytest.approx(2e-3)
    assert totals["zen.step"]["device_s"] == pytest.approx(10e-3)
    assert totals["zen.mask"]["device_s"] is None
    assert totals["zen.analyze"]["calls"] == 2
