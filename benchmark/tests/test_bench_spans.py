"""The readers of the program's phase spans (``benchmark/spans.py``,
``metrics/<phase>_us.py``, ``metrics/span_cover.py``): fake totals become
event µs a unit and the leaves' share of the busy time; nothing where the
spans carry no device time (the CPU), where the parent ran another number
of times than the slice has units, or where the program has no recorder;
and each traced run drains and reads its own slice alone."""
from __future__ import annotations

import pytest

from benchmark import harness, spans, tracing

STEP_LEAVES = ("frame", "analyze", "k1", "k2", "mask", "synth", "ola", "advance")
FLEET, TRACK = "fleet-81920x16", "offline-track240"


def _run(units=4, busy_s=0.2):
    trace = tracing.Trace(units=units, window_s=busy_s * 1.01, busy_s=busy_s)
    return harness.Run(setup_s=1.0, window_s=1.0, work={}, latencies_ms={}, dispatch_s=[],
                       trace=trace)


def _step_totals(units, leaf_s=0.025, device=True):
    out = {"zen.step": {"calls": units, "device_s": 8 * leaf_s if device else None,
                        "host_s": 0.01, "parents": {}}}
    for leaf in STEP_LEAVES:
        out[f"zen.{leaf}"] = {"calls": units, "device_s": leaf_s if device else None,
                              "host_s": 0.001, "parents": {"zen.step": units}}
    return out


@pytest.fixture
def fake_drain(monkeypatch):
    from zen_tpu_torch.runtime import profiling

    def install(totals):
        calls = []

        def drain():
            calls.append(1)
            return totals

        monkeypatch.setattr(profiling, "drain_spans", drain)
        return calls

    return install


def test_fake_totals_become_us_a_unit_and_cover(fake_drain):
    calls = fake_drain(_step_totals(4, leaf_s=0.025))
    run = _run(units=4, busy_s=0.2)
    for leaf in STEP_LEAVES:
        assert harness.reader(f"{leaf}_us.stream")(run) == pytest.approx(0.025 / 4 * 1e6)
    assert harness.reader("span_cover.stream")(run) == pytest.approx(100.0)
    assert harness.reader("pass1_us.offline")(run) is None  # a step has no pass 1
    assert len(calls) == 1  # the first reader drained; the others read its totals


def test_track_totals_and_their_leaves(fake_drain):
    def entry(calls, device_s, parents):
        return {"calls": calls, "device_s": device_s, "host_s": 0.0, "parents": parents}

    totals = {"zen.track": entry(2, 0.012, {}),
              "zen.pass1": entry(2, 0.004, {"zen.track": 2}),
              "zen.handoff": entry(2, 0.001, {"zen.track": 2}),
              "zen.pass2": entry(2, 0.007, {"zen.track": 2}),
              "zen.k2": entry(4, 0.006, {"zen.pass1": 2, "zen.pass2": 2}),
              "zen.ola": entry(4, 0.004, {"zen.pass1": 2, "zen.pass2": 2})}
    fake_drain(totals)
    run = _run(units=2, busy_s=0.0125)
    assert spans.leaves(totals) == ["zen.handoff", "zen.k2", "zen.ola"]
    assert harness.reader("pass1_us.offline")(run) == pytest.approx(2000.0)
    assert harness.reader("k2_us.offline")(run) == pytest.approx(3000.0)
    assert harness.reader("span_cover.offline")(run) == pytest.approx(88.0)
    assert harness.reader("advance_us.stream")(run) is None


@pytest.mark.parametrize("case", ["cpu", "count", "no_trace", "no_recorder"])
def test_nothing_to_read(fake_drain, monkeypatch, case):
    run = _run(units=4)
    if case == "cpu":
        fake_drain(_step_totals(4, device=False))
    elif case == "count":  # the recorder holds more than this slice
        fake_drain(_step_totals(5))
    elif case == "no_trace":
        fake_drain(_step_totals(4))
        run.trace = None
    else:  # a program from before the recorder
        from zen_tpu_torch.runtime import profiling

        monkeypatch.delattr(profiling, "drain_spans")
    for name in [f"{leaf}_us.stream" for leaf in STEP_LEAVES] + ["span_cover.stream"]:
        assert harness.reader(name)(run) is None


@pytest.mark.parametrize("cell, parent", [(FLEET, "zen.step"), (TRACK, "zen.track")])
def test_traced_runs_each_read_their_own_slice(small, monkeypatch, cell, parent):
    """Two traced small runs in one process: each drains the recorder once,
    and what it drains is its own slice's units; on the CPU no phase metric
    is reported (no device time)."""
    from zen_tpu_torch.runtime import profiling

    drained = []
    real = profiling.drain_spans

    def spy():
        drained.append(real())
        return drained[-1]

    monkeypatch.setattr(profiling, "drain_spans", spy)
    for _ in range(2):
        result = small(cell, traced=True)
        assert result["correct"] is True, result["checks"]
        units = result["attempted"] - result["window"]["units"]
        assert drained[-1][parent]["calls"] == units
        assert all(t["device_s"] is None for t in drained[-1].values())
        assert not set(result["metrics"]) & {n for n, cells in _new_metrics() if cell in cells}
    assert len(drained) == 2
    assert real() == {}


def _new_metrics():
    return [(m["name"], m.get("workloads", [])) for m in harness.manifest()["per_layer"]
            if m["name"].split(".")[0] in {f"{leaf}_us" for leaf in STEP_LEAVES}
            | {"pass1_us", "span_cover"}]
