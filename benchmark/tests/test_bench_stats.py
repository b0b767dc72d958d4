"""The end-to-end arithmetic over planted step times: a stall shows in the
tail and in the rate."""
from __future__ import annotations

import pytest

from benchmark import harness, stats


def _run(step_ms: list, samples_per_step: int) -> harness.Run:
    window_s = sum(step_ms) / 1e3
    return harness.Run(setup_s=9.5, window_s=window_s,
                       work={"stream_samples": samples_per_step * len(step_ms)},
                       latencies_ms={"stream_step_ms": step_ms}, dispatch_s=[1e-3] * len(step_ms))


def _read(name: str, run: harness.Run):
    return harness.reader(name)(run)


def test_percentile_nearest_rank():
    assert stats.percentile([], 95) is None
    assert stats.percentile([3.0], 95) == 3.0
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 50) == 50


@pytest.mark.parametrize("stalls, p95", [(0, 2.0), (40, 2.0), (60, 12.0)])
def test_stall_in_tail_and_rate(stalls, p95):
    steps = [2.0] * (1000 - stalls) + [12.0] * stalls
    run = _run(steps, 8_388_608)
    assert _read("stream_step_p95_ms", run) == p95
    expected = 8_388_608 * 1000 / (sum(steps) / 1e3) / 1e6
    assert _read("stream_msamples_per_s", run) == pytest.approx(expected)
    # every stall costs the rate its whole length
    clean = 8_388_608 / 2e-3 / 1e6
    assert _read("stream_msamples_per_s", run) == pytest.approx(clean * 2000 / (2000 + 10 * stalls))


def test_offline_readers_and_missing_data():
    run = harness.Run(setup_s=1.0, window_s=10.0, work={"offline_audio_s": 240 * 1400},
                      latencies_ms={"offline_track_ms": [7.0] * 1330 + [9.0] * 70},
                      dispatch_s=[2e-3] * 1400)
    assert _read("offline_audio_s_per_s", run) == pytest.approx(33_600.0)
    assert _read("offline_track_p95_ms", run) == 7.0
    assert _read("dispatch_ms.offline", run) == pytest.approx(2.0)
    assert _read("setup_s", run) == 1.0
    # a reader finds nothing to read in another loop's run, and no trace
    assert _read("stream_msamples_per_s", run) is None
    assert _read("stream_step_p95_ms", run) is None
    for name in ("transform_us.offline", "glue_us.offline", "median_us.offline",
                 "median_roofline.offline", "idle_share.offline"):
        assert _read(name, run) is None


def test_trace_readers():
    from benchmark.tracing import Trace

    tr = Trace(units=10, window_s=0.02, busy_s=0.018,
               by_class_s={"transform": 0.005, "glue": 0.01, "median": 0.003})
    run = harness.Run(setup_s=1.0, window_s=1.0, work={}, latencies_ms={},
                      dispatch_s=[], median_bound_us=120.0, trace=tr)
    assert _read("transform_us.stream", run) == pytest.approx(500.0)
    assert _read("glue_us.stream", run) == pytest.approx(1000.0)
    assert _read("median_us.stream", run) == pytest.approx(300.0)
    assert _read("median_roofline.stream", run) == pytest.approx(40.0)
    assert _read("idle_share.stream", run) == pytest.approx(10.0)


def test_classify_kernel_names():
    from benchmark.tracing import classify

    assert classify("void vector_fft_c2r<512u, 4u>(kernel_arguments_t<unsigned int>)") == "transform"
    assert classify("void regular_fft<128u, EPT_4, 32u, 2u>(...)") == "transform"
    assert classify("void at::native::vectorized_elementwise_kernel<4, ...>") == "glue"
    assert classify("Memcpy DtoD (Device -> Device)") == "glue"
    assert classify("Memset (Device)") == "glue"
    assert classify("abs_kernel_vectorized2_kernel") == "glue"
    assert classify("bench.call") == "median"  # spans are dropped before classing
    assert classify("void zen_core::time_core_kernel<float, 3>(...)") == "median"


class _Loop:
    """Units that each take ``unit_s`` of host time to dispatch; what was
    kept, and when."""

    def __init__(self, unit_s: float):
        self.unit_s, self.calls, self.kept = unit_s, [], []

    def call(self, i):
        import time

        time.sleep(self.unit_s)
        self.calls.append(i)
        return f"out{i}"

    def keep(self, i, out):
        assert i in self.calls
        self.kept.append((i, out))


@pytest.mark.parametrize("in_flight", [1, 2, 4])
def test_window_in_flight(monkeypatch, in_flight):
    """Every unit sent in the window counts, each is waited for once and in
    order, at most ``in_flight`` are on the card at once, and the window
    closes after the last wait."""
    import torch

    waits, open_units = [], []  # units waited for, in order; units on the "card"
    wait = lambda device: lambda: waits.append(open_units.pop(0))  # noqa: E731
    monkeypatch.setattr(harness, "_sync", wait)
    monkeypatch.setattr(harness, "_marker", wait)
    loop = _Loop(2e-3)
    original = loop.call

    def call(i):
        out = original(i)
        open_units.append(i)
        assert len(open_units) <= in_flight
        return out

    loop.call = call
    wall, lat, disp, ends = harness.window(loop, 0.05, torch.device("cpu"), in_flight)
    n = len(loop.calls)
    assert n >= 0.05 / 2e-3 * 0.5 and waits == list(range(n)) and not open_units
    assert len(lat) == len(disp) == len(ends) == n and wall == ends[-1] >= 0.05
    assert [i for i, _ in loop.kept] == list(range(n)) and loop.kept[-1][1] == f"out{n - 1}"
    assert ends == sorted(ends) and all(ms >= d * 1e3 for ms, d in zip(lat, disp))
