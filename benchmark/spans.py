"""The program's phase spans (``zen_tpu_torch.runtime.profiling.span``) as
µs a unit of the traced slice.

The program records spans only while a profiler runs, and only the traced
slice runs under one, so what its recorder holds when a run's metrics are
read is the slice's. The first reader that asks for a run's spans drains
the recorder (``drain_spans()``) and keeps the totals for that run; the
others read them from there. A program without the recorder gives
nothing to read.

A span's time is the interval between the CUDA events the program
records on the stream at its ends (``program_span``): the device's time
only while the host stays ahead of the card. It also holds the gaps
between kernels and any wait of the card on the host, which the slice's
busy time does not. The profiler's own kernel records, grouped by the
span that launched them (``profiling.profiled_spans``), give the device
time alone; ``tracing.profile`` keeps no events for them yet.
"""
from __future__ import annotations

PARENTS = ("zen.step", "zen.track")  # one a unit: the streaming step, the two-pass track

_kept = {"trace": None, "totals": None}


def totals(run):
    """The span totals of ``run``'s traced slice, {name: {calls, device_s,
    host_s, parents}}; None without a trace or without a recorder in the
    program."""
    if run.trace is None:
        return None
    if _kept["trace"] is not run.trace:
        try:
            from zen_tpu_torch.runtime.profiling import drain_spans
        except ImportError:
            drain_spans = None
        _kept["trace"] = run.trace
        _kept["totals"] = None if drain_spans is None else drain_spans()
    return _kept["totals"]


def _unit_spans(run):
    """The totals where a parent span ran once a unit of the slice; None
    where none did (the recorder holds more or less than the slice)."""
    spans = totals(run)
    if not spans:
        return None
    if not any(spans.get(p, {}).get("calls") == run.trace.units for p in PARENTS):
        return None
    return spans


def span_us(name: str):
    """The reader of span ``name``'s event µs a unit of the slice: None
    where it did not run, or where ``_unit_spans`` gives nothing."""

    def read(run):
        spans = _unit_spans(run)
        span = None if spans is None else spans.get(name)
        if span is None or span["device_s"] is None:
            return None
        return span["device_s"] / run.trace.units * 1e6

    return read


def leaves(spans: dict) -> list:
    """The spans inside which no other span ran."""
    inner = {p for t in spans.values() for p in t["parents"]}
    return sorted(set(spans) - inner)


def cover(run):
    """The leaves' event time over the slice's busy time, in %."""
    spans = _unit_spans(run)
    if spans is None or run.trace.busy_s <= 0.0:
        return None
    times = [spans[name]["device_s"] for name in leaves(spans)]
    if not times or any(t is None for t in times):
        return None
    return 100.0 * sum(times) / run.trace.busy_s
