"""Per-layer device numbers from one torch.profiler slice of steady work.

The slice runs under ``profile(activities=[CPU, CUDA])`` inside a
``bench.window`` span. Every device operation (kernel, memcpy, memset)
is classed by its name alone:

* ``transform``: cuFFT's kernels (NVIDIA's names carry ``fft``);
* ``glue``: ATen's kernels (``at::``, and the jiterator's, compiled at run
  time) and memcpy / memset;
* ``median``: every other kernel, so a hand-written kernel that a later
  change adds is counted with the medians without an edit here.

Busy time is the union of the device operations' intervals inside the
window; the idle gaps between them are named by what the host was doing
at their middle: the benchmark's own span and the innermost ATen op.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

CLASSES = ("transform", "glue", "median")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown


# ATen's kernels compiled at run time (the jiterator: complex abs and the
# like) carry no namespace and no signature: <op>_kernel[_vectorized<N>]_kernel
JITERATOR = re.compile(r"^\w+_kernel(_vectorized\d+)?_kernel$")


def classify(name: str) -> str:
    if "at::" in name or name.startswith(("Memcpy", "Memset")) or JITERATOR.match(name):
        return "glue"
    if "fft" in name.lower():
        return "transform"
    return "median"


@dataclass
class Trace:
    units: int  # units of work (steps or tracks) in the slice
    window_s: float
    busy_s: float
    by_class_s: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)  # [[name, seconds]], longest first
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds]], longest first
    names: dict = field(default_factory=dict)  # {kernel name: class}

    def per_unit_us(self, cls: str) -> float:
        return self.by_class_s.get(cls, 0.0) / self.units * 1e6


def class_us(cls: str):
    """The reader of a class's device µs per unit of work in the traced
    slice: None without a trace, or with no time in the class."""

    def read(run):
        if run.trace is None or run.trace.by_class_s.get(cls, 0.0) <= 0.0:
            return None
        return run.trace.per_unit_us(cls)

    return read


def _merge(intervals: list) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _host_activity(cpu: list, t: float) -> str:
    """The bench.* span and the innermost aten op covering time t."""
    span, aten = None, None
    for name, lo, hi in cpu:
        if lo <= t <= hi:
            if name.startswith("bench.") and name != "bench.window":
                if span is None or hi - lo < span[1]:
                    span = (name, hi - lo)
            elif name.startswith("aten::"):
                if aten is None or hi - lo < aten[1]:
                    aten = (name, hi - lo)
    parts = [p[0] for p in (span, aten) if p is not None]
    return "/".join(parts) if parts else "host: none"


def profile(run, units: int) -> Trace:
    """Run ``run()`` (``units`` units of work, each ending in a synchronize)
    under the profiler and reduce its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        with record_function("bench.window"):
            run()
    events = prof.events()
    window = next(e for e in events if e.name == "bench.window")
    w_lo, w_hi = window.time_range.start, window.time_range.end
    dev, cpu = [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a record_function span also shows on the device's timeline
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                dev.append((e.name, max(lo, w_lo), min(hi, w_hi)))
        else:
            cpu.append((e.name, lo, hi))
    dev = [d for d in dev if d[2] > d[1]]
    busy = _merge([[lo, hi] for _, lo, hi in dev])
    by_class = dict.fromkeys(CLASSES, 0.0)
    by_name, names = {}, {}
    for name, lo, hi in dev:
        cls = names.setdefault(name, classify(name))
        by_class[cls] += (hi - lo) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) * 1e-6
    edges = [w_lo] + [x for iv in busy for x in iv] + [w_hi]
    gaps = [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]
    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(
        units=units,
        window_s=(w_hi - w_lo) * 1e-6,
        busy_s=sum(hi - lo for lo, hi in busy) * 1e-6,
        by_class_s=by_class,
        device_ops=[[name[:NAME_CHARS], s] for name, s in top_ops],
        idle_gaps=[[_host_activity(cpu, (lo + hi) / 2), (hi - lo) * 1e-6] for lo, hi in gaps[:TOP]],
        names=names,
    )
