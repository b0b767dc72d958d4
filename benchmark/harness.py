"""One run of one cell: set-up, the measured window, the traced slice, the check.

Everything is found by name. ``BENCHMARK.json`` names the cell's
configuration and traffic; ``configs/<config>.json`` holds the
configuration, ``traffic/<traffic>.json`` the mix, whose ``loop`` names
``loops/<loop>.py``, and each metric's reader is ``metrics/<name>.py``,
or ``metrics/<name up to its first dot>.py`` for a metric split by the
end-to-end metric it moves (``glue_us.stream`` reads ``glue_us.py``). A
new cell, configuration, mix, loop or metric is a new file.

A loop module defines ``Loop(config, traffic, seed, device, control)``:
set-up in the constructor, ``call(i)`` for the i-th unit of work (a
step or a track) through the program's entry, ``keep(i, out)`` to hold
what the check compares, ``release()`` to free the program's state,
``check()`` -> {number: value}, and the attributes ``work`` (totals a
unit adds, by name), ``latency`` (the name its unit times go under),
``median_bound_us`` (the least time of a unit's median calls) and
``setup_parts`` (seconds of its set-up, by part). A mix's ``in_flight``
(1 unless it says) is how many units may be on the card at once: the
next are dispatched while the oldest runs.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.profiler import record_function  # imported in set-up, not in the window

from . import tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zen_tpu")
TRACE_SECONDS = 0.25  # the traced slice's length, at least TRACE_UNITS units
TRACE_UNITS = 4


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str, man: dict | None = None, bench: Path = BENCH) -> tuple:
    """(workload entry, configuration, traffic) of the cell ``name``."""
    man = manifest() if man is None else man
    workload = _by_name(man["workloads"], name, "workload")
    config = json.loads((bench / "configs" / f"{workload['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{workload['traffic']}.json").read_text())
    return workload, config, traffic


def metrics_for(man: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced. An entry without a
    ``workloads`` key applies to every cell (a per-layer one to every
    cell that reports the metric it moves)."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m.get("workloads", [workload]) and m["moves"] in moved]


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, bench: Path = BENCH):
    """The ``read(run)`` function of metric ``name``."""
    exact = bench / "metrics" / f"{name}.py"
    path = exact if exact.exists() else bench / "metrics" / f"{name.split('.')[0]}.py"
    return _module(path).read


def loop_class(kind: str, bench: Path = BENCH):
    return _module(bench / "loops" / f"{kind}.py").Loop


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    work: dict  # totals over the window's units, by name
    latencies_ms: dict  # {name: [per unit]}
    dispatch_s: list  # host seconds from each call to its return
    median_bound_us: float | None = None
    trace: tracing.Trace | None = None


def _sync(device: torch.device):
    """What a unit's time waits on: the card's work done (nothing on the
    CPU, where the tests run)."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _marker(device: torch.device):
    """The wait for the work queued on the card so far: an event recorded on
    the current stream now (nothing on the CPU, where the tests run)."""
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
        return event.synchronize
    return lambda: None


def _units(loop, first: int, device: torch.device, in_flight: int, more, keep: bool) -> tuple:
    """Units first, first + 1, ... through the entry, at most ``in_flight`` on
    the card at once, while ``more(units sent, seconds)`` holds; then nothing
    more is sent, and every unit sent is waited for. One in flight, each
    unit ends in a synchronize; more, the next units are dispatched while
    the oldest runs, and each is waited for by an event behind it. A unit's
    outputs are held until its wait, then kept (``loop.keep``) or dropped;
    its time runs on the host's clock from its call to its wait's return.
    (wall s after the last wait, [ms], [dispatch s], [s at each wait's return])."""
    sync = _sync(device)
    lat, disp, ends, queue = [], [], [], deque()
    t0 = time.perf_counter()

    def finish():
        i, t_call, wait, out = queue.popleft()
        with record_function("bench.sync"):
            wait()
        now = time.perf_counter()
        lat.append((now - t_call) * 1e3)
        ends.append(now - t0)
        if keep:
            loop.keep(i, out)

    i = first
    while more(i - first, time.perf_counter() - t0):
        with record_function("bench.call"):
            t_call = time.perf_counter()
            out = loop.call(i)
            disp.append(time.perf_counter() - t_call)
        queue.append((i, t_call, sync if in_flight == 1 else _marker(device), out))
        del out
        i += 1
        while len(queue) >= in_flight:
            finish()
    while queue:
        finish()
    return ends[-1], lat, disp, ends


def window(loop, seconds: float, device: torch.device, in_flight: int = 1) -> tuple:
    """The measured window: units until ``seconds`` have passed, at most
    ``in_flight`` on the card at once; all that was sent counts, over all
    the time to its end. (wall s, [ms], [dispatch s], [s at each wait's return])."""
    return _units(loop, 0, device, in_flight, lambda n, t: n == 0 or t < seconds, keep=True)


def traced_slice(loop, first: int, per_unit_s: float, device: torch.device,
                 in_flight: int = 1) -> tracing.Trace:
    """A short slice of units after the window, sent as the window sends
    them, under the profiler; their outputs are not kept."""
    units = max(TRACE_UNITS, math.ceil(TRACE_SECONDS / max(per_unit_s, 1e-6)))

    def run():
        _units(loop, first, device, in_flight, lambda n, t: n < units, keep=False)

    return tracing.profile(run, units)


def _window_info(lat: list, ends: list) -> dict:
    """How steady the window was: its units, their median time, and the
    host wall ms a unit over each quarter of the window's units."""
    n = len(lat)
    cuts = [0.0] + [ends[n * (q + 1) // 4 - 1] for q in range(4)]
    counts = [n * (q + 1) // 4 - n * q // 4 for q in range(4)]
    return {"units": n, "median_unit_ms": sorted(lat)[n // 2],
            "quarter_wall_ms_per_unit": [(cuts[q + 1] - cuts[q]) / c * 1e3
                                         for q, c in enumerate(counts) if c]}


def loaded_forbidden() -> list:
    """Modules in this process whose top-level name is one the benchmark
    must never load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
            t_start: float | None = None, man: dict | None = None, cell_override=None,
            control: bool = False) -> dict:
    """One run; returns the result object (module note of run.py).
    ``cell_override`` replaces (workload, config, traffic), for tests at
    a small size; ``control`` runs the configuration's control."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest() if man is None else man
    entry, config, traffic = cell(workload, man) if cell_override is None else cell_override
    device = torch.device(device)
    t_loop = time.perf_counter()
    loop = loop_class(traffic["loop"])(config, traffic, seed, device, control)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    parts = {"before_loop_s": t_loop - t_start, **loop.setup_parts}  # the set-up's, then the check's
    in_flight = int(traffic.get("in_flight", 1))
    wall, lat, disp, ends = window(loop, seconds, device, in_flight)
    units = len(lat)
    run = Run(setup_s=setup_s, window_s=wall,
              work={k: v * units for k, v in loop.work.items()},
              latencies_ms={loop.latency: lat}, dispatch_s=disp,
              median_bound_us=loop.median_bound_us)
    attempted = units
    if traced:
        run.trace = traced_slice(loop, units, wall / units, device, in_flight)
        attempted += run.trace.units
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = loop.check()
    parts["check_s"] = time.perf_counter() - t_check
    limits = config["limits"]
    checks = {name: {"value": value, "limit": limits[name]} for name, value in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in metrics_for(man, entry["name"], traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev, "window": {**_window_info(lat, ends), "seconds": parts}}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
        result["trace_classes"] = run.trace.names
    result["checks"] = checks
    return result
