"""Tracing and timing (counterpart of ``zen_tpu/runtime/profiling.py``).

Two timers, both over chained calls (each call's output is the next
call's input, as the JAX timers chain theirs):

* ``steady_state_ms``: host wall time per call over a steady window that
  ends in a synchronize: what a caller issuing call after call sees,
  host overhead included. Runs on any device.
* ``device_ms``: the card's time per call, from CUDA events around a
  window of calls enqueued behind a ``torch.cuda._sleep`` spin. The spin
  keeps the card busy while the host enqueues the window, so the events
  bracket device work and not the host's launch overhead. Its length
  comes from the host's measured enqueue time, and after enqueueing the
  event at the spin's end is queried: if the spin had already ended, the
  window holds host gaps, so the spin doubles and the window runs again,
  a bounded number of times, and then it raises. It replaces the JAX
  package's ``scan_slope_ms``, a readback slope that the card does not
  need. CPU tensors raise: there is no timing fallback. A window's
  launches must fit the card's queue of pending launches (about 1024 on
  an H100): past it the host blocks until the spin ends, and the window
  is refused. 16 SSE steps at hop 1024 (~64 kernels each) fill it, so
  callers size ``iters`` by the launches of a call.

The gap between the two is the host's share of a steady window.
"""
from __future__ import annotations

import contextlib
import functools
import statistics
import time
from pathlib import Path

import torch

from ..errors import ZenError

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "zen_tpu_torch" / "trace"
SPIN_RETRIES = 4  # doublings of the spin before device_ms gives up
SPIN_MARGIN = 2.0  # spin length over the measured enqueue time
SPIN_FLOOR_MS = 0.05  # least spin: covers the event records themselves
_CALIBRATION_CYCLES = 2_000_000


@contextlib.contextmanager
def trace(log_dir=TRACE_DIR):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card); on exit the chrome trace is written to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _first_tensor(obj):
    """The first tensor in a tensor, tuple, list or dict (depth first)."""
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        for item in obj:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def _device(example, first_output) -> torch.device:
    """The device the chain runs on: the example's first tensor's, or
    when the example holds none, the first call's output's."""
    t = _first_tensor(example)
    if t is None:
        t = _first_tensor(first_output)
    return t.device if t is not None else torch.device("cpu")


def steady_state_ms(fn, example, iters: int = 30, warmup: int = 8) -> float:
    """Steady-state wall ms per call of fn(x) -> y, chained (y feeds the
    next call): ``warmup`` calls, a synchronize, ``iters`` calls and a
    synchronize on the chain's device, which is in the window. Includes
    the host's cost of every call; on a CPU tensor it is the CPU's
    time."""
    y = fn(example)
    dev = _device(example, y)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        y = fn(y)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn(y)
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


@functools.lru_cache(maxsize=8)
def _spin_cycles_per_ms(device: torch.device) -> float:
    """Clock cycles of torch.cuda._sleep per ms on ``device``, timed once
    with CUDA events."""
    with torch.cuda.device(device):
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(_CALIBRATION_CYCLES)
        stop.record()
        stop.synchronize()
        return _CALIBRATION_CYCLES / start.elapsed_time(stop)


def device_ms(fn, example, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """The card's ms per call of fn(x) -> y, chained: the median over
    ``repeats`` windows of ``iters`` calls, each window bracketed by CUDA
    events behind a spin (module note). Raises ZenError on a chain that
    lies on the CPU, and when the host cannot enqueue a window while the
    card spins (a call that synchronizes the host, such as a copy from
    pageable host memory, makes every window do so)."""
    t = _first_tensor(example)
    if t is not None and not t.is_cuda:
        raise ZenError(f"device_ms times the card: the chain's tensors lie on {t.device}")
    y = example
    for _ in range(max(warmup, 1)):
        y = fn(y)
    dev = _device(example, y)
    if dev.type != "cuda":
        raise ZenError(f"device_ms times the card: the chain runs on {dev}")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn(y)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    spin_ms = max(SPIN_MARGIN * enqueue_ms, SPIN_FLOOR_MS)
    per_ms = _spin_cycles_per_ms(dev)
    times = []
    with torch.cuda.device(dev):
        for _ in range(repeats):
            for _ in range(SPIN_RETRIES + 1):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(int(spin_ms * per_ms))
                start.record()  # the spin's end and the window's start
                for _ in range(iters):
                    y = fn(y)
                stop.record()
                covered = not start.query()
                stop.synchronize()
                if covered:
                    break
                spin_ms *= 2
            else:
                raise ZenError(
                    f"device_ms: the spin ({spin_ms / 2:.3f} ms after {SPIN_RETRIES} "
                    f"doublings) ended before the host had enqueued {iters} calls: "
                    "the window would hold host time; does the call synchronize?"
                )
            times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)
