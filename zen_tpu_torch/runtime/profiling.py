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

Phase spans, ``span(name, on)``, name the program's phases where their
work is enqueued (the ``zen.*`` names below). While no profiler runs, a
span is one shared no-op context. While one runs, a span opens a
RecordFunction of its name, so the phase lies on the profiler's host
timeline over the device operations it launched. Its device time is read
in one of two ways:

* ``trace()`` reads it from its profiler's kernel records
  (``profiled_spans``): the durations of the device operations launched
  inside the span, so time in which the card idles never counts. Inside
  ``trace()`` a span is its RecordFunction alone.
* Under any other profiler, whose records the program cannot read,
  timing events on the current stream of ``on``'s device (a tensor or a
  device; only a CUDA one) bound the span, and a recorder keeps (name,
  parent span, events, host seconds) until ``span_totals()`` or
  ``drain_spans()`` reads them. An interval between two events is the
  stream's time, not the device's: it holds the gaps between kernels and
  any wait of the card on the host, so it reads the device time only
  while the host stays ahead of the card. Past ``SPANS_KEPT`` spans the
  recorder folds its oldest half into totals, so a long profiled session
  holds a bounded number of events.

Consecutive spans share the event between them, since under the profiler
each event costs the host ~17 µs (an H100, torch 2.11): a span starts at
its parent's start if it is the first its parent opens, at its previous
sibling's end otherwise (on the same stream), and records a new event
only at its end; a span without a parent always records its start. Work
a parent enqueues outside its children so counts to the child after it;
the units below enqueue none.

* the streaming step (``drivers/realtime.py``, ``block_step``): ``zen.step``
  over the leaves ``zen.frame``, ``zen.analyze``, ``zen.k1``, ``zen.k2``,
  ``zen.mask``, ``zen.synth``, ``zen.ola`` and ``zen.advance``;
* the two-pass track (``drivers/offline.py``, ``HPRIOffline.process``):
  ``zen.track`` over ``zen.pass1``, ``zen.handoff`` and ``zen.pass2``, each
  pass over ``zen.frame`` .. ``zen.ola``.

Each leaf opens in one place, the shared function that does its work
(``engine/spectral.py``, ``ops/framing.py``) or the driver that alone
runs it, so the blocked pass and the pipeline carry the same names.
"""
from __future__ import annotations

import contextlib
import functools
import json
import statistics
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

from ..errors import ZenError

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "zen_tpu_torch" / "trace"
SPIN_RETRIES = 4  # doublings of the spin before device_ms gives up
SPIN_MARGIN = 2.0  # spin length over the measured enqueue time
SPIN_FLOOR_MS = 0.05  # least spin: covers the event records themselves
_CALIBRATION_CYCLES = 2_000_000
SPAN_PREFIX = "zen."  # the program's span names
SPANS_KEPT = 4096  # spans the recorder keeps with their events before folding


@contextlib.contextmanager
def trace(log_dir=TRACE_DIR):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card); on exit the chrome trace is written to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing) and
    the block's phase spans to ``log_dir/spans.json`` (``profiled_spans``:
    by span name, its calls, device µs from the profiler's kernel records,
    null where there is no card, host µs and the spans it ran inside,
    with their counts). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    global _ranges_only
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    _ranges_only = True
    try:
        with profile(activities=activities) as prof:
            yield prof
            if on_card:
                torch.cuda.synchronize()
    finally:
        _ranges_only = False
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    spans = profiled_spans(prof.events(), on_card)
    (log_dir / "spans.json").write_text(json.dumps(spans, indent=1, sort_keys=True))


def profiled_spans(events, on_card: bool) -> dict:
    """By span name, from a torch.profiler's events (``prof.events()``):
    ``calls``, ``device_us`` (the durations of the device operations
    launched inside the span, which the profiler links to the host op
    that launched them; None where ``on_card`` is false), ``host_us`` and
    ``parents`` ({enclosing span: calls})."""
    from torch.autograd import DeviceType

    out = {}

    def total(name: str) -> dict:
        return out.setdefault(name, {"calls": 0, "device_us": 0.0 if on_card else None,
                                     "host_us": 0.0, "parents": {}})

    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        spans, up = [], e  # the spans around e, innermost first (e itself if one)
        while up is not None:
            if up.name.startswith(SPAN_PREFIX):
                spans.append(up.name)
            up = up.cpu_parent
        if e.name.startswith(SPAN_PREFIX):
            t = total(e.name)
            t["calls"] += 1
            t["host_us"] += e.cpu_time_total
            if len(spans) > 1:
                t["parents"][spans[1]] = t["parents"].get(spans[1], 0) + 1
        if on_card and spans:
            # a span's RecordFunction shows on the device's timeline too:
            # it is no operation
            own = sum(k.duration for k in e.kernels if not k.name.startswith(SPAN_PREFIX))
            for name in spans:
                total(name)["device_us"] += own
    return out


@functools.lru_cache(maxsize=None)
def _range_guard():
    """What opens a RecordFunction: torch's C++ guard where this torch has
    it (``_RecordFunctionFast``, a private name; ``record_function`` wraps
    the same at about seven times its host cost under the profiler, 15.5
    against 2 µs on an H100's host, torch 2.11), else ``record_function``."""
    try:
        from torch._C._profiler import _RecordFunctionFast as guard
    except ImportError:
        from torch.profiler import record_function as guard
    return guard


def _recorded(stream) -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


class _Span:
    """One open phase span timed by events (module note); made only while
    a profiler other than ``trace()``'s runs."""

    __slots__ = ("name", "on", "parent", "host", "stream", "start", "t0")

    def __init__(self, name: str, on):
        self.name, self.on = name, on

    def __enter__(self):
        local = _RECORDER.local()
        self.parent = local.stack[-1] if local.stack else None
        local.stack.append(self)
        self.host = _range_guard()(self.name)
        self.host.__enter__()
        self.stream, self.start = _RECORDER.stream(self.on), None
        if self.stream is not None:
            owner, stream, event = local.mark
            if self.parent is not None and owner is self.parent and stream == self.stream:
                self.start = event
            else:
                self.start = _recorded(self.stream)
            local.mark = (self, self.stream, self.start)  # where a first child starts
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        local = _RECORDER.local()
        end = None
        if self.stream is not None:
            end = _recorded(self.stream)
            local.mark = (self.parent, self.stream, end)  # where the next sibling starts
        self.host.__exit__(*exc)
        local.stack.pop()
        parent = None if self.parent is None else self.parent.name
        _RECORDER.add((self.name, parent, self.start, end, host_s))
        return False


class SpanRecorder:
    """The spans closed since the last drain, and each thread's open ones."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._closed = []  # (name, parent name, start event, end event, host s)
        self._folded = {}  # the totals of spans read out of _closed before a drain
        self._streams = {}  # one Stream object a CUDA stream

    def local(self):
        """This thread's open spans (``stack``, outermost first) and its last
        span event (``mark``: the span it belongs to, its stream, the event)."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.mark = [], (None, None, None)
        return local

    def stream(self, on):
        """The current stream of ``on``'s device where that is a CUDA device,
        else None; the same object for a stream each time where this torch
        has the private ``torch._C._cuda_getCurrentStream``, which costs a
        fraction of ``torch.cuda.current_stream``'s 8.4 µs of host under the
        profiler (an H100's host, torch 2.11)."""
        device = on.device if isinstance(on, torch.Tensor) else on
        if device is None or torch.device(device).type != "cuda":
            return None
        device = torch.device(device)
        current = getattr(torch._C, "_cuda_getCurrentStream", None)
        if current is None:
            return torch.cuda.current_stream(device)
        index = torch.cuda.current_device() if device.index is None else device.index
        key = current(index)  # (stream id, device index, device type)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return stream

    def add(self, record: tuple) -> None:
        with self._lock:
            self._closed.append(record)
            if len(self._closed) > SPANS_KEPT:
                half = len(self._closed) // 2
                _fold(self._folded, self._closed[:half])
                del self._closed[:half]

    def totals(self, drain: bool = False) -> dict:
        with self._lock:
            closed, folded = self._closed, self._folded
            if drain:
                self._closed, self._folded = [], {}
            else:
                closed = list(closed)
                folded = {name: dict(t, parents=dict(t["parents"])) for name, t in folded.items()}
        return _fold(folded, closed)


def _fold(out: dict, closed: list) -> dict:
    """``out``, {name: {calls, device_s, host_s, parents: {parent name:
    calls}}}, with the spans of ``closed`` added; waits for their events
    (the last blocks; the earlier ones are done by then, and a stream of
    its own has its own last)."""
    for _, _, _, end, _ in reversed(closed):
        if end is not None:
            end.synchronize()
    for name, parent, start, end, host_s in closed:
        t = out.setdefault(name, {"calls": 0, "device_s": None, "host_s": 0.0, "parents": {}})
        t["calls"] += 1
        t["host_s"] += host_s
        if end is not None:
            t["device_s"] = (t["device_s"] or 0.0) + start.elapsed_time(end) * 1e-3
        if parent is not None:
            t["parents"][parent] = t["parents"].get(parent, 0) + 1
    return out


_RECORDER = SpanRecorder()
_OFF = contextlib.nullcontext()
_ranges_only = False  # set inside trace(), which reads kernel records


def span(name: str, on=None):
    """The phase span ``name`` over a with-block (module note). ``on``, a
    tensor or a device, says where the phase's work runs: only a CUDA one
    gets event times. While no profiler runs: one shared no-op context,
    which records and allocates nothing; inside ``trace()``: a
    RecordFunction alone."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if _ranges_only:
        return _range_guard()(name)
    return _Span(name, on)


def span_totals() -> dict:
    """By span name: ``calls``, ``device_s`` (the sum of its event
    intervals, which hold any idle of the card between its operations;
    None where no call ran on a card, never a CPU time), ``host_s`` and
    ``parents`` ({enclosing span: calls}), over the spans recorded since
    the last drain. Waits for their events, not for the card."""
    return _RECORDER.totals()


def drain_spans() -> dict:
    """``span_totals()``, and the spans it read are forgotten."""
    return _RECORDER.totals(drain=True)


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
