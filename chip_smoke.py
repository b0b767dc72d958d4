#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from zen_tpu_torch/csrc with nvcc and
holds each route of each kernel bitwise against its plain PyTorch twin
at every shape its paths give it, beside one torch.kthvalue call over
the same windows (the library yardstick, which the port never calls)
and the least time the card could take (phase 3; at a 4-minute track's
offline shapes the kernels run without their twin; rows of few outputs
and huge K run the select route, K1 and K2 up to their tap limits, and
K2's sort past one block's shared memory its key store). Phase 3 also
times the rank, warp (K1), network (K2) and select routes side by side on
the wide rows, with the cost rule's pick beside the fastest one measured,
and holds the comparator-network routes (K1 register and K2 network, up
to 63 taps) bitwise at every odd K they take, tie-heavy and bf16, each in both
of its forms (the per-output network and the shared core at each R it is
built for; K1's on one tap run and on the causal wrap's two, K2's under
each of the four borders); sweeps K2's
two routes over K at
three row shapes, the network in both of its forms: the crossover
FREQ_RANK_MIN_TAPS (ops/median_cuda.py) comes from it; times K1's network kernel at each run length and its
shared core at each R, beside the form the wrapper picks, and both
rank routes at every geometry the cost rule weighs (K2's tile and run of
outputs a thread, K1's run of rows, lane run and columns: the walk from
rank 0 or the steps from the neighbour's median) at the paths' rows, beside the
wrappers' choices; and splits each rank block's time into staging, sort
and walk, median2d's rows included, from two
more builds of the library that end the rank kernels early (phase 2
builds all three at once). Then it drives the paths through their user
entry points at full width:

  phase 4  HPRRealtime at 44.1 kHz, hop 1024: 64 blocks of 32 hops,
           then 64 single hops (its frequency median, K = 47, on K2's
           network route in its shared-core form, no K2 rank launch);
  phase 10 HPRRealtime at 44.1 kHz, hop 32, the low-latency stream whose
           time median is K = 93 over 183 history rows (K1's warp
           route, a warp an output): 64 blocks of 32 hops, then 64 single
           hops;
  phase 10b hop 64 at 44.1 kHz, K = 47 over 91 history rows (K1's
           network): HPRRealtime, 64 blocks of 32 hops then 64 single
           hops, and MultiStreamHPR, 64 streams, 16 blocks of 32 hops;
  phase 10c HPRRealtime at 384 kHz, hop 1, whose time median is K =
           25,601 over 51,199 history rows (K1's select route): 64
           blocks of 32 hops, then 64 single hops;
  phase 5  MultiStreamHPR, 64 streams at 44.1 kHz, hop 256, 32-hop
           blocks, plus a percussive-only fleet for the compact rows;
  phase 7  HPRIOffline(44100, 4096, 256, 2.5, 2.5) (BASELINE.json
           configs[0]) on the reference's 161,571-sample clip;
  phase 8  the same on a 4-minute track through process() and
           process_blocked();
  phase 9  the port's CLI, `zen-torch stream --streams 512` at 44.1 kHz,
           hop 256, 16-hop blocks (the stock wide-fleet command), called
           in-process on ~3 s per stream at f32 and with --stream-state
           bf16, and on a shorter input with --cpu (replicate border)
           and --nocopybord (valid border); then one real pipe through
           `python -m zen_tpu_torch stream`;
  phase 11 the serving-state bound instruments: benches/hbm_pattern at
           512 streams (each median stage of the hop-256 step beside its
           copy-only mirror, #9 rows_copy and #10 segment_copy, which
           phase 3 holds bitwise against their twins), and
  phase 12 benches/serving_bound's legs (full block_step, transform,
           median, rest) at 64, 256 and 512 streams in f32 and at 512 in
           bf16, each in device time and in steady-window wall time;
  phase 13 the SSE variant (box means of 1/|S|^2, no median kernel):
           HPRRealtime hop 1024 (64 x B=32, 64 x B=1), MultiStreamHPR
           64 x hop 256 in f32 and bf16 state, HPRIOffline on the clip
           (process and process_blocked) and `zen-torch stream --streams
           512 --sse`, each held against the CPU port at SSE_ATOL x scale
           on every sample (continuous masks: nothing flips);
  phase 14 the box mean alone at those paths' shapes, bitwise to the CPU
           with its +inf prefill;
  phase 15 the DFT transform (fft_impl dft_f32, dft, dft_bf16): 64 x hop
           256, 512 x B=16 (MultiStreamHPR) and hop 1024 (HPRRealtime)
           streams held against the CPU port's same entry point and mode
           under the flip rule on the masks the two runs computed, and
           against torch.fft at each mode's class; whether a rerun, a
           recount or a row's batch changes bits; the clip with 'dft';
           the transform alone beside torch.fft and the 512-stream
           step's device time per mode;
  phase 16 benches/quality on the card: the SSE row's floors at fs 22050
           and the precision ladder at 44.1 kHz (full_bf16: bf16 DFT
           operands and bf16 stream state);
  phase 17 files and the CLI: the native codec library built from
           native/*.cpp; the clip written as WAV and the 4-minute track as
           FLAC through the port's writers; `zen-torch offline` in-process
           on both (configs[0]; the track --blocked --stem-format flac),
           stems held sample for sample against process() and
           process_blocked() on the card; the checkpointed process_blocked
           on the track killed twice and resumed, bitwise; `zen-torch
           fakert --block-hops 32` at hop 256 and 1024 against the CPU
           port; LiveStream at hop 256 over the native rings; one real
           `python -m zen_tpu_torch offline`;
  phase 18 the corpus: ten WAV tracks (1501 s, one past
           LONG_TRACK_SAMPLES) through `zen-torch corpus`, every stem
           byte-equal to process() / process_blocked() on the card, a
           resume that processes nothing, an empty .ckpt; `--pp` and
           separate_corpus on a dp=4 mesh against it; the loader (prefetch
           2 against 0) and the pipelined cascade against sequential
           process(), in turns;
  phase 19 the demos: `zen-torch pitch-track` and `beat-track` on
           docs/DEMOS.md's mix and 60 s of a steady chord, on the card and
           with --device cpu, with DEMOS.md's verdicts; the demos' stems,
           ODF and autocorrelation against the CPU port;
  phase 20 the single-host parallel layer on virtual shards of the card
           (make_mesh with the card repeated): sharded_hpri_offline at
           configs[0] on a two-channel clip batch over dp x sp meshes,
           sharded_hpri_blocked on the 4-minute track (sp 4 and 2, and
           killed once and resumed), tp_hpri_offline on the clip (tp 4 and
           2), MultiStreamHPR 64 x B=32 and 512 x B=16 at dp=4, each
           against its unsharded run, and the CLI's --mesh surfaces;
  phase 21 benches/headline at full width (bench.py's rows: the hop-1024
           B=32 metric in device and wall us per 10 ms, hop 256, soft
           mask, SSE, 64 streams, the clip, the single-hop round trip),
           its JSON line, and the 4-minute track's peak device memory;
  phase 22 entry()'s flagship step against entry(device="cpu") under
           the flip rule, and dryrun_multichip(4) on virtual shards;
  phase 23 tools/fuzz_parity, four random cases of every mode;
  phase 24 benches/kernels --quick (every route by name, the twin, the
           library call, the transforms, the block step; complexity fits);
           its launches by route name, which no wrapper counts, stand
           apart in the `kernels` line as by_route_launches;
  phase 25 benches/soak, 256 steps of 64 streams, finite, its drift;
  phase 26 benches/scaling on virtual meshes of 1, 2 and 4 and the
           one-card streams curve at 1, 8, 64 and 512 streams;
  phase 27 benches/io_codec on 5 s (host only, no launch);
  phase 28 tools/feed_wav_realtime on 2.5 s at wall-clock rate;
  phase 29 tools/ab_reference against the port's own strict-ref stems
           (passes) and with a corrupted stem (fails);
  phase 30 the multi-process paths on this card (tools/multihost_smoke.py):
           2 and 3 processes sharing the card, every process byte-equal to
           one process on the same global mesh: the corpus over dp = N x
           sp = 2 (five tracks, the last routed long), a SIGKILL before the
           last track and a resume, `python -m zen_tpu_torch corpus --nprocs
           2`; `zen-torch corpus --mesh sp=N --nprocs N` (one sp ring cut
           across the processes, its halos over gloo) killed and resumed;
           tp_hpri_offline at tp 2 and 4 over 2 processes (configs[0]);
           MultiStreamHPR 64 x hop 256 over dp = 2; and the pipelined
           cascade given the card twice;
  phase 31 median2d, the reference's whole-matrix filter
           (zen_tpu_torch/ops/median.py), every direction x border at the
           4-minute track's offline widths ([2585, 8193] frequency fl 187,
           K2 rank; time fl 17, K1 network; [41355, 513] time fl 11, K1
           network; frequency fl 13, K2 network; time fl 93, K1 rank), bf16,
           the marked matrix, +inf rows, fl past both dims and a
           transposed view: bitwise to its mapping over the kernels' twins
           (and to median2d_plain on the CPU for the small ones), launches
           exactly as predicted, its device time and its glue's beside the
           twins, kthvalue and the bound, every K1 register case in both
           forms (per-output network, shared core), and what NaN gives on
           each route;

and holds the outputs against the same port run on the CPU (plain
twins, CPU FFT), offline pass by pass, and the blocked offline driver
against the batched one. A hard-mask bin whose ratio sits within float
noise of beta can flip between cuFFT and the CPU FFT; flips are counted
by running the path's own masks half on the same input on both sides,
must stay below 1e-5 of all mask bins, and the 5e-5 x scale stem
tolerance applies to every output sample no flipped frame feeds (phase
9 holds every 32nd of its 512 streams so, at unit gain, and the bf16
run's percussive stem against the f32 run's by SI-SNR). Kernel launches
are counted per path and per kernel route, K1's register launches that took the
shared core apart (CORE), K2's network launches that took its shared core
apart (FREQ_CORE: required on phases 4, 6, 7, 8, 9 and 31, refused on
the latency rows of phases 10 and 19), and K2's rank launches by
where their keys live (phase 6 and phases 7-30; the
SSE paths must launch none; phases 18-22 and 24-30 require each run's
count to equal the count from its shapes and, for the instruments, the
calls they report; phase 23's random configs are read, not counted).

Every time printed is a measurement of this run on the card named in
phase 1. Any failure raises and exits non-zero; there is no CPU path.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# the port's flip rule and its limits: 5e-5 x scale (the realtime parity
# class) and at most 1e-5 of the hard-mask bins flipped
from zen_tpu_torch.tools.parity import FLIP_SHARE, STEM_ATOL, flip_rule  # noqa: E402
BY_ROUTE: dict = {}  # {wrapper/route: launches by route name}, phase 24's
TIMED_RUNS = 30
NOISE_FLOOR = 0.01  # white noise under the synthetic mix (see synthetic_mix)
DEVICE = "cuda"  # every tensor of the run under test lives here
OFFLINE_FS = 44100.0
CLIP_SAMPLES = 161_571  # the reference's 3.66 s clip (BASELINE.md:11)
CLIP_REF_MS = 487.0  # its time on an RTX 2070 SUPER (BASELINE.md:11)
TRACK_SAMPLES = 240 * 44_100  # a 4-minute track
TRACK_FRAMES_H = -(-TRACK_SAMPLES // 4096) + 1  # pass-1 frames (lag 1)
TRACK_FRAMES_P = -(-TRACK_SAMPLES // 256) + 11  # pass-2 frames (lag 11)
FLEET_STREAMS = 512  # zen stream --streams 512, the #4 route's fleet
# the least time the card could take: an H100 SXM's device-memory rate
# and its float32 rate outside the tensor cores (NVIDIA's data sheet);
# the medians compare in float32, bf16 taps included
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K2's crossover sweep: every K the network route takes and the first past it, then wider,
# on the hop-1024 step's rows (B = 32 and its single hop's B = 1) and the 64-stream fleet's
SWEEP_K = tuple(range(3, 67, 2)) + (95, 127, 187, 257)
SWEEP_SHAPES = ((32, 2049), (2048, 513), (1, 2049))
ROUTES = {"tap_median_time": ("register", "rank", "select", "warp"),
          "sliding_median_boundary": ("network", "rank", "select")}
SCRATCH = "rank@scratch"  # K2's rank launches whose keys live in the key store
STEPS = "rank@steps"  # rank launches that took the steps kernel (a thread a run of outputs)
SORT_SOURCE = "zen_rank::warp_merge_sort, zen_tpu_torch/csrc/rank_select.cuh"  # the steps' sort
CORE = "register@core"  # K1's register launches that took the shared core (runs of outputs)
FREQ_CORE = "network@core"  # K2's network launches that took its shared core
SLOW_US = 100_000.0  # a phase-3 call past this is timed 3 times, not TIMED_RUNS
# phase 3's select lines force a route through _time_launch, whose plan
# lookups hash a wide tap set's offsets on the host (~0.5 ms at 25,601
# taps, where the wrapper memoizes the call): a ~6 ms spin covers them
SELECT_SPIN = 10_000_000
T256 = tuple(range(-21, -16)) + tuple(range(-5, 1))  # hop 256's causal wrap taps, K = 11
RUN_LENGTHS = (1, 2, 4, 8, 16)  # K1's network kernel: output rows per thread
PROBES = ("rows_copy", "segment_copy")  # ops/probe_cuda.py, one route each: "copy"
MP = "zen_tpu/ops/median_pallas.py"
TPU_KERNELS = {  # PERF.md's table numbers -> file:line of the TPU kernel
    "#1": f"{MP}:895", "#2": f"{MP}:787", "#3": f"{MP}:1020", "#4": f"{MP}:826",
    "#5": f"{MP}:395", "#6": f"{MP}:331", "#7": f"{MP}:603", "#8": f"{MP}:482",
    "#9": "benches/hbm_pattern.py:181", "#10": "benches/hbm_pattern.py:240",
}
SOURCES = {"tap_median_time": "zen_tpu_torch/csrc/median_time.cu",
           f"tap_median_time/{CORE}": "zen_tpu_torch/csrc/median_time_core.cu",
           f"sliding_median_boundary/{FREQ_CORE}": "zen_tpu_torch/csrc/median_freq_core.cu",
           "sliding_median_boundary": "zen_tpu_torch/csrc/median_freq.cu",
           "rows_copy": "zen_tpu_torch/csrc/probe_copy.cu",
           "segment_copy": "zen_tpu_torch/csrc/probe_copy.cu"}
FLEET_HOP, FLEET_BLOCK = 256, 16  # zen stream's defaults
CLI_STEMS = ("harm", "perc", "residual")  # zen offline's stem file names
FLEET_HELD = range(0, FLEET_STREAMS, 32)  # the streams held against the CPU
# the SSE paths' stems against the CPU port: the oracle class
# (tests/test_engine_parity.py:46-49). The masks are continuous, so no
# bin flips; what differs is cuFFT's rounding against the CPU FFT's,
# which 1/|S|^2 amplifies at near-zero bins. The measured value is printed.
SSE_ATOL = 5e-4
# each DFT mode's stems against torch.fft's (tests/test_engine_parity.py:237-249)
DFT_CLASS = {"dft_f32": 2e-5, "dft": 3e-3, "dft_bf16": 5e-2}
# each DFT mode's stems on the card against the CPU port's of the same
# mode, under the flip rule: the realtime parity class, except for
# dft_bf16, whose inverse rounds its float32 inputs to bf16. An input
# within float32 noise of a rounding boundary (the two sides' sums differ
# in order) rounds to neighbouring bf16 values on the card and on the
# CPU: two bf16 steps, 2^-7 of scale, bound it
DFT_CPU_ATOL = {"dft_f32": STEM_ATOL, "dft": STEM_ATOL, "dft_bf16": 2.0**-7}
# the card's rates per DFT mode's arithmetic (NVIDIA's data sheet, the
# H100 SXM, dense): float32 outside the tensor cores, bf16 tensor cores;
# 'dft' does three bf16 products per term
DFT_RATE = {"dft_f32": F32_OPS_PER_S, "dft": 989e12 / 3, "dft_bf16": 989e12}
QUALITY_FS = 22050.0  # the SSE floors' calibration (tests/test_quality.py:36, :93)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def synthetic_mix(n: int, fs: float, seed: int, f0: float = 220.0) -> np.ndarray:
    """Harmonic tones plus decaying noise bursts every 0.5 s (the verify
    recipe), over a white noise floor at 0.01 (-40 dBFS), as a recording
    has. Without the floor most bins of a frame hold only FFT round-off,
    whose masks flip freely between cuFFT and the CPU FFT."""
    t = np.arange(n) / fs
    harm = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 2 * f0 * t)
    perc = np.zeros(n)
    rng = np.random.default_rng(seed)
    length = 400
    for onset in np.arange(0.25, n / fs, 0.5):
        i = int(onset * fs)
        burst = rng.standard_normal(length) * np.exp(-np.arange(length) / 60)
        perc[i : i + length] += burst[: n - i]
    floor = NOISE_FLOOR * rng.standard_normal(n)
    return (harm + perc + floor).astype(np.float32)


# ---------------- timing ----------------


def median_us(fn, runs: int = TIMED_RUNS, warmup: int = 3, spin: int = 2_000_000) -> float:
    """Median over ``runs`` of one call's device time, from CUDA events.
    A spin kernel of ``spin`` cycles (~1 ms) ahead of each start event
    keeps the card busy while the host enqueues the call, so the events
    bracket device work and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3)
    return float(np.median(times))


def row_us(fn, spin: int = 2_000_000) -> tuple:
    """(µs, runs): median_us over TIMED_RUNS calls, or over 3 where one
    warm call took more than SLOW_US (the widest rows' twins and kthvalue)."""
    if median_us(fn, runs=1, warmup=1, spin=spin) > SLOW_US:
        return median_us(fn, runs=3, warmup=0, spin=spin), 3
    return median_us(fn, spin=spin), TIMED_RUNS


def wall_us_per_call(fn, runs: int) -> float:
    """Host wall time per call over ``runs`` calls ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e6


def device_profile(fn) -> str:
    """Device kernels and copies one call issues, their summed device
    time and the three longest by name, from torch.profiler; 'not
    measured' when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        return "device ops not measured"
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    busy = sum(by_name.values())
    return (
        f"{len(ops)} device ops, {busy:.1f} us device-busy; longest: "
        + ", ".join(f"{name[:48]} {us:.1f} us" for name, us in top)
    )


# ---------------- phases ----------------


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"phase 1 card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}"
    )
    return smi


def phase_build() -> None:
    """The kernel library, and beside it the two split builds of phase 3
    (ZEN_RANK_CUT 1 and 2), all compiling at once."""
    from concurrent.futures import ThreadPoolExecutor

    from zen_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(_build.library, (0, 1, 2)))
    print(
        f"phase 2 build: {time.perf_counter() - t0:.2f} s, the library and its two "
        f"split builds ({_build.library_path().relative_to(ROOT)}), the generated median "
        f"networks in {(_build.generated_include_dir() / _build.GENERATED_HEADER).relative_to(ROOT)}"
    )


def _mags(rng, *shape) -> torch.Tensor:
    """Positive continuous values on the card, like magnitudes."""
    x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
    return torch.from_numpy(x).to(DEVICE)


def _ties(rng, *shape) -> torch.Tensor:
    """Tie-heavy magnitudes on the card: 8 levels."""
    x = np.floor(rng.random(shape, dtype=np.float32) * 8) / 8 + np.float32(0.125)
    return torch.from_numpy(x.astype(np.float32)).to(DEVICE)


def bound(in_elems: int, out_elems: int, itemsize: int, k: int) -> tuple:
    """(µs, 'bytes' | 'operations'): the least time for the work, the
    larger of each input element read once and each output written once
    at HBM_BYTES_PER_S, and ceil(log2 K) compares per output at
    F32_OPS_PER_S: what a sliding median needs, its window kept sorted
    from one output to the next (a search for the sample that enters)."""
    t_bytes = (in_elems + out_elems) * itemsize / HBM_BYTES_PER_S * 1e6
    t_ops = out_elems * math.ceil(math.log2(k)) / F32_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_bound(a, b, offsets, start) -> tuple:
    """bound() of tap_median_time: the distinct rows of V that some output
    row's taps reach, the union over o of [start + o, start + o + t_out)
    within V (a gap between two tap runs, as under a causal wrap, is
    read by no tap and not counted)."""
    ta, tb = a.shape[-2], b.shape[-2]
    t_v = ta + tb
    t_out = t_v - start
    reach = end = 0
    for o in sorted(set(offsets)):
        lo, hi = max(0, start + o), min(t_v, start + o + t_out)
        reach += max(0, hi - max(lo, end))
        end = max(end, hi)
    lead_f = a.numel() // max(ta, 1) if ta else b.numel() // tb
    outs = lead_f * t_out
    return bound(lead_f * reach, outs, a.element_size(), len(offsets))


def freq_bound(x, k, mode) -> tuple:
    f_out = x.shape[-1] - k + 1 if mode == "valid" else x.shape[-1]
    outs = x.numel() // x.shape[-1] * f_out
    return bound(x.numel(), outs, x.element_size(), k)


def time_library(a, b, offsets, start, fill=0.0):
    """One torch.kthvalue over tap_median_time's windows, as a callable;
    the windows are built here, outside the timed call: an unfold view of
    V padded with fill rows where the offsets are one contiguous run, the
    gathered taps [..., t_out, F, K] otherwise. (kind, callable)."""
    k, lo, hi = len(offsets), min(offsets), max(offsets)
    ta, tb = a.shape[-2], b.shape[-2]
    t_out = ta + tb - start
    v = torch.cat([a, b], dim=-2)
    if tuple(offsets) == tuple(range(lo, hi + 1)):
        pad_lo = max(0, -(start + lo))
        pad_hi = max(0, start + t_out + hi - (ta + tb))

        def rows(n):
            return torch.full(a.shape[:-2] + (n, a.shape[-1]), fill, dtype=a.dtype,
                              device=a.device)

        vp = torch.cat([rows(pad_lo), v, rows(pad_hi)], dim=-2)
        first = start + lo + pad_lo
        windows, kind = vp[..., first : first + t_out + k - 1, :].unfold(-2, k, 1), "unfold view"
    else:
        idx = (start + torch.arange(t_out, device=a.device)[:, None]
               + torch.tensor(offsets, device=a.device)[None, :])
        valid = (idx >= 0) & (idx < ta + tb)
        taps = v[..., idx.clamp(0, ta + tb - 1), :]  # [..., t_out, K, F]
        taps = torch.where(valid[..., None], taps, torch.tensor(fill, dtype=a.dtype,
                                                                device=a.device))
        windows, kind = taps.transpose(-1, -2).contiguous(), "gathered"
    return kind, lambda: torch.kthvalue(windows, k // 2 + 1, dim=-1)


def freq_library(x, k, mode):
    """One torch.kthvalue over sliding_median_boundary's windows: an
    unfold view of the row padded by its boundary rule (built here)."""
    if mode != "valid":
        m, f = (k - 1) // 2, x.shape[-1]
        p = torch.arange(-m, f + m, device=x.device)
        if mode == "reflect":
            idx = torch.minimum(p.abs(), 2 * (f - 1) - p.abs())
        elif mode == "wrap":
            idx = torch.remainder(p, f)
        else:
            idx = p.clamp(0, f - 1)
        x = x[..., idx]
    windows = x.unfold(-1, k, 1)
    return "unfold view", lambda: torch.kthvalue(windows, k // 2 + 1, dim=-1)


def time_call_label(offsets, start: int, t_v: int, streams: int, f: int, sms: int) -> str:
    """The route tap_median_time launches for a call (time_call_route),
    STEPS where its rank route takes the steps kernel, CORE where its
    register route takes the shared core (time_network_form)."""
    from zen_tpu_torch.ops import median_cuda as mc

    offsets = tuple(offsets)
    route = mc.time_call_route(offsets, start, t_v, streams, f, sms)
    if route == "rank" and mc.time_rank_geometry(offsets, start, t_v, streams, f, sms)[1] > 1:
        return STEPS
    if route == "register" and mc.time_network_form(offsets, t_v - start, streams, f)[0] == "core":
        return CORE
    return route


def time_label(a, b, offsets, start) -> str:
    """time_call_label of a call on a and b."""
    return time_call_label(offsets, start, a.shape[-2] + b.shape[-2], math.prod(a.shape[:-2]),
                           a.shape[-1], sm_count(a.device))


def freq_call_label(k: int, rows: int, f_in: int, mode: str, sms: int) -> str:
    """The route sliding_median_boundary launches for a call
    (freq_call_route), SCRATCH where its sort's keys take the key store,
    STEPS where it takes the steps kernel, FREQ_CORE where its network
    route takes the shared core (freq_network_form)."""
    from zen_tpu_torch.ops import median_cuda as mc

    route = mc.freq_call_route(k, rows, f_in, mode, sms)
    if route == "network" and mc.freq_network_form(k, rows, f_in, mode)[0] == "core":
        return FREQ_CORE
    if route != "rank":
        return route
    plan = mc.freq_rank_plan(k, rows, f_in, mode, sms)
    return SCRATCH if plan is None else STEPS if plan[1] > 1 else route


def freq_label(x, k: int, mode: str) -> str:
    """freq_call_label of a call on x."""
    return freq_call_label(k, x.numel() // x.shape[-1], x.shape[-1], mode, sm_count(x.device))


def sm_count(device) -> int:
    from zen_tpu_torch.ops import median_cuda as mc

    return mc._sm_count(device)


def by_route(counts: dict) -> dict:
    """``counts`` without the STEPS, CORE and FREQ_CORE keys: what a count
    from the configs and shapes alone holds (which rank calls take the
    steps kernel, and which register or network calls a shared core,
    depends on each call's rows; phases 3, 7, 8, 9 and 31 check those)."""
    return {k: v for k, v in counts.items() if not k.endswith((STEPS, CORE, FREQ_CORE))}


def launch_keys(key: str) -> tuple:
    """The read_launches() keys one launch labelled ``key`` adds to: a
    SCRATCH or STEPS launch counts on its kernel's rank route too, a CORE
    launch on its register route, a FREQ_CORE launch on its network
    route."""
    name, route = key.split("/")
    return (key, f"{name}/{route.split('@')[0]}") if "@" in route else (key,)


def kernel_cases():
    """(kernel, route, TPU kernel #, label, kernel call, plain call,
    library yardstick's factory, bound) at every main-path shape (hop-1024
    streaming first), the offline passes', the hop-32 and hop-64 streams'
    and 48 kHz hop 64's shapes, K1's network up to its cap of 63 taps,
    tap spans far past the rows a call has, tie-heavy and bf16 inputs at
    large K, the other boundary modes at a ragged row count, and the rows
    whose keys pass one block's shared memory (the select route, and K2's
    key store where a row's many outputs share its sort: route SCRATCH),
    K2 up to MAX_FREQ_TAPS; then the two copy-only mirrors, #9 and #10
    (library yardstick: the same copy as one PyTorch call)."""
    from zen_tpu_torch import HPRConfig
    from zen_tpu_torch.ops import median_cuda as mc
    from zen_tpu_torch.ops import probe_cuda as pc

    rng = np.random.default_rng(0)
    mag = functools.partial(_mags, rng)
    ties = functools.partial(_ties, rng)

    def bf16(*shape):
        return mag(*shape).to(torch.bfloat16)

    t1024 = (-5, -1, 0)
    t256_rep = tuple(range(-5, 0)) + (0,) * 6  # --cpu: replicate repeats offset 0
    t256_valid = tuple(range(-11, 0))  # --nocopybord: the previous 11 frames
    t_k93 = tuple(range(-183, -137)) + tuple(range(-46, 1))  # 44.1 kHz hop 32
    t_k401 = tuple(range(-200, 201))  # 48 kHz hop 8, centered
    t_far = (-16353,) + tuple(range(-65, 1))  # past the first rank plan's 16,352 rows
    t_farther = (-70000,) + tuple(range(-65, 1))  # a table past 227 KB at its own span
    t_k47 = HPRConfig(44100.0, 64, causal=True).time_offsets  # hop 64, causal wrap
    t_k51 = HPRConfig(48000.0, 64, causal=True).time_offsets
    t_k63 = tuple(range(-31, 32))
    hop1 = {fs: HPRConfig(fs, 1, causal=True) for fs in (192000.0, 384000.0)}
    cases = []
    for tpu, label, a, b, offs, start in (
        ("#1", "pair C=1 H=5 B=32 F=2049 K=3", mag(1, 5, 2049), mag(1, 32, 2049), t1024, 5),
        ("#1", "pair C=64 H=21 B=32 F=513 K=11", mag(64, 21, 513), mag(64, 32, 513), T256, 21),
        ("#2", "single C=1 T=6 start=5 F=2049 K=3", mag(1, 6, 2049), mag(1, 0, 2049), t1024, 5),
        ("#3", "offline pass 2 T=643 F=513 K=11 centered", mag(1, 643, 513),
         mag(1, 0, 513), tuple(range(-5, 6)), 0),
        ("#2", "offline pass 1 T=41 F=8193 K=1", mag(1, 41, 8193), mag(1, 0, 8193), (0,), 0),
        # the demo apps' streams: pitch-track (hop 4096) and beat-track (hop 256)
        ("#1", "pair C=1 H=0 B=8 F=8193 K=1 (pitch-track)", mag(1, 0, 8193), mag(1, 8, 8193),
         (0,), 0),
        ("#1", "pair C=1 H=21 B=64 F=513 K=11 (beat-track)", mag(1, 21, 513), mag(1, 64, 513),
         T256, 21),
        ("#1", "pair C=1 H=183 B=32 F=65 K=93 (hop 32)", mag(1, 183, 65), mag(1, 32, 65),
         t_k93, 183),
        ("#1", "pair C=1 H=183 B=1 F=65 K=93 (hop 32)", mag(1, 183, 65), mag(1, 1, 65),
         t_k93, 183),
        ("#1", "pair C=1 H=183 B=32 F=65 K=93 ties", ties(1, 183, 65), ties(1, 32, 65),
         t_k93, 183),
        ("#1", "pair C=1 H=183 B=32 F=65 K=93 bf16", bf16(1, 183, 65), bf16(1, 32, 65),
         t_k93, 183),
        ("#1", "pair C=1 H=183 B=1 F=65 K=93 ties bf16", ties(1, 183, 65).to(torch.bfloat16),
         ties(1, 1, 65).to(torch.bfloat16), t_k93, 183),
        # the warp route at eight taps a lane: K = 187 and 255
        ("#3", "single T=300 F=17 K=187 centered", mag(1, 300, 17), mag(1, 0, 17),
         tuple(range(-93, 94)), 0),
        ("#1", "pair C=1 H=254 B=8 F=33 K=255 ties", ties(1, 254, 33), ties(1, 8, 33),
         tuple(range(-254, 1)), 254),
        ("#3", "single T=900 F=17 K=401 centered", mag(1, 900, 17), mag(1, 0, 17), t_k401, 0),
        ("#3", "single T=900 F=17 K=401 centered ties bf16",
         ties(1, 900, 17).to(torch.bfloat16), mag(1, 0, 17).to(torch.bfloat16), t_k401, 0),
        # the 512-stream fleet (zen stream's B=16 < H=21): #4's shapes
        ("#4", "pair C=512 H=21 B=16 F=513 K=11 f32", mag(512, 21, 513),
         mag(512, 16, 513), T256, 21),
        ("#4", "pair C=512 H=21 B=16 F=513 K=11 bf16", bf16(512, 21, 513),
         bf16(512, 16, 513), T256, 21),
        ("#4", "pair C=512 H=21 B=1 F=513 K=11 bf16", bf16(512, 21, 513),
         bf16(512, 1, 513), T256, 21),
        ("#4", "padded single C=256 T=64 F=513 K=11 centered start=0 f32",
         mag(256, 64, 513), mag(256, 0, 513), tuple(range(-5, 6)), 0),
        ("#1", "pair C=64 H=21 B=32 F=513 K=11 bf16", bf16(64, 21, 513),
         bf16(64, 32, 513), T256, 21),
        # the same fleet under each other border, full C2C spectrum (B=16 >= H)
        ("#1", "pair C=512 H=5 B=16 F=1024 K=11 replicate", mag(512, 5, 1024),
         mag(512, 16, 1024), t256_rep, 5),
        ("#1", "pair C=512 H=11 B=16 F=1024 K=11 valid", mag(512, 11, 1024),
         mag(512, 16, 1024), t256_valid, 11),
        # spans past the rows a call has: the far taps read only fill and
        # move next to V; on 65,536 rows the table stays in device memory
        ("#1", "single T=300 F=9 K=67 span 16354 (far taps)", mag(1, 300, 9),
         mag(1, 0, 9), t_far, 0),
        ("#1", "single T=300 F=9 K=67 span 70001 (far taps)", mag(1, 300, 9),
         mag(1, 0, 9), t_farther, 0),
        ("#3", "single T=65536 F=9 K=67 span 70001 (table in device memory)",
         mag(1, 65536, 9), mag(1, 0, 9), t_farther, 0),
        # K1's network past 31 taps: K = 33, hop 64 (K = 47) and 48 kHz hop 64
        # (K = 51) under the causal wrap, K = 63 centered
        ("#1", "pair C=64 H=32 B=32 F=513 K=33", mag(64, 32, 513),
         mag(64, 32, 513), tuple(range(-32, 1)), 32),
        ("#1", "pair C=1 H=91 B=32 F=129 K=47 (hop 64)", mag(1, 91, 129), mag(1, 32, 129),
         t_k47, 91),
        ("#1", "pair C=1 H=91 B=1 F=129 K=47 (hop 64)", mag(1, 91, 129), mag(1, 1, 129),
         t_k47, 91),
        ("#1", "pair C=64 H=91 B=32 F=129 K=47 (hop 64 fleet)", mag(64, 91, 129),
         mag(64, 32, 129), t_k47, 91),
        ("#1", "pair C=64 H=91 B=32 F=129 K=47 (hop 64 fleet) bf16", bf16(64, 91, 129),
         bf16(64, 32, 129), t_k47, 91),
        ("#1", "pair C=1 H=99 B=32 F=129 K=51 (48 kHz hop 64)", mag(1, 99, 129),
         mag(1, 32, 129), t_k51, 99),
        ("#1", "pair C=64 H=62 B=32 F=129 K=63 centered", mag(64, 62, 129), mag(64, 32, 129),
         t_k63, 62),
        # phase 20's shards: an sp=4 shard of the two-channel clip (pass 1: 11
        # frames; pass 2: 161 frames between 5-row halos), a tp=4 shard's bins,
        # a dp=4 shard of the 64- and 512-stream fleets
        ("#2", "sp=4 shard pass 1 C=2 T=11 F=8193 K=1", mag(2, 11, 8193), mag(2, 0, 8193),
         (0,), 0),
        ("#3", "sp=4 shard pass 2 C=2 T=171 start=5 F=513 K=11", mag(2, 171, 513),
         mag(2, 0, 513), tuple(range(-5, 6)), 5),
        ("#2", "tp=4 shard pass 1 T=41 F=4096 K=1", mag(1, 41, 4096), mag(1, 0, 4096), (0,), 0),
        ("#3", "tp=4 shard pass 2 T=643 F=256 K=11", mag(1, 643, 256), mag(1, 0, 256),
         tuple(range(-5, 6)), 0),
        ("#1", "dp=4 shard pair C=16 H=21 B=32 F=513 K=11", mag(16, 21, 513),
         mag(16, 32, 513), T256, 21),
        ("#4", "dp=4 shard pair C=128 H=21 B=16 F=513 K=11", mag(128, 21, 513),
         mag(128, 16, 513), T256, 21),
        # hop 1 at 192 and 384 kHz: 12,801 taps and 25,601 (one row's
        # keys pass shared memory), 96 and 3 outputs: the select route, a
        # block an output; a contiguous 20,001 on a whole clip's rows,
        # 180,900 outputs in runs of 32
        ("#1", "pair C=1 H=25599 B=32 F=3 K=12801 (192 kHz hop 1)",
         mag(1, hop1[192000.0].time_history, 3), mag(1, 32, 3),
         hop1[192000.0].time_offsets, hop1[192000.0].time_history),
        ("#1", "pair C=1 H=51199 B=32 F=3 K=25601 (384 kHz hop 1)",
         mag(1, hop1[384000.0].time_history, 3), mag(1, 32, 3),
         hop1[384000.0].time_offsets, hop1[384000.0].time_history),
        ("#1", "pair C=1 H=51199 B=1 F=3 K=25601 (384 kHz hop 1)",
         mag(1, hop1[384000.0].time_history, 3), mag(1, 1, 3),
         hop1[384000.0].time_offsets, hop1[384000.0].time_history),
        ("#3", "single T=20100 F=9 K=20001", mag(1, 20_100, 9), mag(1, 0, 9),
         tuple(range(-20_000, 1)), 0),
    ):
        cases.append((
            "tap_median_time", time_label(a, b, offs, start), tpu, label,
            lambda a=a, b=b, o=offs, s=start: mc.tap_median_time(a, b, o, s),
            lambda a=a, b=b, o=offs, s=start: mc.tap_median_time_plain(a, b, o, s),
            lambda a=a, b=b, o=offs, s=start: time_library(a, b, o, s),
            time_bound(a, b, offs, start),
        ))
    for tpu, label, x, k, mode in (
        ("#5", "R=32 F=2049 K=47 reflect", mag(32, 2049), 47, "reflect"),
        ("#5", "R=1 F=2049 K=47 reflect (hop 1024, B=1)", mag(1, 2049), 47, "reflect"),
        ("#5", "R=32 F=2049 K=47 reflect ties", ties(32, 2049), 47, "reflect"),
        ("#5", "R=32 F=2049 K=47 reflect bf16", bf16(32, 2049), 47, "reflect"),
        ("#5", "R=32 F=2049 K=63 reflect", mag(32, 2049), 63, "reflect"),
        ("#7", "R=2048 F=513 K=13 reflect", mag(2048, 513), 13, "reflect"),
        ("#7", "R=37 F=4096 K=47 wrap", mag(37, 4096), 47, "wrap"),
        ("#7", "R=37 F=513 K=13 edge", mag(37, 513), 13, "edge"),
        ("#5", "R=37 F=2095 K=47 valid", mag(37, 2049 + 46), 47, "valid"),
        ("#6", "offline pass 1 R=41 F=8193 K=187 reflect", mag(41, 8193), 187, "reflect"),
        ("#6", "offline pass 1 R=41 F=8193 K=187 reflect ties", ties(41, 8193), 187, "reflect"),
        ("#6", "R=41 F=8193 K=187 reflect bf16", bf16(41, 8193), 187, "reflect"),
        ("#8", "offline pass 2 R=643 F=513 K=13 reflect", mag(643, 513), 13, "reflect"),
        ("#5", "R=8 F=8193 K=187 reflect (pitch-track)", mag(8, 8193), 187, "reflect"),
        ("#7", "R=64 F=513 K=13 reflect (beat-track)", mag(64, 513), 13, "reflect"),
        ("#5", "R=32 F=2049 K=257 reflect (fs 8000 hop 1024)", mag(32, 2049), 257, "reflect"),
        ("#5", "R=32 F=2049 K=257 reflect ties", ties(32, 2049), 257, "reflect"),
        ("#5", "R=37 F=2304 K=257 valid ties bf16", ties(37, 2304).to(torch.bfloat16), 257,
         "valid"),
        # hop 32's K = 1
        ("#5", "R=32 F=65 K=1 reflect (hop 32)", mag(32, 65), 1, "reflect"),
        ("#5", "R=1 F=65 K=1 reflect (hop 32, B=1)", mag(1, 65), 1, "reflect"),
        ("#7", "R=2048 F=513 K=9 reflect", mag(2048, 513), 9, "reflect"),
        ("#7", "R=13 F=4096 K=401 wrap ties", ties(13, 4096), 401, "wrap"),
        ("#7", "R=13 F=4096 K=401 edge bf16", bf16(13, 4096), 401, "edge"),
        # the 512-stream fleet's 8192 rows per step, each border
        ("#7", "R=8192 F=513 K=13 reflect f32", mag(8192, 513), 13, "reflect"),
        ("#7", "R=8192 F=513 K=13 reflect bf16", bf16(8192, 513), 13, "reflect"),
        ("#7", "R=8192 F=1024 K=13 edge (replicate)", mag(8192, 1024), 13, "edge"),
        ("#5", "R=8192 F=1036 K=13 valid", mag(8192, 1024 + 12), 13, "valid"),
        # phase 20's shards: sp=4 of the two-channel clip; TP's median over
        # each shard's bins between fm-bin halos, K2's valid route (tp=4, 2)
        ("#6", "sp=4 shard pass 1 R=22 F=8193 K=187 reflect", mag(22, 8193), 187, "reflect"),
        ("#8", "sp=4 shard pass 2 R=322 F=513 K=13 reflect", mag(322, 513), 13, "reflect"),
        ("#5", "tp=4 shard pass 1 R=41 F=4282 K=187 valid", mag(41, 4096 + 186), 187, "valid"),
        ("#5", "tp=4 shard pass 2 R=643 F=268 K=13 valid", mag(643, 256 + 12), 13, "valid"),
        ("#5", "tp=2 shard pass 1 R=41 F=8378 K=187 valid", mag(41, 8192 + 186), 187, "valid"),
        ("#5", "tp=2 shard pass 2 R=643 F=524 K=13 valid", mag(643, 512 + 12), 13, "valid"),
        ("#7", "dp=4 shard R=512 F=513 K=13 reflect", mag(512, 513), 13, "reflect"),
        # past one block's shared memory: the K K2's first kernel's counting
        # took (the key store: 8193 outputs a row), that kernel's widest and
        # past it (256 outputs: select), and the limit (64 outputs: select)
        ("#7", "R=4 F=8193 K=16385 reflect", mag(4, 8193), 16_385, "reflect"),
        ("#7", "R=4 F=8193 K=16385 reflect bf16", bf16(4, 8193), 16_385, "reflect"),
        ("#5", "R=1 F=58112 K=57857 valid", mag(1, 58_112), 57_857, "valid"),
        ("#5", "R=2 F=65792 K=65537 valid", mag(2, 65_792), 65_537, "valid"),
        ("#7", f"R=2 F=64 K={mc.MAX_FREQ_TAPS} wrap", mag(2, 64), mc.MAX_FREQ_TAPS, "wrap"),
    ):
        cases.append((
            "sliding_median_boundary", freq_label(x, k, mode), tpu, label,
            lambda x=x, k=k, m=mode: mc.sliding_median_boundary(x, k, m),
            lambda x=x, k=k, m=mode: mc.sliding_median_boundary_plain(x, k, m),
            lambda x=x, k=k, m=mode: freq_library(x, k, m),
            freq_bound(x, k, mode),
        ))
    # the copy-only mirrors at hbm_pattern's 512-stream shapes (phase 11)
    for tpu, label, x, start, t_out in (
        ("#9", "C=512 T=53 start=21 t_out=32 F=513 f32", mag(512, 53, 513), 21, 32),
        ("#9", "C=512 T=53 start=21 t_out=32 F=513 bf16", bf16(512, 53, 513), 21, 32),
        ("#9", "C=3 T=9 start=5 t_out=4 F=65 (ragged)", mag(3, 9, 65), 5, 4),
    ):
        n = x.shape[0] * t_out * x.shape[-1]
        cases.append((
            "rows_copy", "copy", tpu, label,
            lambda x=x, s=start, t=t_out: pc.rows_copy(x, s, t),
            lambda x=x, s=start, t=t_out: pc.rows_copy_plain(x, s, t),
            lambda x=x, s=start, t=t_out: (f"x[:, {s}:{s + t}].contiguous()",
                                           lambda: x[:, s : s + t].contiguous()),
            bound(n, n, x.element_size(), 1),
        ))
    for tpu, label, x, k, mode in (
        ("#10", "R=16384 F=513 K=13 reflect f32", mag(16384, 513), 13, "reflect"),
        ("#10", "R=16384 F=513 K=13 reflect bf16", bf16(16384, 513), 13, "reflect"),
        ("#10", "R=37 F=65 K=13 wrap (ragged)", mag(37, 65), 13, "wrap"),
        ("#10", "R=37 F=65 K=13 edge (ragged)", mag(37, 65), 13, "edge"),
    ):
        cases.append((
            "segment_copy", "copy", tpu, label,
            lambda x=x, k=k, m=mode: pc.segment_copy(x, k, m),
            lambda x=x, k=k, m=mode: pc.segment_copy_plain(x, k, m),
            lambda x=x: ("x.clone()", x.clone),
            bound(x.numel(), x.numel(), x.element_size(), 1),
        ))
    return cases


def phase_kernels() -> dict:
    """Each route against its plain twin, bitwise, with its device time,
    the twin's, the library call's and the bound; then the kernels at a
    4-minute track's offline shapes, against their twins (which gather in
    chunks of 2^24 taps, so pass 1's 15.8 GB of taps never lie on the card
    at once), timed over fewer runs."""
    from zen_tpu_torch.ops import median_cuda as mc

    stats = {}
    for (name, route, tpu, label, run_kernel, run_plain, library,
         (b_us, b_by)) in kernel_cases():
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        require(got.shape == want.shape, f"{name} {label}: shape {got.shape}")
        err = float((got.float() - want.float()).abs().max())
        require(torch.equal(got, want), f"{name} {label}: max |diff| {err}")
        del got, want
        (k_us, k_n), (p_us, p_n) = row_us(run_kernel), row_us(run_plain)
        kind, lib_call = library()
        l_us, l_n = row_us(lib_call)
        del lib_call
        lib = "library" if name in PROBES else "kthvalue"
        print(
            f"phase 3 {name}/{route} ({tpu}) {label}: bitwise equal, kernel {k_us:.2f} us, "
            f"plain {p_us:.2f} us, {lib} {l_us:.2f} us ({kind}), bound {b_us:.2f} us "
            f"({b_by}) (medians of {k_n}, {p_n}, {l_n})"
        )
        st = stats.setdefault((name, route), {"max_abs_err": 0.0, "shapes": []})
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["shapes"].append({"tpu_kernel": tpu, "shape": label, "ms": k_us / 1e3,
                             "plain_ms": p_us / 1e3, "library_ms": l_us / 1e3,
                             "library": kind, "bound_ms": b_us / 1e3, "bound_by": b_by})
    rng = np.random.default_rng(1)
    feats2 = _mags(rng, 1, TRACK_FRAMES_P, 513)
    feats1 = _mags(rng, TRACK_FRAMES_H, 8193)
    centered = tuple(range(-5, 6))
    # median2d's time filter at fl 93 on the pass-2 frames (phase 31), 'valid'
    feats93, causal93 = _mags(rng, 1, TRACK_FRAMES_P + 92, 513), tuple(range(-92, 1))
    for name, tpu, label, fn, plain, library, (b_us, b_by), route in (
        ("tap_median_time", "#3", f"track pass 2 T={TRACK_FRAMES_P} F=513 K=11",
         lambda: mc.tap_median_time(feats2, feats2[:, :0], centered, 0),
         lambda: mc.tap_median_time_plain(feats2, feats2[:, :0], centered, 0),
         lambda: time_library(feats2, feats2[:, :0], centered, 0),
         time_bound(feats2, feats2[:, :0], centered, 0),
         time_label(feats2, feats2[:, :0], centered, 0)),
        ("sliding_median_boundary", "#8", f"track pass 2 R={TRACK_FRAMES_P} F=513 K=13",
         lambda: mc.sliding_median_boundary(feats2[0], 13, "reflect"),
         lambda: mc.sliding_median_boundary_plain(feats2[0], 13, "reflect"),
         lambda: freq_library(feats2[0], 13, "reflect"),
         freq_bound(feats2[0], 13, "reflect"), freq_label(feats2[0], 13, "reflect")),
        ("sliding_median_boundary", "#6", f"track pass 1 R={TRACK_FRAMES_H} F=8193 K=187",
         lambda: mc.sliding_median_boundary(feats1, 187, "reflect"),
         lambda: mc.sliding_median_boundary_plain(feats1, 187, "reflect"),
         lambda: freq_library(feats1, 187, "reflect"),
         freq_bound(feats1, 187, "reflect"), freq_label(feats1, 187, "reflect")),
        ("tap_median_time", "#2", f"median2d time fl 93 T={TRACK_FRAMES_P}+92 F=513 K=93",
         lambda: mc.tap_median_time(feats93, feats93[:, :0], causal93, 92),
         lambda: mc.tap_median_time_plain(feats93, feats93[:, :0], causal93, 92),
         lambda: time_library(feats93, feats93[:, :0], causal93, 92),
         time_bound(feats93, feats93[:, :0], causal93, 92),
         time_label(feats93, feats93[:, :0], causal93, 92)),
    ):
        got, want = fn(), plain()
        err = float((got - want).abs().max())
        require(torch.equal(got, want), f"{name} {label}: max |diff| {err}")
        del got, want
        us = median_us(fn, runs=5, warmup=1)
        p_us = median_us(plain, runs=3, warmup=0)
        kind, build = library()
        l_us = median_us(build, runs=3, warmup=1)
        del build
        torch.cuda.empty_cache()
        print(f"phase 3 {name}/{route} ({tpu}) {label}: bitwise equal, kernel {us:.2f} us "
              f"(median of 5), plain {p_us:.2f} us (median of 3), kthvalue {l_us:.2f} us "
              f"({kind}, median of 3), bound {b_us:.2f} us ({b_by})")
        stats.setdefault((name, route), {"max_abs_err": 0.0, "shapes": []})["shapes"].append({
            "tpu_kernel": tpu, "shape": label, "ms": us / 1e3, "plain_ms": p_us / 1e3,
            "library_ms": l_us / 1e3, "library": kind, "bound_ms": b_us / 1e3,
            "bound_by": b_by})
    return stats


def phase_network() -> None:
    """The comparator-network routes at every odd K they take, each held
    bitwise against its twin: K1 register (K 1..63) in both of its forms,
    the per-output network at the wrapper's run and the shared core at
    each R it is built for (select_network.core_shapes), on a centered
    one-input case with fill = inf (one tap run, tie-heavy f32) and a
    causal-wrap pair of two tap runs (fm, fm + 1) (bf16), and the network
    on a causal pair with a duplicated offset 0 (bf16; no core shape); K2
    network (K 1..63) in both of its forms, the per-output network and the
    shared core at each R it is built for (freq_core_runs), under each of
    the four borders on tie-heavy f32 rows with +inf and -inf samples and
    on bf16 rows. Times the f32 cases, each form of both kernels (K2 on
    [2048, 513] reflect), and prints the form and R each wrapper's rule
    picks (time_network_form, freq_network_form)."""
    from zen_tpu_torch.ops import median_cuda as mc

    rng = np.random.default_rng(5)
    a32, a16 = _ties(rng, 64, 37, 513), _mags(rng, 64, 21, 513).to(torch.bfloat16)
    b16 = _mags(rng, 64, 16, 513).to(torch.bfloat16)
    w16 = _mags(rng, 16, 2 * mc.REGISTER_TAPS + 16, 129).to(torch.bfloat16)
    # K2: rows of 513 bins; 'valid' reads 543 (544 - K outputs)
    x32 = _ties(rng, 2048, 513 + mc.FREQ_NETWORK_MAX_TAPS - 1)
    x32[torch.rand(x32.shape, device=DEVICE) < 0.02] = float("inf")
    x32[torch.rand(x32.shape, device=DEVICE) < 0.02] = float("-inf")
    x16 = _mags(rng, 512, 513 + mc.FREQ_NETWORK_MAX_TAPS - 1).to(torch.bfloat16)
    rows2 = {"valid": (x32, x16), "bins": (x32[:, :513].contiguous(), x16[:, :513].contiguous())}
    inf = float("inf")
    for k in range(1, mc.REGISTER_TAPS + 1, 2):
        m = (k - 1) // 2
        centered = tuple(range(-m, m + 1))
        causal = tuple(range(-(k - 3), 1)) + (0, 0) if k > 1 else (0,)
        two = tuple(range(-2 * k, -2 * k + m)) + tuple(range(-m, 1))  # the causal wrap's runs
        require(mc.time_route(centered) == "register", f"K={k} leaves K1's network")
        want = mc.tap_median_time_plain(a32, a32[:, :0], centered, 0, inf)
        run = mc.time_network_run(37, 64, 513, centered)
        forms = {f"network run {run}": lambda: mc._time_launch(  # noqa: E731
            a32, a32[:, :0], centered, 0, inf, "register", run=run)}
        forms.update({f"core R={r}": lambda r=r: mc._time_launch(  # noqa: E731
            a32, a32[:, :0], centered, 0, inf, "register", core=r)
            for r in mc.time_core_runs(centered)})
        for name, fn in forms.items():
            require(torch.equal(fn(), want), f"K1 {name} K={k} centered fill=inf ties differs")
        hist, fresh = w16[:, -2 * k:].contiguous(), w16[:, :16].contiguous()
        want16 = mc.tap_median_time_plain(hist, fresh, two, 2 * k)
        for r in (None, *mc.time_core_runs(two)):
            got = mc._time_launch(hist, fresh, two, 2 * k, 0.0, "register", core=r,
                                  run=None if r else mc.time_network_run(16, 16, 129, two))
            require(torch.equal(got, want16),
                    f"K1 {'core R=%d' % r if r else 'network'} K={k} two tap runs bf16 differs")
        require(torch.equal(mc._time_launch(a16, b16, causal, 21, 0.0, "register"),
                            mc.tap_median_time_plain(a16, b16, causal, 21)),
                f"K1 network K={k} causal duplicated-0 bf16 differs")
        form, size = mc.time_network_form(centered, 37, 64, 513)
        k1 = (", ".join(f"{name} {median_us(fn, runs=10):.2f}" for name, fn in forms.items())
              + f" us, picked {'core R=%d' % size if form == 'core' else 'network run %d' % size}")
        require(mc.freq_route(k) == "network", f"K={k} leaves K2's network")
        timed2 = {}
        for mode in mc.FREQ_MODES:
            for x in rows2["valid" if mode == "valid" else "bins"]:
                want = mc.sliding_median_boundary_plain(x, k, mode)
                for core in (1, *mc.freq_core_runs(k)):
                    fn = lambda x=x, m=mode, c=core: mc._freq_launch(  # noqa: E731
                        x, k, m, "network", core=c)
                    name = "network" if core == 1 else f"core R={core}"
                    require(torch.equal(fn(), want), f"K2 {name} K={k} {mode} {x.dtype} differs")
                    if mode == "reflect" and x.dtype == torch.float32:
                        timed2[name] = fn
        form, size = mc.freq_network_form(k, 2048, 513, "reflect")
        k2 = ("K2 [2048, 513] " + ", ".join(f"{name} {median_us(fn, runs=10):.2f}"
                                            for name, fn in timed2.items())
              + f" us, picked {'core R=%d' % size if form == 'core' else 'network'}")
        print(f"phase 3 network K={k}: bitwise equal (K1 both forms: f32 ties fill=inf one tap "
              f"run, bf16 two tap runs at every built R; K1 network bf16 duplicated taps; K2 both "
              f"forms at every built R, each border, f32 ties +-inf and bf16); K1 [64, 37, 513] "
              f"{k1}, {k2} (medians of 10)")


def phase_runs() -> None:
    """K1's register route in both forms at the paths' shapes: the
    per-output network at each of RUN_LENGTHS (output rows per thread)
    and the shared core at each R it is built for, every output equal to
    the twin's; their times, the fastest, and the form and R the
    wrapper's rule picks (time_network_form) beside it."""
    from zen_tpu_torch.ops import median_cuda as mc

    rng = np.random.default_rng(6)
    centered = tuple(range(-5, 6))
    for label, a, b, offs, start in (
        ("K=11 C=512 H=21 B=16 F=513", _mags(rng, 512, 21, 513), _mags(rng, 512, 16, 513),
         T256, 21),
        ("K=11 C=64 H=21 B=32 F=513", _mags(rng, 64, 21, 513), _mags(rng, 64, 32, 513), T256, 21),
        (f"K=11 track pass 2 T={TRACK_FRAMES_P} F=513 centered",
         _mags(rng, 1, TRACK_FRAMES_P, 513), _mags(rng, 1, 0, 513), centered, 0),
        ("K=11 clip pass 2 T=643 F=513 centered", _mags(rng, 1, 643, 513), _mags(rng, 1, 0, 513),
         centered, 0),
        ("K=3 C=1 H=5 B=32 F=2049", _mags(rng, 1, 5, 2049), _mags(rng, 1, 32, 2049),
         (-5, -1, 0), 5),
        ("K=47 C=64 H=91 B=32 F=129 (hop 64)", _mags(rng, 64, 91, 129),
         _mags(rng, 64, 32, 129), tuple(range(-91, -68)) + tuple(range(-23, 1)), 91),
        ("K=47 C=1 H=91 B=32 F=129 (one hop-64 stream)", _mags(rng, 1, 91, 129),
         _mags(rng, 1, 32, 129), tuple(range(-91, -68)) + tuple(range(-23, 1)), 91),
    ):
        want = mc.tap_median_time_plain(a, b, offs, start)
        us = {}
        for run in RUN_LENGTHS:
            fn = lambda r=run: mc._time_launch(a, b, offs, start, 0.0, "register", run=r)  # noqa: E731
            require(torch.equal(fn(), want), f"runs {label} run {run} differs")
            us[f"run {run} ({len(mc.time_network_plan(offs, run)[0])} staged)"] = median_us(
                fn, runs=10)
        for r in mc.time_core_runs(offs):
            fn = lambda r=r: mc._time_launch(a, b, offs, start, 0.0, "register", core=r)  # noqa: E731
            require(torch.equal(fn(), want), f"runs {label} core R={r} differs")
            us[f"core R={r}"] = median_us(fn, runs=10)
        form, size = mc.time_network_form(offs, a.shape[1] + b.shape[1] - start, a.shape[0],
                                           a.shape[2])
        print(f"phase 3 runs K1 register {label}: bitwise equal; network "
              + ", ".join(f"{name} {v:.2f} us" for name, v in us.items())
              + f" (medians of 10); fastest {min(us, key=us.get)}, picked "
              + (f"core R={size}" if form == "core" else f"network run {size}"))


def phase_sweep() -> None:
    """K2's routes over SWEEP_K at SWEEP_SHAPES (reflect): every route
    that takes a K (network up to FREQ_NETWORK_MAX_TAPS in both of its
    forms, the per-output network and the shared core at each built R;
    rank) held bitwise against the twin, timed beside kthvalue and beside
    the form the rule picks (freq_network_form); prints the
    measured crossover (the smallest K from which the rank route is the
    fastest at every larger K of the sweep, on every shape) beside the
    constant."""
    from zen_tpu_torch.ops import median_cuda as mc

    rng = np.random.default_rng(2)
    rank_wins = {}
    for shape in SWEEP_SHAPES:
        x = _mags(rng, *shape)
        for k in SWEEP_K:
            want = mc.sliding_median_boundary_plain(x, k, "reflect")
            runs = {}
            if k <= mc.FREQ_NETWORK_MAX_TAPS:
                runs["network"] = functools.partial(mc._freq_launch, x, k, "reflect", "network",
                                                    core=1)
                for r in mc.freq_core_runs(k):
                    runs[f"core R={r}"] = functools.partial(mc._freq_launch, x, k, "reflect",
                                                            "network", core=r)
            runs["rank"] = functools.partial(mc._freq_launch, x, k, "reflect", "rank")
            us = {}
            for name, run in runs.items():
                require(torch.equal(run(), want), f"sweep {shape} K={k} {name} differs")
                us[name] = median_us(run, runs=10)
            kind, lib = freq_library(x, k, "reflect")
            l_us = median_us(lib, runs=10)
            b_us, b_by = freq_bound(x, k, "reflect")
            rank_wins.setdefault(k, []).append(min(us, key=us.get) == "rank")
            picked = ""
            if k <= mc.FREQ_NETWORK_MAX_TAPS:
                form, r = mc.freq_network_form(k, *shape, "reflect")
                picked = ("; picked " + (f"core R={r}" if form == "core" else "network")
                          + f", fastest {min(us, key=us.get)}")
            print(f"phase 3 sweep R={shape[0]} F={shape[1]} K={k} reflect: bitwise equal; "
                  + ", ".join(f"{r} {v:.2f} us" for r, v in us.items())
                  + f" (rank tile, run {mc.freq_rank_plan(k, *shape, 'reflect', mc._sm_count(x.device))}), "
                  f"kthvalue {l_us:.2f} us ({kind}), bound "
                  f"{b_us:.2f} us ({b_by}) (medians of 10){picked}")
    wins = [k for i, k in enumerate(SWEEP_K) if all(all(rank_wins[j]) for j in SWEEP_K[i:])]
    print(f"phase 3 sweep: rank the fastest route on every shape from K="
          f"{wins[0] if wins else None} on; FREQ_RANK_MIN_TAPS = {mc.FREQ_RANK_MIN_TAPS}")


def phase_tiles() -> None:
    """The rank routes at every geometry the cost rule weighs
    (benches/rank_geometry.py's rows but the 4-minute track's: K2's tile
    and run of outputs a thread, K1's run of output rows, lane run and
    columns), each held bitwise against the twin, timed beside the rule's
    price, and the fastest beside the rule's pick."""
    from zen_tpu_torch.benches import rank_geometry, rank_store
    from zen_tpu_torch.ops import median_cuda as mc

    rank_geometry.run_rows(torch, mc, rank_store.device_us, 10, fast=True, device=DEVICE,
                           emit=lambda line: print(f"phase 3 {line}"))


def phase_warp() -> None:
    """K1's warp route beside its rank and select routes at
    benches/warp_rows.py's rows (hop 32's K = 93 from one stream at B = 1
    to 64 streams, K = 127 to 255), each bitwise to the twin, beside the
    cost rule's prices and pick."""
    from zen_tpu_torch.benches import warp_rows
    from zen_tpu_torch.ops import median_cuda as mc

    warp_rows.run_rows(torch, mc, 10, DEVICE, emit=lambda line: print(f"phase 3 {line}"))


def phase_select() -> dict:
    """K1's and K2's wide routes side by side on benches/rank_store.py's
    rows: the seven that lost to torch.kthvalue on the key store or the
    shared sort, K2's store row of many outputs, and the paths' rank rows
    (hop 32's K1, which the warp route takes now, and hop 1024's K2, which
    the network takes). Each forced through the select route and, where
    they take the call, the rank route, K1's warp route and K2's network
    (_time_launch, _freq_launch): each bitwise to the rank route's output
    (to the twin where the rank route cannot take it), each timed beside
    the twin, one torch.kthvalue call and the bound, the cost rule's prices
    and pick (time_route_costs, freq_route_costs) beside the fastest route
    measured. Returns {label: {route: µs}}."""
    from zen_tpu_torch import ZenError
    from zen_tpu_torch.benches import rank_store
    from zen_tpu_torch.ops import median_cuda as mc

    sms = mc._sm_count(torch.device(DEVICE))
    out, agree = {}, 0
    for label, kind, args in rank_store.rows(torch, DEVICE):
        if kind == "time":
            a, b, offs, start = args
            t_v, streams, f = a.shape[-2] + b.shape[-2], math.prod(a.shape[:-2]), a.shape[-1]
            run = {r: functools.partial(mc._time_launch, a, b, offs, start, 0.0, r)
                   for r in ("rank", "select")
                   + (("warp",) if mc.time_warp_slots(len(offs)) else ())}
            _, _, staged, threads = mc.time_select_plan(offs, start, t_v, streams, f, sms)
            bins = mc.select_shared_bins(threads)
            other = functools.partial(mc._time_launch, a, b, offs, start, 0.0, "select",
                                      shared_bins=not bins)
            plain = functools.partial(mc.tap_median_time_plain, a, b, offs, start)
            costs = mc.time_route_costs(offs, start, t_v, streams, f, sms)
            pick = mc.time_call_route(offs, start, t_v, streams, f, sms)
            library, (b_us, b_by) = time_library(a, b, offs, start), time_bound(a, b, offs, start)
        else:
            x, k, mode = args
            run = {r: functools.partial(mc._freq_launch, x, k, mode, r) for r in ("rank", "select")
                   + (("network",) if k <= mc.FREQ_NETWORK_MAX_TAPS else ())}
            _, staged, threads = mc.freq_select_plan(k, x.numel() // x.shape[-1], x.shape[-1],
                                                     mode, sms)
            bins = mc.select_shared_bins(threads)
            other = functools.partial(mc._freq_launch, x, k, mode, "select", shared_bins=not bins)
            plain = functools.partial(mc.sliding_median_boundary_plain, x, k, mode)
            costs = mc.freq_route_costs(k, x.numel() // x.shape[-1], x.shape[-1], mode, sms)
            pick = freq_label(x, k, mode).split("@")[0]
            library, (b_us, b_by) = freq_library(x, k, mode), freq_bound(x, k, mode)
        got = run["select"]()
        try:
            want, held = run["rank"](), "the rank route"
        except ZenError:
            want, held = plain(), "the twin"
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"select {label}: differs from {held}")
        for route in set(run) - {"rank", "select"}:
            require(torch.equal(run[route](), want), f"{route} {label}: differs from {held}")
        del got, want
        us = {}
        for route, fn in run.items():
            try:
                us[route] = row_us(fn, spin=SELECT_SPIN)[0]
            except ZenError:
                pass
        alt = ""
        bins = mc.select_layout(staged, threads, bins)[1]  # where they fit
        if mc.select_layout(staged, threads)[:2] == (True, True):  # both places fit
            require(torch.equal(other(), run["select"]()), f"select {label}: bins differ")
            alt = (f", select with its bins {'in registers' if bins else 'in shared memory'} "
                   f"{row_us(other, spin=SELECT_SPIN)[0]:.2f} us")
        p_us = row_us(plain)[0]
        kind_l, lib_call = library
        l_us = row_us(lib_call)[0]
        del lib_call
        fastest = min(us, key=us.get)
        agree += fastest == pick
        out[label] = us
        rank_text = f"rank {us['rank']:.2f} us" if "rank" in us else "rank n/a (keys pass a block)"
        rank_text += "".join(f", {route} {us[route]:.2f} us" for route in ("warp", "network")
                             if route in us)
        cost_text = "n/a" if costs[0] is None else f"{costs[0]:.1f}"
        if len(costs) > 2 and costs[2] is not None:
            cost_text += f", warp {costs[2]:.1f}"
        print(f"phase 3 select {label}: select bitwise equal to {held}; select "
              f"{us['select']:.2f} us ({threads} threads, {staged} staged, bins "
              f"{'in shared memory' if bins else 'in registers'}){alt}, {rank_text}, plain "
              f"{p_us:.2f} us, kthvalue {l_us:.2f} "
              f"us ({kind_l}), bound {b_us:.2f} us ({b_by}); cost rule rank {cost_text}, "
              f"select {costs[1]:.1f}: picks {pick}, fastest measured {fastest}")
        torch.cuda.empty_cache()
    print(f"phase 3 select: the cost rule picked the fastest route on {agree} of {len(out)} rows")
    return out


def phase_split() -> None:
    """Where a rank block's time goes: each rank kernel whole and from the
    two split builds (ZEN_RANK_CUT, csrc/rank_select.cuh), which end after
    staging and after the sort, at the paths' shapes and median2d's
    (benches/rank_split.py's rows: the 4-minute track's pass 1, median2d's
    fl 93 and fl 187, the clip's pass 1, pitch-track's K2). The
    differences read as staging (with the launch), sort and walk; beside
    them the route the wrapper takes, the twin, one torch.kthvalue call
    and the bound."""
    from zen_tpu_torch.benches import rank_split, rank_store
    from zen_tpu_torch.ops import median_cuda as mc

    splits = rank_split.split(torch, mc, rank_store.device_us, TIMED_RUNS, DEVICE)
    for (label, kind, args), (_, whole, stage, sort, walk) in zip(rank_split.rows(torch, DEVICE),
                                                                  splits):
        if kind == "time":
            a, b, offs, start = args
            plain = functools.partial(mc.tap_median_time_plain, a, b, offs, start)
            library, (b_us, b_by) = time_library(a, b, offs, start), time_bound(a, b, offs, start)
            picked = time_label(a, b, offs, start)
        else:
            x, k, mode = args
            plain = functools.partial(mc.sliding_median_boundary_plain, x, k, mode)
            library, (b_us, b_by) = freq_library(x, k, mode), freq_bound(x, k, mode)
            picked = freq_label(x, k, mode)
        p_us = median_us(plain, runs=3, warmup=1)
        kind_l, lib_call = library
        l_us = median_us(lib_call, runs=3, warmup=1)
        del args, plain, library, lib_call
        torch.cuda.empty_cache()
        print(f"phase 3 split {label}: whole {whole:.2f} us; staging and launch {stage:.2f}, "
              f"sort {sort:.2f}, walk {walk:.2f} us (medians of {TIMED_RUNS}); the wrapper takes "
              f"{picked}; plain {p_us:.2f} us, kthvalue {l_us:.2f} us ({kind_l}), bound "
              f"{b_us:.2f} us ({b_by}) (medians of 3)")


def stream_masks(cfg, audio: np.ndarray, sizes, device, keep=None) -> torch.Tensor:
    """Hard masks [2, C, N, bins] (harmonic, percussive) of the streams
    audio [C, N*hop], block by block through block_step's own analysis
    half and state update (no synthesis), on ``device``; of the streams
    ``keep`` only, when given (all streams still run)."""
    from zen_tpu_torch.drivers import realtime as rt

    c = audio.shape[0]
    hops = torch.from_numpy(audio).reshape(c, -1, cfg.hop)
    state = rt.init_state(cfg, c, device)
    sel = slice(None) if keep is None else torch.as_tensor(list(keep), device=device)
    out, t = [], 0
    for b in sizes:
        step = rt.step_masks(cfg, state, hops[:, t : t + b].to(device))
        out.append(torch.stack(step.masks[:2])[:, sel].cpu())
        rt.advance_state(cfg, state, step)
        t += b
    return torch.cat(out, dim=2)


def compare_stream(cfg, audio, sizes, got, want, stems, keep=None) -> dict:
    """Flip count from the masks on both devices, then the stem
    tolerance on every hop no flipped frame feeds (frame t feeds output
    hops t and t+1). got/want: [C, E, L] host arrays, L <= N*hop, of the
    streams ``keep`` of audio [S, N*hop] (all when None); the card's
    masks come from a run of all S streams, the CPU's from those C."""
    m_gpu = stream_masks(cfg, audio, sizes, DEVICE, keep)
    m_cpu = stream_masks(cfg, audio if keep is None else audio[list(keep)], sizes, "cpu")
    return hold_masks(m_gpu, m_cpu, cfg.hop, got, want, stems)


def hold_masks(m_a, m_b, hop, got, want, stems, atol=STEM_ATOL, flip_share=FLIP_SHARE) -> dict:
    """compare_stream's rule on two runs' masks [2, C, N, bins]: the flip
    share (raises above ``flip_share`` unless it is None), then ``atol``
    x scale on every output hop no flipped frame feeds."""
    differ = (m_a != m_b).any(dim=0)  # [C, N, bins]
    flips = int(differ.sum())
    share = flips / differ.numel()
    if flip_share is not None:
        require(share <= flip_share, f"hard-mask flips {flips} ({share:.3g} of bins)")
    flipped = differ.any(dim=-1).numpy()  # [C, N]
    excluded = flipped.copy()
    excluded[:, 1:] |= flipped[:, :-1]
    c, n = excluded.shape
    held = np.repeat(~excluded, hop, axis=1)[:, : got.shape[-1]]  # [C, L]
    worst = 0.0
    for e, stem in enumerate(stems):
        for ch in range(c):
            ref = want[ch, e]
            scale = max(1.0, float(np.abs(ref).max()))
            err = float(np.abs(got[ch, e] - ref)[held[ch]].max(initial=0.0))
            require(
                err <= atol * scale,
                f"{stem} stream {ch}: max |diff| {err} > {atol} x {scale}",
            )
            worst = max(worst, err / scale)
    return {"flips": flips, "share": share, "excluded": int(excluded.sum()),
            "hops": c * n, "rel_err": worst}


def reset_launches() -> None:
    from zen_tpu_torch.ops import median_cuda as mc
    from zen_tpu_torch.ops import probe_cuda as pc

    for name in ROUTES:
        wrapper = getattr(mc, name)
        wrapper.launches = wrapper.steps = wrapper.cores = 0
        wrapper.routes.update(dict.fromkeys(wrapper.routes, 0))
    mc.sliding_median_boundary.stores.update(dict.fromkeys(mc.sliding_median_boundary.stores, 0))
    for name in PROBES:
        getattr(pc, name).launches = 0


def read_launches() -> dict:
    """Median launches since the last reset by kernel route, 'kernel/route';
    of each kernel's on the rank route, the ones that took its steps
    kernel, 'kernel/rank@steps' (STEPS); of K1's on the register route,
    the ones that took the shared core, 'tap_median_time/register@core'
    (CORE); of K2's on the network route, the ones that took its shared
    core, 'sliding_median_boundary/network@core' (FREQ_CORE); and of K2's
    on the rank route, the ones whose keys took the key store,
    'sliding_median_boundary/rank@scratch'."""
    from zen_tpu_torch.ops import median_cuda as mc

    counts = {f"{name}/{route}": getattr(mc, name).routes[route]
              for name, routes in ROUTES.items() for route in routes}
    counts.update({f"{name}/{STEPS}": getattr(mc, name).steps for name in ROUTES})
    counts[f"tap_median_time/{CORE}"] = mc.tap_median_time.cores
    counts[f"sliding_median_boundary/{FREQ_CORE}"] = mc.sliding_median_boundary.cores
    counts[f"sliding_median_boundary/{SCRATCH}"] = mc.sliding_median_boundary.stores["scratch"]
    return counts


def read_probe_launches() -> dict:
    """The copy mirrors' launches since the last reset, 'kernel/copy'."""
    from zen_tpu_torch.ops import probe_cuda as pc

    return {f"{name}/copy": getattr(pc, name).launches for name in PROBES}


def per_kernel(counts: dict) -> dict:
    """read_launches() summed over each kernel's routes."""
    return {name: sum(counts[f"{name}/{r}"] for r in routes) for name, routes in ROUTES.items()}


def run_stream(fs=44100.0, hop=1024, b=32, n_blocks=64, n_single=64, **cfg_kw):
    """Main path, single stream: returns (config, outputs [1, 3, N*hop],
    audio, block sizes, timings). ``cfg_kw`` go to HPRConfig."""
    from zen_tpu_torch import HPRRealtime

    n = (n_blocks * b + n_single) * hop
    audio = synthetic_mix(n, fs, seed=1)
    hops = torch.from_numpy(audio).to(DEVICE).reshape(-1, hop)
    rt = HPRRealtime(fs, hop=hop, device=DEVICE, **cfg_kw)
    rt.warmup((b, 1))
    outs = [rt.process_block(hops[j * b : (j + 1) * b]) for j in range(n_blocks)]
    outs += [rt.process_next_hop(hops[n_blocks * b + t]) for t in range(n_single)]
    got = torch.cat(outs, dim=1).cpu().numpy()[None]
    step = hops[:b]
    timing = {
        "step_us": wall_us_per_call(lambda: rt.process_block(step), TIMED_RUNS),
        "hop_us": wall_us_per_call(lambda: rt.process_next_hop(step[0]), 200),
        "prof_b": device_profile(lambda: rt.process_block(step)),
        "prof_1": device_profile(lambda: rt.process_next_hop(step[0])),
    }
    sizes = [b] * n_blocks + [1] * n_single
    return rt.cfg, got, audio[None], sizes, timing


def reference_stream(audio, sizes, hop=1024, fs=44100.0, **cfg_kw) -> np.ndarray:
    from zen_tpu_torch import HPRRealtime

    rt = HPRRealtime(fs, hop=hop, device="cpu", **cfg_kw)
    hops = torch.from_numpy(audio[0]).reshape(-1, hop)
    outs, t = [], 0
    for b in sizes:
        outs.append(rt.process_block(hops[t : t + b]))
        t += b
    return torch.cat(outs, dim=1).numpy()[None]


def fleet_audio(c: int, n: int, fs: float) -> np.ndarray:
    return np.stack(
        [synthetic_mix(n, fs, seed=100 + i, f0=110.0 * (1 + i / 16)) for i in range(c)]
    )


def run_fleet(fs=44100.0, hop=256, c=64, b=32, n_blocks=16, **cfg_kw):
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, MultiStreamHPR

    audio = fleet_audio(c, n_blocks * b * hop, fs)
    blocks = torch.from_numpy(audio).to(DEVICE).reshape(c, n_blocks, b, hop)
    ms = MultiStreamHPR(c, fs, hop=hop, device=DEVICE, **cfg_kw)
    ms.warmup((b,))
    got = torch.cat(
        [ms.process_block(blocks[:, j]) for j in range(n_blocks)], dim=2
    ).cpu().numpy()
    # percussive-only fleet: compact rows, one per enabled stem
    perc = MultiStreamHPR(c, fs, hop=hop, outputs=OUTPUT_PERCUSSIVE, device=DEVICE, **cfg_kw)
    rows = perc.stem_rows
    require(
        rows == {"harmonic": None, "percussive": 0, "residual": None},
        f"stem_rows of a percussive-only fleet: {rows}",
    )
    part = torch.cat(
        [perc.process_block(blocks[:, j]) for j in range(4)], dim=2
    ).cpu().numpy()
    require(part.shape == (c, 1, 4 * b * hop), f"compact rows shape {part.shape}")
    full_p = got[:, ms.stem_rows["percussive"], : 4 * b * hop]
    scale = max(1.0, float(np.abs(full_p).max()))
    require(
        float(np.abs(part[:, 0] - full_p).max()) <= STEM_ATOL * scale,
        "percussive-only compact row differs from the full fleet's percussive row",
    )
    step = blocks[:, 0]
    step_us = wall_us_per_call(lambda: ms.process_block(step), TIMED_RUNS)
    timing = {
        "step_us": step_us,
        "msps": c * b * hop / step_us,
        "prof_b": device_profile(lambda: ms.process_block(step)),
    }
    return ms.cfg, got, audio, [b] * n_blocks, timing


def reference_fleet(audio, sizes, hop=256, fs=44100.0, **cfg_kw) -> np.ndarray:
    from zen_tpu_torch import MultiStreamHPR

    c = audio.shape[0]
    ms = MultiStreamHPR(c, fs, hop=hop, device="cpu", **cfg_kw)
    x = torch.from_numpy(audio).reshape(c, -1, hop)
    outs, t = [], 0
    for b in sizes:
        outs.append(ms.process_block(x[:, t : t + b]))
        t += b
    return torch.cat(outs, dim=2).numpy()


# ---------------- offline two-pass HPR-I ----------------


def hold_pass(what: str, got: dict, want: dict, masks_got, masks_want, hop: int,
              atol: float = STEM_ATOL) -> dict:
    """Hold one pass's stems against a reference run under the port's
    flip rule (zen_tpu_torch.tools.parity.flip_rule)."""
    st = flip_rule(got, want, masks_got, masks_want, hop, atol, what)
    return {**st, "samples": got["harmonic"].shape[-1]}


def hold_pass_on_cpu(cfg, audio: torch.Tensor) -> tuple:
    """One offline pass on the card vs the port on the CPU, fed the same
    samples, hpr_separate's two halves on each side: the stems and the
    very masks they came from, which the flip rule reads."""
    from zen_tpu_torch.drivers.offline import pass_masks, pass_stems

    host = audio.cpu()
    fm_gpu, fm_cpu = pass_masks(audio, cfg), pass_masks(host, cfg)
    got, want = pass_stems(fm_gpu, cfg, audio), pass_stems(fm_cpu, cfg, host)
    st = hold_pass(f"hop {cfg.hop} pass", got, want, fm_gpu.masks, fm_cpu.masks, cfg.hop)
    return got, st


def offline_separator():
    """BASELINE.json configs[0]: zen offline --hps 4096 2.5 256 2.5."""
    from zen_tpu_torch import HPRIOffline

    return HPRIOffline(OFFLINE_FS, 4096, 256, 2.5, 2.5, device=DEVICE)


def phase_offline_clip(smi: str) -> dict:
    """The reference's 3.66 s clip through HPRIOffline.process on the
    card, held pass by pass against the port on the CPU: pass 1 on the
    same audio, pass 2 on the card's intermediate (so pass-1 flips do
    not cascade), and process() bitwise against the composition of its
    two passes on the card."""
    sep = offline_separator()
    x = torch.from_numpy(synthetic_mix(CLIP_SAMPLES, OFFLINE_FS, seed=7)).to(DEVICE)
    sep.process(x)  # cuFFT plans
    reset_launches()
    h, p, r = sep.process(x)
    launches = read_launches()
    totals = per_kernel(launches)
    wall = wall_us_per_call(lambda: sep.process(x), 10) / 1e6
    pass1, st1 = hold_pass_on_cpu(sep.cfg_h, x)
    pass2, st2 = hold_pass_on_cpu(sep.cfg_p, pass1["percussive"] + pass1["residual"])
    require(
        torch.equal(h, pass1["harmonic"]) and torch.equal(p, pass2["percussive"])
        and torch.equal(r, pass2["residual"]),
        "process() differs from its two hpr_separate passes on the card",
    )
    for i, st in ((1, st1), (2, st2)):
        print(
            f"phase 7 offline clip pass {i}: mask flips {st['flips']} "
            f"({st['share']:.3g} of bins), excluded samples {st['excluded']}/"
            f"{st['samples']}, max |diff|/scale {st['rel_err']:.3g} (limit {STEM_ATOL})"
        )
    print(
        f"phase 7 offline clip {CLIP_SAMPLES} samples (3.66 s): process() "
        f"{wall * 1e3:.2f} ms wall (mean of 10) = {CLIP_SAMPLES / OFFLINE_FS / wall:.1f} s "
        f"of audio per s; the reference took {CLIP_REF_MS:.0f} ms on an RTX 2070 SUPER "
        f"(BASELINE.md, an outside point); launches {launches} [{smi}]"
    )
    require(all(v > 0 for v in totals.values())
            and launches[f"sliding_median_boundary/{STEPS}"] > 0
            and launches[f"sliding_median_boundary/{FREQ_CORE}"] > 0,
            f"offline clip launches {launches} (pass 1's K2 takes the steps, pass 2's its "
            "shared core)")
    return launches


def phase_offline_track(smi: str) -> dict:
    """A 4-minute track through process() and process_blocked() on the
    card, held against each other: bitwise, or else pass by pass under
    the flip rule (the blocked pass batches its transforms per block)."""
    from zen_tpu_torch import hpr_separate, hpr_separate_blocked
    from zen_tpu_torch.drivers.offline import blocked_pass_masks, pass_masks

    sep = offline_separator()
    x = torch.from_numpy(synthetic_mix(TRACK_SAMPLES, OFFLINE_FS, seed=8)).to(DEVICE)
    reset_launches()
    whole = sep.process(x)
    blocked = sep.process_blocked(x)
    torch.cuda.synchronize()
    launches = read_launches()
    require(all(v > 0 for v in per_kernel(launches).values())
            and launches[f"sliding_median_boundary/{STEPS}"] > 0
            and launches[f"sliding_median_boundary/{FREQ_CORE}"] > 0,
            f"offline track launches {launches} (pass 1's K2 takes the steps, pass 2's its "
            "shared core)")
    for outs in (whole, blocked):
        require(all(bool(torch.isfinite(o).all()) for o in outs), "non-finite track stems")
    if all(torch.equal(a, b) for a, b in zip(whole, blocked)):
        held = "bitwise equal"
    else:
        held, audio = [], x
        for cfg, bf in ((sep.cfg_h, 512), (sep.cfg_p, 8192)):
            unb = hpr_separate(audio, cfg)
            blk = hpr_separate_blocked(audio, cfg, bf)
            st = hold_pass(f"track hop {cfg.hop} blocked", blk, unb,
                           blocked_pass_masks(audio, cfg, bf),
                           pass_masks(audio, cfg).masks, cfg.hop)
            held.append(f"hop {cfg.hop}: flips {st['flips']} ({st['share']:.3g}), "
                        f"max |diff|/scale {st['rel_err']:.3g}")
            audio = unb["percussive"] + unb["residual"]  # pass 2 on one intermediate
        held = "held pass by pass: " + "; ".join(held)
    t_whole = wall_us_per_call(lambda: sep.process(x), 3) / 1e6
    t_blocked = wall_us_per_call(lambda: sep.process_blocked(x), 3) / 1e6
    seconds = TRACK_SAMPLES / OFFLINE_FS
    torch.cuda.reset_peak_memory_stats()
    prof = device_profile(lambda: sep.process(x))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"phase 8 offline track {TRACK_SAMPLES} samples ({seconds:.0f} s): "
        f"process_blocked vs process {held}; process {t_whole:.3f} s wall (mean of 3) = {seconds / t_whole:.1f} s of "
        f"audio per s, peak {peak:.2f} GiB; process_blocked {t_blocked:.3f} s = "
        f"{seconds / t_blocked:.1f} s of audio per s; launches {launches}; "
        f"one process(): {prof} [{smi}]"
    )
    return launches


# ---------------- zen stream --streams 512: the port's CLI ----------------


def zen_stream(argv, data: bytes) -> tuple:
    """The port's CLI run in-process, so that the launch counters see it,
    with stdin and stdout swapped for byte buffers: (stdout bytes,
    stderr lines)."""
    from zen_tpu_torch.cli import main

    saved = sys.stdin, sys.stdout, sys.stderr
    sys.stdin = io.TextIOWrapper(io.BytesIO(data))
    sys.stdout = io.TextIOWrapper(io.BytesIO())
    sys.stderr = io.StringIO()
    try:
        rc = main(argv)
        sys.stdout.flush()
        out, err = sys.stdout.buffer.getvalue(), sys.stderr.getvalue()
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved
    require(rc == 0, f"zen-torch {' '.join(argv)}: exit {rc}: {err[-2000:]}")
    return out, err.splitlines()


def fleet_argv(*extra) -> list:
    return ["stream", "--streams", str(FLEET_STREAMS), "--fs", "44100", "--hop",
            str(FLEET_HOP), "--block-hops", str(FLEET_BLOCK), "--device", DEVICE, *extra]


def interleave(audio: np.ndarray) -> bytes:
    """[C, n] streams -> the pipe's N-channel f32le bytes."""
    return np.ascontiguousarray(audio.T).tobytes()


def deinterleave(out: bytes, c: int) -> np.ndarray:
    return np.frombuffer(out, np.float32).reshape(-1, c).T


def si_snr(ref: np.ndarray, est: np.ndarray) -> float:
    """Scale-invariant SNR of ``est`` against ``ref`` in dB (the repo's
    definition, zen_tpu/io/synth.py:141)."""
    ref, est = ref.astype(np.float64), est.astype(np.float64)
    s_t = np.dot(est, ref) / max(np.dot(ref, ref), 1e-30) * ref
    e = est - s_t
    return float(10 * np.log10(max(np.dot(s_t, s_t), 1e-30) / max(np.dot(e, e), 1e-30)))


def hold_fleet_run(audio: np.ndarray, out: bytes, cfg_kw: dict) -> dict:
    """Every 32nd stream of one `zen stream` run on the card against the
    port's CPU MultiStreamHPR on those streams, at unit gain, under the
    flip rule (the card's masks from all 512 streams)."""
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, HPRConfig

    c, n = audio.shape
    block = FLEET_BLOCK * FLEET_HOP
    n_blocks = -(-n // block)
    padded = np.zeros((c, n_blocks * block), np.float32)  # the CLI's zero tail
    padded[:, :n] = audio
    sizes = [FLEET_BLOCK] * n_blocks
    kw = dict(outputs=OUTPUT_PERCUSSIVE, **cfg_kw)
    cfg = HPRConfig(fs=44100.0, hop=FLEET_HOP, causal=True, **kw)
    held = list(FLEET_HELD)
    got = deinterleave(out, c)[held][:, None]
    require(bool(np.isfinite(got).all()), "non-finite zen stream samples")
    unit = np.float32(1.0 / cfg.synth_scale)
    want = reference_fleet(padded[held], sizes, **kw)[:, :, :n] * unit
    return compare_stream(cfg, padded, sizes, got, want, ("percussive",), held)


def phase_zen_stream(smi: str) -> dict:
    """`zen-torch stream --streams 512` in-process at f32, bf16, --cpu and
    --nocopybord, each held against the CPU on every 32nd stream; the
    bf16 stem against the f32 one by SI-SNR; one real pipe byte-equal to
    the in-process run; one 512 x 16 step's device profile."""
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, MultiStreamHPR
    from zen_tpu_torch.benches.quality import LADDER_FLOORS_DB

    floor = LADDER_FLOORS_DB["bf16_state"]
    c, block = FLEET_STREAMS, FLEET_BLOCK * FLEET_HOP
    audio = fleet_audio(c, 32 * block + 1234, 44100.0)  # ~3.0 s, ragged tail
    short = np.ascontiguousarray(audio[:, : 8 * block + 777])
    data = interleave(audio)
    runs, total = {}, dict.fromkeys(read_launches(), 0)
    for name, flags, kw, x in (
        ("f32", (), {}, audio),
        ("--stream-state bf16", ("--stream-state", "bf16"), {"stream_state": "bf16"}, audio),
        ("--cpu", ("--cpu",), {"border": "replicate"}, short),
        ("--nocopybord", ("--nocopybord",), {"border": "valid"}, short),
    ):
        raw = data if x is audio else interleave(x)
        reset_launches()
        out, err = zen_stream(fleet_argv(*flags), raw)
        counts = read_launches()
        require(all(v > 0 for v in per_kernel(counts).values())
                and counts[f"sliding_median_boundary/{FREQ_CORE}"]
                == counts["sliding_median_boundary/network"],
                f"zen stream {name} launches {counts} (every K2 call of the 512-stream block "
                "takes its shared core)")
        require(len(out) == len(raw), f"zen stream {name}: {len(out)} bytes out of {len(raw)}")
        line = json.loads(err[-1])
        require(line["metric"] == "stream_serving" and err[0].startswith("zen stream ready"),
                f"zen stream {name} stderr: {err}")
        for k in total:
            total[k] += counts[k]
        runs[name] = (x, out, kw, line, counts)
    for name, (x, out, kw, line, counts) in runs.items():
        r = hold_fleet_run(x, out, kw)
        print(
            f"phase 9 zen stream --streams {c} {name}: {x.shape[1]} samples per stream; "
            f"{len(FLEET_HELD)} streams vs CPU: mask flips {r['flips']} ({r['share']:.3g} of "
            f"bins), excluded hops {r['excluded']}/{r['hops']}, max |diff| at unit gain "
            f"{r['rel_err']:.3g} (limit {STEM_ATOL}); samples_per_s {line['samples_per_s']}, "
            f"us_per_hop {line['us_per_hop']}, warmup_s {line['warmup_s']}, first_block_s "
            f"{line['first_block_s']}, hops {line['hops_per_stream']}; launches {counts} [{smi}]"
        )
    # The run's percussive stem (all streams as one signal) against the
    # f32 run's. The ladder's floor is per mixture of the quality corpus;
    # on two of this fleet's pure tones zen_tpu's own bf16 state falls
    # below it (on the CPU, over all 512 streams: stream 2 at 123.75 Hz
    # 20.03 dB, stream 32 at 330 Hz 23.79 dB, the port within 0.12 dB of
    # zen_tpu on every stream), so it is held on the pooled stem and the
    # per-stream spread is printed.
    f32 = deinterleave(runs["f32"][1], c)
    b16 = deinterleave(runs["--stream-state bf16"][1], c)
    pooled = si_snr(f32.ravel(), b16.ravel())
    per = np.array([si_snr(f32[i], b16[i]) for i in range(c)])
    require(bool(np.isfinite(b16).all()) and pooled > floor,
            f"bf16 vs f32 percussive SI-SNR {pooled:.2f} dB <= {floor}")
    worst = ", ".join(f"{i}: {per[i]:.2f}" for i in np.argsort(per)[:4])
    print(f"phase 9 bf16 vs f32 percussive stem, {c} streams: SI-SNR {pooled:.2f} dB "
          f"(floor {floor}); per stream median {np.median(per):.2f} dB, "
          f"{int((per < floor).sum())} below the floor, worst (stream: dB) {worst}")

    four = data[: 4 * block * c * 4]  # four blocks of every stream
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "zen_tpu_torch", *fleet_argv()], input=four,
                          capture_output=True, cwd=ROOT, timeout=300)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"zen stream pipe: exit {proc.returncode}: "
            f"{proc.stderr.decode()[-2000:]}")
    require(proc.stdout == runs["f32"][1][: len(four)],
            "the pipe's stdout differs from the in-process run on the same input")
    line = json.loads(proc.stderr.decode().splitlines()[-1])
    print(f"phase 9 real pipe python -m zen_tpu_torch stream --streams {c}, 4 blocks: "
          f"stdout byte-equal to the in-process run; process {wall:.2f} s, "
          f"stream_serving samples_per_s {line['samples_per_s']}, warmup_s {line['warmup_s']}")

    step = torch.from_numpy(audio[:, :block].reshape(c, FLEET_BLOCK, FLEET_HOP)).to(DEVICE)
    for kw in ({}, {"stream_state": "bf16"}):
        ms = MultiStreamHPR(c, 44100.0, FLEET_HOP, outputs=OUTPUT_PERCUSSIVE, device=DEVICE, **kw)
        ms.warmup((FLEET_BLOCK,))
        step_us = wall_us_per_call(lambda: ms.process_block(step), TIMED_RUNS)
        print(f"phase 9 MultiStreamHPR {c} x B={FLEET_BLOCK} step {kw or 'f32'}: {step_us:.1f} us wall "
              f"(mean of {TIMED_RUNS}) = {c * block / step_us:.2f} Msamples/s; one step: "
              f"{device_profile(lambda: ms.process_block(step))} [{smi}]")
    return total


def phase_hop32(smi: str) -> dict:
    """HPRRealtime(44100, hop=32), the low-latency stream (0.73 ms per
    hop): K1's warp route carries its time median (K = 93 over 183
    history rows; a warp an output). 64 blocks of B=32, then 64 single
    hops, held against the CPU port under phase 4's flip rule and stem
    tolerance."""
    reset_launches()
    cfg, got, audio, sizes, t = run_stream(hop=32)
    launches = read_launches()
    require(launches["tap_median_time/warp"] > 0 and launches["tap_median_time/rank"] == 0
            and launches["tap_median_time/select"] == 0
            and launches[f"sliding_median_boundary/{FREQ_CORE}"] == 0
            and all(per_kernel(launches).values()),
            f"hop-32 stream launches {launches} (K1's K = 93 takes the warp route at B = 32 and "
            "B = 1, K2's K = 1 the per-output network)")
    require(bool(np.isfinite(got).all()), "non-finite hop-32 stem samples")
    r = compare_stream(cfg, audio, sizes, got, reference_stream(audio, sizes, hop=32),
                       ("harmonic", "percussive", "residual"))
    print(
        f"phase 10 HPRRealtime fs 44100 hop 32 (time K={len(cfg.time_offsets)} over "
        f"H={cfg.time_history}, frequency K={cfg.freq_filter_len}), 64 x B=32 + 64 x B=1: "
        f"mask flips {r['flips']} ({r['share']:.3g} of bins), excluded hops "
        f"{r['excluded']}/{r['hops']}, max |diff|/scale {r['rel_err']:.3g} (limit "
        f"{STEM_ATOL}); {t['step_us']:.1f} us/step at B=32 ({32 * cfg.hop / cfg.fs * 1e3:.2f} "
        f"ms of audio); {t['hop_us']:.1f} us/hop at B=1 ({cfg.hop / cfg.fs * 1e3:.3f} ms); "
        f"one B=32 step: {t['prof_b']}; one B=1 step: {t['prof_1']}; launches {launches} "
        f"[{smi}]"
    )
    return launches


def phase_hop64(smi: str) -> dict:
    """Hop 64 at 44.1 kHz (1.451 ms a hop): K1's network carries its time
    median (K = 47 over 91 history rows, the causal wrap). HPRRealtime, 64
    blocks of B=32 then 64 single hops, and MultiStreamHPR, 64 streams,
    16 blocks of B=32, each held against the CPU port under phase 4's flip
    rule and stem tolerance."""
    from zen_tpu_torch.ops import median_cuda as mc

    reset_launches()
    cfg, got, audio, sizes, t = run_stream(hop=64)
    cfgm, gotm, audiom, sizesm, tm = run_fleet(hop=64)
    launches = read_launches()
    k = len(cfg.time_offsets)
    require(k == len(cfgm.time_offsets) == 47 and mc.time_route(cfg.time_offsets) == "register",
            f"hop-64 time median K={k} route {mc.time_route(cfg.time_offsets)}")
    require(launches["tap_median_time/register"] > 0 and launches["tap_median_time/rank"] == 0
            and all(per_kernel(launches).values()), f"hop-64 launches {launches}")
    for arr in (got, gotm):
        require(bool(np.isfinite(arr).all()), "non-finite hop-64 stem samples")
    stems = ("harmonic", "percussive", "residual")
    r = compare_stream(cfg, audio, sizes, got, reference_stream(audio, sizes, hop=64), stems)
    rm = compare_stream(cfgm, audiom, sizesm, gotm, reference_fleet(audiom, sizesm, hop=64),
                        stems)
    hop_us = cfg.hop / cfg.fs * 1e6
    print(
        f"phase 10b HPRRealtime fs 44100 hop 64 (time K={k} over H={cfg.time_history}, "
        f"frequency K={cfg.freq_filter_len}), 64 x B=32 + 64 x B=1: mask flips {r['flips']} "
        f"({r['share']:.3g} of bins), excluded hops {r['excluded']}/{r['hops']}, max "
        f"|diff|/scale {r['rel_err']:.3g} (limit {STEM_ATOL}); {t['step_us']:.1f} us/step at "
        f"B=32 = {t['step_us'] / 32:.1f} us/hop against {hop_us:.0f} us of audio a hop; "
        f"{t['hop_us']:.1f} us/hop at B=1; one B=32 step: {t['prof_b']}; one B=1 step: "
        f"{t['prof_1']} [{smi}]"
    )
    print(
        f"phase 10b MultiStreamHPR 64 x fs 44100 hop 64, 16 x B=32: mask flips {rm['flips']} "
        f"({rm['share']:.3g} of bins), excluded hops {rm['excluded']}/{rm['hops']}, max "
        f"|diff|/scale {rm['rel_err']:.3g}; {tm['step_us']:.1f} us/step = "
        f"{tm['step_us'] / 32:.1f} us/hop for 64 streams against {hop_us:.0f} us = "
        f"{tm['msps']:.2f} Msamples/s; one step: {tm['prof_b']}; launches {launches} [{smi}]"
    )
    return launches


def phase_hop1(smi: str) -> dict:
    """HPRRealtime(384000, hop=1), a hop of 2.6 us: its time median is K =
    25,601 taps over 51,199 history rows, and one output row's keys pass a
    block's shared memory, so K1 takes the select route (a block an output
    row: 3 at B=1, 96 at B=32). 64 blocks of B=32, then 64 single hops,
    held against the CPU port under phase 4's flip rule and stem
    tolerance; then the device and wall time per hop of a B=32 step and
    of a single hop."""
    from zen_tpu_torch import HPRRealtime

    fs = 384000.0
    reset_launches()
    cfg, got, audio, sizes, t = run_stream(fs=fs, hop=1)
    launches = read_launches()
    k = len(cfg.time_offsets)
    require(k == 25_601 and launches["tap_median_time/select"] > 0
            and launches["tap_median_time/rank"] == 0 and all(per_kernel(launches).values()),
            f"384 kHz hop 1 time median K={k} not on the select route: launches {launches}")
    require(bool(np.isfinite(got).all()), "non-finite hop-1 stem samples")
    r = compare_stream(cfg, audio, sizes, got, reference_stream(audio, sizes, hop=1, fs=fs),
                       ("harmonic", "percussive", "residual"))
    rt = HPRRealtime(fs, hop=1, device=DEVICE)
    steps = torch.from_numpy(audio[0, :32]).to(DEVICE).reshape(32, 1)
    rt.warmup((32, 1))
    dev_b, dev_1 = step_device_us(rt, steps) / 32, step_device_us(rt, steps[:1])
    hop_us = cfg.hop / cfg.fs * 1e6
    print(
        f"phase 10c HPRRealtime fs 384000 hop 1 (time K={k} over H={cfg.time_history} on the "
        f"select route, frequency K={cfg.freq_filter_len}), 64 x B=32 + 64 x B=1: mask flips "
        f"{r['flips']} ({r['share']:.3g} of bins), excluded hops {r['excluded']}/{r['hops']}, "
        f"max |diff|/scale {r['rel_err']:.3g} (limit {STEM_ATOL}); a hop is {hop_us:.2f} us of "
        f"audio: B=32 step {dev_b:.2f} us device and {t['step_us'] / 32:.2f} us wall a hop; "
        f"B=1 {dev_1:.2f} us device and {t['hop_us']:.2f} us wall a hop; one B=32 step: "
        f"{t['prof_b']}; one B=1 step: {t['prof_1']}; launches {launches} [{smi}]"
    )
    return launches


def phase_hbm_pattern(smi: str) -> dict:
    """benches/hbm_pattern at 512 streams, in-process: every stage beside
    its copy mirror, the derived compute shares, and the launches of the
    run (the mirrors' only path). The instrument raises on a ceiling_big
    reading above 105% of the card's device-memory rate."""
    from zen_tpu_torch.benches import hbm_pattern, write_artifact
    from zen_tpu_torch.ops import median_cuda as mc

    reset_launches()
    result = hbm_pattern.measure(hbm_pattern.parse(["--device", DEVICE]),
                                 log=lambda line: print(f"phase 11 hbm_pattern {line}"))
    torch.cuda.synchronize()
    counts = {**read_launches(), **read_probe_launches()}
    stages = result["stages"]
    require(all(math.isfinite(st["us_per_step"]) and st["us_per_step"] > 0
                for st in stages.values()), f"hbm_pattern stage times {stages}")
    require(all(counts[f"{name}/copy"] > 0 for name in PROBES)
            and counts["tap_median_time/register"] > 0
            and counts[f"sliding_median_boundary/{mc.freq_route(13)}"] > 0,
            f"hbm_pattern launches {counts}")
    path = write_artifact(result, None, "hbm_pattern.json")
    print(f"phase 11 hbm_pattern {result['config']['streams']} streams: {len(stages)} stages; "
          f"launches {counts}; artifact {path.relative_to(ROOT)} [{smi}]")
    return counts


def phase_serving_bound(smi: str) -> dict:
    """benches/serving_bound in-process at 64, 256 and 512 streams (f32)
    and 512 (bf16 stream state): each leg's device and wall time."""
    from zen_tpu_torch.benches import serving_bound, write_artifact
    from zen_tpu_torch.ops import median_cuda as mc

    reset_launches()
    for streams, state in (("64,256,512", "f32"), ("512", "bf16")):
        args = serving_bound.parse(["--device", DEVICE, "--streams", streams,
                                    "--stream-state", state])
        result = serving_bound.measure(
            args, log=lambda line: print(f"phase 12 serving_bound {line}"))
        for table in ("legs_us_per_step", "legs_wall_us_per_step"):
            for s_count, legs in result[table].items():
                require(all(math.isfinite(v) for v in legs.values())
                        and all(legs[k] > 0 for k in ("full", "transform", "median")),
                        f"serving_bound {state} S={s_count} {table}: {legs}")
        path = write_artifact(result, None, f"serving_bound_{state}.json")
        print(f"phase 12 serving_bound {state} streams {streams}: artifact "
              f"{path.relative_to(ROOT)} [{smi}]")
    counts = read_launches()
    require(counts["tap_median_time/register"] > 0
            and counts[f"sliding_median_boundary/{mc.freq_route(13)}"] > 0,
            f"serving_bound launches {counts}")
    return counts


# ---------------- SSE, the box mean, the DFT transform, quality ----------------


def rel_err(got: np.ndarray, want: np.ndarray, atol: float, what: str) -> float:
    """Largest max |diff| / max(1, max |want|) over the rows of [..., L]
    arrays, every sample held; raises above ``atol`` (unless it is None)
    or on a non-finite sample of ``got``."""
    got, want = np.asarray(got), np.asarray(want)
    require(got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}")
    require(bool(np.isfinite(got).all()), f"{what}: non-finite samples")
    worst = 0.0
    for g, w in zip(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])):
        worst = max(worst, float(np.abs(g - w).max(initial=0.0)) / max(1.0, float(np.abs(w).max())))
    require(atol is None or worst <= atol, f"{what}: max |diff|/scale {worst:.3g} > {atol}")
    return worst


def step_device_us(ms, step) -> float:
    """The card's µs per process_block(step) (runtime.profiling.device_ms,
    which raises when the call synchronizes the host)."""
    from zen_tpu_torch.runtime.profiling import device_ms

    return device_ms(lambda _: ms.process_block(step), step, iters=10, repeats=3) * 1e3


def phase_sse(smi: str) -> dict:
    """The SSE variant through its entry points at full width, each held
    against the port's CPU run at SSE_ATOL x scale on every sample:
    HPRRealtime hop 1024 (64 x B=32, 64 x B=1), MultiStreamHPR 64 x hop
    256 (16 x B=32, float32 and bf16 state), HPRIOffline on the clip
    (process and process_blocked) and `zen-torch stream --streams 512
    --sse` on ~1 s per stream. The box means replace both medians: the
    phase launches no median kernel."""
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, HPRConfig, HPRIOffline, MultiStreamHPR

    reset_launches()
    cfg1, got1, audio1, sizes1, t1 = run_stream(use_sse=True)
    e1 = rel_err(got1, reference_stream(audio1, sizes1, use_sse=True), SSE_ATOL,
                 "SSE hop-1024 stream")
    print(f"phase 13 SSE HPRRealtime fs 44100 hop 1024, 64 x B=32 + 64 x B=1: max |diff|/scale "
          f"{e1:.3g} vs CPU (limit {SSE_ATOL}), finite from the first hop; {t1['step_us']:.1f} "
          f"us/step wall at B=32, {t1['hop_us']:.1f} us/hop at B=1; one B=32 step: "
          f"{t1['prof_b']}; one B=1 step: {t1['prof_1']} [{smi}]")
    for kw in ({}, {"stream_state": "bf16"}):
        cfgm, gotm, audiom, sizesm, tm = run_fleet(use_sse=True, **kw)
        em = rel_err(gotm, reference_fleet(audiom, sizesm, use_sse=True, **kw), SSE_ATOL,
                     f"SSE fleet {kw}")
        c = audiom.shape[0]
        ms = MultiStreamHPR(c, 44100.0, 256, use_sse=True, device=DEVICE, **kw)
        step = torch.from_numpy(audiom[:, : 32 * 256].reshape(c, 32, 256)).to(DEVICE)
        print(f"phase 13 SSE MultiStreamHPR {c} x fs 44100 hop 256 {kw or 'f32'}, 16 x B=32: "
              f"max |diff|/scale {em:.3g} vs CPU (limit {SSE_ATOL}); {tm['step_us']:.1f} us/step "
              f"wall = {tm['msps']:.2f} Msamples/s, {step_device_us(ms, step):.1f} us/step device; "
              f"one step: {tm['prof_b']} [{smi}]")

    sep = HPRIOffline(OFFLINE_FS, 4096, 256, 2.5, 2.5, use_sse=True, device=DEVICE)
    x = torch.from_numpy(synthetic_mix(CLIP_SAMPLES, OFFLINE_FS, seed=7)).to(DEVICE)
    whole, blocked = sep.process(x), sep.process_blocked(x)
    cpu = HPRIOffline(OFFLINE_FS, 4096, 256, 2.5, 2.5, use_sse=True, device="cpu")
    host = [o.cpu().numpy() for o in whole]
    ec = rel_err(host, [o.numpy() for o in cpu.process(x.cpu())], SSE_ATOL, "SSE clip")
    eb = rel_err([o.cpu().numpy() for o in blocked], host, SSE_ATOL, "SSE clip blocked")
    same = all(torch.equal(a, b) for a, b in zip(whole, blocked))
    wall = wall_us_per_call(lambda: sep.process(x), 10) / 1e3
    wall_b = wall_us_per_call(lambda: sep.process_blocked(x), 10) / 1e3
    print(f"phase 13 SSE HPRIOffline(44100, 4096, 256, 2.5, 2.5) clip {CLIP_SAMPLES} samples: "
          f"process vs CPU max |diff|/scale {ec:.3g} (limit {SSE_ATOL}); process_blocked vs "
          f"process {'bitwise equal' if same else f'{eb:.3g}'}; process {wall:.2f} ms wall, "
          f"process_blocked {wall_b:.2f} ms (means of 10); one process(): "
          f"{device_profile(lambda: sep.process(x))} [{smi}]")

    c, block = FLEET_STREAMS, FLEET_BLOCK * FLEET_HOP
    audio = fleet_audio(c, 10 * block + 321, 44100.0)  # ~0.94 s, ragged tail
    out, err = zen_stream(fleet_argv("--sse"), interleave(audio))
    line = json.loads(err[-1])
    n = audio.shape[1]
    n_blocks = -(-n // block)
    padded = np.zeros((c, n_blocks * block), np.float32)
    padded[:, :n] = audio
    held = list(FLEET_HELD)
    kw = dict(outputs=OUTPUT_PERCUSSIVE, use_sse=True)
    unit = np.float32(1.0 / HPRConfig(fs=44100.0, hop=FLEET_HOP, causal=True, **kw).synth_scale)
    want = reference_fleet(padded[held], [FLEET_BLOCK] * n_blocks, **kw)[:, 0, :n] * unit
    ez = rel_err(deinterleave(out, c)[held], want, SSE_ATOL, "SSE zen stream")
    launches = read_launches()
    require(not any(launches.values()), f"the SSE paths launched median kernels: {launches}")
    print(f"phase 13 SSE zen stream --streams {c} --sse: {n} samples per stream; "
          f"{len(held)} streams vs CPU at unit gain: max |diff|/scale {ez:.3g} (limit "
          f"{SSE_ATOL}); samples_per_s {line['samples_per_s']}, us_per_hop {line['us_per_hop']}; "
          f"median launches over every SSE run {launches} [{smi}]")
    return launches


def phase_box(smi: str) -> None:
    """The box mean alone at the SSE paths' shapes: the card bitwise
    equal to the CPU, infs included, with its device time beside the
    bound (each input element read and each output written once at
    HBM_BYTES_PER_S; two adds and a division per output, a running
    window, at F32_OPS_PER_S)."""
    from zen_tpu_torch.ops.box import sliding_mean

    rng = np.random.default_rng(9)
    inf = float("inf")

    def feat(*shape, inf_rows=0):
        x = 1.0 / np.square(rng.random(shape, dtype=np.float32) + np.float32(1e-3))
        x[..., :inf_rows, :] = np.inf  # the prefill of a fresh stream
        return torch.from_numpy(x.astype(np.float32))

    for label, x, offs, dim, boundary, fill in (
        ("[32, 2049] K=47 reflect (hop 1024 frequency)", feat(32, 2049),
         tuple(range(-23, 24)), -1, "reflect", 0.0),
        ("[2048, 513] K=13 reflect (64 x B=32 hop 256 frequency)", feat(2048, 513),
         tuple(range(-6, 7)), -1, "reflect", 0.0),
        ("[64, 21+32, 513] hop 256 time taps over [hist ++ fresh], +inf prefill",
         feat(64, 53, 513, inf_rows=21), T256, -2, "zero", inf),
        ("[1, 5+32, 2049] hop 1024 time taps K=3, +inf prefill", feat(1, 37, 2049, inf_rows=5),
         (-5, -1, 0), -2, "zero", inf),
    ):
        xd = x.to(DEVICE)
        run = lambda xd=xd, o=offs, d=dim, b=boundary, f=fill: sliding_mean(xd, o, d, b, f)  # noqa: E731
        got, want = run().cpu(), sliding_mean(x, offs, dim, boundary, fill)
        require(torch.equal(torch.isinf(got), torch.isinf(want)) and torch.equal(got, want),
                f"box mean {label}: card differs from CPU")
        us = median_us(run)
        t_bytes = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e6
        t_ops = 3 * x.numel() / F32_OPS_PER_S * 1e6
        b_us, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"phase 14 box mean {label}: card bitwise equal to CPU ({int(torch.isinf(got).sum())} "
              f"inf outputs); {us:.2f} us device (median of {TIMED_RUNS}), bound {b_us:.2f} us "
              f"({b_by}) [{smi}]")


def transform_rows(mode: str, rows: int, nwin: int) -> dict:
    """One DFT mode's forward and inverse at [rows, nwin] beside
    torch.fft's: device µs, bound µs, relative error against a float64
    DFT of the same inputs."""
    from zen_tpu_torch.ops import fft as zfft

    nfft, bins = 2 * nwin, nwin + 1
    rng = np.random.default_rng(rows + nwin)
    x64 = rng.standard_normal((rows, nwin))
    s64 = np.fft.rfft(x64, n=nfft)
    p64 = np.concatenate([s64.real, s64.imag], axis=-1)
    y64 = np.fft.irfft(s64, n=nfft)[:, :nwin]
    x = torch.from_numpy(x64.astype(np.float32)).to(DEVICE)
    p = torch.from_numpy(p64.astype(np.float32)).to(DEVICE)
    s = torch.complex(p[:, :bins], p[:, bins:])

    def err(got, ref):
        return float(np.abs(got.cpu().double().numpy() - ref).max() / np.abs(ref).max())

    fwd = lambda: zfft.dft_matmul(x, nwin, nfft, False, mode)  # noqa: E731
    inv = lambda: zfft.dft_matmul(p, nwin, nfft, True, mode)  # noqa: E731
    out = {"fwd_us": median_us(fwd), "inv_us": median_us(inv),
           "fwd_err": err(fwd(), p64), "inv_err": err(inv(), y64)}
    flops = 2.0 * rows * nwin * 2 * bins
    item = {"dft_f32": 4, "dft": 4, "dft_bf16": 2}[mode]  # the matrix: float32, hi + lo, bf16
    for leg, n_in, n_out in (("fwd", nwin, 2 * bins), ("inv", 2 * bins, nwin)):
        t_bytes = (rows * (n_in + n_out) * 4 + n_in * n_out * item) / HBM_BYTES_PER_S * 1e6
        t_ops = flops / DFT_RATE[mode] * 1e6
        out[f"{leg}_bound"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    rf = lambda: torch.fft.rfft(x, n=nfft)  # noqa: E731
    ir = lambda: torch.fft.irfft(s, n=nfft)[:, :nwin]  # noqa: E731
    out.update(rfft_us=median_us(rf), irfft_us=median_us(ir),
               rfft_err=err(torch.cat([rf().real, rf().imag], -1), p64), irfft_err=err(ir(), y64))
    return out


@contextlib.contextmanager
def entry_masks(keep=None):
    """The hard masks (harmonic, percussive) that the streaming entry
    points compute inside the block, one [2, C, B, bins] host tensor per
    step, of the streams ``keep`` only when given: drivers.realtime's
    step_masks, which block_step calls, wrapped to keep its result's
    masks. The flip rule then reads the masks of the very run it holds,
    not those of a second run."""
    from zen_tpu_torch.drivers import realtime as rt

    inner, seen = rt.step_masks, []

    def recorded(cfg, state, blocks):
        step = inner(cfg, state, blocks)
        m = torch.stack(step.masks[:2])
        seen.append((m if keep is None else m[:, keep]).cpu())
        return step

    rt.step_masks = recorded
    try:
        yield seen
    finally:
        rt.step_masks = inner


def fleet_entry(audio: np.ndarray, sizes, device, keep=None, **cfg_kw) -> tuple:
    """MultiStreamHPR.process_block over the streams audio [C, N*hop] at
    44.1 kHz, hop 256, block by block on ``device``: (outputs [C', E,
    N*hop] as a host array, the masks of that run [2, C', N, bins], the
    fleet), C' the streams ``keep`` (all when None)."""
    from zen_tpu_torch import MultiStreamHPR

    c = audio.shape[0]
    ms = MultiStreamHPR(c, 44100.0, FLEET_HOP, device=device, **cfg_kw)
    x = torch.from_numpy(audio).reshape(c, -1, FLEET_HOP)
    sel = slice(None) if keep is None else list(keep)
    outs, t = [], 0
    with entry_masks(sel) as seen:
        for b in sizes:
            outs.append(ms.process_block(x[:, t : t + b].to(device))[sel].cpu())
            t += b
    return torch.cat(outs, dim=2).numpy(), torch.cat(seen, dim=2), ms


def realtime_entry(audio: np.ndarray, sizes, device, hop=1024, **cfg_kw) -> tuple:
    """HPRRealtime over the stream audio [1, N*hop] at 44.1 kHz on
    ``device``: process_block for a block of B > 1 hops, process_next_hop
    for one. (outputs [1, 3, N*hop] as a host array, the masks of that run
    [2, 1, N, bins], the stream)."""
    from zen_tpu_torch import HPRRealtime

    rt = HPRRealtime(44100.0, hop, device=device, **cfg_kw)
    x = torch.from_numpy(audio[0]).reshape(-1, hop)
    outs, t = [], 0
    with entry_masks() as seen:
        for b in sizes:
            blk = x[t : t + b].to(device)
            outs.append((rt.process_block(blk) if b > 1 else rt.process_next_hop(blk[0])).cpu())
            t += b
    return torch.cat(outs, dim=1).numpy()[None], torch.cat(seen, dim=2), rt


def gemm_invariance(mode: str, device) -> dict:
    """Whether one DFT mode's product of a row depends on more than the
    row, at the 64-stream step's shapes (forward [2048, 512], inverse
    [6144, 1026]): the rows whose bits differ from the whole batch's
    when the same rows run again from a fresh buffer (rerun), from a
    buffer 4 bytes off its allocation (offset), the first m rows alone
    (rows_m), and on the CPU on one thread (threads_1)."""
    from zen_tpu_torch.ops import fft as zfft

    rng = np.random.default_rng(5)
    out = {}
    for leg, rows, k, inverse in (("fwd", 2048, 512, False), ("inv", 6144, 1026, True)):
        x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).to(device)
        run = functools.partial(zfft.dft_matmul, nwin=512, nfft=1024, inverse=inverse, mode=mode)
        ref = run(x)

        def differ(got):
            return int((got != ref[: got.shape[0]]).any(dim=1).sum())

        shifted = torch.empty(rows * k + 1, device=device)[1:].view(rows, k)
        shifted.copy_(x)
        cases = {"rerun": differ(run(x.clone())), "offset": differ(run(shifted))}
        for m in (1, 32, 512):
            cases[f"rows_{m}"] = differ(run(x[:m].clone()))
        if torch.device(device).type == "cpu":
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            cases["threads_1"] = differ(run(x))
            torch.set_num_threads(n)
        out[leg] = cases
    return out


def phase_dft(smi: str) -> dict:
    """The DFT transform at full width, each mode, through the entry
    points: MultiStreamHPR at 64 streams, hop 256 (8 x B=32) and 512 x
    B=16 (8 blocks, every 32nd stream held), HPRRealtime at hop 1024 (16
    x B=32 + 16 x B=1), each held against the port's CPU run of the same
    entry point and mode under the flip rule, on the masks of the two
    runs held (entry_masks), and against torch.fft on the card at the
    mode's class; whether a second run, or a recount of the masks as
    phases 4, 5, 9 and 10 make it, gives the same bits, and whether a
    row's product depends on its batch (gemm_invariance); the clip
    through HPRIOffline with 'dft' pass by pass against the CPU. Then the
    transform alone beside torch.fft and the 512-stream step's device
    time per mode. Returns the median launches of the paths."""
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, HPRConfig, HPRIOffline, MultiStreamHPR

    stems = ("harmonic", "percussive", "residual")
    totals = {}
    c, b, hop = FLEET_STREAMS, FLEET_BLOCK, FLEET_HOP
    fleet, sizes = fleet_audio(64, 8 * 32 * hop, 44100.0), [32] * 8
    kept = list(range(0, 64, 4))  # the 64-stream fleet's streams held against the CPU
    audio512, held = fleet_audio(c, 8 * b * hop, 44100.0), list(FLEET_HELD)
    audio1, sizes1 = synthetic_mix(528 * 1024, 44100.0, seed=1)[None], [32] * 16 + [1] * 16

    # torch.fft's runs on the card are the yardstick of every mode
    fft_hard = fleet_entry(fleet, sizes, DEVICE)
    fft_soft = fleet_entry(fleet, sizes, DEVICE, soft_mask=True)[0]
    for mode in DFT_CLASS:
        reset_launches()
        got, m_gpu, ms = fleet_entry(fleet, sizes, DEVICE, fft_impl=mode)
        want, m_cpu, _ = fleet_entry(fleet[kept], sizes, "cpu", fft_impl=mode)
        rm = hold_masks(m_gpu[:, kept], m_cpu, hop, got[kept], want, stems, DFT_CPU_ATOL[mode])
        again, m_again, _ = fleet_entry(fleet, sizes, DEVICE, fft_impl=mode)
        rerun = "bitwise equal" if np.array_equal(again, got) and torch.equal(m_again, m_gpu) \
            else f"differs by {rel_err(again, got, None, 'rerun'):.3g}"
        cfgm = HPRConfig(fs=44100.0, hop=hop, causal=True, fft_impl=mode)
        recount = (int((stream_masks(cfgm, fleet, sizes, DEVICE) != m_gpu).sum()),
                   int((stream_masks(cfgm, fleet[kept], sizes, "cpu") != m_cpu).sum()))
        inv = {"card": gemm_invariance(mode, DEVICE), "CPU": gemm_invariance(mode, "cpu")}
        # against torch.fft at the mode's class: hard masks under the flip
        # rule (bf16 operands flip bins near the noise floor), soft masks
        # on every sample
        ef = hold_masks(m_gpu, fft_hard[1], hop, got, fft_hard[0], stems,
                        atol=DFT_CLASS[mode], flip_share=None)
        e_all = rel_err(got, fft_hard[0], None, f"{mode} fleet vs torch.fft")
        soft = fleet_entry(fleet, sizes, DEVICE, fft_impl=mode, soft_mask=True)[0]
        e_soft = rel_err(soft, fft_soft, DFT_CLASS[mode], f"{mode} soft-mask fleet vs torch.fft")
        step = torch.from_numpy(fleet[:, : 32 * hop].reshape(64, 32, hop)).to(DEVICE)
        print(f"phase 15 {mode} MultiStreamHPR 64 x hop 256, 8 x B=32: {len(kept)} streams vs "
              f"CPU {mode}: flips {rm['flips']} ({rm['share']:.3g}), max |diff|/scale "
              f"{rm['rel_err']:.3g} (limit {DFT_CPU_ATOL[mode]:.3g}); vs torch.fft on the card "
              f"(class {DFT_CLASS[mode]}): hard masks {ef['flips']} bins flipped "
              f"({ef['share']:.3g}), excluded hops {ef['excluded']}/{ef['hops']}, max "
              f"|diff|/scale {ef['rel_err']:.3g} on the rest, {e_all:.3g} over every hop; soft "
              f"masks {e_soft:.3g} over every hop; "
              f"{wall_us_per_call(lambda: ms.process_block(step), TIMED_RUNS):.1f} us/step wall "
              f"[{smi}]")
        print(f"phase 15 {mode} reproducibility: a second run on the card {rerun}; a recount of "
              f"the masks (stream_masks) differs from the run's own in {recount[0]} bins on the "
              f"card, {recount[1]} on the CPU; rows whose product differs from the batch's: "
              + "; ".join(f"{dev} {leg} {cases}" for dev, legs in inv.items()
                          for leg, cases in legs.items()) + f" [{smi}]")

        got, m_gpu, _ = fleet_entry(audio512, [b] * 8, DEVICE, held,
                                    outputs=OUTPUT_PERCUSSIVE, fft_impl=mode)
        want, m_cpu, _ = fleet_entry(audio512[held], [b] * 8, "cpu",
                                     outputs=OUTPUT_PERCUSSIVE, fft_impl=mode)
        r512 = hold_masks(m_gpu, m_cpu, hop, got, want, ("percussive",), DFT_CPU_ATOL[mode])
        print(f"phase 15 {mode} MultiStreamHPR {c} x B={b}, 8 blocks: {len(held)} streams vs "
              f"CPU {mode}: flips {r512['flips']} ({r512['share']:.3g}), max |diff|/scale "
              f"{r512['rel_err']:.3g} (limit {DFT_CPU_ATOL[mode]:.3g}) [{smi}]")

        got1, m1, rt1 = realtime_entry(audio1, sizes1, DEVICE, fft_impl=mode)
        want1, mc1, _ = realtime_entry(audio1, sizes1, "cpu", fft_impl=mode)
        r1 = hold_masks(m1, mc1, 1024, got1, want1, stems, DFT_CPU_ATOL[mode])
        blk = torch.from_numpy(audio1[0, : 32 * 1024].reshape(32, 1024)).to(DEVICE)
        print(f"phase 15 {mode} HPRRealtime hop 1024, 16 x B=32 + 16 x B=1: vs CPU {mode}: "
              f"flips {r1['flips']} ({r1['share']:.3g}), max |diff|/scale {r1['rel_err']:.3g} "
              f"(limit {DFT_CPU_ATOL[mode]:.3g}); "
              f"{wall_us_per_call(lambda: rt1.process_block(blk), TIMED_RUNS):.1f} us/step wall at "
              f"B=32, {wall_us_per_call(lambda: rt1.process_next_hop(blk[0]), 200):.1f} us/hop at "
              f"B=1; one B=32 step: {device_profile(lambda: rt1.process_block(blk))} [{smi}]")
        counts = read_launches()
        require(all(v > 0 for v in per_kernel(counts).values()), f"{mode} paths launches {counts}")
        print(f"phase 15 {mode} streaming paths' median launches: {counts}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    reset_launches()
    sep = HPRIOffline(OFFLINE_FS, 4096, 256, 2.5, 2.5, fft_impl="dft", device=DEVICE)
    x = torch.from_numpy(synthetic_mix(CLIP_SAMPLES, OFFLINE_FS, seed=7)).to(DEVICE)
    h, p, r = sep.process(x)
    counts = read_launches()
    require(all(v > 0 for v in per_kernel(counts).values()), f"dft clip launches {counts}")
    pass1, st1 = hold_pass_on_cpu(sep.cfg_h, x)
    pass2, st2 = hold_pass_on_cpu(sep.cfg_p, pass1["percussive"] + pass1["residual"])
    require(torch.equal(h, pass1["harmonic"]) and torch.equal(p, pass2["percussive"]),
            "dft process() differs from its two passes on the card")
    wall = wall_us_per_call(lambda: sep.process(x), 10) / 1e3
    print(f"phase 15 dft HPRIOffline clip: pass 1 flips {st1['flips']} ({st1['share']:.3g}), max "
          f"|diff|/scale {st1['rel_err']:.3g}; pass 2 flips {st2['flips']} ({st2['share']:.3g}), "
          f"{st2['rel_err']:.3g} (limit {STEM_ATOL}); process {wall:.2f} ms wall (mean of 10); "
          f"launches {counts} [{smi}]")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v

    for rows, nwin, what in ((8192, 512, "512 x B=16 hop 256"), (32, 2048, "B=32 hop 1024")):
        for mode in DFT_CLASS:
            t = transform_rows(mode, rows, nwin)
            print(f"phase 15 transform [{rows}, {nwin}] -> {nwin + 1} bins ({what}) {mode}: "
                  f"forward {t['fwd_us']:.2f} us (bound {t['fwd_bound'][0]:.2f}, "
                  f"{t['fwd_bound'][1]}; rel err {t['fwd_err']:.3g}) vs rfft {t['rfft_us']:.2f} us "
                  f"({t['rfft_err']:.3g}); inverse {t['inv_us']:.2f} us (bound "
                  f"{t['inv_bound'][0]:.2f}, {t['inv_bound'][1]}; {t['inv_err']:.3g}) vs irfft "
                  f"{t['irfft_us']:.2f} us ({t['irfft_err']:.3g}) (medians of {TIMED_RUNS}) [{smi}]")
    step = torch.from_numpy(fleet_audio(FLEET_STREAMS, FLEET_BLOCK * FLEET_HOP, 44100.0)
                            .reshape(FLEET_STREAMS, FLEET_BLOCK, FLEET_HOP)).to(DEVICE)
    times = {}
    for impl in ("torch",) + tuple(DFT_CLASS):
        ms = MultiStreamHPR(FLEET_STREAMS, 44100.0, FLEET_HOP, outputs=OUTPUT_PERCUSSIVE,
                            fft_impl=impl, device=DEVICE)
        ms.warmup((FLEET_BLOCK,))
        times[impl] = step_device_us(ms, step)
    print(f"phase 15 MultiStreamHPR {FLEET_STREAMS} x B={FLEET_BLOCK} step device time: "
          + ", ".join(f"{k} {v:.1f} us" for k, v in times.items()) + f" [{smi}]")
    return totals


def phase_quality(smi: str) -> dict:
    """benches/quality on the card: the SSE offline row on the 2 s hard
    mixture at fs 22050, 1024/256 (SSE_FLOORS_DB), and the precision
    ladder at 44.1 kHz, hop 256 (LADDER_FLOORS_DB: the first GPU reading
    of full_bf16). Returns the ladder's median launches."""
    from zen_tpu_torch.benches import quality

    harm, perc, cym, mix = quality.make_hard_mixture(QUALITY_FS, 2.0)
    sig = {"harm": harm, "perc": perc, "cym": cym, "mix": mix}
    row = quality.offline_row(QUALITY_FS, "hard", sig, 1024, 256, "sse", 2.0,
                              {"use_sse": True}, DEVICE)
    require(all(row[k] > v for k, v in quality.SSE_FLOORS_DB.items()),
            f"SSE quality floors {quality.SSE_FLOORS_DB}: {row}")
    print(f"phase 16 quality SSE hard mixture fs 22050 1024/256: harm {row['harm_db']} dB, perc "
          f"{row['perc_db']} dB (floors {quality.SSE_FLOORS_DB}), cymbal to residual "
          f"{row['cym_resid_db']} dB, to percussive {row['cym_perc_db']} dB [{smi}]")
    reset_launches()
    rows = quality.run_ladder(OFFLINE_FS, 2.0, [], DEVICE,
                              log=lambda line: print(f"phase 16 {line}"))
    counts = read_launches()
    fails = [(r["mode"], r["mixture"], k, r[k]) for r in rows
             for k in ("vs_f32_harm_db", "vs_f32_perc_db")
             if not r[k] >= quality.LADDER_FLOORS_DB[r["mode"]]]
    require(not fails, f"ladder floors {quality.LADDER_FLOORS_DB}: {fails}")
    print(f"phase 16 ladder fs 44100 hop 256: every rung at or above its floor "
          f"{quality.LADDER_FLOORS_DB}; launches {counts} [{smi}]")
    return counts


# ---------------- files and the CLI: offline, fakert, checkpoints, LiveStream ----------------


def zen_cli(argv) -> list:
    """A file command of the port's CLI run in-process, so that the
    launch counters see it: its stdout lines; raises on a nonzero exit."""
    from zen_tpu_torch.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    require(rc == 0, f"zen-torch {' '.join(map(str, argv))}: exit {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue().splitlines()


def same_samples(got: Path, want: Path) -> bool:
    from zen_tpu_torch.io.audio import read_audio_mono

    (fs_g, g), (fs_w, w) = read_audio_mono(str(got)), read_audio_mono(str(want))
    return fs_g == fs_w and np.array_equal(g, w)


def write_stems(prefix: Path, fmt: str, stems, fs: int) -> None:
    """The CLI's own writing of [L] stems: peak-normalized, 16-bit."""
    from zen_tpu_torch.io.audio import peak_normalize, write_audio_pcm16

    for name, x in zip(CLI_STEMS, stems):
        write_audio_pcm16(f"{prefix}_{name}.{fmt}", fs, peak_normalize(x.cpu().numpy()))


def timed(fn):
    """(result, wall seconds) of one call that ends on the host."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def routes_launched(counts: dict, want: tuple, what: str) -> dict:
    """The routes of one run that launched, with a check that ``want`` did."""
    launched = {k: v for k, v in counts.items() if v}
    require(all(counts[k] > 0 for k in want), f"{what}: launches {launched}, want {want}")
    return launched


def cli_offline(wav: Path, prefix: Path, *extra) -> tuple:
    """zen-torch offline at BASELINE.json configs[0] in-process: (its
    offline_2pass_ms line, the routes it launched, its wall seconds)."""
    reset_launches()
    lines, wall = timed(lambda: zen_cli(["offline", "-i", wav, "--hps", "4096", "2.5", "256",
                                         "2.5", "-o", prefix, "--device", DEVICE, *extra]))
    line = json.loads(lines[-1])
    require(lines[0].startswith("Running zen-offline") and line["metric"] == "offline_2pass_ms"
            and any("HPR-I-Offline took" in ln for ln in lines), f"zen offline stdout: {lines}")
    return line, read_launches(), wall


def phase_files_cli(smi: str) -> dict:
    """The file surface on the card: the clip written as WAV and the
    4-minute track as FLAC through the port's writers; `zen-torch offline`
    in-process on both (the clip at configs[0], the track --blocked
    --stem-format flac), each stem decoded and held sample for sample
    against the port's writer over the same card's process() /
    process_blocked() stems; the checkpointed process_blocked on the track
    interrupted after its second segment of pass 1 and once in pass 2,
    then resumed, bitwise to the uninterrupted run; `zen-torch fakert` at
    hop 256 and 1024 (its file bitwise to the card's process_stream, that
    held against the CPU port under phase 4's flip rule); LiveStream at
    hop 256, bitwise to process_stream; one real `python -m zen_tpu_torch
    offline`, its stems byte-equal to the in-process run's. Returns the
    launches of the entry points' runs (not of their references)."""
    import tempfile

    from zen_tpu_torch import OUTPUT_PERCUSSIVE, HPRRealtime
    from zen_tpu_torch.drivers.offline import clear_track_checkpoint
    from zen_tpu_torch.io.audio import peak_normalize, read_audio_mono, write_audio_pcm16
    from zen_tpu_torch.runtime import native
    from zen_tpu_torch.runtime.stream import LiveStream

    _, build_s = timed(native.library)
    print(f"phase 17 native codec library: built and loaded in {build_s:.2f} s "
          f"({native.library_path().name}, {len(native.SOURCES)} sources, one g++ each)")
    total = dict.fromkeys(read_launches(), 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        wav, flac = tmp / "clip.wav", tmp / "track.flac"
        clip = peak_normalize(synthetic_mix(CLIP_SAMPLES, OFFLINE_FS, seed=7))
        track = peak_normalize(synthetic_mix(TRACK_SAMPLES, OFFLINE_FS, seed=8))
        _, w_wav = timed(lambda: write_audio_pcm16(str(wav), int(OFFLINE_FS), clip))
        _, w_flac = timed(lambda: write_audio_pcm16(str(flac), int(OFFLINE_FS), track))
        (fs, x_clip), r_wav = timed(lambda: read_audio_mono(str(wav)))
        (_, x_track), r_flac = timed(lambda: read_audio_mono(str(flac)))
        require(fs == OFFLINE_FS and len(x_clip) == CLIP_SAMPLES and len(x_track) == TRACK_SAMPLES,
                "decoded clip or track")
        print(f"phase 17 files: clip WAV write {w_wav * 1e3:.2f} ms, read {r_wav * 1e3:.2f} ms; "
              f"4-minute track FLAC ({flac.stat().st_size / 2**20:.1f} MiB) write "
              f"{w_flac * 1e3:.1f} ms, read {r_flac * 1e3:.1f} ms")

        # zen-torch offline on the clip, against process() on this card
        sep = offline_separator()
        line, counts, wall = cli_offline(wav, tmp / "cli")
        add(counts)
        launched = routes_launched(counts, ("tap_median_time/register", "sliding_median_boundary/rank",
                                            f"sliding_median_boundary/{STEPS}",
                                            "sliding_median_boundary/network"), "offline clip")
        x = torch.from_numpy(x_clip).to(DEVICE)
        write_stems(tmp / "ref", "wav", sep.process(x), fs)
        for name in CLI_STEMS:
            require(same_samples(tmp / f"cli_{name}.wav", tmp / f"ref_{name}.wav"),
                    f"zen offline clip {name} stem differs from process() on the card")
        lib_ms = wall_us_per_call(lambda: sep.process(x), 10) / 1e3
        print(f"phase 17 zen-torch offline clip ({CLIP_SAMPLES} samples, WAV): stems sample for "
              f"sample equal to process() on the card; offline_2pass_ms {line['value']:.2f}, "
              f"process() alone {lib_ms:.2f} ms (mean of 10), whole command {wall * 1e3:.1f} ms "
              f"(file I/O and set-up {wall * 1e3 - line['value']:.1f} ms); launches {launched} [{smi}]")

        # zen-torch offline --blocked --stem-format flac on the track
        line, counts, wall = cli_offline(flac, tmp / "trk", "--blocked", "--stem-format", "flac")
        add(counts)
        launched = routes_launched(counts, ("tap_median_time/register", "sliding_median_boundary/rank",
                                            "sliding_median_boundary/network"), "offline track")
        xt = torch.from_numpy(x_track).to(DEVICE)
        want = sep.process_blocked(xt)
        write_stems(tmp / "trkref", "flac", want, fs)
        for name in CLI_STEMS:
            require(same_samples(tmp / f"trk_{name}.flac", tmp / f"trkref_{name}.flac"),
                    f"zen offline --blocked track {name} stem differs from process_blocked()")
        print(f"phase 17 zen-torch offline --blocked --stem-format flac, 4-minute track: stems "
              f"sample for sample equal to process_blocked() on the card; offline_2pass_ms "
              f"{line['value']:.1f}, whole command {wall * 1e3:.1f} ms; launches {launched} [{smi}]")

        # the checkpointed process_blocked, killed twice, then resumed
        class Kill(Exception):
            pass

        calls = []

        def kill_at(*nth):
            def hook(next_block, n_blocks):
                calls.append((next_block, n_blocks))
                if len(calls) in nth:
                    raise Kill
            return hook

        ck = dict(ckpt_dir=str(tmp / "ckpt"), tag="trk", ckpt_every_blocks=2)
        reset_launches()
        t0 = time.perf_counter()
        for nth in ((2,), (3,)):  # pass 1's second segment; then pass 2's first
            try:
                sep.process_blocked(xt, on_segment=kill_at(*nth), **ck)
                require(False, "the kill hook did not fire")
            except Kill:
                calls.clear()
        resumed = sep.process_blocked(xt, on_segment=kill_at(), **ck)
        torch.cuda.synchronize()
        ck_wall = time.perf_counter() - t0
        counts = read_launches()
        add(counts)
        require(all(torch.equal(a, b) for a, b in zip(resumed, want)),
                "resumed checkpointed process_blocked differs from the uninterrupted run")
        require(len(calls) == 3, f"the resume ran segments {calls}, want pass 2's last three")
        _, plain_s = timed(lambda: (sep.process_blocked(xt), torch.cuda.synchronize()))
        _, ckpt_s = timed(lambda: sep.process_blocked(xt, ckpt_dir=str(tmp / "ckpt2"),
                                                      ckpt_every_blocks=2))
        for t in ("trk.p1", "trk.p2"):
            clear_track_checkpoint(str(tmp / "ckpt"), t)
            clear_track_checkpoint(str(tmp / "ckpt2"), t)
        print(f"phase 17 checkpointed process_blocked, 4-minute track, 2 blocks a segment: killed "
              f"after pass 1's second segment and after pass 2's first, resumed: bitwise equal to "
              f"process_blocked(); three runs {ck_wall:.2f} s; one uninterrupted checkpointed run "
              f"{ckpt_s:.2f} s against {plain_s:.3f} s without; launches "
              f"{ {k: v for k, v in counts.items() if v} } [{smi}]")

        # zen-torch fakert --block-hops 32 at hop 256 and 1024
        for hop, want_routes in ((256, ("tap_median_time/register", "sliding_median_boundary/network")),
                                 (1024, ("tap_median_time/register",
                                         f"sliding_median_boundary/{FREQ_CORE}"))):
            out = tmp / f"fakert_{hop}.wav"
            reset_launches()
            lines = zen_cli(["fakert", "-i", wav, "--hps", hop, "2.0", "-o", out,
                             "--block-hops", "32", "--device", DEVICE])
            counts = read_launches()
            add(counts)
            launched = routes_launched(counts, want_routes, f"fakert hop {hop}")
            line = json.loads(lines[-1])
            require(line["metric"] == "fakert_us_per_hop" and lines[0].startswith("Running zen-fakert")
                    and any(ln.startswith("PRealtime") for ln in lines), f"fakert stdout {lines}")
            rt = HPRRealtime(fs, hop, 2.0, outputs=OUTPUT_PERCUSSIVE, device=DEVICE)
            perc = rt.process_stream(x_clip, block_hops=32)[1]
            write_audio_pcm16(str(tmp / "fakert_ref.wav"), fs, peak_normalize(perc[:CLIP_SAMPLES]))
            require(same_samples(out, tmp / "fakert_ref.wav"),
                    f"fakert hop {hop}: its file differs from process_stream on the card")
            n_hops = -(-CLIP_SAMPLES // hop)
            padded = np.zeros((1, n_hops * hop), np.float32)
            padded[0, :CLIP_SAMPLES] = x_clip
            sizes = [32] * (n_hops // 32) + ([n_hops % 32] if n_hops % 32 else [])
            cpu = HPRRealtime(fs, hop, 2.0, outputs=OUTPUT_PERCUSSIVE, device="cpu")
            ref = cpu.process_stream(x_clip, block_hops=32)[1]
            r = compare_stream(rt.cfg, padded, sizes, perc[None, None], ref[None, None],
                               ("percussive",))
            print(f"phase 17 zen-torch fakert --hps {hop} 2.0 --block-hops 32, clip: file equal to "
                  f"process_stream on the card; vs CPU: mask flips {r['flips']} ({r['share']:.3g}),"
                  f" excluded hops {r['excluded']}/{r['hops']}, max |diff|/scale "
                  f"{r['rel_err']:.3g} (limit {STEM_ATOL}); {line['value']:.2f} us per hop against "
                  f"the hop's {line['budget_us']:.1f} us budget (rtf {line['rtf']:.4f}; the CUDA "
                  f"reference's 173.99 us/hop at hop 256 on an RTX 2070 SUPER is an outside "
                  f"point); launches {launched} [{smi}]")

        # LiveStream at hop 256 over the native rings
        block_hops = 16
        n = CLIP_SAMPLES // (block_hops * 256) * block_hops * 256
        live = LiveStream(fs, 256, block_hops=block_hops, ring_capacity=1 << 18, device=DEVICE)
        live.warmup()
        reset_launches()
        require(live.push(x_clip[:n]) == n, "LiveStream input ring overrun")
        (_, live_s) = timed(lambda: [None for _ in iter(live.poll, False)])
        counts = read_launches()
        add(counts)
        want_live = HPRRealtime(fs, 256, device=DEVICE).process_stream(x_clip[:n], block_hops=block_hops)
        for i, name in enumerate(("harmonic", "percussive", "residual")):
            require(np.array_equal(live.pull(name, n), want_live[i]),
                    f"LiveStream {name} differs from process_stream on the card")
        require(live.dropped_out_samples == 0, "LiveStream dropped output")
        print(f"phase 17 LiveStream hop 256, {live.blocks_processed} blocks of {block_hops} hops: "
              f"three output rings bitwise equal to process_stream on the card; "
              f"{live_s / live.blocks_processed * 1e6:.1f} us per block (poll, one readback; "
              f"the block lasts {block_hops * 256 / fs * 1e6:.0f} us of audio); launches "
              f"{ {k: v for k, v in counts.items() if v} } [{smi}]")

        # one real process
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "zen_tpu_torch", "offline", "-i", str(wav), "--hps", "4096",
             "2.5", "256", "2.5", "-o", str(tmp / "proc"), "--device", DEVICE],
            capture_output=True, text=True, cwd=ROOT, timeout=300)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0, f"python -m zen_tpu_torch offline: exit {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        for name in CLI_STEMS:
            require((tmp / f"proc_{name}.wav").read_bytes() == (tmp / f"cli_{name}.wav").read_bytes(),
                    f"the real process's {name} stem differs from the in-process run's")
        line = json.loads(proc.stdout.splitlines()[-1])
        print(f"phase 17 real process python -m zen_tpu_torch offline, clip: stems byte-equal to "
              f"the in-process run; process {wall:.2f} s, offline_2pass_ms {line['value']:.2f} "
              f"(its first call builds no kernel: the libraries are on disk)")
    return total


# ---------------- the corpus: zen-torch corpus, the loader, the pipelined cascade ----------------

CORPUS_SECONDS = (30, 45, 60, 75, 90, 120, 180, 240)  # the 44.1 kHz tracks of phase 18


def corpus_separator(fs):
    """zen-torch corpus's default cascade, 4096/2.0/256/2.0, on the card."""
    from zen_tpu_torch import HPRIOffline

    return HPRIOffline(fs, 4096, 256, 2.0, 2.0, device=DEVICE)


def corpus_plan(items, dp: int = 1, long_samples: int | None = None) -> tuple:
    """How separate_corpus groups tracks [(path, fs, n)] in order: (the
    batches of up to ``dp`` short tracks of one rate, the long tracks: past
    ``long_samples``, LONG_TRACK_SAMPLES by default)."""
    from zen_tpu_torch.drivers.offline import LONG_TRACK_SAMPLES

    long_samples = LONG_TRACK_SAMPLES if long_samples is None else long_samples
    batches, long_tracks, cur = [], [], []
    for path, fs, n in items:
        if n > long_samples:
            long_tracks.append((path, fs, n))
            continue
        if cur and (fs != cur[0][1] or len(cur) == dp):
            batches.append(cur)
            cur = []
        cur.append((path, fs, n))
    return batches + ([cur] if cur else []), long_tracks


def add_pass(counts: dict, cfg, n: int) -> dict:
    """``counts`` plus ``n`` launches of each of a pass's two medians (K1
    at the pass's time taps, K2 at its frequency width), by route."""
    from zen_tpu_torch.ops import median_cuda as mc

    counts[f"tap_median_time/{mc.time_route(cfg.time_offsets)}"] += n
    counts[f"sliding_median_boundary/{mc.freq_route(cfg.freq_filter_len)}"] += n
    return counts


def corpus_launches(items, dp: int = 1) -> dict:
    """The median launches of separate_corpus over ``items`` on a dp x 1
    mesh, counted from the configs and shapes: each batch is one
    sharded_hpri_offline call, each of its dp shards one K1 and one K2 a
    pass (rows past the batch's tracks are zeros, launched all the same);
    a long track each pass's blocks (one K1 and one K2 a block)."""
    from zen_tpu_torch.drivers.offline import _Blocking

    counts = dict.fromkeys(read_launches(), 0)
    batches, long_tracks = corpus_plan(items, dp)
    calls = [(b[0][1], None) for b in batches] + [(fs, n) for _, fs, n in long_tracks]
    for fs, n in calls:
        sep = corpus_separator(fs)
        for cfg, bf in ((sep.cfg_h, 512), (sep.cfg_p, 8192)):
            add_pass(counts, cfg, dp if n is None else _Blocking.of(n, cfg, bf).n_blocks)
    return counts


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def synced(fn):
    """fn() once the card has finished it."""
    out = fn()
    torch.cuda.synchronize()
    return out


def launch_ledger():
    """(total, counted): ``counted(fn, want, what)`` runs one entry point
    between a reset and a read of the launch counters, requires the count
    to equal ``want`` (counted from the shapes; ``want(result)`` for an
    instrument, whose timing windows vary in length and which reports the
    calls it made) and adds it to ``total``; it returns (fn's result, its
    wall seconds)."""
    total = dict.fromkeys(read_launches(), 0)

    def counted(fn, want, what):
        torch.cuda.synchronize()
        reset_launches()
        out, wall = timed(lambda: synced(fn))
        counts = read_launches()
        if callable(want):
            want = want(out)
        require(by_route(counts) == by_route(want), f"{what}: launches {nonzero(counts)}, "
                f"counted from the shapes {nonzero(want)}")
        for k in total:
            total[k] += counts[k]
        return out, wall

    return total, counted


def same_bytes(a: Path, b: Path) -> bool:
    return a.read_bytes() == b.read_bytes()


def phase_corpus(smi: str) -> dict:
    """The corpus surface on the card, at the sizes an offline user runs:
    eight tracks of 30-240 s at 44.1 kHz, one of 60 s at 48 kHz and one
    just past LONG_TRACK_SAMPLES at 48 kHz, written as WAV. `zen-torch
    corpus` (dp=1, 4096/2.0/256/2.0) in-process: every stem byte-equal to
    the port's writer over process() (process_blocked() for the long
    track) on the card; a second run processes nothing; the .ckpt
    directory is empty. `--pp` on the short tracks: stems byte-equal to
    the plain run's. separate_corpus on a dp=4 mesh of this card: its
    stems byte-equal to the writer over process() of each track's
    zero-padded row of the batch (the arithmetic its shard runs), and
    compared with the dp=1 run's. The loader (prefetch 2 against 0) and the
    pipelined cascade against the sequential one, in turns. Each run's
    launches equal the count from the shapes."""
    import shutil
    import tempfile

    from zen_tpu_torch.drivers.corpus import separate_corpus
    from zen_tpu_torch.drivers.offline import LONG_TRACK_SAMPLES
    from zen_tpu_torch.drivers.pipeline import PipelinedHPRIOffline
    from zen_tpu_torch.io.audio import peak_normalize, read_audio_mono, write_audio_pcm16

    total, counted = launch_ledger()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        src = tmp / "in"
        src.mkdir()
        specs = [(f"a{i}_{s}s", 44100, int(s * 44100)) for i, s in enumerate(CORPUS_SECONDS)]
        specs += [("b_48k_60s", 48000, 60 * 48000),
                  ("c_48k_long", 48000, LONG_TRACK_SAMPLES + 48000)]
        tracks = {}
        t0 = time.perf_counter()
        for seed, (name, fs, n) in enumerate(specs):
            path = src / f"{name}.wav"
            write_audio_pcm16(str(path), fs, peak_normalize(synthetic_mix(n, fs, seed=20 + seed)))
            tracks[str(path)] = read_audio_mono(str(path))
        paths = sorted(tracks)
        items = [(p, tracks[p][0], len(tracks[p][1])) for p in paths]
        short = [p for p, _, n in items if n <= LONG_TRACK_SAMPLES]
        short_items = [it for it in items if it[0] in short]
        seconds = sum(n / fs for _, fs, n in items)
        print(f"phase 18 corpus input: {len(paths)} WAV tracks, {seconds:.0f} s of audio "
              f"({sum(Path(p).stat().st_size for p in paths) / 2**20:.0f} MiB; {len(CORPUS_SECONDS)} at "
              f"44.1 kHz of {CORPUS_SECONDS} s, one of 60 s and one of {specs[-1][2]} samples at "
              f"48 kHz, "
              f"LONG_TRACK_SAMPLES {LONG_TRACK_SAMPLES}); made in {time.perf_counter() - t0:.1f} s")

        # zen-torch corpus, then each stem against the writer over process() on this card
        out = tmp / "out"
        argv = ["corpus", "-i", src / "*.wav", "-o", out, "--device", DEVICE]
        lines, wall = counted(lambda: zen_cli(argv), corpus_launches(items), "zen-torch corpus")
        require(lines[0] == f"corpus: {len(paths)} tracks, mesh {{'dp': 1, 'sp': 1}}, out={out}"
                and json.loads(lines[-1]) == {"metric": "corpus_tracks", "done": 0,
                                              "processed": len(paths)},
                f"zen-torch corpus stdout {lines}")
        require(sorted(os.listdir(out / ".ckpt")) == [], "checkpoint files left in .ckpt")
        card_s = 0.0
        for path, fs, n in items:
            sep = corpus_separator(fs)
            x = torch.from_numpy(tracks[path][1]).to(DEVICE)
            run = sep.process_blocked if n > LONG_TRACK_SAMPLES else sep.process
            stems, s = timed(lambda: synced(lambda: run(x)))
            card_s += s
            for name, stem in zip(CLI_STEMS, stems):
                write_audio_pcm16(str(tmp / "ref.wav"), fs, peak_normalize(stem.cpu().numpy()))
                require(same_bytes(out / f"{Path(path).stem}_{name}.wav", tmp / "ref.wav"),
                        f"corpus {Path(path).name} {name}: differs from the writer over "
                        f"{'process_blocked' if n > LONG_TRACK_SAMPLES else 'process'}()")
        launched = nonzero(corpus_launches(items))
        print(f"phase 18 zen-torch corpus, {len(paths)} tracks ({seconds:.0f} s): every stem "
              f"byte-equal to the writer over process() / process_blocked() on the card; .ckpt "
              f"empty; whole command {wall:.2f} s = {seconds / wall:.1f} s of audio per s; "
              f"process() and process_blocked() alone on the same tracks {card_s:.3f} s, the "
              f"card's share {card_s / wall:.1%} (the rest: decode, peak normalization, encode, "
              f"journal); launches {launched}, as counted from the shapes [{smi}]")
        lines, _ = counted(lambda: zen_cli(argv), dict.fromkeys(total, 0), "corpus resume")
        require(json.loads(lines[-1]) == {"metric": "corpus_tracks", "done": len(paths),
                                          "processed": 0}, f"resume: {lines[-1]}")
        require(sorted(os.listdir(out / ".ckpt")) == [], "checkpoint files left after resume")
        print(f"phase 18 resume: {lines[-1]}; no launch; .ckpt empty")

        # --pp on the short tracks: the pipelined cascade, stems equal to the plain run's
        out_pp = tmp / "pp"
        lines, wall_pp = counted(
            lambda: zen_cli(["corpus", "-i", *short, "-o", out_pp, "--pp", "--device", DEVICE]),
            corpus_launches(short_items), "zen-torch corpus --pp")
        for p in short:
            for name in CLI_STEMS:
                stem = f"{Path(p).stem}_{name}.wav"
                require(same_bytes(out_pp / stem, out / stem), f"--pp {stem} differs")
        shutil.rmtree(out_pp)
        print(f"phase 18 zen-torch corpus --pp, {len(short)} short tracks: stems byte-equal to "
              f"the plain run's; whole command {wall_pp:.2f} s [{smi}]")

        # a dp=4 mesh of this card: batches of four tracks of one rate, a track a shard
        out4 = tmp / "dp4"
        res, wall4 = counted(lambda: separate_corpus(short, str(out4), card_mesh({"dp": 4})),
                             corpus_launches(short_items, dp=4), "separate_corpus(dp=4)")
        require(res == {"done": 0, "processed": len(short)}, f"dp=4: {res}")
        batches, _ = corpus_plan(short_items, dp=4)
        as_dp1 = 0
        for batch in batches:
            fs = batch[0][1]
            sep = corpus_separator(fs)
            width = max(n for _, _, n in batch)
            for p, _, n in batch:
                row = torch.zeros((1, width), device=DEVICE)
                row[0, :n] = torch.from_numpy(tracks[p][1]).to(DEVICE)
                for name, stem in zip(CLI_STEMS, sep.process(row, lengths=[n])):
                    write_audio_pcm16(str(tmp / "ref.wav"), fs,
                                      peak_normalize(stem[0, :n].cpu().numpy()))
                    stem_file = f"{Path(p).stem}_{name}.wav"
                    require(same_bytes(out4 / stem_file, tmp / "ref.wav"),
                            f"dp=4 {Path(p).name} {name}: differs from process() of its row")
                    as_dp1 += same_bytes(out4 / stem_file, out / stem_file)
        shutil.rmtree(out4)
        print(f"phase 18 separate_corpus on a dp=4 mesh of this card, {len(short)} tracks in "
              f"{len(batches)} batches: stems byte-equal to the writer over process() of each "
              f"track's padded row; {as_dp1} of {3 * len(short)} stem files byte-equal to the "
              f"dp=1 run's; {wall4:.2f} s against dp=1's prefetch runs below [{smi}]")

        # the loader and the pipelined cascade, each against its sequential twin, in turns
        walls = {0: [], 2: []}
        for k, pf in enumerate((0, 2, 2, 0)):
            o = tmp / f"pf{k}"
            _, w = counted(lambda: separate_corpus(short, str(o), card_mesh({"dp": 1}),
                                                   prefetch=pf),
                           corpus_launches(short_items), f"separate_corpus(prefetch={pf})")
            walls[pf].append(w)
            shutil.rmtree(o)
        short44 = [it for it in short_items if it[1] == 44100]
        sep = corpus_separator(44100)
        pipe = PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device=DEVICE)
        audios = [tracks[p][1] for p, _, _ in short44]
        runs = {"sequential": lambda: [[s.cpu().numpy() for s in sep.process(a)] for a in audios],
                "pipelined": lambda: [[s.cpu().numpy() for s in out]
                                      for out in pipe.process_stream(audios)]}
        pwalls, got = {"sequential": [], "pipelined": []}, {}
        for name in ("sequential", "pipelined", "pipelined", "sequential"):
            got[name], w = counted(runs[name], corpus_launches(short44), name)
            pwalls[name].append(w)
        require(all(np.array_equal(a, b) for ta, tb in zip(got["sequential"], got["pipelined"])
                    for a, b in zip(ta, tb)),
                "the pipelined cascade's stems differ from the sequential process()")
        prof = {name: device_profile(run) for name, run in runs.items()}
        audio_s = sum(n / fs for _, fs, n in short_items)
        print(f"phase 18 loader, {len(short)} tracks ({audio_s:.0f} s), files in and out, "
              f"in turns: prefetch=2 {walls[2][0]:.2f} / {walls[2][1]:.2f} s against prefetch=0 "
              f"{walls[0][0]:.2f} / {walls[0][1]:.2f} s [{smi}]")
        print(f"phase 18 pipelined cascade (two CUDA streams) on the {len(short44)} 44.1 kHz "
              f"tracks, host arrays in and out, in turns: pipelined {pwalls['pipelined'][0]:.3f}"
              f" / {pwalls['pipelined'][1]:.3f} s against sequential process() "
              f"{pwalls['sequential'][0]:.3f} / {pwalls['sequential'][1]:.3f} s; stems bitwise "
              f"equal; one run each under torch.profiler: sequential {prof['sequential']}; "
              f"pipelined {prof['pipelined']} [{smi}]")
    return total


# ---------------- the demo apps: pitch-track and beat-track ----------------

APPS = {"pitch-track": (4096, 8), "beat-track": (256, 64)}  # hop, block hops
DEMO_MIXES = {  # docs/DEMOS.md's command, and 60 s of a steady sine chord under the same drums
    "demo 3 s": ["--sawtooth", "--vibrato-cents", "17", "--bpm", "120", "--hits-per-beat", "4",
                 "--seconds", "3"],
    "steady 60 s": ["--bpm", "120", "--hits-per-beat", "4", "--seconds", "60"],
}
PITCH_HZ_ATOL = 0.01  # one unit of the printed precision: close values may round apart
# the FFT's relative rounding: twice log2(512) float32 epsilons (a radix-2 FFT's
# error bound, twiddles included)
ODF_FFT_DELTA = 2 * 9 * float(np.finfo(np.float32).eps)
ACF_RTOL = 1e-5  # x max|acf| per chunk: cuFFT against the CPU FFT


def odf_tolerance(frames: np.ndarray) -> np.ndarray:
    """Per frame, how far two FFTs' onset detection functions may differ:
    sqrt(2 ODF_FFT_DELTA) x the sum over bins of m_t + m_(t-1) (float64
    magnitudes of the windowed, half-swapped frames). A bin's complex
    spectral difference sqrt(m^2 + m_p^2 - 2 m m_p cos(dev)) is a
    difference of nearly equal terms where a partial is steady, so a
    rounding delta of the spectra moves it by up to (m + m_p) sqrt(2
    delta); the magnitude gate (m > m_p) flips only where that bound
    covers the bin. Valid where every bin carries energy: the phase of a
    bin holding only round-off is noise, and a frame two hops later reads
    it at full weight (hold such inputs over a noise floor)."""
    from zen_tpu_torch.apps.btrack import HOP_SIZE, _odf_window

    xw = frames.astype(np.float64) * _odf_window()
    m = np.abs(np.fft.fft(np.concatenate([xw[:, HOP_SIZE:], xw[:, :HOP_SIZE]], 1))).sum(1)
    return math.sqrt(2 * ODF_FFT_DELTA) * (m + np.concatenate([[0.0], m[:-1]]))


def app_separator(cmd: str, fs: float, device):
    """The demo's own stream: hop 4096 harmonic, or hop 256 percussive, beta 2.5."""
    from zen_tpu_torch import OUTPUT_HARMONIC, OUTPUT_PERCUSSIVE, HPRRealtime

    outputs = OUTPUT_HARMONIC if cmd == "pitch-track" else OUTPUT_PERCUSSIVE
    return HPRRealtime(fs, APPS[cmd][0], 2.5, outputs=outputs, device=device)


def app_launches(cmd: str, fs: float, n_samples: int) -> dict:
    """One K1 and one K2 launch per step of the demo's stream, counted from
    its hop and block (a ragged last block is one step too)."""
    from zen_tpu_torch.ops import median_cuda as mc

    hop, block = APPS[cmd]
    cfg = app_separator(cmd, fs, "cpu").cfg
    steps = -(-(n_samples // hop) // block)
    counts = dict.fromkeys(read_launches(), 0)
    counts[f"tap_median_time/{mc.time_route(cfg.time_offsets)}"] += steps
    counts[f"sliding_median_boundary/{mc.freq_route(cfg.freq_filter_len)}"] += steps
    return counts


def pitch_rows(lines) -> np.ndarray:
    """[chunks, 3]: t, +HPR pitch, -HPR pitch of pitch-track's lines."""
    rows = [ln for ln in lines if ln.startswith("t:")]
    return np.array([[float(f.split(":")[1]) for f in ln.split(",\t")] for ln in rows])


def beat_times(lines, name: str) -> np.ndarray:
    line = next(ln for ln in lines if ln.startswith(f"{name} beat timestamps:"))
    return np.array([float(x) for x in line.split(":", 1)[1].split()])


def phase_apps(smi: str) -> dict:
    """The reference's two demos on the card: `zen-torch pitch-track` and
    `beat-track` in-process on docs/DEMOS.md's mixture and on 60 s of a
    steady pitch, each against its own run with --device cpu (the printed
    lines; pitches within PITCH_HZ_ATOL, beats within one ODF frame), with
    DEMOS.md's verdicts on the 60 s mix: +HPR pitch steadier than -HPR,
    both beat lists on the 0.5 s grid. Then the demos' separation stems,
    the ODF and the autocorrelation against the CPU port at their
    classes, each timed apart."""
    import tempfile

    from zen_tpu_torch.apps.btrack import frames_from_hops, odf_batch
    from zen_tpu_torch.apps.mpm import _autocorr_batch
    from zen_tpu_torch.io.audio import read_audio_mono

    total, counted = launch_ledger()
    pitches, beats, audio = {}, {}, {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for mix, flags in DEMO_MIXES.items():
            wav = Path(tmp) / f"{mix.split()[0]}.wav"
            zen_cli(["synth", "-o", wav, *flags])
            fs, audio[mix] = read_audio_mono(str(wav))
            for cmd in APPS:
                want = app_launches(cmd, fs, len(audio[mix]))
                gpu, wall = counted(lambda: zen_cli([cmd, "-i", wav, "--device", DEVICE]), want,
                                    f"{cmd} {mix}")
                cpu, wall_cpu = timed(lambda: zen_cli([cmd, "-i", wav, "--device", "cpu"]))
                rows = ("t:",) if cmd == "pitch-track" else ("+HPR beat", "-HPR beat")
                require([ln for ln in gpu if not ln.startswith(rows)]
                        == [ln for ln in cpu if not ln.startswith(rows)],
                        f"{cmd} {mix}: echo lines differ")
                if cmd == "pitch-track":
                    g, c = pitch_rows(gpu), pitch_rows(cpu)
                    require(g.shape == c.shape and np.array_equal(g[:, 0], c[:, 0]),
                            f"{cmd} {mix}: chunks differ")
                    # in units of the printed 0.01 Hz: 110.13 - 110.12 is 0.010000000000005
                    err = float(np.abs(np.rint(g[:, 1:] * 100) - np.rint(c[:, 1:] * 100)).max()
                                ) / 100
                    require(err <= PITCH_HZ_ATOL, f"{cmd} {mix}: card vs CPU pitch {err} Hz")
                    held = f"{len(g)} chunks, max |pitch diff| {err:.3g} Hz"
                    pitches[mix] = g
                else:
                    held = []
                    for name in ("+HPR", "-HPR"):
                        g, c = beat_times(gpu, name), beat_times(cpu, name)
                        require(len(g) == len(c) and np.abs(g - c).max(initial=0.0)
                                <= 256 / fs + 1e-4, f"{cmd} {mix} {name}: card {g} vs CPU {c}")
                        held.append(f"{name} {len(g)} beats, max |diff| "
                                    f"{np.abs(g - c).max(initial=0.0):.4f} s")
                        beats[mix, name] = g
                    held = "; ".join(held) + f" (limit one ODF frame, {256 / fs:.4f} s)"
                print(f"phase 19 zen-torch {cmd}, {mix}: card against --device cpu: {held}; "
                      f"command {wall:.2f} s on the card, {wall_cpu:.2f} s on the CPU; launches "
                      f"{nonzero(want)}, as counted from the shapes [{smi}]")

    demo, steady = DEMO_MIXES
    print("phase 19 pitch-track, demo 3 s (t: +HPR / -HPR Hz): " + "; ".join(
        f"{t:.2f}: {a:.2f} / {b:.2f}" for t, a, b in pitches[demo]))
    for name in ("+HPR", "-HPR"):
        print(f"phase 19 beat-track, demo 3 s, {name} beat timestamps: "
              + " ".join(f"{b:.4f}" for b in beats[demo, name]))
    # docs/DEMOS.md's verdicts; the first chunk is the harmonic stream's warm-up hop
    rows = pitches[steady][1:]
    spread = {name: float(np.abs(rows[:, i] - np.median(rows[:, i])).max())
              for i, name in ((1, "+HPR"), (2, "-HPR"))}
    require(spread["+HPR"] < spread["-HPR"] and (rows[:, 1] > 0).all(),
            f"pitch verdict: +HPR not steadier than -HPR: {spread}")
    grid = {}
    for name in ("+HPR", "-HPR"):
        ibi = np.diff(beats[steady, name])
        grid[name] = (float(np.median(ibi)), float(np.mean(np.abs(ibi - 0.5) < 0.05)))
        require(abs(grid[name][0] - 0.5) < 0.015,
                f"beat verdict: {name} median inter-beat interval {grid[name][0]} s")
    print(f"phase 19 verdicts, steady 60 s: pitch +HPR max |p - median| {spread['+HPR']:.4f} Hz "
          f"against -HPR {spread['-HPR']:.4f} Hz (steadier, as docs/DEMOS.md); beats on the "
          f"0.5 s grid, median inter-beat interval " + ", ".join(
              f"{n} {m:.4f} s ({share:.0%} of intervals within 0.05 s)"
              for n, (m, share) in grid.items()) + f" [{smi}]")

    # the demos' streams, the ODF and the autocorrelation against the CPU port; times apart
    x60 = audio[steady]
    rng = np.random.default_rng(19)
    x = x60[: 20 * int(fs)]
    x = (x + NOISE_FLOOR * rng.standard_normal(len(x))).astype(np.float32)
    for cmd, (hop, block) in APPS.items():
        n_hops = len(x) // hop
        xs = x[: n_hops * hop]
        sizes = [block] * (n_hops // block) + ([n_hops % block] if n_hops % block else [])
        idx, stem = (0, "harmonic") if cmd == "pitch-track" else (1, "percussive")
        rt = app_separator(cmd, fs, DEVICE)
        got = rt.process_stream(xs, block_hops=block)[idx]
        want = app_separator(cmd, fs, "cpu").process_stream(xs, block_hops=block)[idx]
        r = compare_stream(rt.cfg, xs[None], sizes, got[None, None], want[None, None], (stem,))
        _, sep_s = timed(lambda: app_separator(cmd, fs, DEVICE).process_stream(
            x60, block_hops=block))
        print(f"phase 19 {cmd} stream (hop {hop}, {block}-hop blocks, {stem}) on 20 s of the "
              f"steady mix over a {NOISE_FLOOR} noise floor, card vs CPU: mask flips "
              f"{r['flips']} ({r['share']:.3g}), excluded hops {r['excluded']}/{r['hops']}, max "
              f"|diff|/scale {r['rel_err']:.3g} (limit {STEM_ATOL}); the separation step on "
              f"60 s: {sep_s:.3f} s wall [{smi}]")
    frames = frames_from_hops(x)  # the floored mix: every bin carries energy
    frames_g = torch.from_numpy(frames).to(DEVICE)
    odf_c = odf_batch(torch.from_numpy(frames)).numpy()
    odf_d = np.abs(odf_batch(frames_g).cpu().numpy() - odf_c)
    odf_ratio = float((odf_d / odf_tolerance(frames)).max())
    require(odf_ratio <= 1.0, f"ODF card vs CPU: {odf_ratio} x the tolerance")
    chunks = x60[: len(x60) // 4096 * 4096].reshape(-1, 4096)
    chunks_g = torch.from_numpy(chunks).to(DEVICE)
    acf_c = _autocorr_batch(torch.from_numpy(chunks), 4096).numpy()
    acf_err = float((np.abs(_autocorr_batch(chunks_g, 4096).cpu().numpy() - acf_c).max(axis=1)
                     / np.abs(acf_c).max(axis=1)).max())
    require(acf_err <= ACF_RTOL, f"ACF card vs CPU: {acf_err} of max|acf|")
    odf_us = median_us(lambda: odf_batch(frames_g))
    acf_us = median_us(lambda: _autocorr_batch(chunks_g, 4096))
    print(f"phase 19 ODF, {len(frames)} frames of 512 (the 20 s floored mix): card vs CPU "
          f"{odf_ratio:.3g} x odf_tolerance at worst ({odf_d.max() / np.abs(odf_c).max():.3g} of "
          f"max|odf|), {odf_us:.1f} us on the card; autocorrelation, "
          f"{len(chunks)} chunks of 4096 at n 8192: {acf_err:.3g} of max|acf| per chunk (limit "
          f"{ACF_RTOL}), {acf_us:.1f} us (device medians of {TIMED_RUNS}) [{smi}]")
    require(total[f"sliding_median_boundary/{FREQ_CORE}"] == 0 and total[
        "sliding_median_boundary/network"] > 0, f"the demos' launches {nonzero(total)} "
            "(beat-track's 64-row K2 keeps the per-output network)")
    return total


# ---------------- the parallel layer: sharded drivers on virtual shards ----------------

TP_ATOL = 2e-4  # zen_tpu's TP class, tests/test_parallel.py:44-47
PARALLEL_CLIP_SEEDS = (7, 9)  # the two channels of phase 20's batch (7: phase 7's clip)


def card_mesh(axes: dict):
    """make_mesh over ``axes`` with every shard on this card: virtual
    shards, which run one after another."""
    from zen_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes, devices=[DEVICE] * math.prod(axes.values()))


def sharded_pass(audio, cfg, mesh) -> tuple:
    """sharded_separate's two halves on ``audio`` [C, L]: (its stems
    {name: [C, L]}, its (harmonic, percussive) masks [C, frames, bins]),
    for the flip rule."""
    from zen_tpu_torch.parallel.sharded import sharded_pass_masks

    return sharded_pass_masks(audio, cfg, mesh)


def tp_pass(audio, cfg, mesh) -> tuple:
    """tp_separate's two halves on ``audio`` [L]: (its stems {name: [L]},
    its (harmonic, percussive) masks [frames, nfft])."""
    from zen_tpu_torch.drivers.offline import _n_frames
    from zen_tpu_torch.parallel import sharded as tsh

    shards = tsh._ring(mesh, "tp", wrap=True)
    n_frames = _n_frames(audio.shape[-1], cfg)
    with tsh._tf32_off():
        spectra, masks, inverse = tsh._tp_masks(audio, cfg, shards, n_frames)
        out = tsh._tp_stems(spectra, masks, inverse, cfg, shards, n_frames)
    stems = {name: out[i, : audio.shape[-1]] for i, name in enumerate(tsh.STEMS)}
    return stems, tuple(torch.cat([m[i] for m in masks], dim=-1) for i in (0, 1))


def hold_passes(what, cfgs, audio, run, atol=STEM_ATOL) -> dict:
    """Each pass of a sharded cascade against the unsharded pass on the
    card under the flip rule, row by row at ``atol`` x scale: pass 1 on
    ``audio``, pass 2 on the unsharded pass 1's intermediate on both sides
    (pass-1 flips do not cascade). ``run(audio, cfg)`` -> (stems, masks)
    of the sharded pass. The worst row of both passes."""
    from zen_tpu_torch.drivers.offline import pass_masks, pass_stems

    worst = {"flips": 0, "share": 0.0, "excluded": 0, "rel_err": 0.0}
    for cfg in cfgs:
        got, masks = run(audio, cfg)
        fm = pass_masks(audio, cfg)
        want = pass_stems(fm, cfg, audio)
        rows = [slice(None)] if audio.ndim == 1 else range(audio.shape[0])
        for j in rows:
            st = hold_pass(f"{what} hop {cfg.hop}", {k: v[j] for k, v in got.items()},
                           {k: v[j] for k, v in want.items()}, [m[j] for m in masks],
                           [m[j] for m in fm.masks[:2]], cfg.hop, atol)
            worst = {k: max(worst[k], st[k]) for k in worst}
        audio = want["percussive"] + want["residual"]
    return worst


def held_text(bitwise: bool, st: dict | None, atol: float = STEM_ATOL, how: str = "") -> str:
    if bitwise:
        return "bitwise equal"
    return (f"not bitwise; {how}under the flip rule: mask flips {st['flips']} "
            f"({st['share']:.3g} of bins), excluded {st['excluded']} "
            f"{'hops' if 'hops' in st else 'samples'}, max "
            f"|diff|/scale {st['rel_err']:.3g} (limit {atol})")


def phase_parallel(smi: str) -> dict:
    """The single-host parallel layer at full width on virtual shards of
    this card (make_mesh with the card repeated): (a) sharded_hpri_offline
    at BASELINE.json configs[0] on a two-channel batch of the clip, meshes
    dp1 x sp4, dp2 x sp2, dp2 x sp1, against process(); (b)
    sharded_hpri_blocked on the 4-minute track at sp 4 and 2, bitwise
    against process_blocked(), and its checkpointed form killed once and
    resumed; (c) tp_hpri_offline on the clip at tp 4 and 2 against
    process() with the exact C2C transform at zen_tpu's TP class; (d)
    MultiStreamHPR 64 x hop 256 (B=32) and 512 x B=16 at dp=4 against the
    unsharded fleet; (e) the CLI's --mesh surfaces. Each sharded run's
    launches equal shards x per-pass launches from the shapes; each row
    prints its host wall beside the unsharded run's. No gain is claimed:
    virtual shards run one after another."""
    import tempfile

    from zen_tpu_torch import HPRIOffline, MultiStreamHPR
    from zen_tpu_torch.errors import ZenError
    from zen_tpu_torch.io.audio import peak_normalize, read_audio_mono, write_audio_pcm16
    from zen_tpu_torch.parallel import sharded as tsh

    total, counted = launch_ledger()
    (ROOT / "build").mkdir(exist_ok=True)

    def zero():
        return dict.fromkeys(total, 0)

    def wall_s(fn, runs=3):
        fn()
        return wall_us_per_call(fn, runs) / 1e6

    # (a) the dp x sp batched cascade
    sep = offline_separator()
    batch = torch.stack([torch.from_numpy(synthetic_mix(CLIP_SAMPLES, OFFLINE_FS, seed=s))
                         for s in PARALLEL_CLIP_SEEDS]).to(DEVICE)
    want = sep.process(batch)
    t_plain = wall_s(lambda: sep.process(batch))
    for axes in ({"dp": 1, "sp": 4}, {"dp": 2, "sp": 2}, {"dp": 2, "sp": 1}):
        mesh = card_mesh(axes)
        run = lambda: tsh.sharded_hpri_offline(batch, sep.cfg_h, sep.cfg_p, mesh)  # noqa: E731
        run()  # cuFFT plans of the shards' shapes
        n = math.prod(axes.values())
        got, _ = counted(run, add_pass(add_pass(zero(), sep.cfg_h, n), sep.cfg_p, n),
                         f"sharded_hpri_offline {axes}")
        for o in got:
            require(o.shape == batch.shape and bool(torch.isfinite(o).all()),
                    f"sharded_hpri_offline {axes}: stems {tuple(o.shape)}")
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        st = None if bitwise else hold_passes(f"sharded {axes}", (sep.cfg_h, sep.cfg_p), batch,
                                              lambda a, c: sharded_pass(a, c, mesh))
        print(f"phase 20 (a) sharded_hpri_offline {axes}, 2 x {CLIP_SAMPLES} samples, against "
              f"process() per channel: {held_text(bitwise, st, how='pass by pass ')}; "
              f"{wall_s(run) * 1e3:.2f} ms "
              f"wall against process() {t_plain * 1e3:.2f} ms (means of 3); launches "
              f"{nonzero(add_pass(add_pass(zero(), sep.cfg_h, n), sep.cfg_p, n))} [{smi}]")

    # (b) the sp blocked scan, and its checkpointed form killed once
    x = torch.from_numpy(synthetic_mix(TRACK_SAMPLES, OFFLINE_FS, seed=8)).to(DEVICE)
    want = sep.process_blocked(x)
    t_plain = wall_s(lambda: sep.process_blocked(x), 1)
    for n_sp in (4, 2):
        mesh = card_mesh({"sp": n_sp})
        counts = zero()
        for cfg, bf in ((sep.cfg_h, 512), (sep.cfg_p, 8192)):
            _, nbl = tsh._sharded_blocking(TRACK_SAMPLES, cfg, bf, n_sp)
            # each shard's blocks, and the block before each span but the first
            add_pass(counts, cfg, n_sp * nbl + n_sp - 1)
        run = lambda: tsh.sharded_hpri_blocked(x, sep.cfg_h, sep.cfg_p, mesh)  # noqa: E731
        got, _ = counted(run, counts, f"sharded_hpri_blocked sp={n_sp}")
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"sharded_hpri_blocked sp={n_sp} differs from process_blocked()")
        resumed = ""
        if n_sp == 4:
            class Killed(Exception):
                pass

            def kill(b, nbl):
                raise Killed

            with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
                ck = dict(ckpt_dir=tmp, tag="track", ckpt_every_blocks=1)
                try:
                    tsh.sharded_hpri_blocked(x, sep.cfg_h, sep.cfg_p, mesh, on_segment=kill, **ck)
                    require(False, "the kill did not fire")
                except Killed:
                    pass
                got, t_ck = timed(lambda: synced(
                    lambda: tsh.sharded_hpri_blocked(x, sep.cfg_h, sep.cfg_p, mesh, **ck)))
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    "the resumed checkpointed sharded scan differs from process_blocked()")
            resumed = (f"; checkpointed (a segment a block) killed after its first segment "
                       f"and resumed: bitwise equal, the resume {t_ck:.3f} s")
        print(f"phase 20 (b) sharded_hpri_blocked sp={n_sp}, 4-minute track, against "
              f"process_blocked(): bitwise equal{resumed}; {wall_s(run, 1):.3f} s wall against "
              f"{t_plain:.3f} s; launches {nonzero(counts)} [{smi}]")
    del x, want, got

    # (c) frequency TP on the clip against process() with the exact C2C transform
    c2c = HPRIOffline(OFFLINE_FS, 4096, 256, 2.5, 2.5, fast_rfft=False, device=DEVICE)
    clip = batch[0]
    t_plain = wall_s(lambda: c2c.process(clip))
    for n_tp in (4, 2):
        mesh = card_mesh({"tp": n_tp})
        run = lambda: tsh.tp_hpri_offline(clip, c2c.cfg_h, c2c.cfg_p, mesh)  # noqa: E731
        counts = add_pass(add_pass(zero(), c2c.cfg_h, n_tp), c2c.cfg_p, n_tp)
        got, _ = counted(run, counts, f"tp_hpri_offline tp={n_tp}")
        for o in got:
            require(o.shape == clip.shape and bool(torch.isfinite(o).all()),
                    f"tp_hpri_offline tp={n_tp}: stems {tuple(o.shape)}")
        st = hold_passes(f"tp={n_tp}", (c2c.cfg_h, c2c.cfg_p), clip,
                         lambda a, c: tp_pass(a, c, mesh), TP_ATOL)
        print(f"phase 20 (c) tp_hpri_offline tp={n_tp}, clip, against process() (fast_rfft "
              f"off): {held_text(False, st, TP_ATOL, 'pass by pass ')}; "
              f"{wall_s(run) * 1e3:.2f} ms wall against "
              f"{t_plain * 1e3:.2f} ms; launches {nonzero(counts)} [{smi}]")
    del batch

    # (d) fleets sharded over dp
    for c, b, n_blocks in ((64, 32, 16), (FLEET_STREAMS, FLEET_BLOCK, 8)):
        audio = fleet_audio(c, n_blocks * b * FLEET_HOP, 44100.0)
        blocks = torch.from_numpy(audio).to(DEVICE).reshape(c, n_blocks, b, FLEET_HOP)
        one = MultiStreamHPR(c, 44100.0, hop=FLEET_HOP, device=DEVICE)
        ms = MultiStreamHPR(c, 44100.0, hop=FLEET_HOP, mesh=card_mesh({"dp": 4}))
        one.warmup((b,))
        ms.warmup((b,))
        want = torch.cat([one.process_block(blocks[:, j]) for j in range(n_blocks)], dim=2)
        counts = add_pass(zero(), ms.cfg, 4 * n_blocks)
        got, _ = counted(lambda: torch.cat([ms.process_block(blocks[:, j])
                                            for j in range(n_blocks)], dim=2),
                         counts, f"MultiStreamHPR {c} dp=4")
        bitwise = torch.equal(got, want)
        st = None
        if not bitwise:
            sizes, per = [b] * n_blocks, c // 4
            m_s = torch.cat([stream_masks(ms.cfg, audio[i * per : (i + 1) * per], sizes, DEVICE)
                             for i in range(4)], dim=1)
            st = hold_masks(m_s, stream_masks(ms.cfg, audio, sizes, DEVICE), FLEET_HOP,
                            got.cpu().numpy(), want.cpu().numpy(),
                            ("harmonic", "percussive", "residual"))
        step = blocks[:, 0]
        print(f"phase 20 (d) MultiStreamHPR {c} x hop {FLEET_HOP} B={b} at dp=4, {n_blocks} "
              f"blocks, against the unsharded fleet: {held_text(bitwise, st)}; "
              f"{wall_us_per_call(lambda: ms.process_block(step), TIMED_RUNS):.1f} us/step wall "
              f"against {wall_us_per_call(lambda: one.process_block(step), TIMED_RUNS):.1f}; "
              f"launches {nonzero(counts)} [{smi}]")

    # (e) the CLI's --mesh surfaces on this card
    hps = ["--hps", "4096", "2.5", "256", "2.5"]
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        wav = tmp / "clip.wav"
        write_audio_pcm16(str(wav), int(OFFLINE_FS),
                          peak_normalize(synthetic_mix(CLIP_SAMPLES, OFFLINE_FS, seed=7)))
        fs, audio = read_audio_mono(str(wav))
        mesh1 = card_mesh({"tp": 1})
        counts = add_pass(add_pass(zero(), c2c.cfg_h, 1), c2c.cfg_p, 1)
        lines, wall = counted(lambda: zen_cli(["offline", "-i", wav, *hps, "-o", tmp / "tp1",
                                               "--mesh", "tp=1", "--device", DEVICE]),
                              counts, "zen-torch offline --mesh tp=1")
        require("\tmesh: tp=1 (frequency-sharded)" in lines, f"offline --mesh stdout {lines}")
        write_stems(tmp / "ref", "wav",
                    tsh.tp_hpri_offline(audio, sep.cfg_h, sep.cfg_p, mesh1), fs)
        _, wall_plain = timed(lambda: zen_cli(["offline", "-i", wav, *hps, "-o", tmp / "plain",
                                               "--device", DEVICE]))
        levels = {}
        for name in CLI_STEMS:
            require(same_bytes(tmp / f"tp1_{name}.wav", tmp / f"ref_{name}.wav"),
                    f"offline --mesh tp=1 {name}: differs from tp_hpri_offline's")
            a, b = (np.round(read_audio_mono(str(tmp / f"{k}_{name}.wav"))[1].astype(np.float64)
                             * 32768) for k in ("tp1", "plain"))
            levels[name] = int(np.abs(a - b).max())
        print(f"phase 20 (e) zen-torch offline --mesh tp=1, clip WAV: stems byte-equal to the "
              f"writer over tp_hpri_offline (tp=1 is the partial-DFT transform with every bin, "
              f"not the unsharded command's cuFFT: largest PCM16 level difference to it "
              f"{levels}); command {wall:.2f} s against {wall_plain:.2f} s; launches "
              f"{nonzero(counts)} [{smi}]")

        x = fleet_audio(64, 8 * FLEET_BLOCK * FLEET_HOP, 44100.0)
        argv = ["stream", "--streams", "64", "--fs", "44100", "--hop", str(FLEET_HOP),
                "--block-hops", str(FLEET_BLOCK), "--device", DEVICE]
        plain, wall_plain = timed(lambda: zen_stream(argv, interleave(x))[0])
        counts = add_pass(zero(), one.cfg, 8 + 1)  # eight blocks and the warmup's one
        (out, err), wall = counted(lambda: zen_stream([*argv, "--mesh", "dp=1"], interleave(x)),
                                   counts, "zen-torch stream --mesh dp=1")
        require(out == plain and json.loads(err[-1])["mesh"] == "dp=1",
                f"stream --mesh dp=1: output differs from the unsharded command's, {err[-1:]}")
        try:
            wide, _ = zen_stream([*argv, "--mesh", "dp=2"], interleave(x))
            require(cards >= 2 and wide == plain,
                    f"stream --mesh dp=2 on {cards} cards differs from the unsharded command's")
            dp2 = f"ran on {cards} cards, output byte-equal"
        except ZenError as e:
            require(cards < 2 and str(e) == "mesh axes {'dp': 2} need 2 devices, got 1",
                    f"stream --mesh dp=2 on {cards} cards: {e}")
            dp2 = f"refused with make_mesh's ZenError: {e}"
        print(f"phase 20 (e) zen-torch stream --streams 64 --mesh dp=1: stdout byte-equal to the "
              f"unsharded command's, mesh \"dp=1\"; {wall:.2f} s against {wall_plain:.2f} s; "
              f"launches {nonzero(counts)}; --mesh dp=2 on {cards} card(s): {dp2} [{smi}]")

        src = tmp / "tracks"
        src.mkdir()
        for seed, secs in ((30, 20), (31, 25)):
            write_audio_pcm16(str(src / f"t{seed}.wav"), 44100,
                              peak_normalize(synthetic_mix(secs * 44100, 44100.0, seed=seed)))
        items = [(str(p), 44100, len(read_audio_mono(str(p))[1])) for p in sorted(src.iterdir())]
        cargv = ["corpus", "-i", src / "*.wav", "--device", DEVICE]
        _, wall_plain = timed(lambda: zen_cli([*cargv, "-o", tmp / "c_plain"]))
        lines, wall = counted(lambda: zen_cli([*cargv, "-o", tmp / "c_mesh",
                                               "--mesh", "dp=1,sp=1"]),
                              corpus_launches(items), "zen-torch corpus --mesh dp=1,sp=1")
        require(lines[0] == f"corpus: 2 tracks, mesh {{'dp': 1, 'sp': 1}}, out={tmp / 'c_mesh'}",
                f"corpus --mesh stdout {lines}")
        for p, _, _ in items:
            for name in CLI_STEMS:
                f = f"{Path(p).stem}_{name}.wav"
                require(same_bytes(tmp / "c_mesh" / f, tmp / "c_plain" / f),
                        f"corpus --mesh dp=1,sp=1 {f}: differs from the unsharded command's")
        print(f"phase 20 (e) zen-torch corpus --mesh dp=1,sp=1, 2 tracks (45 s): every stem "
              f"byte-equal to the command without --mesh; {wall:.2f} s against "
              f"{wall_plain:.2f} s; launches {nonzero(corpus_launches(items))} [{smi}]")
    return total


# ---------------- the instruments and the entry points ----------------


def no_launches() -> dict:
    return dict.fromkeys(read_launches(), 0)


def phase_headline(smi: str) -> dict:
    """benches/headline at full width in-process: bench.py's rows (device
    and wall), its JSON line, and the 4-minute track's peak memory; the
    launches from each row's calls (SSE launches no median)."""
    from zen_tpu_torch.benches import headline, write_artifact
    from zen_tpu_torch.drivers.offline import _Blocking

    sizes = headline.SIZES[False]

    def want_of(result):
        calls, want = result["calls"], no_launches()
        rows = headline.stream_rows(sizes)
        for name, (cfg, _, _) in rows.items():
            if not cfg.use_sse:
                add_pass(want, cfg, calls[name])
        add_pass(want, rows["hop1024"][0], calls["round_trip"])
        sep = headline.offline_separator(sizes, DEVICE)
        for cfg, bf in ((sep.cfg_h, 512), (sep.cfg_p, 8192)):
            add_pass(want, cfg, calls["offline_clip"] + calls["track_process"])
            add_pass(want, cfg, calls["track_process_blocked"]
                     * _Blocking.of(sizes["track"], cfg, bf).n_blocks)
        return want

    total, counted = launch_ledger()
    result, _ = counted(
        lambda: headline.measure(headline.parse(["--device", DEVICE]),
                                 log=lambda line: print(f"phase 21 headline {line} [{smi}]")),
        want_of, "headline")
    line = headline.headline_line(result)
    row = result["rows"]["hop1024"]
    require(all(v is not None and math.isfinite(v) and v > 0
                for r in result["rows"].values() for k, v in r.items()
                if k.endswith(("_us_per_hop", "_ms", "wall_us"))),
            f"headline rows {result['rows']}")
    require(line["value"] == round(row["device_us_per_10ms"], 2) and "smoke" not in line,
            f"headline line {line}")
    mem = result["memory"]
    require(mem["process_peak_bytes"] > 0 and mem["process_blocked_peak_bytes"] > 0,
            f"headline memory {mem}")
    path = write_artifact(result, None, "headline.json")
    print(f"phase 21 headline line {json.dumps(line)}; artifact {path.relative_to(ROOT)}; "
          f"launches {nonzero(total)} [{smi}]")
    return total


def dryrun_launches(n: int, flip_ruled: int) -> dict:
    """dryrun_multichip(n)'s launches from its shapes: both passes on n
    shards for every factorization (twice more, both meshes, for each one
    held under the flip rule), TP on its width's shards, the dp fleet's
    two blocks on n shards, and the sp blocked scan twice (each shard's
    blocks and the block before each span but the first)."""
    from zen_tpu_torch import entry
    from zen_tpu_torch.parallel import sharded as tsh

    cfg_h, cfg_p, cfg_tp, cfg_stream = entry.dryrun_configs()
    counts = no_launches()
    passes = len(entry._factorizations(n)) + 2 * flip_ruled
    for cfg in (cfg_h, cfg_p):
        add_pass(counts, cfg, n * passes)
    add_pass(counts, cfg_tp, entry.dryrun_tp_width(n))
    add_pass(counts, cfg_stream, 2 * n)
    length = cfg_p.hop * (cfg_p.stft_width + 2) * n * 2
    _, nbl = tsh._sharded_blocking(length, cfg_h, 8, n)
    add_pass(counts, cfg_h, 2 * (n * nbl + n - 1))
    return counts


def phase_entry(smi: str) -> dict:
    """entry()'s flagship step on the card against entry(device="cpu") on
    the same blocks, under the flip rule; then dryrun_multichip(4) on four
    virtual shards of the card."""
    from zen_tpu_torch.entry import dryrun_multichip, entry, entry_config

    cfg = entry_config()
    n_blocks = 16
    audio = synthetic_mix(n_blocks * 32 * cfg.hop, cfg.fs, seed=22)
    blocks = torch.from_numpy(audio).reshape(n_blocks, 32, cfg.hop)

    def steps(device):
        fn, (state, block) = entry(device)
        require(tuple(block.shape) == (32, cfg.hop) and block.device.type == device,
                f"entry example block {tuple(block.shape)} on {block.device}")
        x = blocks.to(device)
        return torch.cat([fn(state, x[j])[1] for j in range(n_blocks)], dim=1)

    total, counted = launch_ledger()
    got, _ = counted(lambda: steps(DEVICE), add_pass(no_launches(), cfg, n_blocks), "entry()")
    want = steps("cpu")
    r = compare_stream(cfg, audio[None], [32] * n_blocks, got.cpu().numpy()[None],
                       want.numpy()[None], ("harmonic", "percussive", "residual"))
    print(f"phase 22 entry() fn: block_step hop {cfg.hop} B=32, {n_blocks} blocks, against "
          f"entry(device='cpu'): mask flips {r['flips']} ({r['share']:.3g} of bins), excluded "
          f"hops {r['excluded']}/{r['hops']}, max |diff|/scale {r['rel_err']:.3g} (limit "
          f"{STEM_ATOL}); launches {nonzero(add_pass(no_launches(), cfg, n_blocks))} [{smi}]")
    with contextlib.redirect_stdout(io.StringIO()):  # it prints the line it returns
        line, wall = counted(lambda: dryrun_multichip(4, device=DEVICE),
                             lambda line: dryrun_launches(4, line.count("flip rule")),
                             "dryrun_multichip(4)")
    print(f"phase 22 {line}; {wall:.2f} s; launches "
          f"{nonzero(dryrun_launches(4, line.count('flip rule')))} [{smi}]")
    return total


def phase_fuzz(smi: str) -> dict:
    """tools/fuzz_parity on the card, four random cases a mode (seed 0):
    every valid case agrees at its mode's class, every refusal is a
    ZenError. The cases' shapes are random, so the launches are read (K1
    and K2 must each have launched), not counted from them."""
    from zen_tpu_torch.tools import fuzz_parity

    torch.cuda.synchronize()
    reset_launches()
    for mode, sweep in fuzz_parity.MODES.items():
        t0 = time.perf_counter()
        ran, skipped = sweep(0, 4, torch.device(DEVICE),
                             log=lambda line: print(f"phase 23 fuzz {line}"))
        print(f"phase 23 fuzz PARITY SWEEP PASS: {ran} ran, {skipped} validated-rejected "
              f"(seed=0, mode={mode}, device={DEVICE}); {time.perf_counter() - t0:.1f} s "
              f"[{smi}]")
    torch.cuda.synchronize()
    counts = read_launches()
    require(all(v > 0 for v in per_kernel(counts).values()), f"fuzz launches {counts}")
    print(f"phase 23 fuzz launches {nonzero(counts)}")
    return counts


def phase_kernels_sweep(smi: str) -> dict:
    """benches/kernels --quick on the card: each route by name, the plain
    twin, the library call and the transforms across sizes, with the
    complexity fits; launches counted from the rows that go through the
    wrappers (the block steps, the _MEM medians); the launches each
    route's rows make by route name, which no wrapper counts, are summed
    into BY_ROUTE from the calls the sweep reports."""
    from zen_tpu_torch.benches import kernels, write_artifact
    from zen_tpu_torch.ops import median_cuda as mc

    def want_of(result):
        want = no_launches()
        for name, n in result["calls"].items():
            kind, shape = name.split("/")
            if kind.startswith("hpr_block_step"):
                add_pass(want, kernels.stream_config(44100.0, int(shape[3:].split("x")[0])), n)
            else:  # a _MEM median on [t, f] (shape K{k}_{t}x{f}), through its wrapper
                k, t, f = map(int, shape[1:].replace("_", "x").split("x"))
                sms = mc._sm_count(torch.device(DEVICE))
                key = (f"sliding_median_boundary/{mc.freq_call_route(k, t, f, 'reflect', sms)}"
                       if "freq" in kind else "tap_median_time/" + mc.time_call_route(
                           tuple(range(-(k // 2), k // 2 + 1)), 0, t, 1, f, sms))
                want[key] += n
        return want

    total, counted = launch_ledger()
    result, wall = counted(
        lambda: kernels.run(kernels.parse(["--quick", "--device", DEVICE]),
                            log=lambda line: print(f"phase 24 kernels {line}")),
        want_of, "kernels --quick")
    require(all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in result["rows"]),
            "kernels rows")
    for name, n in result["route_calls"].items():
        kind = name.split("/")[0]
        wrapper = ("sliding_median_boundary" if kind.startswith("median_freq")
                   else "tap_median_time")
        key = f"{wrapper}/{kind.split('_')[2]}"
        BY_ROUTE[key] = BY_ROUTE.get(key, 0) + n
    (ROOT / "build").mkdir(exist_ok=True)
    kernels.write_csv(ROOT / "build" / "kernels_quick.csv", result)
    path = write_artifact(result, None, "kernels.json")
    print(f"phase 24 kernels --quick: {len(result['rows'])} rows in {wall:.1f} s; artifacts "
          f"build/kernels_quick.csv, {path.relative_to(ROOT)}; launches {nonzero(total)}, "
          f"and by route name (no wrapper counts them) {BY_ROUTE} [{smi}]")
    return total


def phase_soak(smi: str) -> dict:
    """benches/soak, short: 64 streams at hop 256, 4 dispatches of 64
    steps, the stats reduced on the card and read once a dispatch."""
    from zen_tpu_torch.benches import soak

    args = soak.parse(["--steps", "64", "--dispatches", "4", "--device", DEVICE])
    cfg = soak.Soak(args).ms.cfg
    total, counted = launch_ledger()
    (line, rc), _ = counted(lambda: soak.run(args),
                            lambda out: add_pass(no_launches(), cfg, out[0]["steps"]), "soak")
    require(rc == 0 and line["finite"] is True and line["steps"] == 4 * 64, f"soak {line}")
    print(f"phase 25 soak {json.dumps(line)}; launches {nonzero(total)} [{smi}]")
    return total


def phase_scaling(smi: str) -> dict:
    """benches/scaling on meshes of 1, 2 and 4 (virtual past 1 on one
    card: they measure one host loop's dispatch, not scaling), and the
    one-card streams curve at 1, 8, 64 and 512 streams."""
    from zen_tpu_torch import HPRConfig, OUTPUT_ALL
    from zen_tpu_torch.benches import scaling

    args = scaling.parse(["--devices", "1,2,4", "--mesh-legs", "--chip-streams", "1,8,64,512",
                          "--device", DEVICE])
    fleet = HPRConfig(fs=args.fs, hop=args.hop, causal=True, outputs=OUTPUT_ALL)
    track = HPRConfig(fs=args.fs, hop=args.hop, causal=False, outputs=OUTPUT_ALL)
    curve = scaling.stream_config(args.fs, args.hop)

    def want_of(out):
        want = no_launches()
        for key, n in out[0]["calls"].items():
            leg, size = key.split("/")
            cfg, shards = {"dp": (fleet, int(size)), "sp": (track, int(size)),
                           "chip": (curve, 1)}[leg]
            add_pass(want, cfg, n * shards)
        return want

    total, counted = launch_ledger()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        (result, line), _ = counted(lambda: scaling.run(args), want_of, "scaling")
    for text in out.getvalue().splitlines():
        print(f"phase 26 scaling {text}")
    require(line["virtual"] is True and all(
        result[f"{leg}_rows"][n]["virtual"] == (n > torch.cuda.device_count())
        for leg in ("dp", "sp") for n in (1, 2, 4)), f"scaling rows {result}")
    print(f"phase 26 scaling {json.dumps(line)}; launches {nonzero(total)} [{smi}]")
    return total


def phase_io_codec(smi: str) -> None:
    """benches/io_codec on 5 s of audio: the native codecs' rungs, host
    only (no launch)."""
    from zen_tpu_torch.benches import io_codec

    _, counted = launch_ledger()
    result, wall = counted(
        lambda: io_codec.run(io_codec.parse(["--seconds", "5"]),
                             log=lambda line: print(f"phase 27 io_codec {line}")),
        no_launches(), "io_codec")
    print(f"phase 27 io_codec: {len(result['rows'])} rungs in {wall:.2f} s; host "
          f"{result['host']} [{smi}]")


def phase_live_tools(smi: str) -> dict:
    """tools/feed_wav_realtime on 2.5 s of audio at wall-clock rate, its
    percussive file byte-equal to HPRRealtime's on the card over the same
    padded blocks; tools/ab_reference on the port's own strict-ref stems
    (passes) and with one stem corrupted (fails)."""
    import tempfile

    from zen_tpu_torch import HPRIOffline, HPRRealtime
    from zen_tpu_torch.io.audio import peak_normalize, read_audio_mono, write_wav_pcm16
    from zen_tpu_torch.tools import ab_reference, feed_wav_realtime

    (ROOT / "build").mkdir(exist_ok=True)
    total, counted = launch_ledger()
    fs, hop, block_hops = 44100, 256, 16
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        audio = synthetic_mix(int(2.5 * fs), float(fs), seed=28)
        wav = tmp / "mix.wav"
        write_wav_pcm16(str(wav), fs, peak_normalize(audio))
        cfg = HPRRealtime(float(fs), hop, device="cpu").cfg
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            st, _ = counted(
                lambda: feed_wav_realtime.main([str(wav), str(tmp / "perc.wav"), str(hop),
                                                "--device", DEVICE]),
                # the warmup's block and every block the ring filled
                lambda st: add_pass(no_launches(), cfg, st["blocks"] + 1), "feed_wav_realtime")
        print(f"phase 28 feed_wav_realtime {out.getvalue().splitlines()[0]}")
        n = len(audio)
        # (the harmonic and residual rings are never read, so they overflow)
        require(st["recovered"] == n and st["overruns"] == 0, f"feed_wav_realtime {st}")
        x = read_audio_mono(str(wav))[1]
        padded = np.zeros(-(-n // (block_hops * hop)) * block_hops * hop, np.float32)
        padded[:n] = x
        ref = HPRRealtime(float(fs), hop, device=DEVICE).process_stream(padded, block_hops)
        write_wav_pcm16(str(tmp / "ref.wav"), fs, peak_normalize(ref[1, :n]))
        require(same_bytes(tmp / "perc.wav", tmp / "ref.wav"),
                "feed_wav_realtime's stem differs from HPRRealtime's over the same blocks")
        print(f"phase 28 feed_wav_realtime hop {hop}, {st['blocks']} blocks of {block_hops} "
              f"hops: {st['audio_s']:.2f} s of audio in {st['wall_s']:.2f} s wall (latest "
              f"push {st['max_late_s'] * 1e3:.2f} ms behind the clock); the percussive file "
              f"byte-equal to HPRRealtime's on the card; launches "
              f"{nonzero(add_pass(no_launches(), cfg, st['blocks'] + 1))} [{smi}]")

        mix = tmp / "ab_mix.wav"
        write_wav_pcm16(str(mix), fs, peak_normalize(synthetic_mix(3 * fs, float(fs), seed=29)))
        ref_prefix = tmp / "ref"
        sep = HPRIOffline(float(fs), 4096, 256, strict_ref=True, device="cpu")
        one = add_pass(add_pass(no_launches(), sep.cfg_h, 1), sep.cfg_p, 1)
        counted(lambda: zen_cli(["offline", "-i", mix, "-o", ref_prefix, "--hps", "4096", "2.0",
                                 "256", "2.0", "--strict-ref", "--device", DEVICE]),
                one, "zen-torch offline --strict-ref")
        verdicts = []
        for what in ("self", "corrupt"):
            if what == "corrupt":
                rng = np.random.default_rng(30)
                write_wav_pcm16(f"{ref_prefix}_perc.wav", fs,
                                0.5 * rng.standard_normal(3 * fs).astype(np.float32))
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc, _ = counted(lambda: ab_reference.main(
                    [str(mix), str(ref_prefix), "--device", DEVICE]), one, f"ab_reference {what}")
            rep = json.loads(out.getvalue().splitlines()[-1])
            require((rc, rep["pass"]) == ((0, True) if what == "self" else (1, False)),
                    f"ab_reference on {what} stems: exit {rc}, {rep}")
            verdicts.append(f"{what}: exit {rc}, worst {rep['worst_snr_db']} dB, "
                            + ", ".join(f"{k} {v['snr_db'] if v['status'] == 'compared' else v['status']}"
                                        for k, v in rep["stems"].items()))
        print(f"phase 29 ab_reference, 3 s at 44.1 kHz against the port's own strict-ref "
              f"stems ({verdicts[0]}) and with the percussive stem corrupted ({verdicts[1]}); "
              f"launches {nonzero({k: 3 * v for k, v in one.items()})} (three cascades) [{smi}]")
    return total


# ---------------- the multi-process corpus ----------------


def mesh_corpus_launches(items, dp: int, sp: int, procs: int, long_cut: int | None,
                         long_passes: int = 2) -> list:
    """The median launches of each of ``procs`` processes running
    separate_corpus over ``items`` on the global mesh dp x sp, the long
    threshold ``long_cut`` x sp (None: the default), counted from the
    shapes: each batch is one sharded_hpri_offline, whose dp x sp shards
    (each process its own) run one K1 and one K2 a pass; a long track at
    sp > 1 is the sharded blocked scan, each process scanning the ring
    positions it owns (make_mesh's block: process p's at unravel_index(p,
    (gcd(procs, dp), procs / gcd))), every block of each and the block
    before each span but the first; at sp = 1 process 0's process_blocked.
    ``long_passes`` 1: a long track's pass 1 resumed whole from its
    checkpoint (one segment), pass 2 run."""
    from zen_tpu_torch.drivers.offline import _Blocking
    from zen_tpu_torch.parallel import sharded as tsh

    per = [dict.fromkeys(read_launches(), 0) for _ in range(procs)]
    dcn_dp = math.gcd(procs, dp)
    dcn_sp = procs // dcn_dp
    batches, long_tracks = corpus_plan(items, dp, None if long_cut is None else long_cut * sp)
    for batch in batches:
        sep = corpus_separator(batch[0][1])
        for cfg in (sep.cfg_h, sep.cfg_p):
            for counts in per:
                add_pass(counts, cfg, dp * sp // procs)
    for _, fs, n in long_tracks:
        sep = corpus_separator(fs)
        for cfg, bf in ((sep.cfg_h, 512), (sep.cfg_p, 8192))[2 - long_passes:]:
            if sp > 1:
                _, nbl = tsh._sharded_blocking(n, cfg, bf, sp)
                span = sp // dcn_sp
                for p, counts in enumerate(per):
                    own = range(p % dcn_sp * span, (p % dcn_sp + 1) * span)
                    add_pass(counts, cfg, sum(nbl + (d > 0) for d in own))
            else:
                add_pass(per[0], cfg, _Blocking.of(n, cfg, bf).n_blocks)
    return per


def tp_leg_launches(procs: int) -> list:
    """Each process's median launches in the tp leg: tp_hpri_offline at tp
    2 and 4 over ``procs`` processes, one K1 and one K2 a pass on each
    shard a process owns."""
    from zen_tpu_torch import HPRIOffline
    from zen_tpu_torch.tools import multihost_smoke as mh

    r = mh.rings_of(DEVICE)
    sep = HPRIOffline(r.fs, r.hop_h, r.hop_p, r.beta, r.beta, fast_rfft=False, device="cpu")
    per = [no_launches() for _ in range(procs)]
    for counts in per:
        for cfg in (sep.cfg_h, sep.cfg_p):
            add_pass(counts, cfg, (2 + 4) // procs)
    return per


def fleet_leg_launches(procs: int, n_dp: int) -> list:
    """Each process's median launches in the fleet leg: MultiStreamHPR over
    {"dp": n_dp}, one K1 and one K2 a step on each of its shards."""
    from zen_tpu_torch import MultiStreamHPR
    from zen_tpu_torch.tools import multihost_smoke as mh

    r = mh.rings_of(DEVICE)
    cfg = MultiStreamHPR(r.streams, r.fleet_fs, r.hop, device="cpu").cfg
    return [add_pass(no_launches(), cfg, n_dp // procs * r.steps) for _ in range(procs)]


def phase_multihost(smi: str) -> dict:
    """The multi-process paths on this one card (tools/multihost_smoke.py
    --device cuda, in-process as its orchestrator; the workers are
    processes sharing the card by time slicing, so their walls say nothing
    about scaling): the corpus command's defaults (44.1 kHz,
    4096/2.0/256/2.0), four tracks of 10-30 s and one of 50 s routed long
    by the workers' lowered LONG_TRACK_SAMPLES. N = 2: the corpus over
    dp = N x sp = 2 (each ring inside a process), killed before the last
    track and resumed, `python -m zen_tpu_torch corpus --nprocs 2` against
    the golden dp = 2 x 1 run; the sp leg (`zen-torch corpus --mesh sp=N
    --nprocs N`: one ring cut across the processes, the long track's
    blocked scan too), then killed before the long track's pass 2 and
    resumed (sp_resume);
    the tp leg (tp_hpri_offline at BASELINE.json configs[0] on the
    161,571-sample clip, tp 2 and 4 over 2 processes); the fleet leg
    (MultiStreamHPR 64 streams x hop 256, B=32, over dp = 2). N = 3: the
    dp x sp corpus and the sp leg. Every process's stems and rows
    byte-equal to the golden single-process run's (this process on the
    same global mesh of the card repeated); every process's launches
    equal its count from the shapes (the CLI leg's processes report
    none). Each leg's wall, each process's exchanges (bytes sent and
    seconds waited: halos, ordered sums, gathers, agreements) and
    launches by kernel are printed. Then `zen-torch corpus --pp` and
    separate_corpus(pp=True) on a dp = 2 mesh of the card (the pipeline
    given the card twice) on the short tracks: byte-equal stems."""
    import shutil
    import tempfile

    from zen_tpu_torch.drivers.corpus import separate_corpus
    from zen_tpu_torch.io.audio import read_audio_mono
    from zen_tpu_torch.tools import multihost_smoke as mh

    total, counted = launch_ledger()
    corpus = mh.corpus_of(DEVICE)
    for n, legs in ((2, "run,resume,cli,sp,sp_resume,tp,fleet"), (3, "run,sp")):
        args = mh.parse(["--device", DEVICE, "--nprocs", str(n), "--legs", legs,
                         "--timeout", "300"])
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            args.work, args.corpus_dir = work, os.path.join(work, "corpus")
            torch.cuda.synchronize()
            report = mh.run_legs(args)
            paths = sorted(str(p) for p in Path(args.corpus_dir).glob("*.wav"))
            items = []
            for p in paths:
                fs, audio = read_audio_mono(p)
                items.append((p, fs, len(audio)))
            done = report["legs"].get("resume", {}).get("done_before", 0)
            sp_done = report["legs"].get("sp_resume", {}).get("done_before", 0)
            cut2, cut_n = mh.long_cut(corpus, 2), mh.long_cut(corpus, n)
            want = {"golden": mesh_corpus_launches(items, n, 2, 1, cut2),
                    "run": mesh_corpus_launches(items, n, 2, n, cut2),
                    "resume": mesh_corpus_launches(items[done:], n, 2, n, cut2),
                    "cli_golden": mesh_corpus_launches(items, n, 1, 1, None),
                    "sp_golden": mesh_corpus_launches(items, 1, n, 1, cut_n),
                    "sp": mesh_corpus_launches(items, 1, n, n, cut_n),
                    "sp_resume": mesh_corpus_launches(items[sp_done:], 1, n, n, cut_n, 1),
                    "tp_golden": tp_leg_launches(1), "tp": tp_leg_launches(2),
                    "fleet_golden": fleet_leg_launches(1, n), "fleet": fleet_leg_launches(n, n)}
            for name, leg in report["legs"].items():
                if name == "cli":
                    continue  # the command's processes: launches nobody reads
                for w in leg["workers"]:
                    got, counts = w["launches"], want[name][w["worker"]]
                    require(by_route(got) == by_route(counts),
                            f"multihost N={n} {name} process {w['worker']}: launches "
                            f"{nonzero(got)}, counted from the shapes {nonzero(counts)}")
                    for k in total:
                        total[k] += got[k]
                per = "; ".join(f"process {w['worker']}: {w['wall_s']:.2f} s, exchanges "
                                f"[{mh.traffic_line(w['traffic']) or 'none'}], launches "
                                f"{per_kernel(w['launches'])}" for w in leg["workers"])
                print(f"phase 30 multihost N={n} {name}: {leg['wall_s']:.2f} s "
                      f"({'this process' if 'golden' in name else 'the processes'}); {per}; "
                      f"as counted from the shapes [{smi}]")
            run = report["legs"]["run"]
            require(all(w["owners"] == [[i] for i in range(n)] for w in run["workers"]),
                    f"an sp ring spans processes: {[w['owners'] for w in run['workers']]}")
            lines = report["legs"]["sp"]["mesh_lines"]
            require(all(f"mesh {{'sp': {n}, 'dp': 1}}" in line for line in lines) and
                    len(lines) == n, f"sp leg's mesh lines {lines}")
            extra = ""
            if "resume" in report["legs"]:
                extra = (f"; killed after {done} journaled tracks (before the last), resumed: "
                         f"{report['legs']['resume']['workers'][0]['results']}, byte-equal; "
                         f"`python -m zen_tpu_torch corpus --nprocs {n}`: "
                         f"{report['legs']['cli']['wall_s']:.2f} s, byte-equal to the dp={n} x 1 "
                         "golden run")
            if "tp" in report["legs"]:
                extra += ("; tp 2 and tp 4 over 2 processes and the dp=2 fleet (a reset "
                          "across the split): every process byte-equal")
            if "sp_resume" in report["legs"]:
                extra += (f"; `--mesh sp={n}` killed after {sp_done} journaled tracks and "
                          "resumed, byte-equal")
            print(f"phase 30 multihost N={n}: {report['tracks']} tracks, every stem byte-equal to "
                  f"the golden run's; no sp ring across processes in the run legs; `--mesh "
                  f"sp={n}` over {n} processes byte-equal{extra} [{smi}]")
            if n == 2:
                short = paths[:4]
                short_items = items[:4]
                out_pp, out_pp2 = Path(work) / "pp", Path(work) / "pp2"
                _, wall_pp = counted(
                    lambda: zen_cli(["corpus", "-i", *short, "-o", out_pp, "--pp", "--hps",
                                     corpus.hop_h, 2.0, corpus.hop_p, 2.0, "--device", DEVICE]),
                    corpus_launches(short_items), "corpus --pp")
                res, wall_pp2 = counted(
                    lambda: separate_corpus(short, str(out_pp2), card_mesh({"dp": 2}), pp=True,
                                            hop_h=corpus.hop_h, hop_p=corpus.hop_p),
                    corpus_launches(short_items), "separate_corpus(pp, devices=[card, card])")
                require(res == {"done": 0, "processed": 4}, f"pp on dp=2: {res}")
                require(mh.stems(out_pp) == mh.stems(out_pp2),
                        "the pipeline given the card twice differs from phase 18's --pp route")
                shutil.rmtree(out_pp)
                shutil.rmtree(out_pp2)
                print(f"phase 30 corpus --pp on {len(short)} tracks: zen-torch corpus --pp "
                      f"(devices [card]) {wall_pp:.2f} s, separate_corpus(pp=True) on a dp=2 mesh "
                      f"(devices [card, card]) {wall_pp2:.2f} s: stems byte-equal [{smi}]")
    require(all(v > 0 for v in per_kernel(total).values()), f"multihost launches {total}")
    return total


def median2d_cases() -> list:
    """(label, x, filter_len, direction, border) of phase 31: every
    direction x border at the offline cascade's full spectrogram widths
    (HPRIOffline(44100, 4096, 256, 2.5, 2.5) on the 4-minute track: pass
    1's [2585, 8193] at its frequency fl 187, K2's rank route, and time fl
    17, K1's network; pass 2's [41355, 513] at its time fl 11, K1's
    network, and frequency fl 13, K2's network), K1's rank route (time fl
    93), bf16, tests/test_ops.py's marked matrix, +inf rows and a column,
    a matrix both filters outreach (fl 13 on [9, 9]: wrap goes round more
    than once, 'valid' launches nothing) and a transposed view with
    leading dims."""
    from zen_tpu_torch.ops.median import (BORDERS, DIRECTIONS, FREQUENCY, REPLICATE,
                                          TIME_ANTICAUSAL, TIME_CAUSAL, VALID, WRAP)

    rng = np.random.default_rng(31)
    pass1 = _mags(rng, TRACK_FRAMES_H, 8193)
    pass2 = _mags(rng, TRACK_FRAMES_P, 513)
    marked = torch.zeros(64, 17, device=DEVICE)
    marked[32, :] = 5
    marked[:, 8] = 8
    infs = _mags(rng, 64, 513)
    infs[20:23, :] = float("inf")
    infs[:, 100] = float("inf")
    times = (TIME_CAUSAL, TIME_ANTICAUSAL)
    cases = []
    for label, x, fl, directions, borders in (
        (f"pass 1 [{TRACK_FRAMES_H}, 8193]", pass1, 187, (FREQUENCY,), BORDERS),
        (f"pass 1 [{TRACK_FRAMES_H}, 8193]", pass1, 17, times, BORDERS),
        (f"pass 2 [{TRACK_FRAMES_P}, 513]", pass2, 11, times, BORDERS),
        (f"pass 2 [{TRACK_FRAMES_P}, 513]", pass2, 13, (FREQUENCY,), BORDERS),
        (f"pass 2 [{TRACK_FRAMES_P}, 513]", pass2, 93, times, (WRAP, VALID)),
        (f"pass 1 [{TRACK_FRAMES_H}, 8193] bf16", pass1.to(torch.bfloat16), 187, (FREQUENCY,),
         (WRAP,)),
        (f"pass 2 [{TRACK_FRAMES_P}, 513] bf16", pass2.to(torch.bfloat16), 11, (TIME_ANTICAUSAL,),
         (REPLICATE,)),
        ("marked [64, 17]", marked, 5, DIRECTIONS, BORDERS),
        ("[64, 513] +inf rows and a column", infs, 11, DIRECTIONS, BORDERS),
        ("[9, 9] past both dims", _mags(rng, 9, 9), 13, DIRECTIONS, BORDERS),
        ("[3, 40, 65] transposed view", _mags(rng, 3, 65, 40).transpose(-1, -2), 7,
         DIRECTIONS, (WRAP, VALID)),
    ):
        cases += [(label, x, fl, d, b) for d in directions for b in borders]
    return cases


def median2d_launch(x, fl: int, direction: str, border: str):
    """The label ('kernel/route', launch_keys) of the one launch median2d
    makes for a call (zen_tpu_torch/ops/median.py: K2 at fl taps for
    frequency, K1 at fl taps for time, over x or over its T + fl - 1
    gathered rows), None where 'valid' writes no output."""
    from zen_tpu_torch.ops import median as om
    from zen_tpu_torch.ops import median_cuda as mc

    fl = om.odd_filter_len(fl)
    n = x.shape[-1 if direction == om.FREQUENCY else -2]
    if border == om.VALID and n - fl < 1:
        return None
    sms = mc._sm_count(x.device)
    lead = math.prod(x.shape[:-2])
    if direction == om.FREQUENCY:
        mode = {om.WRAP: "wrap", om.REPLICATE: "edge", om.VALID: "valid"}[border]
        return f"sliding_median_boundary/{freq_call_label(fl, lead * x.shape[-2], n, mode, sms)}"
    offsets = tuple(range(-fl + 1, 1))  # fl contiguous taps, as every time case has
    start, t_v = (0, n) if border == om.VALID else (fl - 1, n + fl - 1)
    return f"tap_median_time/{time_call_label(offsets, start, t_v, lead, x.shape[-1], sms)}"


def median2d_library(x, fl: int, direction: str, border: str):
    """One torch.kthvalue over the windows of the medians median2d
    writes, as a callable (None where it writes none): an unfold view of
    x ('valid') or of its rows or columns gathered under the border,
    built here."""
    from zen_tpu_torch.ops import median as om

    fl = om.odd_filter_len(fl)
    dim = -1 if direction == om.FREQUENCY else -2
    n = x.shape[dim]
    if border == om.VALID:
        if n - fl < 1:
            return None
        src = x.narrow(dim, 0, n - 1)
    else:
        p = torch.arange(-(fl // 2), n + fl // 2, device=x.device)
        src = x.index_select(dim, torch.remainder(p, n) if border == om.WRAP else p.clamp(0, n - 1))
    windows = src.unfold(dim, fl, 1)
    return lambda: torch.kthvalue(windows, fl // 2 + 1, dim=-1)


def glue_only(x, fl: int, direction: str, border: str):
    """median2d's mapping over stand-ins for the two kernels that launch
    nothing (an empty output of the kernel's shape), as a callable: the
    gathers, fills and pads median2d adds to its one kernel launch."""
    from zen_tpu_torch.ops import median as om

    def time_stub(a, b, offsets, start, fill=0.0):
        return a.new_empty(a.shape[:-2] + (a.shape[-2] + b.shape[-2] - start, a.shape[-1]))

    def freq_stub(v, k, mode):
        return v.new_empty(v.shape[:-1] + (v.shape[-1] - (k - 1 if mode == "valid" else 0),))

    return lambda: om.median2d_over(x, fl, direction, border, time_stub, freq_stub)


def network_form(core: int):
    """sliding_median_boundary's stand-in that forces K2's network route
    into one form: ``core`` 1 the per-output network, R > 1 the shared
    core at runs of R outputs; counts nothing."""
    from zen_tpu_torch.ops import median_cuda as mc

    return lambda v, k, mode: mc._freq_launch(v, k, mode, "network", core=core)


def register_form(form):
    """tap_median_time's stand-in that forces K1's register route into one
    form: 'network' (the per-output network at the wrapper's run) or an R
    (the shared core at runs of R outputs); counts nothing."""
    from zen_tpu_torch.ops import median_cuda as mc

    def time_median(a, b, offsets, start, fill=0.0):
        offsets = tuple(offsets)
        if form != "network":
            return mc._time_launch(a, b, offsets, start, fill, "register", core=form)
        run = mc.time_network_run(a.shape[-2] + b.shape[-2] - start, math.prod(a.shape[:-2]),
                                  a.shape[-1], offsets)
        return mc._time_launch(a, b, offsets, start, fill, "register", run=run)

    return time_median


def phase_median2d(smi: str) -> dict:
    """median2d, the reference's whole-matrix filter, through its entry
    point on every case of median2d_cases(): one counted run (each call's
    launch exactly as median2d_launch predicts), then each output held
    bitwise against median2d's mapping over the kernels' plain twins on
    the card (median2d_over) and, for the small matrices, against
    median2d_plain on the CPU; median2d's device time and its glue's
    (glue_only), the twins' time, torch.kthvalue over the same windows
    and the bound (x read once, the output written once). Every case K1's
    register route takes runs again in both of its forms (the per-output
    network, the shared core at each built R), held bitwise against the
    twins and timed, beside the form the wrapper takes. Last, a NaN
    probe: what each route gives for a window holding NaN, beside its
    twin (the kernels take magnitudes; recorded, not held)."""
    from zen_tpu_torch.ops import median as om
    from zen_tpu_torch.ops import median_cuda as mc

    cases = median2d_cases()
    reset_launches()
    want = read_launches()
    outs = []
    for _, x, fl, direction, border in cases:
        outs.append(om.median2d(x, fl, direction, border))
        key = median2d_launch(x, fl, direction, border)
        for k in launch_keys(key) if key else ():
            want[k] += 1
    torch.cuda.synchronize()
    launches = read_launches()
    require(launches == want, f"median2d launches {launches}, from the shapes {want}")
    require(all(want[f"{name}/{STEPS}"] > 0 for name in ROUTES)
            and want[f"sliding_median_boundary/{FREQ_CORE}"] > 0,
            f"median2d: no case takes a rank route's steps kernel or K2's shared core ({want})")
    for (label, x, fl, direction, border), got in zip(cases, outs):
        what = f"median2d {label} {direction}/{border} fl={fl}"
        plain = lambda x=x, f=fl, d=direction, b=border: om.median2d_over(  # noqa: E731
            x, f, d, b, mc.tap_median_time_plain, mc.sliding_median_boundary_plain)
        twin = plain()
        require(got.shape == x.shape and got.dtype == x.dtype, f"{what}: {got.shape} {got.dtype}")
        require(bool(torch.isfinite(got).all()) or "+inf" in label, f"{what}: non-finite output")
        require(torch.equal(got, twin), f"{what}: max |diff| to the twins "
                f"{float((got.float() - twin.float()).abs().max())}")
        held = "bitwise equal to the twins on the card"
        if x.numel() < 1 << 16:
            on_cpu = om.median2d_plain(x.cpu(), fl, direction, border)
            require(torch.equal(got.cpu(), on_cpu), f"{what}: differs from median2d_plain")
            held += " and to median2d_plain on the CPU"
        del twin
        p_us = median_us(plain, runs=3, warmup=0)
        call = lambda x=x, f=fl, d=direction, b=border: om.median2d(x, f, d, b)  # noqa: E731
        us, n = row_us(call)
        g_us = median_us(glue_only(x, fl, direction, border))
        library = median2d_library(x, fl, direction, border)
        lib = f"{median_us(library, runs=3, warmup=1):.2f} us" if library else "none (no output)"
        b_us, b_by = bound(x.numel(), x.numel(), x.element_size(), om.odd_filter_len(fl))
        key = median2d_launch(x, fl, direction, border)
        print(f"phase 31 {what} -> {key or 'no launch'}: {held}; {us:.2f} us device (median of "
              f"{n}), of which glue (gathers, fills, pads) {g_us:.2f} us; the twins {p_us:.2f} us "
              f"(median of 3); "
              f"kthvalue {lib} (unfold view); bound "
              f"{b_us:.2f} us ({b_by}); {1 if key else 0} launch per call [{smi}]")
    del outs
    # K1's register route in both forms on median2d's own operands
    for label, x, fl, direction, border in cases:
        key = median2d_launch(x, fl, direction, border)
        if key not in ("tap_median_time/register", f"tap_median_time/{CORE}"):
            continue
        what = f"median2d {label} {direction}/{border} fl={fl}"
        twin = om.median2d_over(x, fl, direction, border, mc.tap_median_time_plain,
                                mc.sliding_median_boundary_plain)
        us = {}
        for form in ("network", *mc.time_core_runs(tuple(range(-om.odd_filter_len(fl) + 1, 1)))):
            fn = lambda f=form, x=x, fl=fl, d=direction, b=border: om.median2d_over(  # noqa: E731
                x, fl, d, b, register_form(f), mc.sliding_median_boundary)
            name = "network" if form == "network" else f"core R={form}"
            require(torch.equal(fn(), twin), f"{what}: K1 {name} differs from the twins")
            us[name] = median_us(fn, runs=10)
        del twin
        print(f"phase 31 {what} both K1 register forms: bitwise equal to the twins; "
              + ", ".join(f"{name} {v:.2f} us" for name, v in us.items())
              + f" (medians of 10, glue included); the wrapper takes {key} [{smi}]")
    # K2's network route in both forms on median2d's own operands
    for label, x, fl, direction, border in cases:
        key = median2d_launch(x, fl, direction, border)
        if key not in ("sliding_median_boundary/network",
                       f"sliding_median_boundary/{FREQ_CORE}"):
            continue
        what = f"median2d {label} {direction}/{border} fl={fl}"
        twin = om.median2d_over(x, fl, direction, border, mc.tap_median_time_plain,
                                mc.sliding_median_boundary_plain)
        us = {}
        for core in (1, *mc.freq_core_runs(om.odd_filter_len(fl))):
            fn = lambda c=core, x=x, fl=fl, d=direction, b=border: om.median2d_over(  # noqa: E731
                x, fl, d, b, mc.tap_median_time, network_form(c))
            name = "network" if core == 1 else f"core R={core}"
            require(torch.equal(fn(), twin), f"{what}: K2 {name} differs from the twins")
            us[name] = median_us(fn, runs=10)
        del twin
        print(f"phase 31 {what} both K2 network forms: bitwise equal to the twins; "
              + ", ".join(f"{name} {v:.2f} us" for name, v in us.items())
              + f" (medians of 10, glue included); the wrapper takes {key} [{smi}]")
    rng = np.random.default_rng(32)
    for what, x, fl, direction in (("K2 network", _mags(rng, 4, 300), 13, om.FREQUENCY),
                                   ("K2 rank", _mags(rng, 4, 300), 65, om.FREQUENCY),
                                   ("K1 network", _mags(rng, 300, 4), 11, om.TIME_ANTICAUSAL),
                                   ("K1 rank", _mags(rng, 300, 4), 93, om.TIME_ANTICAUSAL)):
        x[2, 2] = float("nan")
        got = om.median2d(x, fl, direction, om.WRAP)
        twin = om.median2d_over(x, fl, direction, om.WRAP, mc.tap_median_time_plain,
                                mc.sliding_median_boundary_plain)
        print(f"phase 31 NaN probe {what} fl={fl} wrap: the kernel gives {int(got.isnan().sum())} "
              f"NaN outputs, its twin {int(twin.isnan().sum())}; they differ at "
              f"{int((got != twin).sum() - (got.isnan() & twin.isnan()).sum())} of {got.numel()}")
    # the select route (no median2d shape takes it) on the same NaN, beside
    # -0.0 and +inf: it orders them as the rank routes' keys do
    x = _mags(rng, 4, 300)
    x[2, 2], x[1, 7:9], x[3, 40] = float("nan"), -0.0, float("inf")
    xt, centered = x.T.contiguous(), tuple(range(-46, 47))
    for what, got, twin in (
            ("K2 select", mc._freq_launch(x, 65, "wrap", "select"),
             mc.sliding_median_boundary_plain(x, 65, "wrap")),
            ("K1 select", mc._time_launch(xt, xt[:0], centered, 0, 0.0, "select"),
             mc.tap_median_time_plain(xt, xt[:0], centered, 0))):
        differ = int((got != twin).sum() - (got.isnan() & twin.isnan()).sum())
        print(f"phase 31 NaN probe {what} K={65 if what[1] == '2' else 93} (-0.0, +inf beside the "
              f"NaN): the kernel gives {int(got.isnan().sum())} NaN outputs, its twin "
              f"{int(twin.isnan().sum())}; they differ at {differ} of {got.numel()}")
        require(differ == 0, f"{what} orders NaN, -0.0 or +inf unlike its twin")
    return launches


def kernel_rows(kstats: dict, by_path: dict) -> tuple:
    """The `kernels` line: one row per kernel route a path launched
    (launches summed over the paths, each path's counts read around its
    own run; the copy mirrors run on phase 11's path; a rank route's row
    counts all its launches, its STEPS row the steps kernel's share and
    K2's SCRATCH row the key store's, each with the times of its own
    shapes), and the
    routes no path launched (K2's rank route on the key store and its
    select route: no HPRConfig comes near 16,355 frequency taps, nor has a
    frequency median of so few outputs), checked in phase 3 only.
    ``by_route_launches`` are phase 24's launches by route name, outside
    ``launches``."""
    rows, off_path = [], []
    for (name, route), st in kstats.items():
        key = f"{name}/{route}"
        first = st["shapes"][0]
        tpus = list(dict.fromkeys(TPU_KERNELS[sh["tpu_kernel"]] for sh in st["shapes"]))
        row = {
            "name": key, "route": "cuda", "source": SOURCES.get(key, SOURCES[name]),
            "replaces": tpus[0],
            "also_replaces": tpus[1:],
            "launches": sum(counts.get(key, 0) for counts in by_path.values()),
            "launches_by_path": {path: counts.get(key, 0) for path, counts in by_path.items()},
            "by_route_launches": BY_ROUTE.get(key, 0),
            "max_abs_err": st["max_abs_err"], "tolerance": "bitwise", "shape": first["shape"],
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shapes": [{**sh, "replaces": TPU_KERNELS[sh["tpu_kernel"]]} for sh in st["shapes"]],
        }
        if route == STEPS:
            row["sort"] = SORT_SOURCE
        (rows if row["launches"] else off_path).append(row)
    return rows, off_path


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; the port's "
            "smoke run needs an NVIDIA GPU and has no CPU path"
        )
    t_run = time.perf_counter()
    from zen_tpu_torch.ops import median_cuda as mc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_card()
    phase_build()
    kstats = phase_kernels()
    phase_network()
    phase_runs()
    phase_sweep()
    phase_tiles()
    phase_warp()
    phase_select()
    phase_split()

    # the main path: launch counters cover exactly these runs
    reset_launches()
    cfg1, got1, audio1, sizes1, t1 = run_stream()
    launches1 = read_launches()
    cfgm, gotm, audiom, sizesm, tm = run_fleet()
    launches = read_launches()
    # hop 1024's frequency median is K = 47: K2's network route, in its
    # shared-core form, at B = 32 and B = 1; no K2 rank launch
    require(cfg1.freq_filter_len == 47 and launches1["sliding_median_boundary/rank"] == 0
            and launches1[f"sliding_median_boundary/{FREQ_CORE}"]
            == launches1["sliding_median_boundary/network"] > 0,
            f"hop-1024 stream launches {launches1} (K2's K = 47 takes the network's shared core)")

    stems = ("harmonic", "percussive", "residual")
    want1 = reference_stream(audio1, sizes1)
    r1 = compare_stream(cfg1, audio1, sizes1, got1, want1, stems)
    for arr in (got1, gotm):
        require(bool(np.isfinite(arr).all()), "non-finite stem samples")
    us_10ms = t1["step_us"] / (32 * cfg1.hop / cfg1.fs * 100)
    print(
        f"phase 4 HPRRealtime fs 44100 hop 1024, 64 x B=32 + 64 x B=1: "
        f"mask flips {r1['flips']} ({r1['share']:.3g} of bins), "
        f"excluded hops {r1['excluded']}/{r1['hops']}, max |diff|/scale "
        f"{r1['rel_err']:.3g} (limit {STEM_ATOL}); "
        f"{t1['step_us']:.1f} us/step at B=32 = {us_10ms:.2f} us per 10 ms; "
        f"{t1['hop_us']:.1f} us/hop at B=1; one B=32 step: {t1['prof_b']}; "
        f"one B=1 step: {t1['prof_1']}; launches {nonzero(launches1)} [{smi}]"
    )

    wantm = reference_fleet(audiom, sizesm)
    rm = compare_stream(cfgm, audiom, sizesm, gotm, wantm, stems)
    print(
        f"phase 5 MultiStreamHPR 64 x fs 44100 hop 256, 16 x B=32: "
        f"mask flips {rm['flips']} ({rm['share']:.3g} of bins), "
        f"excluded hops {rm['excluded']}/{rm['hops']}, max |diff|/scale "
        f"{rm['rel_err']:.3g}; stem_rows compact percussive row ok; "
        f"{tm['step_us']:.1f} us/step = {tm['msps']:.2f} Msamples/s; "
        f"one step: {tm['prof_b']} [{smi}]"
    )

    require(all(v > 0 for v in per_kernel(launches).values())
            and not any(launches[f"{name}/{STEPS}"] for name in ROUTES)
            and launches[f"sliding_median_boundary/{FREQ_CORE}"] > 0,
            f"kernel launches {launches} (the streams' rank calls walk from rank 0; the "
            "64-stream fleet's K2 takes its shared core)")
    print(f"phase 6 streaming kernel launches: {launches}")

    by_path = {"streaming": launches}
    for name, phase in (("offline_clip", phase_offline_clip), ("offline_track", phase_offline_track),
                        ("zen_stream_512", phase_zen_stream), ("streaming_hop32", phase_hop32),
                        ("streaming_hop64", phase_hop64), ("streaming_hop1_384k", phase_hop1),
                        ("hbm_pattern", phase_hbm_pattern), ("serving_bound", phase_serving_bound),
                        ("sse", phase_sse), ("box", phase_box), ("dft", phase_dft),
                        ("quality_ladder", phase_quality), ("files_cli", phase_files_cli),
                        ("corpus", phase_corpus), ("apps", phase_apps),
                        ("parallel", phase_parallel), ("headline", phase_headline),
                        ("entry", phase_entry), ("fuzz", phase_fuzz),
                        ("kernels_sweep", phase_kernels_sweep), ("soak", phase_soak),
                        ("scaling", phase_scaling), ("io_codec", phase_io_codec),
                        ("live_tools", phase_live_tools), ("multihost", phase_multihost),
                        ("median2d", phase_median2d)):
        t0 = time.perf_counter()
        counts = phase(smi)
        if counts is not None:
            by_path[name] = counts
        print(f"chip_smoke: {name} took {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_run:.1f} s in all)")
    rows, off_path = kernel_rows(kstats, by_path)
    # every route the paths' tap counts select ran on a path (frequency K:
    # 47 at hop 1024, 13 at hop 256, 187 offline at hop 4096, 1 at hop 32),
    # K1's warp route (hop 32) and select route (384 kHz hop 1), both rank
    # routes' steps kernels (the offline pass 1, median2d's fl 93), and both
    # copy mirrors
    wanted = {"tap_median_time/register", "tap_median_time/rank", "tap_median_time/select",
              "tap_median_time/warp",
              f"tap_median_time/{CORE}", f"sliding_median_boundary/{FREQ_CORE}",
              *(f"{name}/{STEPS}" for name in ROUTES),
              *(f"sliding_median_boundary/{mc.freq_route(k)}" for k in (47, 13, 187, 1)),
              *(f"{name}/copy" for name in PROBES)}
    launched = {row["name"] for row in rows}
    require(wanted <= launched, f"routes no path launched: {sorted(wanted - launched)}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": rows, "off_path_kernels": off_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
