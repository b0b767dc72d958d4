#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from zen_tpu_torch/csrc with nvcc, holds
each one bitwise against its plain PyTorch twin at the main path's
shapes, then drives the causal streaming HPR through its user entry
points at full width:

  phase 4  HPRRealtime at 44.1 kHz, hop 1024: 64 blocks of 32 hops,
           then 64 single hops;
  phase 5  MultiStreamHPR, 64 streams at 44.1 kHz, hop 256, 32-hop
           blocks, plus a percussive-only fleet for the compact rows;

and holds every output against the same port run on the CPU (plain
twins, CPU FFT). A hard-mask bin whose ratio sits within float noise of
beta can flip between cuFFT and the CPU FFT; flips are counted by
running the step's analysis half on the same blocks on both devices, must
stay below 1e-5 of all mask bins, and the 5e-5 x scale stem tolerance
applies to every output hop no flipped frame feeds.

Every time printed is a measurement of this run on the card named in
phase 1. Any failure raises and exits non-zero; there is no CPU path.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
STEM_ATOL = 5e-5  # realtime parity class, tests/test_engine_parity.py:271-275
FLIP_SHARE = 1e-5  # largest share of hard-mask bins allowed to differ
TIMED_RUNS = 30
NOISE_FLOOR = 0.01  # white noise under the synthetic mix (see synthetic_mix)
DEVICE = "cuda"  # every tensor of the run under test lives here


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


def median_us(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median over ``runs`` of one call's device time, from CUDA events.
    A ~1 ms spin kernel ahead of each start event keeps the card busy
    while the host enqueues the call, so the events bracket device work
    and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3)
    return float(np.median(times))


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
    from zen_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(
        f"phase 2 build: {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().relative_to(ROOT)})"
    )


def kernel_cases():
    """(kernel, label, kernel call, plain call) at every main-path shape,
    main-path hop-1024 shape first, plus the other boundary modes at a
    ragged row count. Inputs are positive continuous values, like
    magnitudes."""
    from zen_tpu_torch.ops import median_cuda as mc

    rng = np.random.default_rng(0)

    def mag(*shape):
        return torch.from_numpy(
            (rng.random(shape, dtype=np.float32) + np.float32(1e-3))
        ).to(DEVICE)

    t1024 = (-5, -1, 0)
    t256 = tuple(range(-21, -16)) + tuple(range(-5, 1))
    cases = []
    for label, a, b, offs, start in (
        ("pair C=1 H=5 B=32 F=2049 K=3", mag(1, 5, 2049), mag(1, 32, 2049), t1024, 5),
        ("pair C=64 H=21 B=32 F=513 K=11", mag(64, 21, 513), mag(64, 32, 513), t256, 21),
        ("single C=1 T=6 start=5 F=2049 K=3", mag(1, 6, 2049), mag(1, 0, 2049), t1024, 5),
    ):
        cases.append((
            "tap_median_time", label,
            lambda a=a, b=b, o=offs, s=start: mc.tap_median_time(a, b, o, s),
            lambda a=a, b=b, o=offs, s=start: mc.tap_median_time_plain(a, b, o, s),
        ))
    for label, x, k, mode in (
        ("R=32 F=2049 K=47 reflect", mag(32, 2049), 47, "reflect"),
        ("R=2048 F=513 K=13 reflect", mag(2048, 513), 13, "reflect"),
        ("R=37 F=4096 K=47 wrap", mag(37, 4096), 47, "wrap"),
        ("R=37 F=513 K=13 edge", mag(37, 513), 13, "edge"),
        ("R=37 F=2095 K=47 valid", mag(37, 2049 + 46), 47, "valid"),
    ):
        cases.append((
            "sliding_median_boundary", label,
            lambda x=x, k=k, m=mode: mc.sliding_median_boundary(x, k, m),
            lambda x=x, k=k, m=mode: mc.sliding_median_boundary_plain(x, k, m),
        ))
    return cases


def phase_kernels() -> dict:
    """Kernel vs plain twin, bitwise, with both device times."""
    stats = {}
    for name, label, run_kernel, run_plain in kernel_cases():
        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        require(got.shape == want.shape, f"{name} {label}: shape {got.shape}")
        err = float((got - want).abs().max())
        require(torch.equal(got, want), f"{name} {label}: max |diff| {err}")
        k_us, p_us = median_us(run_kernel), median_us(run_plain)
        print(
            f"phase 3 {name} {label}: bitwise equal, kernel {k_us:.2f} us, "
            f"plain {p_us:.2f} us (median of {TIMED_RUNS})"
        )
        st = stats.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["shapes"].append((label, k_us, p_us))
    return stats


def stream_masks(cfg, audio: np.ndarray, sizes, device) -> torch.Tensor:
    """Hard masks [2, C, N, bins] (harmonic, percussive) of the streams
    audio [C, N*hop], block by block through block_step's own analysis
    half and state update (no synthesis), on ``device``."""
    from zen_tpu_torch.drivers import realtime as rt

    c = audio.shape[0]
    hops = torch.from_numpy(audio).reshape(c, -1, cfg.hop)
    state = rt.init_state(cfg, c, device)
    out, t = [], 0
    for b in sizes:
        step = rt.step_masks(cfg, state, hops[:, t : t + b].to(device))
        out.append(torch.stack(step.masks[:2]).cpu())
        rt.advance_state(cfg, state, step)
        t += b
    return torch.cat(out, dim=2)


def compare_stream(cfg, audio, sizes, got, want, stems) -> dict:
    """Flip count from the masks on both devices, then the stem
    tolerance on every hop no flipped frame feeds (frame t feeds output
    hops t and t+1). got/want: [C, E, N*hop] host arrays."""
    m_gpu = stream_masks(cfg, audio, sizes, DEVICE)
    m_cpu = stream_masks(cfg, audio, sizes, "cpu")
    differ = (m_gpu != m_cpu).any(dim=0)  # [C, N, bins]
    flips = int(differ.sum())
    share = flips / differ.numel()
    require(share <= FLIP_SHARE, f"hard-mask flips {flips} ({share:.3g} of bins)")
    flipped = differ.any(dim=-1).numpy()  # [C, N]
    excluded = flipped.copy()
    excluded[:, 1:] |= flipped[:, :-1]
    c, n = excluded.shape
    keep = np.repeat(~excluded, cfg.hop, axis=1)  # [C, N*hop]
    worst = 0.0
    for e, stem in enumerate(stems):
        for ch in range(c):
            ref = want[ch, e]
            scale = max(1.0, float(np.abs(ref).max()))
            err = float(np.abs(got[ch, e] - ref)[keep[ch]].max(initial=0.0))
            require(
                err <= STEM_ATOL * scale,
                f"{stem} stream {ch}: max |diff| {err} > {STEM_ATOL} x {scale}",
            )
            worst = max(worst, err / scale)
    return {"flips": flips, "share": share, "excluded": int(excluded.sum()),
            "hops": c * n, "rel_err": worst}


def reset_launches() -> None:
    from zen_tpu_torch.ops import median_cuda as mc

    mc.tap_median_time.launches = 0
    mc.sliding_median_boundary.launches = 0


def read_launches() -> dict:
    from zen_tpu_torch.ops import median_cuda as mc

    return {
        "tap_median_time": mc.tap_median_time.launches,
        "sliding_median_boundary": mc.sliding_median_boundary.launches,
    }


def run_hop1024(fs=44100.0, hop=1024, b=32, n_blocks=64, n_single=64):
    """Main path, single stream: returns (outputs [1, 3, N*hop], audio,
    block sizes, timings)."""
    from zen_tpu_torch import HPRRealtime

    n = (n_blocks * b + n_single) * hop
    audio = synthetic_mix(n, fs, seed=1)
    hops = torch.from_numpy(audio).to(DEVICE).reshape(-1, hop)
    rt = HPRRealtime(fs, hop=hop, device=DEVICE)
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


def reference_hop1024(audio, sizes, hop=1024, fs=44100.0) -> np.ndarray:
    from zen_tpu_torch import HPRRealtime

    rt = HPRRealtime(fs, hop=hop, device="cpu")
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


def run_fleet(fs=44100.0, hop=256, c=64, b=32, n_blocks=16):
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, MultiStreamHPR

    audio = fleet_audio(c, n_blocks * b * hop, fs)
    blocks = torch.from_numpy(audio).to(DEVICE).reshape(c, n_blocks, b, hop)
    ms = MultiStreamHPR(c, fs, hop=hop, device=DEVICE)
    ms.warmup((b,))
    got = torch.cat(
        [ms.process_block(blocks[:, j]) for j in range(n_blocks)], dim=2
    ).cpu().numpy()
    # percussive-only fleet: compact rows, one per enabled stem
    perc = MultiStreamHPR(c, fs, hop=hop, outputs=OUTPUT_PERCUSSIVE, device=DEVICE)
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


def reference_fleet(audio, sizes, hop=256, fs=44100.0) -> np.ndarray:
    from zen_tpu_torch import MultiStreamHPR

    c = audio.shape[0]
    ms = MultiStreamHPR(c, fs, hop=hop, device="cpu")
    x = torch.from_numpy(audio).reshape(c, -1, hop)
    outs, t = [], 0
    for b in sizes:
        outs.append(ms.process_block(x[:, t : t + b]))
        t += b
    return torch.cat(outs, dim=2).numpy()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; the port's "
            "smoke run needs an NVIDIA GPU and has no CPU path"
        )
    sys.path.insert(0, str(ROOT))
    import zen_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_card()
    phase_build()
    kstats = phase_kernels()

    # the main path: launch counters cover exactly these runs
    reset_launches()
    cfg1, got1, audio1, sizes1, t1 = run_hop1024()
    cfgm, gotm, audiom, sizesm, tm = run_fleet()
    launches = read_launches()

    stems = ("harmonic", "percussive", "residual")
    want1 = reference_hop1024(audio1, sizes1)
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
        f"one B=1 step: {t1['prof_1']} [{smi}]"
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

    require(all(v > 0 for v in launches.values()), f"kernel launches {launches}")
    print(f"phase 6 main-path kernel launches: {launches}")

    sources = {
        "tap_median_time": (
            "zen_tpu_torch/csrc/median_time.cu",
            "zen_tpu/ops/median_pallas.py:895",
            ["zen_tpu/ops/median_pallas.py:787"],
        ),
        "sliding_median_boundary": (
            "zen_tpu_torch/csrc/median_freq.cu",
            "zen_tpu/ops/median_pallas.py:603",
            ["zen_tpu/ops/median_pallas.py:395"],
        ),
    }
    rows = []
    for name, (src, replaces, also) in sources.items():
        label, k_us, p_us = kstats[name]["shapes"][0]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "also_replaces": also, "launches": launches[name],
            "max_abs_err": kstats[name]["max_abs_err"], "tolerance": "bitwise",
            "shape": label, "ms": k_us / 1e3, "plain_ms": p_us / 1e3,
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
