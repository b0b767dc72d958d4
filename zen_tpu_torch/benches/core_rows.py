"""K1's comparator-network rows on the card, for comparing two trees in one call.

    python zen_tpu_torch/benches/core_rows.py [--tree DIR] [--label NAME] [--runs 30]
        [--forms] [--check]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), as ``rank_store.py`` does, so that one call on the card
can time another checkout's kernels beside this one's, in turns
(parent, change, change, parent), each in its own process. Times,
through the entry points (``tap_median_time``, ``median2d``), whatever
each tree's wrapper picks at the rows K1's register route takes: the
4-minute track's pass 2 (T=41355 F=513, centered K = 11), median2d's time
filter at the track's widths (fl 17 on [2585, 8193], fl 11 on [41355,
513], 'valid' and 'wrap'), the 512-stream fleet (#4, f32 and bf16; the
replicate and valid borders), the 64-stream fleet, the clip's pass 2 and
beat-track, the latency rows (hop 1024's K = 3, pitch-track's K = 1, one
hop-64 stream's K = 47 at B = 32 and B = 1) and the network's rows past
31 taps (K = 33, the hop-64 fleet at K = 47, 48 kHz hop 64's K = 51, K =
63). Each time is the card's µs for one call: CUDA events behind a spin,
the median of ``--runs`` calls after one warm call. Beside it, the
SHA-256 of the output's bytes, so that two trees' outputs compare
without a twin.

``--forms`` (a tree with the shared core) also times each of K1's rows
in both of its register forms, the per-output network at the wrapper's
run and the shared core at each R it is built for, each output held
bitwise against ``tap_median_time_plain`` on the card, and prints which
form and R the wrapper's rule (``time_network_form``) picks beside the
fastest. ``--check`` first holds the shared core at every shape it is
built for (``select_network.core_shapes``), f32 and bf16, on tie-heavy
inputs with fill = +inf, against the twin. Prints the card's name and
power limit, one line a row, then one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

TRACK_H, TRACK_P = 2585, 41355  # the 4-minute track's pass-1 and pass-2 frames
T256 = tuple(range(-21, -16)) + tuple(range(-5, 1))  # hop 256's causal wrap taps
T64 = tuple(range(-91, -68)) + tuple(range(-23, 1))  # 44.1 kHz hop 64's, K = 47
T51 = tuple(range(-99, -74)) + tuple(range(-25, 1))  # 48 kHz hop 64's, K = 51
CENTERED11 = tuple(range(-5, 6))


def rows(torch, device) -> list:
    """(label, kind, args): kind 'time' takes tap_median_time's (a, b,
    offsets, start), 'median2d' median2d's (x, fl, direction, border);
    inputs from one numpy seed, made on the card."""
    import numpy as np

    rng = np.random.default_rng(0)

    def mag(*shape, dtype=torch.float32):
        x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
        return torch.from_numpy(x).to(device).to(dtype)

    bf16 = torch.bfloat16
    return [
        (f"K1 4-minute pass 2 T={TRACK_P} F=513 K=11", "time",
         (mag(1, TRACK_P, 513), mag(1, 0, 513), CENTERED11, 0)),
        (f"median2d time fl 17 [{TRACK_H}, 8193] valid", "median2d",
         (mag(TRACK_H, 8193), 17, "time_anticausal", "valid")),
        (f"median2d time fl 17 [{TRACK_H}, 8193] wrap", "median2d",
         (mag(TRACK_H, 8193), 17, "time_anticausal", "wrap")),
        (f"median2d time fl 11 [{TRACK_P}, 513] valid", "median2d",
         (mag(TRACK_P, 513), 11, "time_anticausal", "valid")),
        (f"median2d time fl 11 [{TRACK_P}, 513] wrap", "median2d",
         (mag(TRACK_P, 513), 11, "time_anticausal", "wrap")),
        ("K1 pair C=512 H=21 B=16 F=513 K=11 f32", "time",
         (mag(512, 21, 513), mag(512, 16, 513), T256, 21)),
        ("K1 pair C=512 H=21 B=16 F=513 K=11 bf16", "time",
         (mag(512, 21, 513, dtype=bf16), mag(512, 16, 513, dtype=bf16), T256, 21)),
        ("K1 pair C=512 H=5 B=16 F=1024 K=11 replicate", "time",
         (mag(512, 5, 1024), mag(512, 16, 1024), tuple(range(-5, 0)) + (0,) * 6, 5)),
        ("K1 pair C=512 H=11 B=16 F=1024 K=11 valid", "time",
         (mag(512, 11, 1024), mag(512, 16, 1024), tuple(range(-11, 0)), 11)),
        ("K1 pair C=64 H=21 B=32 F=513 K=11 (64-stream fleet)", "time",
         (mag(64, 21, 513), mag(64, 32, 513), T256, 21)),
        ("K1 single T=643 F=513 K=11 (clip pass 2)", "time",
         (mag(1, 643, 513), mag(1, 0, 513), CENTERED11, 0)),
        ("K1 pair C=1 H=21 B=64 F=513 K=11 (beat-track)", "time",
         (mag(1, 21, 513), mag(1, 64, 513), T256, 21)),
        ("K1 pair C=1 H=5 B=32 F=2049 K=3 (hop 1024)", "time",
         (mag(1, 5, 2049), mag(1, 32, 2049), (-5, -1, 0), 5)),
        ("K1 pair C=1 H=0 B=8 F=8193 K=1 (pitch-track)", "time",
         (mag(1, 0, 8193), mag(1, 8, 8193), (0,), 0)),
        ("K1 pair C=1 H=91 B=32 F=129 K=47 (hop 64)", "time",
         (mag(1, 91, 129), mag(1, 32, 129), T64, 91)),
        ("K1 pair C=1 H=91 B=1 F=129 K=47 (hop 64)", "time",
         (mag(1, 91, 129), mag(1, 1, 129), T64, 91)),
        ("K1 pair C=64 H=32 B=32 F=513 K=33", "time",
         (mag(64, 32, 513), mag(64, 32, 513), tuple(range(-32, 1)), 32)),
        ("K1 pair C=64 H=91 B=32 F=129 K=47 (hop 64 fleet)", "time",
         (mag(64, 91, 129), mag(64, 32, 129), T64, 91)),
        ("K1 pair C=64 H=91 B=32 F=129 K=47 (hop 64 fleet) bf16", "time",
         (mag(64, 91, 129, dtype=bf16), mag(64, 32, 129, dtype=bf16), T64, 91)),
        ("K1 pair C=1 H=99 B=32 F=129 K=51 (48 kHz hop 64)", "time",
         (mag(1, 99, 129), mag(1, 32, 129), T51, 99)),
        ("K1 pair C=64 H=62 B=32 F=129 K=63 centered", "time",
         (mag(64, 62, 129), mag(64, 32, 129), tuple(range(-31, 32)), 62)),
    ]


def device_us(torch, fn, runs: int) -> float:
    """One call's device time: the median over ``runs`` calls, each behind
    a ~1 ms spin so that the events bracket device work, not the host's
    enqueue."""
    import numpy as np

    def once():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3

    once()
    return float(np.median([once() for _ in range(runs)]))


def check_shapes(torch, mc, sn) -> int:
    """The shared core at every built shape, f32 and bf16, tie-heavy,
    fill = +inf (a run of outputs past V's ends), against the twin on the
    card; returns the shapes held."""
    import numpy as np

    rng = np.random.default_rng(1)
    for lengths, r in sn.core_shapes():
        gap = 3 * r
        offsets, first = [], -sum(lengths) - gap * len(lengths)
        for n in lengths:
            offsets += range(first, first + n)
            first += n + gap
        offsets = tuple(offsets)
        h = -min(offsets)
        for dtype in (torch.float32, torch.bfloat16):
            levels = rng.integers(0, 4, (3, h + 7, 131)).astype(np.float32)
            v = torch.from_numpy(levels).to("cuda").to(dtype)
            a, b = v[:, :h].contiguous(), v[:, h:].contiguous()
            got = mc._time_launch(a, b, offsets, h - 2, float("inf"), "register", core=r)
            want = mc.tap_median_time_plain(a, b, offsets, h - 2, float("inf"))
            if not torch.equal(got, want):
                raise SystemExit(f"shared core {lengths} R={r} {dtype} differs from the twin")
    torch.cuda.synchronize()
    return len(sn.core_shapes())


def forms(torch, mc, a, b, offsets, start, runs: int) -> dict:
    """Each register form of K1 at one row: µs of the per-output network
    at the wrapper's run and of the shared core at each built R, each held
    bitwise against the twin; and the wrapper's pick."""
    offsets = tuple(offsets)
    t_out, streams, f = a.shape[-2] + b.shape[-2] - start, a.shape[0], a.shape[-1]
    want = mc.tap_median_time_plain(a, b, offsets, start)
    plan = offsets if mc.time_majority_tap(offsets) is None else (mc.time_majority_tap(offsets),)
    us = {}
    choices = [("network", mc.time_network_run(t_out, streams, f, plan), None)]
    choices += [(f"core R={r}", None, r) for r in mc.time_core_runs(plan)]
    for name, run, core in choices:
        fn = lambda run=run, core=core: mc._time_launch(  # noqa: E731
            a, b, offsets, start, 0.0, "register", run=run, core=core)
        if not torch.equal(fn(), want):
            raise SystemExit(f"{name} differs from the twin at {offsets} {tuple(a.shape)}")
        us[name if core else f"network run {run}"] = device_us(torch, fn, runs)
    form, size = mc.time_network_form(plan, t_out, streams, f)
    return {"us": us, "fastest": min(us, key=us.get),
            "picked": f"core R={size}" if form == "core" else f"network run {size}"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch
    import zen_tpu_torch
    from zen_tpu_torch.ops import median as om
    from zen_tpu_torch.ops import median_cuda as mc

    if not zen_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"zen_tpu_torch came from {zen_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("core_rows times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    from zen_tpu_torch.ops import _build

    _build.library()
    print(f"{args.label}: library built in {time.perf_counter() - t0:.1f} s", flush=True)
    result = {}
    if args.check:
        from zen_tpu_torch.ops import select_network as sn

        n = check_shapes(torch, mc, sn)
        print(f"{args.label}: the shared core bitwise to the twin at all {n} built shapes "
              "(f32 and bf16, tie-heavy, fill = +inf)", flush=True)
        result["checked_shapes"] = n
    for label, kind, call_args in rows(torch, "cuda"):
        fn = (lambda c=call_args: mc.tap_median_time(*c)) if kind == "time" else (
            lambda c=call_args: om.median2d(*c))
        out = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().contiguous().view(torch.uint8).numpy().tobytes())
        del out
        row = {"us": device_us(torch, fn, args.runs), "sha256": digest.hexdigest()[:16]}
        line = f"{args.label} {label}: {row['us']:.2f} us, sha256 {row['sha256']}"
        if args.forms and kind == "time":
            row["forms"] = forms(torch, mc, *call_args, runs=max(10, args.runs // 3))
            line += ("; forms " + ", ".join(f"{k} {v:.2f}" for k, v in row["forms"]["us"].items())
                     + f" us, fastest {row['forms']['fastest']}, picked {row['forms']['picked']}")
        result[label] = row
        print(line, flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"core_rows": result, "label": args.label, "card": smi}))
    return result


if __name__ == "__main__":
    main()
