"""The comparator-network rows of K1 or K2 on the card, for comparing two
trees in one call.

    python zen_tpu_torch/benches/core_rows.py [--kernel K1|K2] [--tree DIR]
        [--label NAME] [--runs 30] [--forms] [--check]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), as ``rank_store.py`` does, so that one call on the card
can time another checkout's kernels beside this one's, in turns
(parent, change, change, parent), each in its own process. Times,
through the entry points (``tap_median_time``, ``sliding_median_boundary``,
``median2d``), whatever each tree's wrapper picks at the rows of
``--kernel``'s network route. K1 (the default), the rows its register
route takes: the
4-minute track's pass 2 (T=41355 F=513, centered K = 11), median2d's time
filter at the track's widths (fl 17 on [2585, 8193], fl 11 on [41355,
513], 'valid' and 'wrap'), the 512-stream fleet (#4, f32 and bf16; the
replicate and valid borders), the 64-stream fleet, the clip's pass 2 and
beat-track, the latency rows (hop 1024's K = 3, pitch-track's K = 1, one
hop-64 stream's K = 47 at B = 32 and B = 1) and the network's rows past
31 taps (K = 33, the hop-64 fleet at K = 47, 48 kHz hop 64's K = 51, K =
63). K2, the rows its network route takes (``freq_rows``): the
512-stream block's 8192 rows (f32 and bf16; the replicate border's edge
at F = 1024 and the valid border's padded 1036), the 64-stream fleet's
2048 rows, the clip's and the 4-minute track's pass 2 (643 and 41355
rows), ``median2d`` frequency fl 13 on [41355, 513] (wrap, replicate,
valid), and the latency rows (beat-track's 64 rows, hop 32's K = 1, and
hop 1024's K = 47 at B = 32 and B = 1, which a tree whose network stops
at 31 taps takes through its rank route). Each time is the card's
µs for one call: CUDA events behind a spin,
the median of ``--runs`` calls after one warm call. Beside it, the
SHA-256 of the output's bytes, so that two trees' outputs compare
without a twin.

``--forms`` (a tree with the kernel's shared core) also times each row
in both of the network's forms, the per-output network (K1 at the
wrapper's run) and the shared core at each R it is built for, each
output held bitwise against the plain twin on the card, and prints which
form and R the wrapper's rule (``time_network_form``,
``freq_network_form``) picks beside the fastest. ``--check`` first holds
the shared core at every shape it is built for
(``select_network.core_shapes``; K2: every one-run shape up to 63 taps
under each of the four borders), f32 and bf16, on tie-heavy inputs
(K1: fill = +inf; K2: +inf and -inf samples, a ragged row count and
rows of one and of three blocks), against the twin. Prints the card's name and
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


def freq_rows(torch, device) -> list:
    """(label, kind, args) of K2's network rows: kind 'freq' takes
    sliding_median_boundary's (x, k, mode), 'median2d' median2d's; inputs
    from one numpy seed, made on the card."""
    import numpy as np

    rng = np.random.default_rng(2)

    def mag(*shape, dtype=torch.float32):
        x = rng.random(shape, dtype=np.float32) + np.float32(1e-3)
        return torch.from_numpy(x).to(device).to(dtype)

    return [
        ("K2 512-stream block R=8192 F=513 K=13 reflect f32", "freq", (mag(8192, 513), 13, "reflect")),
        ("K2 512-stream block R=8192 F=513 K=13 reflect bf16", "freq",
         (mag(8192, 513, dtype=torch.bfloat16), 13, "reflect")),
        ("K2 R=8192 F=1024 K=13 edge (replicate)", "freq", (mag(8192, 1024), 13, "edge")),
        ("K2 R=8192 F=1036 K=13 valid", "freq", (mag(8192, 1036), 13, "valid")),
        ("K2 64-stream step R=2048 F=513 K=13 reflect", "freq", (mag(2048, 513), 13, "reflect")),
        ("K2 clip pass 2 R=643 F=513 K=13 reflect", "freq", (mag(643, 513), 13, "reflect")),
        (f"K2 track pass 2 R={TRACK_P} F=513 K=13 reflect", "freq",
         (mag(TRACK_P, 513), 13, "reflect")),
        (f"median2d frequency fl 13 [{TRACK_P}, 513] wrap", "median2d",
         (mag(TRACK_P, 513), 13, "frequency", "wrap")),
        (f"median2d frequency fl 13 [{TRACK_P}, 513] replicate", "median2d",
         (mag(TRACK_P, 513), 13, "frequency", "replicate")),
        (f"median2d frequency fl 13 [{TRACK_P}, 513] valid", "median2d",
         (mag(TRACK_P, 513), 13, "frequency", "valid")),
        ("K2 beat-track R=64 F=513 K=13 reflect", "freq", (mag(64, 513), 13, "reflect")),
        ("K2 hop 32 R=32 F=65 K=1 reflect", "freq", (mag(32, 65), 1, "reflect")),
        ("K2 hop 1024 R=32 F=2049 K=47 reflect", "freq", (mag(32, 2049), 47, "reflect")),
        ("K2 hop 1024 B=1 R=1 F=2049 K=47 reflect", "freq", (mag(1, 2049), 47, "reflect")),
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


def check_freq_shapes(torch, mc, sn) -> int:
    """K2's shared core at every one-run shape it is built for, f32 and
    bf16, each border, on tie-heavy rows holding +inf and -inf samples:
    37 rows of 131 outputs (one block, ragged runs) and 5 of 2049 (three
    blocks of 683), against the twin on the card; returns the shapes
    held."""
    import numpy as np

    rng = np.random.default_rng(3)
    ids = sn.freq_core_shape_ids()
    for q in ids:
        (k,), r = sn.core_shapes()[q]
        for mode in ("reflect", "wrap", "edge", "valid"):
            for rows, f_out in ((37, 131), (5, 2049)):
                f_in = f_out + (k - 1 if mode == "valid" else 0)
                levels = rng.integers(0, 8, (rows, f_in)).astype(np.float32) / 8
                levels[rng.random((rows, f_in)) < 0.02] = np.inf
                levels[rng.random((rows, f_in)) < 0.02] = -np.inf
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.from_numpy(levels).to("cuda").to(dtype)
                    got = mc._freq_launch(x, k, mode, "network", core=r)
                    if not torch.equal(got, mc.sliding_median_boundary_plain(x, k, mode)):
                        raise SystemExit(f"K2 shared core K={k} R={r} {mode} [{rows}, {f_in}] "
                                         f"{dtype} differs from the twin")
    torch.cuda.synchronize()
    return len(ids)


def freq_forms(torch, mc, x, k, mode, runs: int) -> dict:
    """Each network form of K2 at one row: µs of the per-output network
    and of the shared core at each built R, each held bitwise against the
    twin; and the wrapper's pick."""
    want = mc.sliding_median_boundary_plain(x, k, mode)
    us = {}
    for core in (1, *mc.freq_core_runs(k)):
        fn = lambda core=core: mc._freq_launch(x, k, mode, "network", core=core)  # noqa: E731
        name = "network" if core == 1 else f"core R={core}"
        if not torch.equal(fn(), want):
            raise SystemExit(f"K2 {name} differs from the twin at K={k} {mode} {tuple(x.shape)}")
        us[name] = device_us(torch, fn, runs)
    form, size = mc.freq_network_form(k, x.numel() // x.shape[-1], x.shape[-1], mode)
    return {"us": us, "fastest": min(us, key=us.get),
            "picked": f"core R={size}" if form == "core" else "network"}


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
    ap.add_argument("--kernel", choices=("K1", "K2"), default="K1")
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

        if args.kernel == "K1":
            n = check_shapes(torch, mc, sn)
            held = "f32 and bf16, tie-heavy, fill = +inf"
        else:
            n = check_freq_shapes(torch, mc, sn)
            held = "f32 and bf16, four borders, tie-heavy with +-inf, ragged rows and chunks"
        print(f"{args.label}: {args.kernel}'s shared core bitwise to the twin at all {n} built "
              f"shapes ({held})", flush=True)
        result["checked_shapes"] = n
    entry = {"time": mc.tap_median_time, "freq": mc.sliding_median_boundary,
             "median2d": om.median2d}
    for label, kind, call_args in (rows if args.kernel == "K1" else freq_rows)(torch, "cuda"):
        fn = lambda c=call_args, f=entry[kind]: f(*c)  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().contiguous().view(torch.uint8).numpy().tobytes())
        del out
        row = {"us": device_us(torch, fn, args.runs), "sha256": digest.hexdigest()[:16]}
        line = f"{args.label} {label}: {row['us']:.2f} us, sha256 {row['sha256']}"
        if args.forms and kind == "time":
            row["forms"] = forms(torch, mc, *call_args, runs=max(10, args.runs // 3))
        elif args.forms and kind == "freq" and mc.freq_route(call_args[1]) == "network":
            row["forms"] = freq_forms(torch, mc, *call_args, runs=max(10, args.runs // 3))
        if "forms" in row:
            line += ("; forms " + ", ".join(f"{k} {v:.2f}" for k, v in row["forms"]["us"].items())
                     + f" us, fastest {row['forms']['fastest']}, picked {row['forms']['picked']}")
        result[label] = row
        print(line, flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"core_rows": result, "kernel": args.kernel, "label": args.label,
                      "card": smi}))
    return result


if __name__ == "__main__":
    main()
