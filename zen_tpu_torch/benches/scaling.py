"""Scaling instrument: samples/s against device count (counterpart of
``benches/scaling.py``).

    python -m zen_tpu_torch.benches.scaling [--devices 1,2,4] [--mesh-legs]
        [--chip-streams 1,8,64,512] [--json out.json] [--device cuda]

Two legs, the two multi-device workloads, each over a ``make_mesh`` of n
shards for every n of ``--devices``:

  dp  weak scaling of the serving path: ``MultiStreamHPR(mesh=)`` with
      ``--streams-per-dev`` streams a shard (flat samples/s per device is
      perfect scaling);
  sp  strong scaling of one track: ``sharded_separate`` over a dp=1 x sp
      mesh on ``--frames`` frames (samples/s growing with n is perfect).

Efficiency(n) = throughput(n) / (n x throughput(1)), throughput being
audio samples per second of host wall over a steady window
(``steady_state_ms``: the step chained, ending in a synchronize).

A mesh of n shards takes the first n cards when there are n; otherwise
it repeats ``--device`` n times: a virtual mesh, whose shards run one
after another on one device. Such a row says ``"virtual": true`` and lists
its devices: it measures the one host loop's dispatch of n shards, not
scaling. One H100 gives only virtual meshes past n = 1.

``--chip-streams`` adds the single-card streams curve: the hop-256 step
at each stream count (``--retention-passes`` interleaved passes, the
retention against each pass's own peak as mean +- half-spread), in
device samples/s (``runtime.profiling.device_ms``) and wall samples/s;
on the CPU (``--device cpu``) only the wall column is measured. The last
line of stdout is the JAX instrument's JSON line, with ``virtual`` and
the device; ``--json`` writes the whole result, with ``calls``: each leg's
and curve point's step calls, from which a caller counts its launches.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import CallCounter, describe_device
from .headline import stream_chain, stream_config
from ..device import resolve_device
from ..drivers.realtime import MultiStreamHPR
from ..engine.config import OUTPUT_ALL, HPRConfig
from ..parallel.mesh import make_mesh
from ..parallel.sharded import sharded_separate
from ..runtime.profiling import device_ms, steady_state_ms

VIRTUAL_CAVEAT = ("virtual mesh: every shard runs on one device, one after another, so "
                  "these rows measure one host loop's dispatch of n shards, not scaling")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.benches.scaling")
    ap.add_argument("--devices", default=None,
                    help="comma list of shard counts (default: 1, 2, .. up to the cards)")
    ap.add_argument("--streams-per-dev", type=int, default=8)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--block-hops", type=int, default=16)
    ap.add_argument("--frames", type=int, default=512, help="sp leg track length in frames")
    ap.add_argument("--fs", type=float, default=44100.0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--chip-streams", default=None,
                    help="also sweep single-card stream counts, e.g. '1,8,64,512'")
    ap.add_argument("--stream-state", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--mesh-legs", dest="mesh_legs", action="store_true", default=None,
                    help="force the dp/sp legs (default: only with more than one card)")
    ap.add_argument("--retention-passes", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def window(device: torch.device) -> int:
    """Steps a wall window times: 20 on the card; 3 on the CPU, whose
    rows test the instrument and measure nothing of the card."""
    return 20 if device.type == "cuda" else 3


def mesh_devices(n: int, device: torch.device) -> list:
    """The first n cards when there are n, else ``device`` repeated n
    times (a virtual mesh)."""
    if device.type == "cuda" and n <= torch.cuda.device_count():
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def _row(samples_per_s: float, devs: list) -> dict:
    return {"samples_per_s": samples_per_s, "virtual": len(set(devs)) < len(devs),
            "devices": [str(d) for d in devs]}


def dp_leg(n: int, args, device: torch.device, counter: CallCounter) -> dict:
    """Weak-scaling serving throughput: samples/s over all streams."""
    devs = mesh_devices(n, device)
    n_streams = args.streams_per_dev * n
    ms = MultiStreamHPR(n_streams, fs=args.fs, hop=args.hop,
                        mesh=make_mesh({"dp": n}, devices=devs))
    blocks = torch.randn((n_streams, args.block_hops, args.hop),
                         generator=torch.Generator().manual_seed(0)).to(devs[0])
    step = counter.wrap(f"dp/{n}", lambda _: ms.process_block(blocks))
    ms_per_step = steady_state_ms(step, blocks, iters=window(device))
    return _row(n_streams * args.block_hops * args.hop / (ms_per_step * 1e-3), devs)


def sp_leg(n: int, args, device: torch.device, counter: CallCounter) -> dict:
    """Strong-scaling offline throughput on one track: samples/s."""
    devs = mesh_devices(n, device)
    cfg = HPRConfig(fs=args.fs, hop=args.hop, beta=2.0, causal=False, outputs=OUTPUT_ALL)
    mesh = make_mesh({"dp": 1, "sp": n}, devices=devs)
    length = args.frames * args.hop
    audio = torch.randn((1, length), generator=torch.Generator().manual_seed(1)).to(devs[0])
    gain = 0.25 / cfg.synth_scale

    def step(x):
        # the harmonic stem fed back in (same shape), scaled so a chain of
        # passes stays in range
        return sharded_separate(x, cfg, mesh)["harmonic"] * gain

    ms_per_pass = steady_state_ms(counter.wrap(f"sp/{n}", step), audio,
                                  iters=max(3, window(device) // 4), warmup=2)
    return _row(length / (ms_per_pass * 1e-3), devs)


def chip_stream_curve(stream_counts, args, device: torch.device, counter: CallCounter) -> dict:
    """One pass of the single-card curve: {streams: {device and wall
    samples/s}} for the percussive hop-``args.hop`` step."""
    cfg = stream_config(args.fs, args.hop, stream_state=args.stream_state)
    curve = {}
    for s in stream_counts:
        fn, example = stream_chain(cfg, s, args.block_hops, device, seed=0)
        fn = counter.wrap(f"chip/{s}", fn)
        samples = s * args.block_hops * cfg.hop
        dev = device_ms(fn, example) if device.type == "cuda" else None
        wall = steady_state_ms(fn, example, iters=window(device))
        curve[s] = {"device_samples_per_s": None if dev is None else samples / (dev * 1e-3),
                    "wall_samples_per_s": samples / (wall * 1e-3)}
    return curve


def _rate(point: dict) -> float:
    """A curve point's rate: the device's where measured, else the wall's."""
    v = point["device_samples_per_s"]
    return point["wall_samples_per_s"] if v is None else v


def chip_stream_curve_interleaved(stream_counts, args, device, passes: int,
                                  counter: CallCounter) -> tuple:
    """``passes`` round-robin passes over every stream count; retention
    within each pass (against that pass's own peak), then its mean and
    half-spread across passes."""
    per_pass = []
    for pi in range(passes):
        curve = chip_stream_curve(stream_counts, args, device, counter)
        for s, pt in curve.items():
            wall = f"{pt['wall_samples_per_s'] / 1e6:.2f} wall"
            rate = (wall if pt["device_samples_per_s"] is None else
                    f"{pt['device_samples_per_s'] / 1e6:.2f} device, {wall}")
            print(f"chip[pass {pi + 1}/{passes}]: {s:4d} streams: {rate} Msamples/s", flush=True)
        per_pass.append(curve)
    summary = {}
    for s in stream_counts:
        rets = [_rate(c[s]) / max(map(_rate, c.values())) for c in per_pass]
        summary[s] = {
            "retention_mean": round(sum(rets) / len(rets), 4),
            "retention_half_spread": round((max(rets) - min(rets)) / 2, 4),
            "samples_per_s_per_pass": [round(_rate(c[s]), 0) for c in per_pass],
        }
        print(f"chip retention @ {s:4d} streams: {summary[s]['retention_mean']:.3f} "
              f"± {summary[s]['retention_half_spread']:.3f}", flush=True)
    return per_pass, summary


def run(args: argparse.Namespace) -> tuple:
    """(the whole result, the last line)."""
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.devices:
        counts = [int(x) for x in args.devices.split(",")]
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= cards]
    desc = describe_device(device)
    print(f"devices available: {cards} ({desc['kind']}, {desc['platform']}); sweep {counts}",
          flush=True)
    result = {"platform": desc["platform"], "device": desc, "counts": counts}
    counter = CallCounter()
    run_mesh = args.mesh_legs if args.mesh_legs is not None else cards > 1
    virtual = False
    if run_mesh:
        for leg, fn in (("dp", dp_leg), ("sp", sp_leg)):
            rows = {n: fn(n, args, device, counter) for n in counts}
            base = rows[counts[0]]["samples_per_s"] / counts[0]
            eff = {n: r["samples_per_s"] / (n * base) for n, r in rows.items()}
            for n, r in rows.items():
                v = " (virtual: " + ", ".join(r["devices"]) + ")" if r["virtual"] else ""
                print(f"{leg}: {n} device(s){v}: {r['samples_per_s'] / 1e6:.2f} Msamples/s, "
                      f"efficiency {eff[n] * 100:.1f}%", flush=True)
                virtual |= r["virtual"]
            result[f"{leg}_rows"] = rows
            result[f"{leg}_samples_per_s"] = {n: r["samples_per_s"] for n, r in rows.items()}
            result[f"{leg}_efficiency"] = eff
        if virtual:
            result["caveat"] = VIRTUAL_CAVEAT
            print(f"NOTE: {VIRTUAL_CAVEAT}", flush=True)

    if args.chip_streams:
        streams = [int(x) for x in args.chip_streams.split(",")]
        per_pass, summary = chip_stream_curve_interleaved(streams, args, device,
                                                          max(1, args.retention_passes), counter)
        curve = {s: _rate(pt) for s, pt in per_pass[-1].items()}
        result["chip_retention_interleaved"] = summary
        result["chip_retention_passes"] = args.retention_passes
        result["chip_stream_curve"] = per_pass[-1]
        result["chip_stream_curve_samples_per_s"] = curve
        result["chip_stream_state"] = args.stream_state
        result["chip_throughput_retention_vs_peak"] = {
            s: curve[s] / max(curve.values()) for s in streams}

    if run_mesh:
        nmax = counts[-1]
        line = {"metric": f"sp_scaling_efficiency_{nmax}dev",
                "value": round(result["sp_efficiency"][nmax], 4), "unit": "ratio",
                "dp_efficiency": round(result["dp_efficiency"][nmax], 4), "target": 0.8,
                "platform": result["platform"], "virtual": virtual}
    elif "chip_stream_curve_samples_per_s" in result:
        curve = result["chip_stream_curve_samples_per_s"]
        smax = max(curve)
        line = {"metric": f"chip_stream_throughput_{smax}x", "value": round(curve[smax] / 1e6, 1),
                "unit": "Msamples/s", "platform": result["platform"],
                "timer": "device" if device.type == "cuda" else "host wall"}
    else:
        line = {"metric": "scaling_noop", "value": 0, "unit": "none",
                "platform": result["platform"],
                "note": "1 device and no --chip-streams/--mesh-legs requested"}
    line["device"] = desc
    result["calls"] = counter.calls
    return result, line


def main(argv=None) -> dict:
    args = parse(argv)
    result, line = run(args)
    print(json.dumps(line), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
