"""Where a serving step's time goes (port of benches/serving_bound.py).

    python -m zen_tpu_torch.benches.serving_bound [--streams 64,256,512]
        [--stream-state f32|bf16] [--device cuda]

Splits the streaming block step (hop 256 at 44.1 kHz, 32-hop blocks,
percussive only: the configuration of the JAX instrument) into legs, at
each stream count S:

  full       drivers/realtime.block_step on init_state(cfg, S)
  transform  analyze + synthesize(s, 0.5) on [S, B, nwin] frames (a
             scalar mask, so no mask bytes)
  median     time_filtered_tail from row H on the [S, H + B, bins]
             features, freq_filtered on the fresh rows, and the cat roll,
             in the stream state's dtype (bf16 histories under
             --stream-state bf16)
  rest       full - transform - median (masks, OLA, state moves, glue)

Each leg is timed twice: ``device_us`` with ``runtime.profiling.device_ms``
(the card's time) and ``wall_us`` with ``steady_state_ms`` (host wall over
a steady window); their gap is the host's share of a steady window. On
the CPU (``--device cpu``, for tests) only the wall time is measured and
the device columns are null. The artifact goes to ``--out``, by default
``build/zen_tpu_torch/serving_bound_<state>.json``; the last line of
stdout is the JAX version's metric line.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import device_kind, platform, write_artifact
from ..device import resolve_device
from ..drivers.realtime import block_step, hist_dtype, init_state
from ..engine.config import OUTPUT_PERCUSSIVE, HPRConfig
from ..engine.spectral import analyze, freq_filtered, num_bins, synthesize, time_filtered_tail
from ..runtime.profiling import device_ms, steady_state_ms

LEGS = ("full", "transform", "median", "rest")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.benches.serving_bound")
    ap.add_argument("--streams", default="64,256,512")
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--block-hops", type=int, default=32)
    ap.add_argument("--fs", type=float, default=44100.0)
    ap.add_argument("--stream-state", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--out", default=None, help="artifact path (default under build/)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=10, help="calls per device window")
    ap.add_argument("--repeats", type=int, default=5, help="device windows per leg (median)")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> HPRConfig:
    return HPRConfig(fs=args.fs, hop=args.hop, beta=2.0, causal=True,
                     outputs=OUTPUT_PERCUSSIVE, stream_state=args.stream_state)


def legs(cfg: HPRConfig, n_streams: int, block_hops: int, device, seed: int = 0) -> dict:
    """{leg: (fn, example)} of the three measured legs, chained as the
    timers call them (fn's output is its next input; full and transform
    take their example's tensor every call, the card has no result cache
    to skip them); inputs are made on ``device`` from ``seed``."""
    S, B, H = n_streams, block_hops, cfg.time_history
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_state(cfg, S, device)
    blocks = torch.randn((S, B, cfg.hop), generator=gen, device=device)
    frames = torch.randn((S, B, cfg.nwin), generator=gen, device=device)
    dt = hist_dtype(cfg)
    feats = torch.randn((S, H + B, num_bins(cfg)), generator=gen, device=device).abs_().to(dt)
    fresh = feats[:, H:].contiguous()
    base = fresh.float()

    def median(carry):
        # zen_tpu's median leg (benches/serving_bound.py:195), batched:
        # the tails and the fresh rows' frequency median, folded into the
        # fixed fresh rows at 1e-12 so the chain stays data-dependent,
        # then the history rolled
        hist, rows = carry
        h = time_filtered_tail(hist, cfg, H)
        p = freq_filtered(rows, cfg).float()
        new = (base + 1e-12 * (h + p)).to(dt)
        return torch.cat([hist[:, B:], new], dim=1), new

    return {
        "full": (lambda _: block_step(cfg, state, blocks), blocks),
        "transform": (lambda _: synthesize(analyze(frames, cfg), 0.5, cfg), frames),
        "median": (median, (feats, fresh)),
    }


def measure(args: argparse.Namespace, log=print) -> dict:
    dev = resolve_device(args.device)
    cfg = config(args)
    on_card = dev.type == "cuda"
    counts = [int(s) for s in args.streams.split(",")]
    result = {
        "platform": platform(dev),
        "device_kind": device_kind(dev),
        "config": {"hop": args.hop, "block_hops": args.block_hops, "fs": args.fs,
                   "outputs": "percussive", "stream_state": args.stream_state},
        "legs_us_per_step": {},
        "legs_wall_us_per_step": {},
        "per_sample_ns": {},
        "idle_share": {},
        "timer": "device_ms and steady_state_ms" if on_card else "steady_state_ms (host wall, cpu)",
        "methodology": (
            "legs_us_per_step: device_ms (CUDA events around --iters chained calls behind "
            "a spin sized from the host's enqueue time, median of --repeats windows); "
            "legs_wall_us_per_step: steady_state_ms (3 x --iters calls ending in a "
            "synchronize); 'rest' = full - transform - median in each; idle_share = 1 - "
            "device/wall of the full leg. Compare legs within this artifact only."
        ),
    }
    for S in counts:
        samples = S * args.block_hops * args.hop
        dev_us, wall_us = {}, {}
        for name, (fn, example) in legs(cfg, S, args.block_hops, dev).items():
            if on_card:
                dev_us[name] = device_ms(fn, example, iters=args.iters,
                                         repeats=args.repeats) * 1e3
            wall_us[name] = steady_state_ms(fn, example, iters=3 * args.iters) * 1e3
        for d in (dev_us, wall_us) if on_card else (wall_us,):
            d["rest"] = d["full"] - d["transform"] - d["median"]
        result["legs_us_per_step"][S] = dev_us if on_card else dict.fromkeys(LEGS)
        result["legs_wall_us_per_step"][S] = wall_us
        result["per_sample_ns"][S] = {
            leg: (dev_us[leg] * 1e3 / samples if on_card else None) for leg in LEGS}
        result["idle_share"][S] = 1 - dev_us["full"] / wall_us["full"] if on_card else None
        dev_txt = " | ".join(f"{leg} {dev_us[leg]:.2f}" for leg in LEGS) if on_card else "not measured"
        log(f"S={S} {args.stream_state}: device us/step {dev_txt}; wall us/step "
            + " | ".join(f"{leg} {wall_us[leg]:.2f}" for leg in LEGS)
            + (f"; idle share {result['idle_share'][S]:.3f}; "
               f"{samples / dev_us['full']:.1f} Msamples/s device, "
               f"{samples / wall_us['full']:.1f} wall" if on_card else ""))
    # least transform traffic: read the frames, write and read the complex
    # spectrum at the transform boundaries, write the synthesis frames
    bins = cfg.nfft // 2 + 1
    result["transform_min_traffic_bytes_per_sample"] = (
        4.0 * (cfg.nwin + 2 * (2 * bins) + cfg.nwin) / cfg.hop)
    return result


def main(argv=None) -> dict:
    args = parse(argv)
    result = measure(args)
    path = write_artifact(result, args.out, f"serving_bound_{args.stream_state}.json")
    print(f"wrote {path}", file=sys.stderr)
    smax = max(result["legs_wall_us_per_step"])
    on_card = result["platform"] == "gpu"
    table = result["legs_us_per_step" if on_card else "legs_wall_us_per_step"]
    print(json.dumps({
        "metric": f"serving_bound_full_{smax}streams",
        "value": table[smax]["full"],
        "unit": "us_per_step",
        "platform": result["platform"],
        "timer": "device" if on_card else "host wall",
    }))
    return result


if __name__ == "__main__":
    main()
