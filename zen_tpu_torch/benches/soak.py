"""Stability soak: hours of audio through the multistream causal step
(counterpart of ``benches/soak.py``).

    python -m zen_tpu_torch.benches.soak [--dispatches 20] [--device cuda]
    python -m zen_tpu_torch.benches.soak --streams 8 --steps 16 --dispatches 2   # short

Streams stream-hours through ``MultiStreamHPR``'s block step (the step
the serving path runs) and checks, on the device, that every output
stays finite and that the output envelope does not drift: the OLA tails
and the feature history are the long-run failure surface. Each dispatch
is ``--steps`` block steps whose input mixes in the previous step's
output (a device op); the per-dispatch stats (max |out| and the count of
non-finite samples) are reduced on the device, step by step, and read
back once per dispatch: no step waits on the host.

Defaults give ~1.69 stream-hours a dispatch: 64 streams x 32-hop blocks
x hop 256 x 512 steps at 44.1 kHz. Prints one JSON line with the JAX
instrument's keys,

  {"metric": "soak_stream_hours", "value": H, "finite": true,
   "max_abs_first": ..., "max_abs_last": ..., "drift_ratio": ...}

and the device it ran on. max_abs_* are per-dispatch maxima, so
drift_ratio = last / first shows a growing envelope (> 1) and a decaying
one (< 1) alike. A non-finite output ends the run with exit code 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import describe_device
from ..device import resolve_device
from ..drivers.realtime import MultiStreamHPR
from ..engine.config import OUTPUT_ALL


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.benches.soak")
    ap.add_argument("--fs", type=float, default=44100.0)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--block-hops", type=int, default=32)
    ap.add_argument("--steps", type=int, default=512, help="block steps per dispatch")
    ap.add_argument("--dispatches", type=int, default=20)
    ap.add_argument("--stream-state", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--fft-impl", default="auto",
                    choices=("auto", "torch", "dft", "dft_bf16", "dft_f32"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dispatches < 1:
        ap.error("--dispatches must be >= 1")
    return args


class Soak:
    """The soak's fleet and its chained input; ``dispatch()`` runs
    ``steps`` block steps and returns that dispatch's (max |out|,
    non-finite count) as device scalars, read by nobody in between."""

    def __init__(self, args: argparse.Namespace):
        self.dev = resolve_device(args.device)
        self.ms = MultiStreamHPR(args.streams, args.fs, args.hop, outputs=OUTPUT_ALL,
                                 stream_state=args.stream_state, fft_impl=args.fft_impl,
                                 device=self.dev)
        self.steps, self.block_hops = args.steps, args.block_hops
        rng = np.random.default_rng(0)
        self.base = torch.from_numpy(rng.standard_normal(
            (args.streams, args.block_hops, args.hop)).astype(np.float32)).to(self.dev)
        self.prev = torch.zeros((args.streams, 3, args.block_hops * args.hop), device=self.dev)
        self.calls = 0

    def dispatch(self) -> tuple:
        mx = torch.zeros((), device=self.dev)
        bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        for _ in range(self.steps):
            blocks = self.base + 1e-12 * self.prev[:, -1].reshape(self.base.shape)
            self.prev = self.ms.process_block(blocks)
            self.calls += 1
            mx = torch.maximum(mx, self.prev.abs().amax())
            bad += (~torch.isfinite(self.prev)).sum()
        return mx, bad


def run(args: argparse.Namespace) -> tuple:
    """(the JSON line, exit code)."""
    soak = Soak(args)
    per_dispatch = args.streams * args.block_hops * args.hop * args.steps
    device = describe_device(soak.dev)
    log(f"soak: {args.streams} streams x hop {args.hop} x {args.block_hops}-hop blocks, "
        f"{args.steps} steps/dispatch ({per_dispatch / args.fs / 3600:.2f} stream-h each), "
        f"device {device['kind']} ({device['platform']}, count {device['count']})")
    max_first = mx = None
    t0 = time.time()
    for d in range(args.dispatches):
        # fresh stats each dispatch: per-dispatch maxima, so a decay shows too
        stats = torch.stack([t.double() for t in soak.dispatch()]).cpu()  # the one readback
        mx, bad = float(stats[0]), int(stats[1])
        if bad:
            log(f"dispatch {d}: {bad} non-finite outputs — ABORT")
            return {"metric": "soak_stream_hours", "value": 0.0, "finite": False,
                    "dispatch": d, "device": device}, 1
        if max_first is None:
            max_first = mx
        log(f"dispatch {d + 1}/{args.dispatches}: max|out|={mx:.1f}, finite, "
            f"{(d + 1) * per_dispatch / args.fs / 3600:.2f} stream-h, "
            f"{time.time() - t0:.0f}s wall")
    hours = args.dispatches * per_dispatch / args.fs / 3600
    return {
        "metric": "soak_stream_hours",
        "value": round(hours, 2),
        "finite": True,
        "max_abs_first": round(max_first, 1),
        "max_abs_last": round(mx, 1),
        "drift_ratio": round(mx / max_first, 4) if max_first else 1.0,
        "steps": soak.calls,
        "device": device,
    }, 0


def main(argv=None) -> int:
    line, rc = run(parse(argv))
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
