"""Serving-state access patterns on the card (port of benches/hbm_pattern.py).

    python -m zen_tpu_torch.benches.hbm_pattern [--streams 512] [--device cuda]

Times each median stage of the 512-stream hop-256 step (44.1 kHz, B = 32
block hops, 513 bins, H = 21 history rows, K = 11 time taps, K = 13
frequency taps with a reflect border) beside a copy-only mirror with the
same access pattern (``ops/probe_cuda.py``), so that "bytes" and
"counting and index arithmetic" come apart by subtraction, and against
two contiguous ceilings. Stages, under the JAX artifact's keys:

  ceiling       x * c over the [S, H + B, bins] slab (55.7 MB at 512
                streams: it may partly sit in the 50 MB L2, so it is
                not called HBM)
  ceiling_big   x * c over a 256 MB flat array (larger than L2)
  time_real     K1, tap_median_time(x, x[:, :0], offsets, H) on the slab
  time_dma      #9 rows_copy(x, H, B): K1's thread mapping, one load
  freqT_real    K2 on the folded fresh rows [S * B, bins]; the port does
                not transpose, so this is K2 as the step runs it
  freqT_dma     #10 segment_copy at the same shape: the staging of the
                route K2 takes at that K, no selection
  transpose_rt  .t().contiguous() round trip of [S * B, bins + K - 1]
  roll          the state rotation torch.cat([x[:, B:], x[:, :B]], 1)
  freq_prod     the port's freq_filtered on the fresh rows [S, B, bins]

Bytes count each input read once and each output written once, from the
port's own kernels' shapes (no chain carry, no row padding). On the card
each stage is timed with ``runtime.profiling.device_ms``; on the CPU
(``--device cpu``, for tests) with ``steady_state_ms``, the host's wall
time, and the artifact says which. The artifact goes to ``--out``, by
default ``build/zen_tpu_torch/hbm_pattern.json``; the last line of
stdout is the JAX version's metric line.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import device_kind, platform, write_artifact
from ..device import resolve_device
from ..engine.config import OUTPUT_PERCUSSIVE, HPRConfig
from ..engine.spectral import freq_filtered, num_bins
from ..ops import median_cuda as mc
from ..ops import probe_cuda as pc
from ..runtime.profiling import device_ms, steady_state_ms

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory (NVIDIA's data sheet)
CEILING_LIMIT = 1.05  # ceiling_big above this share of it is an impossible reading
C_MUL = 1.0000001


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.benches.hbm_pattern")
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--block-hops", type=int, default=32)
    ap.add_argument("--fs", type=float, default=44100.0)
    ap.add_argument("--out", default=None, help="artifact path (default under build/)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=20, help="calls per timed window")
    ap.add_argument("--repeats", type=int, default=5, help="windows per stage (median)")
    ap.add_argument("--big-mb", type=int, default=256, help="ceiling_big's array size")
    return ap.parse_args(argv)


def measure(args: argparse.Namespace, log=print) -> dict:
    """Run every stage; ``log`` gets one line per stage and derived value."""
    dev = resolve_device(args.device)
    S, B, hop = args.streams, args.block_hops, args.hop
    cfg = HPRConfig(fs=args.fs, hop=hop, beta=2.0, causal=True,
                    outputs=OUTPUT_PERCUSSIVE, stream_state="f32")
    H, bins, kf = cfg.time_history, num_bins(cfg), cfg.freq_filter_len
    T, R, offs = H + B, S * B, tuple(cfg.time_offsets)
    gen = torch.Generator(device=dev).manual_seed(0)

    def mags(*shape):
        return torch.randn(shape, generator=gen, device=dev).abs_()

    slab = mags(S, T, bins)
    slab_bytes, out_bytes = slab.numel() * 4, S * B * bins * 4
    rows = mags(R, bins)
    on_card = dev.type == "cuda"
    stages: dict = {}

    def run(name, fn, example, nbytes, note):
        if on_card:
            ms = device_ms(fn, example, iters=args.iters, repeats=args.repeats)
        else:
            ms = steady_state_ms(fn, example, iters=args.iters, warmup=1)
        us = ms * 1e3
        gbps = nbytes / (us * 1e-6) / 1e9
        stages[name] = {"us_per_step": us, "bytes_per_iter": int(nbytes), "gbps": gbps,
                        "note": note}
        log(f"{name:13s} {us:10.2f} us {nbytes / 1e6:9.1f} MB {gbps:9.1f} GB/s  {note}")

    def keep(out, x):  # run a kernel, chain its input (no result cache here)
        return x

    run("ceiling", lambda x: x * C_MUL, slab, 2 * slab_bytes,
        f"x * c over the [{S},{T},{bins}] slab (may sit partly in L2)")
    big = mags(args.big_mb << 18)
    run("ceiling_big", lambda x: x * C_MUL, big, 2 * big.numel() * 4,
        f"x * c over {args.big_mb} MB flat")
    del big
    t_route, t_form = mc.time_route(offs), (None, None)
    if t_route == "register":
        t_form = mc.time_network_form(offs, B, S, bins)
        t_note = (f"shared core, runs of {t_form[1]} rows" if t_form[0] == "core" else
                  f"network, runs of {t_form[1]} rows, "
                  f"{len(mc.time_network_plan(offs, t_form[1])[0])} staged")
    else:
        t_note = t_route
    run("time_real", lambda x: keep(mc.tap_median_time(x, x[:, :0], offs, H), x), slab,
        slab_bytes + out_bytes, f"K1 {t_route} (K={len(offs)}; {t_note}) tail from row {H}")
    run("time_dma", lambda x: keep(pc.rows_copy(x, H, B), x), slab, 2 * out_bytes,
        f"#9 rows_copy rows {H}..{H + B} (K1's thread mapping, runs of "
        f"{mc.time_fill_run(B, S, bins)} rows: the run that fills the card, before "
        "the network's staging limit; the shared core takes its own R)")
    f_route = mc.freq_route(kf)
    # the outputs a block takes: the network route's share of a row, or the rank route's tile
    tile = mc.freq_network_chunk(bins) if f_route == "network" else mc.freq_rank_tile(kf)
    run("freqT_real", lambda y: keep(mc.sliding_median_boundary(y, kf, "reflect"), y), rows,
        2 * rows.numel() * 4,
        f"K2 {f_route} (K={kf}, {tile} outputs a block) on [{R},{bins}] reflect; the port "
        "applies the border on the load and does not transpose")
    run("freqT_dma", lambda y: keep(pc.segment_copy(y, kf, "reflect"), y), rows,
        2 * rows.numel() * 4,
        f"#10 segment_copy (K2 {f_route}'s staging, {tile} outputs a block, no selection)")
    del rows
    fp = bins + kf - 1
    wide = mags(R, fp)
    run("transpose_rt", lambda y: y.t().contiguous().t().contiguous(), wide,
        4 * wide.numel() * 4, f"[{R},{fp}] -> [{fp},{R}] -> back, .t().contiguous()")
    del wide
    run("roll", lambda x: torch.cat([x[:, B:], x[:, :B]], dim=1), slab, 2 * slab_bytes,
        "state rotation cat(x[:, B:], x[:, :B])")
    fresh = slab[:, H:].contiguous()
    run("freq_prod", lambda x: keep(freq_filtered(x, cfg), x), fresh, 2 * out_bytes,
        f"freq_filtered on the fresh rows [{S},{B},{bins}]")

    derived = {
        "time_compute_us": stages["time_real"]["us_per_step"] - stages["time_dma"]["us_per_step"],
        "freq_compute_us": (stages["freqT_real"]["us_per_step"]
                            - stages["freqT_dma"]["us_per_step"]),
        "hbm_ceiling_gbps": stages["ceiling_big"]["gbps"],
        "slab_ceiling_gbps": stages["ceiling"]["gbps"],
    }
    for k, v in derived.items():
        log(f"{k:22s} {v:.2f}")
    limit = CEILING_LIMIT * HBM_BYTES_PER_S / 1e9
    if on_card and derived["hbm_ceiling_gbps"] > limit:
        raise RuntimeError(
            f"ceiling_big read {derived['hbm_ceiling_gbps']:.1f} GB/s, above {limit:.0f} GB/s "
            f"({CEILING_LIMIT} x the card's {HBM_BYTES_PER_S / 1e12} TB/s): not a real reading"
        )
    return {
        "platform": platform(dev),
        "device_kind": device_kind(dev),
        "config": {
            "streams": S, "hop": hop, "block_hops": B, "fs": args.fs, "bins": bins,
            "history_rows": H, "time_taps": len(offs), "freq_taps": kf,
            "time_route": t_route, "time_network_form": t_form[0],
            "time_network_run": t_form[1],
            "freq_route": f_route, "freq_block_outputs": tile,
            "freq_rank_tile": mc.freq_rank_tile(kf) if f_route == "rank" else None,
        },
        "stages": stages,
        "derived": derived,
        "timer": "device_ms" if on_card else "steady_state_ms (host wall, cpu)",
        "methodology": (
            "device_ms per stage on the card (CUDA events around --iters chained calls "
            "behind a spin sized from the host's enqueue time; median of --repeats "
            "windows); bytes: each input read once, each output written once. Compare "
            "stages within this artifact only."
        ),
    }


def main(argv=None) -> dict:
    args = parse(argv)
    result = measure(args)
    path = write_artifact(result, args.out, "hbm_pattern.json")
    print(f"wrote {path}", file=sys.stderr)
    print(json.dumps({
        "metric": f"hbm_pattern_ceiling_{args.streams}streams",
        "value": result["stages"]["ceiling"]["gbps"],
        "unit": "GB/s",
        "platform": result["platform"],
    }))
    return result


if __name__ == "__main__":
    main()
