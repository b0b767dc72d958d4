"""Host wall per streaming step, for comparing two trees in one call.

    python zen_tpu_torch/benches/step_walls.py [--tree DIR] [--label NAME]
        [--fft-impl dft|dft_bf16|dft_f32]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), so that one call on the card can time another checkout's
package beside this one's, in turns (parent, change, change, parent),
each in its own process. Times, on the card, the steps chip_smoke.py's
streaming phases drive: ``HPRRealtime`` at 44.1 kHz hop 1024 and hop 32
(B=32 and B=1), ``MultiStreamHPR`` with 64 streams at hop 256 (B=32),
unsharded and over a dp=4 mesh of the card (chip_smoke phase 20's
fleet, its wall alone), and the 512-stream percussive fleet at hop 256
(B=16) in f32 and bf16 stream state: the mean host wall of ``--runs``
synchronized steps after 5 warm ones (3 × ``--runs`` at B=1), and for
each step its device µs
(``runtime.profiling.device_ms``, the median of 3 windows of 10).
Last, the pipe: ``zen-torch stream --streams 512`` run in-process on 16
blocks per stream, as its own ``stream_serving`` line counts it, in
Msamples/s. ``--fft-impl`` sets every step's and the pipe's transform.
Prints one line, the label, each time in µs and the pipe's rate.
"""
from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--fft-impl", default="auto")
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch
    import zen_tpu_torch
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, HPRRealtime, MultiStreamHPR
    from zen_tpu_torch.parallel.mesh import make_mesh
    from zen_tpu_torch.runtime.profiling import device_ms

    if not zen_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"zen_tpu_torch came from {zen_tpu_torch.__file__}, not {tree}")

    def wall(fn, runs):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / runs * 1e6

    def timed(name, step, x):
        out[name] = wall(lambda: step(x), args.runs)
        out[f"{name} device"] = device_ms(lambda _: step(x), x, iters=10, repeats=3) * 1e3

    kw = {"fft_impl": args.fft_impl}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for hop in (1024, 32):
        rt = HPRRealtime(44100.0, hop=hop, **kw)
        blk = torch.randn(32, hop, generator=gen, device="cuda")
        timed(f"hop{hop} B=32", rt.process_block, blk)
        out[f"hop{hop} B=1"] = wall(lambda: rt.process_next_hop(blk[0]), 3 * args.runs)
        out[f"hop{hop} B=1 device"] = device_ms(lambda _: rt.process_next_hop(blk[0]), blk[0],
                                                iters=10, repeats=3) * 1e3
    ms = MultiStreamHPR(64, 44100.0, 256, **kw)
    fleet = torch.randn(64, 32, 256, generator=gen, device="cuda")
    timed("64 x hop256 B=32", ms.process_block, fleet)
    # its host wall only: a device_ms window of 10 steps of 4 shards
    # passes the card's ~1024-entry launch queue
    ms = MultiStreamHPR(64, 44100.0, 256, mesh=make_mesh({"dp": 4}, devices=["cuda"] * 4), **kw)
    out["64 x hop256 B=32 dp=4"] = wall(lambda: ms.process_block(fleet), args.runs)
    for state in ("f32", "bf16"):
        ms = MultiStreamHPR(512, 44100.0, 256, outputs=OUTPUT_PERCUSSIVE, stream_state=state, **kw)
        timed(f"512 x hop256 B=16 {state}", ms.process_block,
              torch.randn(512, 16, 256, generator=gen, device="cuda"))
    out["pipe 512 Msamples/s"] = pipe_msps(512, 16, 256, 16, args.fft_impl)
    print(args.label, " | ".join(f"{k} {v:.1f}" for k, v in out.items()), flush=True)
    return out


def pipe_msps(streams: int, blocks: int, hop: int, block_hops: int, fft_impl: str) -> float:
    """``samples_per_s`` of the stream command's own last stderr line, in
    millions, for ``blocks`` blocks of seeded noise per stream through
    the CLI's main() with stdin and stdout swapped for byte buffers."""
    import numpy as np
    from zen_tpu_torch.cli import main as cli_main

    audio = np.random.default_rng(0).standard_normal(
        (blocks * block_hops * hop, streams)).astype(np.float32)
    saved = sys.stdin, sys.stdout, sys.stderr
    sys.stdin = io.TextIOWrapper(io.BytesIO(audio.tobytes()))
    sys.stdout = io.TextIOWrapper(io.BytesIO())
    sys.stderr = io.StringIO()
    try:
        rc = cli_main(["stream", "--streams", str(streams), "--fs", "44100", "--hop", str(hop),
                       "--block-hops", str(block_hops), "--fft-impl", fft_impl])
        err = sys.stderr.getvalue()
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved
    if rc != 0:
        raise SystemExit(f"zen-torch stream exited {rc}: {err[-1000:]}")
    return json.loads(err.splitlines()[-1])["samples_per_s"] / 1e6


if __name__ == "__main__":
    main()
