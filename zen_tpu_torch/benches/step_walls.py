"""Host wall per streaming step, for comparing two trees in one call.

    python zen_tpu_torch/benches/step_walls.py [--tree DIR] [--label NAME]

Imports ``zen_tpu_torch`` from ``--tree`` (default: the checkout this
file lies in), so that one call on the card can time another checkout's
package beside this one's, in turns (parent, change, change, parent),
each in its own process. Times, on the card, the steps chip_smoke.py's
streaming phases drive: ``HPRRealtime`` at 44.1 kHz hop 1024 and hop 32
(B=32 and B=1), ``MultiStreamHPR`` with 64 streams at hop 256 (B=32) and
the 512-stream percussive fleet at hop 256 (B=16) in f32 and bf16 stream
state: the mean host wall of ``--runs`` synchronized steps after 5 warm
ones (3 × ``--runs`` at B=1). Prints one line, the label and each wall
in µs.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--runs", type=int, default=100)
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch
    import zen_tpu_torch
    from zen_tpu_torch import OUTPUT_PERCUSSIVE, HPRRealtime, MultiStreamHPR

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for hop in (1024, 32):
        rt = HPRRealtime(44100.0, hop=hop)
        blk = torch.randn(32, hop, generator=gen, device="cuda")
        out[f"hop{hop} B=32"] = wall(lambda: rt.process_block(blk), args.runs)
        out[f"hop{hop} B=1"] = wall(lambda: rt.process_next_hop(blk[0]), 3 * args.runs)
    ms = MultiStreamHPR(64, 44100.0, 256)
    b64 = torch.randn(64, 32, 256, generator=gen, device="cuda")
    out["64 x hop256 B=32"] = wall(lambda: ms.process_block(b64), args.runs)
    for state in ("f32", "bf16"):
        ms = MultiStreamHPR(512, 44100.0, 256, outputs=OUTPUT_PERCUSSIVE, stream_state=state)
        b512 = torch.randn(512, 16, 256, generator=gen, device="cuda")
        out[f"512 x hop256 B=16 {state}"] = wall(lambda: ms.process_block(b512), args.runs)
    print(args.label, " | ".join(f"{k} {v:.1f}" for k, v in out.items()), flush=True)
    return out


if __name__ == "__main__":
    main()
