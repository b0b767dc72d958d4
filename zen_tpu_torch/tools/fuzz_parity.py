"""Randomized engine parity sweep of the port (counterpart of
``scripts/fuzz_parity.py``).

    python -m zen_tpu_torch.tools.fuzz_parity [seed] [n_cases] [mode] [--device cuda]

Samples random configurations (fs, hop, border, causal, mask variant,
beta, track length, random audio) and holds the port to the same checks
as the JAX sweep, mode by mode:

  oracle   hpr_separate and the causal HPRRealtime stream against the
           port's hop-by-hop numpy oracle (engine/oracle.py), 5e-4
  blocked  hpr_separate_blocked at a random block size against
           hpr_separate, 1e-4
  sharded  sharded_separate and sharded_separate_blocked over a dp x sp
           mesh of 8 shards against hpr_separate per channel, 1e-4
  twopass  HPRIOffline's cascade against the oracle cascade, 5e-4
  tp       tp_separate at tp 2, 4 or 8 against hpr_separate, 1e-3
  serving  MultiStreamHPR (with a random mid-run reset_streams) against
           independent HPRRealtime streams, 1e-4

Errors are relative to max(max|ref|, 1e-3) (oracle, twopass) or
max(1, max|ref|). An invalid configuration must be refused with a
ZenError (or the ValueError zen_tpu also accepts), never a crash; the
count of such refusals is printed. A disagreement raises
ParityMismatch, an AssertionError, as the JAX sweep's asserts do. Everything runs on ``--device`` (the
card by default; the sharded modes' meshes repeat it), and the run ends
in ``PARITY SWEEP PASS`` and a JSON line naming the device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..benches import describe_device
from ..device import resolve_device
from ..drivers.offline import HPRIOffline, hpr_separate, hpr_separate_blocked
from ..drivers.realtime import HPRRealtime, MultiStreamHPR
from ..engine.config import OUTPUT_ALL, OUTPUT_PERCUSSIVE, OUTPUT_RESIDUAL, HPRConfig
from ..engine.oracle import oracle_offline_pass, oracle_realtime_stream
from ..errors import ZenError
from ..parallel.mesh import make_mesh
from ..parallel.sharded import sharded_separate, sharded_separate_blocked, tp_separate

RTOL = 5e-4
STEMS = ("harmonic", "percussive", "residual")
REJECTED = (ZenError, ValueError)


class ParityMismatch(AssertionError):
    """A valid configuration whose output disagrees with its reference
    (never a ZenError, so no refusal handler can take it for one)."""


def _hold(err: float, limit: float, what: str) -> None:
    if not err < limit:
        raise ParityMismatch(f"{what} relerr={err:.2e}")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(audio: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(audio)).to(dev)


def _rel(got, want, floor: float) -> float:
    got, want = _host(got), _host(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def _cfg(fs, hop, beta, causal, border, variant, **kw) -> HPRConfig:
    return HPRConfig(fs=fs, hop=hop, beta=beta, causal=causal, border=border,
                     outputs=OUTPUT_ALL, fast_rfft=False, soft_mask=variant == "soft",
                     use_sse=variant == "sse", **kw)


def run_sweep(seed: int, n_cases: int, dev: torch.device, log=print) -> tuple:
    rng = np.random.default_rng(seed)
    ran = skipped = 0
    for case in range(n_cases):
        fs = float(rng.integers(800, 48001))
        hop = int(rng.choice([8, 16, 32, 64]))
        border = str(rng.choice(["wrap", "valid", "replicate"]))
        causal = bool(rng.integers(2))
        variant = str(rng.choice(["hard", "soft", "sse"]))
        beta = float(rng.uniform(1.0, 3.5))
        length = int(rng.integers(300, 2500))
        t = np.arange(length) / fs
        audio = (
            0.6 * np.sin(2 * np.pi * rng.uniform(30, fs / 8) * t)
            + 0.4 * (rng.random(length) > 0.97)
            + 0.05 * rng.standard_normal(length)
        ).astype(np.float32)
        desc = (f"case {case}: fs={fs:.0f} hop={hop} border={border} causal={causal} "
                f"variant={variant} beta={beta:.2f} L={length}")
        try:
            cfg = _cfg(fs, hop, beta, causal, border, variant)
        except REJECTED as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        want = oracle_offline_pass(audio, cfg)
        got = hpr_separate(_on(audio, dev), cfg)
        for k in STEMS:
            err = _rel(got[k], want[k], 1e-3)
            _hold(err, RTOL, f"{desc} stem={k}")
        if causal:
            want_rt = oracle_realtime_stream(audio, cfg)
            rt = HPRRealtime(fs, hop, beta, border=border, soft_mask=variant == "soft",
                             use_sse=variant == "sse", fast_rfft=False, device=dev)
            got_rt = rt.process_stream(audio, block_hops=16)
            w = np.stack([want_rt[k] for k in STEMS])
            err = _rel(got_rt[:, : w.shape[1]], w, 1e-3)
            _hold(err, RTOL, f"{desc} STREAM")
        ran += 1
        log(f"{desc} -> OK")
    return ran, skipped


def run_blocked_sweep(seed: int, n_cases: int, dev: torch.device, log=print) -> tuple:
    """hpr_separate_blocked against hpr_separate on random configs and
    block sizes, short tracks whose halo exceeds the track included."""
    rng = np.random.default_rng(seed)
    ran = skipped = 0
    for case in range(n_cases):
        fs = float(rng.integers(800, 48001))
        hop = int(rng.choice([8, 16, 32, 64]))
        border = str(rng.choice(["wrap", "valid", "replicate"]))
        causal = bool(rng.integers(2))
        variant = str(rng.choice(["hard", "soft", "sse"]))
        beta = float(rng.uniform(1.0, 3.5))
        length = int(rng.integers(300, 4000))
        bf = int(rng.choice([2, 4, 8, 16, 64]))
        audio = (0.5 * rng.standard_normal(length)).astype(np.float32)
        desc = (f"blocked case {case}: fs={fs:.0f} hop={hop} border={border} "
                f"causal={causal} variant={variant} beta={beta:.2f} L={length} bf={bf}")
        try:
            cfg = _cfg(fs, hop, beta, causal, border, variant)
        except REJECTED as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        x = _on(audio, dev)
        want = hpr_separate(x, cfg)
        got = hpr_separate_blocked(x, cfg, block_frames=bf)
        for k in STEMS:
            w = np.nan_to_num(_host(want[k]), posinf=0, neginf=0)
            g = np.nan_to_num(_host(got[k]), posinf=0, neginf=0)
            err = _rel(g, w, 1.0)
            _hold(err, 1e-4, f"{desc} stem={k}")
        ran += 1
        log(f"{desc} -> OK")
    return ran, skipped


def run_sharded_sweep(seed: int, n_cases: int, dev: torch.device, log=print) -> tuple:
    """sharded_separate (and its blocked scan) on a mesh of 8 shards of
    ``dev`` with random configs, splits and channel counts against
    hpr_separate per channel; a config whose time halo exceeds a shard
    must be refused with a ZenError."""
    rng = np.random.default_rng(seed)
    ran = skipped = 0
    for case in range(n_cases):
        fs = float(rng.integers(800, 16001))
        hop = int(rng.choice([16, 32, 64]))
        border = str(rng.choice(["wrap", "valid", "replicate"]))
        causal = bool(rng.integers(2))
        variant = str(rng.choice(["hard", "soft", "sse"]))
        beta = float(rng.uniform(1.0, 3.5))
        length = int(rng.integers(1500, 6000))
        dp = int(rng.choice([1, 2]))
        sp = 8 // dp
        n_ch = dp * int(rng.integers(1, 3))
        bf = int(rng.choice([2, 8, 32]))
        audio = (0.5 * rng.standard_normal((n_ch, length))).astype(np.float32)
        desc = (f"sharded case {case}: fs={fs:.0f} hop={hop} border={border} "
                f"causal={causal} variant={variant} beta={beta:.2f} L={length} dp={dp} "
                f"sp={sp} C={n_ch} bf={bf}")
        try:
            cfg = _cfg(fs, hop, beta, causal, border, variant)
        except REJECTED as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        mesh = make_mesh({"dp": dp, "sp": sp}, devices=[dev] * 8)
        x = _on(audio, dev)
        want = {k: np.stack([_host(hpr_separate(x[c], cfg)[k]) for c in range(n_ch)])
                for k in STEMS}

        try:
            got = sharded_separate(x, cfg, mesh)
        except ZenError as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        for k in STEMS:
            _hold(_rel(got[k], want[k], 1.0), 1e-4, f"{desc} SHARDED {k}")
        try:
            gotb = sharded_separate_blocked(x[0], cfg, mesh, block_frames=bf)
        except ZenError as e:
            log(f"{desc} -> blocked validated reject: {e}")
        else:
            for k in STEMS:
                _hold(_rel(gotb[k], want[k][0], 1.0), 1e-4, f"{desc} BLOCKED-SHARDED {k}")
        ran += 1
        log(f"{desc} -> OK")
    return ran, skipped


def run_twopass_sweep(seed: int, n_cases: int, dev: torch.device, log=print) -> tuple:
    """HPRIOffline's two-pass cascade against the oracle cascade (pass 1,
    its percussive + residual into pass 2) on random hop pairs, borders,
    betas and lengths."""
    rng = np.random.default_rng(seed)
    ran = skipped = 0
    for case in range(n_cases):
        fs = float(rng.integers(800, 24001))
        hop_p = int(rng.choice([8, 16]))
        hop_h = hop_p * int(rng.choice([2, 4, 8]))
        border = str(rng.choice(["wrap", "valid", "replicate"]))
        beta_h = float(rng.uniform(1.2, 3.2))
        beta_p = float(rng.uniform(1.2, 3.2))
        length = int(rng.integers(300, 2500))
        audio = (0.5 * rng.standard_normal(length)).astype(np.float32)
        desc = (f"twopass case {case}: fs={fs:.0f} hops={hop_h}/{hop_p} border={border} "
                f"betas={beta_h:.2f}/{beta_p:.2f} L={length}")
        try:
            sep = HPRIOffline(fs, hop_h, hop_p, beta_h, beta_p, border=border,
                              fast_rfft=False, device=dev)
            cfg_h = HPRConfig(fs=fs, hop=hop_h, beta=beta_h, causal=False, border=border,
                              outputs=OUTPUT_ALL, fast_rfft=False)
            cfg_p = HPRConfig(fs=fs, hop=hop_p, beta=beta_p, causal=False, border=border,
                              outputs=OUTPUT_PERCUSSIVE | OUTPUT_RESIDUAL, fast_rfft=False)
        except REJECTED as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        h, p, r = sep.process(audio)
        pass1 = oracle_offline_pass(audio, cfg_h)
        pass2 = oracle_offline_pass(pass1["percussive"] + pass1["residual"], cfg_p)
        for tag, g, w in (("harm", h, pass1["harmonic"]), ("perc", p, pass2["percussive"]),
                          ("res", r, pass2["residual"])):
            err = _rel(g, w, 1e-3)
            _hold(err, RTOL, f"{desc} {tag}")
        ran += 1
        log(f"{desc} -> OK")
    return ran, skipped


def run_tp_sweep(seed: int, n_cases: int, dev: torch.device, log=print) -> tuple:
    """Frequency TP (partial-DFT matmuls) at tp 2, 4 or 8 against the
    unsharded pass; a width that cannot shard must be refused with a
    ZenError. Wrap border only (the bin halo ring is circular)."""
    rng = np.random.default_rng(seed)
    ran = skipped = 0
    for case in range(n_cases):
        fs = float(rng.integers(800, 24001))
        hop = int(rng.choice([16, 32, 64]))
        causal = bool(rng.integers(2))
        variant = str(rng.choice(["hard", "soft"]))
        beta = float(rng.uniform(1.2, 3.2))
        length = int(rng.integers(500, 2500))
        tp = int(rng.choice([2, 4, 8]))
        audio = (0.5 * rng.standard_normal(length)).astype(np.float32)
        desc = (f"tp case {case}: fs={fs:.0f} hop={hop} causal={causal} variant={variant} "
                f"beta={beta:.2f} L={length} tp={tp}")
        try:
            cfg = _cfg(fs, hop, beta, causal, "wrap", variant)
        except REJECTED as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        mesh = make_mesh({"tp": tp}, devices=[dev] * tp)
        x = _on(audio, dev)
        want = hpr_separate(x, cfg)
        try:
            got = tp_separate(x, cfg, mesh)
        except ZenError as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        for k in STEMS:
            err = _rel(got[k], want[k], 1.0)
            _hold(err, 1e-3, f"{desc} stem={k}")
        ran += 1
        log(f"{desc} -> OK")
    return ran, skipped


def run_serving_sweep(seed: int, n_cases: int, dev: torch.device, log=print) -> tuple:
    """MultiStreamHPR against C independent HPRRealtime streams on random
    configs, stream counts and block sizes; on half the cases a random
    mid-run ``reset_streams``: reset slots must reproduce fresh streams
    from the reset on, the others continue unperturbed."""
    rng = np.random.default_rng(seed)
    ran = skipped = 0
    for case in range(n_cases):
        fs = float(rng.integers(800, 48001))
        hop = int(rng.choice([8, 16, 32]))
        border = str(rng.choice(["wrap", "valid", "replicate"]))
        variant = str(rng.choice(["hard", "soft", "sse"]))
        beta = float(rng.uniform(1.0, 3.5))
        n_ch = int(rng.integers(2, 6))
        b = int(rng.choice([2, 4, 8]))
        n_blocks = int(rng.integers(2, 6))
        reset_at = int(rng.integers(1, n_blocks)) if rng.integers(2) else 0
        reset_idx = (sorted(int(i) for i in rng.choice(
            n_ch, size=int(rng.integers(1, n_ch)), replace=False)) if reset_at else [])
        desc = (f"serving case {case}: fs={fs:.0f} hop={hop} border={border} "
                f"variant={variant} beta={beta:.2f} C={n_ch} b={b} blocks={n_blocks} "
                f"reset@{reset_at}={reset_idx}")
        kw = dict(border=border, soft_mask=variant == "soft", use_sse=variant == "sse",
                  device=dev)
        try:
            ms = MultiStreamHPR(n_ch, fs, hop, beta, **kw)
        except REJECTED as e:
            skipped += 1
            log(f"{desc} -> validated reject: {e}")
            continue
        audio = (0.5 * rng.standard_normal((n_ch, n_blocks * b * hop))).astype(np.float32)
        blocks = _on(audio.reshape(n_ch, n_blocks, b, hop), dev)
        outs = []
        for k in range(n_blocks):
            if reset_idx and k == reset_at:
                ms.reset_streams(reset_idx)
            outs.append(_host(ms.process_block(blocks[:, k])))
        multi = np.concatenate(outs, axis=-1)  # [C, 3, L]
        cut = reset_at * b * hop
        for c in range(n_ch):
            rt = HPRRealtime(fs, hop, beta, **kw)
            if c in reset_idx:
                pre = rt.process_stream(audio[c][:cut], block_hops=b)
                post = HPRRealtime(fs, hop, beta, **kw).process_stream(audio[c][cut:],
                                                                       block_hops=b)
                want = np.concatenate([pre, post], axis=-1)
            else:
                want = rt.process_stream(audio[c], block_hops=b)
            err = _rel(multi[c], want, 1.0)
            _hold(err, 1e-4, f"{desc} stream={c}")
        ran += 1
        log(f"{desc} -> OK")
    return ran, skipped


MODES = {
    "oracle": run_sweep,
    "blocked": run_blocked_sweep,
    "sharded": run_sharded_sweep,
    "twopass": run_twopass_sweep,
    "tp": run_tp_sweep,
    "serving": run_serving_sweep,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.tools.fuzz_parity")
    ap.add_argument("seed", type=int, nargs="?", default=0)
    ap.add_argument("n_cases", type=int, nargs="?", default=60)
    ap.add_argument("mode", nargs="?", default="oracle", choices=sorted(MODES))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {describe_device(dev)}", flush=True)
    ran, skipped = MODES[args.mode](args.seed, args.n_cases, dev,
                                   log=lambda line: print(line, flush=True))
    print(f"PARITY SWEEP PASS: {ran} ran, {skipped} validated-rejected "
          f"(seed={args.seed}, mode={args.mode}, device={dev})", flush=True)
    print(json.dumps({"metric": "fuzz_parity", "mode": args.mode, "seed": args.seed,
                      "ran": ran, "rejected": skipped, "device": describe_device(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
