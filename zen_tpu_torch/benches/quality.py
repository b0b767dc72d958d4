"""Separation quality: SI-SNR against ground truth (port of
benches/quality.py).

    python -m zen_tpu_torch.benches.quality [--fs 22050] [--seconds 2]
        [--json PATH] [--check] [--device cuda]

``run_fs`` separates the easy chord/bursts mixture and the hard mixture
(``io/synth.py``, a copy of zen_tpu's) with HPRIOffline over the hop-pair
cascades valid at the sample rate, with the variant axes (beta, soft
mask, SSE) at the 1024/256 gate cascade. ``run_ladder`` streams both
mixtures through HPRRealtime at hop 256 in float32 and in each
precision rung of LADDER, and measures each rung against the float32
stream. On the card ``fft_impl='dft_bf16'`` really rounds the DFT's
operands to bf16 (ops/fft.py); so does the port's CPU route, where
zen_tpu's CPU computes that rung in float32.

``--check`` holds the hard-mixture floors at 1024/256 (CHECK_FLOORS) and
every ladder row against LADDER_FLOORS_DB, as zen_tpu's instrument does;
SSE_FLOORS_DB are the SSE variant's floors of tests/test_quality.py:93.
Runs on the card by default (``--device cpu`` on a machine without one);
every row names the platform it ran on.
"""
from __future__ import annotations

import argparse
import json

from . import platform
from ..device import resolve_device
from ..drivers.offline import HPRIOffline
from ..drivers.realtime import HPRRealtime
from ..engine.config import HPRConfig
from ..errors import ZenError
from ..io.synth import make_hard_mixture, make_quality_mixture, si_snr

# hop-pair cascades swept (validated per fs); (4096, 256) is the
# reference CLI's default, (1024, 256) the test-gate cascade
HOP_PAIRS = ((1024, 256), (2048, 256), (4096, 256), (512, 128))

# hard-mixture floors at the flagship (1024/256, hard mask, beta 2)
CHECK_FLOORS = {"harm_db": 15.0, "perc_db": 5.0, "cym_resid_db": 2.0}

# the SSE variant's floors on the hard mixture at 1024/256, fs 22050
# (tests/test_quality.py:93; measured 17.7/1.9 there on the CPU)
SSE_FLOORS_DB = {"harm_db": 15.0, "perc_db": 0.5}

# the serving precision ladder: each rung against the float32 stream
LADDER = (
    ("bf16_state", {"stream_state": "bf16"}),
    ("full_bf16", {"stream_state": "bf16", "fft_impl": "dft_bf16"}),
)

# vs-f32 floors of the rungs (benches/quality.py:71, calibrated on
# zen_tpu's runs including a TPU's)
LADDER_FLOORS_DB = {"bf16_state": 25.0, "full_bf16": 22.0}


def _valid_pair(fs: float, hop_h: int, hop_p: int) -> bool:
    try:
        HPRConfig(fs=fs, hop=hop_h, causal=False)
        HPRConfig(fs=fs, hop=hop_p, causal=False)
        return True
    except ZenError:
        return False


def _mixtures(fs: float, seconds: float) -> dict:
    easy = make_quality_mixture(fs, seconds)
    hard = make_hard_mixture(fs, seconds)
    return {
        "easy": {"harm": easy[0], "perc": easy[1], "mix": easy[2]},
        "hard": {"harm": hard[0], "perc": hard[1], "cym": hard[2], "mix": hard[3]},
    }


def offline_row(fs, mname, sig, hop_h, hop_p, vname, beta, kw, device) -> dict:
    """One separation of one mixture, scored against its ground truth."""
    n, device = len(sig["mix"]), resolve_device(device)
    sep = HPRIOffline(fs, hop_h, hop_p, beta, beta, device=device, **kw)
    h, p, r = (x.cpu().numpy()[:n] for x in sep.process(sig["mix"]))
    row = {
        "fs": fs, "mixture": mname, "cascade": f"{hop_h}/{hop_p}", "variant": vname,
        "beta": beta, "platform": platform(device),
        "harm_db": round(si_snr(sig["harm"], h), 2),
        "perc_db": round(si_snr(sig["perc"], p), 2),
    }
    if "cym" in sig:
        row["cym_resid_db"] = round(si_snr(sig["cym"], r), 2)
        row["cym_perc_db"] = round(si_snr(sig["cym"], p), 2)
    return row


def run_fs(fs: float, seconds: float, rows: list, device="cuda", log=print) -> list:
    """The offline sweep at one sample rate; appends to and returns rows."""
    device = resolve_device(device)
    mixtures = _mixtures(fs, seconds)
    log(f"fs={fs:.0f} ({platform(device)})")
    log(f"{'mixture':<6} {'cascade':<10} {'variant':<14} "
        f"{'harm dB':>8} {'perc dB':>8} {'cym->r dB':>10}")
    for hop_h, hop_p in HOP_PAIRS:
        if not _valid_pair(fs, hop_h, hop_p):
            log(f"       {hop_h}/{hop_p}: invalid at fs={fs:.0f} (l_harm floor), skipped")
            rows.append({"fs": fs, "cascade": f"{hop_h}/{hop_p}", "status": "invalid_at_fs"})
            continue
        variants = [("hard", 2.0, {})]
        if (hop_h, hop_p) == (1024, 256):
            variants += [
                ("hard", 1.5, {}), ("hard", 2.5, {}), ("hard", 3.0, {}),
                ("soft", 2.0, {"soft_mask": True}),
                ("sse", 2.0, {"use_sse": True}),
            ]
        if (hop_h, hop_p) == (4096, 256) and fs >= 44000:
            variants += [("hard", 2.5, {})]  # `zen offline --hps 4096 2.5 256 2.5`
        for mname, sig in mixtures.items():
            for vname, beta, kw in variants:
                row = offline_row(fs, mname, sig, hop_h, hop_p, vname, beta, kw, device)
                rows.append(row)
                cd = f"{row['cym_resid_db']:10.2f}" if "cym_resid_db" in row else ""
                log(f"{mname:<6} {hop_h}/{hop_p:<5} {f'{vname} b={beta}':<14} "
                    f"{row['harm_db']:8.2f} {row['perc_db']:8.2f} {cd}")
    return rows


def run_ladder(fs: float, seconds: float, rows: list, device="cuda", log=print) -> list:
    """The causal streaming precision ladder at the serving config (hop
    256, 32-hop blocks, hard mask, beta 2): each rung against the float32
    stream (vs_f32_*_db) and against ground truth (aligned by the one-hop
    latency)."""
    device = resolve_device(device)
    hop, stems = 256, ("harm", "perc", "resid")
    log(f"ladder fs={fs:.0f} ({platform(device)})")
    log(f"{'mixture':<6} {'mode':<11} " + " ".join(f"{'vsf32_' + s + ' dB':>14}" for s in stems)
        + f" {'harm dB':>8} {'perc dB':>8}")
    for mname, sig in _mixtures(fs, seconds).items():
        mix, n = sig["mix"], len(sig["mix"])
        outs = {mode: HPRRealtime(fs, hop, 2.0, device=device, **kw).process_stream(
                    mix, block_hops=32) for mode, kw in (("f32", {}),) + LADDER}
        for mode, _ in LADDER:
            y = outs[mode]
            row = {"fs": fs, "mixture": mname, "mode": mode, "platform": platform(device),
                   "config": "stream hop=256 beta=2.0 hard-mask"}
            for si, sname in enumerate(stems):
                row[f"vs_f32_{sname}_db"] = round(si_snr(outs["f32"][si], y[si]), 2)
            row["harm_db"] = round(si_snr(sig["harm"][: n - hop], y[0][hop:n]), 2)
            row["perc_db"] = round(si_snr(sig["perc"][: n - hop], y[1][hop:n]), 2)
            rows.append(row)
            log(f"{mname:<6} {mode:<11} "
                + " ".join(f"{row[f'vs_f32_{s}_db']:14.2f}" for s in stems)
                + f" {row['harm_db']:8.2f} {row['perc_db']:8.2f}")
    return rows


def check(rows: list) -> None:
    """zen_tpu's --check: the 1024/256 hard-mask floors on the hard
    mixture and every ladder rung's vs-f32 floor; raises SystemExit."""
    gate = [r for r in rows if r.get("mixture") == "hard" and r.get("cascade") == "1024/256"
            and r.get("variant") == "hard" and r.get("beta") == 2.0]
    if not gate:
        raise SystemExit("quality floors not evaluable: the 1024/256 gate cascade is "
                         "invalid at this fs (l_harm floor)")
    failures = [(k, gate[0].get(k), floor) for k, floor in CHECK_FLOORS.items()
                if not (gate[0].get(k) is not None and gate[0][k] > floor)]
    if failures:
        raise SystemExit(f"quality floors violated: {failures} ({gate[0]})")
    lfail = [(r["mode"], r["mixture"], key, r[key], LADDER_FLOORS_DB[r["mode"]])
             for r in rows if r.get("mode") in LADDER_FLOORS_DB
             for key in ("vs_f32_harm_db", "vs_f32_perc_db")
             if r.get(key) is not None and r[key] <= LADDER_FLOORS_DB[r["mode"]]]
    if lfail:
        raise SystemExit(f"ladder floors violated: {lfail}")


def run(fs_list, seconds: float, json_path=None, check_floors=False, ladder=True,
        device="cuda", log=print) -> dict:
    rows: list = []
    for fs in fs_list:
        run_fs(fs, seconds, rows, device, log)
        if ladder:
            run_ladder(fs, seconds, rows, device, log)
    artifact = {"metric": "quality_si_snr_db",
                "fs": fs_list if len(fs_list) > 1 else fs_list[0],
                "seconds": seconds, "rows": rows}
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(artifact, fh, indent=1)
        log(f"wrote {json_path}")
    if check_floors:
        check(rows)
        log("quality floors: OK (incl. precision ladder)")
    return artifact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.benches.quality")
    ap.add_argument("--fs", default="22050", help="comma-separated sample rates")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fs_list = [float(s) for s in str(args.fs).split(",") if s]
    run(fs_list, args.seconds, args.json, args.check, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
