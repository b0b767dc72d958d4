"""One-command A/B of the port's stems against another binary's stem
files (counterpart of ``scripts/ab_reference.py``).

    python -m zen_tpu_torch.tools.ab_reference <mixture.wav> <ref_stems> \\
        [--hps 4096 2.0 256 2.0] [--sse] [--soft-mask] [--nocopybord] \\
        [--min-snr-db 20] [--json report.json] [--device cuda]

``ref_stems`` is a directory holding, or a path prefix of, the reference
CLI's outputs <prefix>_harm.wav, <prefix>_perc.wav, <prefix>_residual.wav
(reference/zen/offline.h:208-219). The harness:

1. separates the mixture with ``HPRIOffline(strict_ref=True)`` on
   ``--device`` (the card by default), which reproduces the reference
   binary's silent pass-2 residual;
2. peak-normalizes each stem as the reference does before its PCM16
   encode (offline.h:182-191), and compares after a least-squares gain
   fit (scale-invariant; PCM16 bounds the SNR near 90 dB);
3. aligns by cross-correlation over +-1 hop (codec padding);
4. prints each stem's SNR and a JSON verdict line (with the device);
   exit 0 iff every compared stem clears --min-snr-db, 1 otherwise, 2 when
   a reference stem's sample rate differs from the mixture's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..benches import describe_device
from ..device import resolve_device
from ..drivers.offline import HPRIOffline
from ..io.audio import peak_normalize, read_audio_mono

STEMS = ("harm", "perc", "residual")
SILENT_RMS = 1e-5  # below this (in +-1.0 normalized units) a stem is
# taken as silent on purpose (the reference's strict-ref residual)


def find_ref_stem(ref: str, stem: str) -> str | None:
    if os.path.isdir(ref):
        hits = [os.path.join(ref, f) for f in sorted(os.listdir(ref)) if f.endswith(f"_{stem}.wav")]
        return hits[0] if hits else None
    p = f"{ref}_{stem}.wav"
    return p if os.path.exists(p) else None


def best_lag(a: np.ndarray, b: np.ndarray, max_lag: int) -> int:
    """argmax_k <a[k:], b[:-k]> over |k| <= max_lag."""
    best, best_k = -np.inf, 0
    for k in range(-max_lag, max_lag + 1):
        if k >= 0:
            x, y = a[k:], b[: len(b) - k if k else len(b)]
        else:
            x, y = a[: len(a) + k], b[-k:]
        n = min(len(x), len(y))
        c = float(np.dot(x[:n], y[:n]))
        if c > best:
            best, best_k = c, k
    return best_k


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR after a least-squares gain fit of ``test`` (both sides were
    peak-normalized, so their gain carries no information); the full
    reference power is the numerator, the usual form for an A/B against
    a binary's output files (not SI-SDR, which projects the estimate)."""
    denom = float(np.dot(test, test))
    g = float(np.dot(ref, test)) / denom if denom > 0 else 0.0
    err = ref - g * test
    p_sig, p_err = float(np.dot(ref, ref)), float(np.dot(err, err))
    if p_err == 0.0:
        return float("inf")
    return float(10.0 * np.log10(p_sig / p_err)) if p_sig > 0 else float("-inf")


def run(args) -> int:
    dev = resolve_device(args.device)
    fs, audio = read_audio_mono(args.mixture)
    hps = (args.hps or []) + [None] * 4
    hop_h = int(hps[0]) if hps[0] is not None else 4096
    beta_h = float(hps[1]) if hps[1] is not None else 2.0
    hop_p = int(hps[2]) if hps[2] is not None else 256
    beta_p = float(hps[3]) if hps[3] is not None else 2.0
    sep = HPRIOffline(fs, hop_h, hop_p, beta_h, beta_p,
                      border="valid" if args.nocopybord else "wrap", use_sse=args.sse,
                      soft_mask=args.soft_mask, strict_ref=True, device=dev)
    ours = {s: peak_normalize(x.cpu().numpy()) for s, x in zip(STEMS, sep.process(audio))}

    report = {"metric": "ab_reference", "mixture": args.mixture, "stems": {},
              "device": describe_device(dev)}
    worst = float("inf")
    for s in STEMS:
        path = find_ref_stem(args.ref_stems, s)
        if path is None:
            report["stems"][s] = {"status": "missing_ref"}
            continue
        ref_fs, ref = read_audio_mono(path)
        if ref_fs != fs:
            # a sample-domain comparison at mismatched rates would find a
            # meaningless lag and report a garbage SNR
            print(f"ab_reference: stem '{s}' sample rate {ref_fs} != mixture {fs} — "
                  "resample the reference stems first", file=sys.stderr)
            return 2
        mine = ours[s]
        n = min(len(ref), len(mine))
        ref, mine = ref[:n], mine[:n]
        if (float(np.sqrt(np.mean(ref**2))) < SILENT_RMS
                and float(np.sqrt(np.mean(mine**2))) < SILENT_RMS):
            report["stems"][s] = {"status": "both_silent", "snr_db": None}
            continue
        lag = best_lag(ref, mine, max_lag=hop_p)
        if lag > 0:
            ref, mine = ref[lag:], mine[: len(mine) - lag]
        elif lag < 0:
            ref, mine = ref[: len(ref) + lag], mine[-lag:]
        val = snr_db(ref, mine)
        worst = min(worst, val)
        report["stems"][s] = {"status": "compared", "snr_db": round(val, 2), "lag_samples": lag,
                              "ref": path}
        print(f"{s:>9s}: SNR {val:7.2f} dB (lag {lag:+d})", file=sys.stderr)
    compared = [v for v in report["stems"].values() if v.get("status") == "compared"]
    ok = bool(compared and worst >= args.min_snr_db)
    report["worst_snr_db"] = None if not compared else round(worst, 2)
    report["pass"] = ok
    line = json.dumps(report)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    return 0 if ok else 1


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m zen_tpu_torch.tools.ab_reference",
        description="SNR A/B of the port's strict-ref stems against a binary's wav outputs")
    ap.add_argument("mixture")
    ap.add_argument("ref_stems", help="directory or path prefix of "
                    "<prefix>_{harm,perc,residual}.wav")
    ap.add_argument("--hps", nargs="*", default=None, metavar=("hop-h", "beta-h"))
    ap.add_argument("--sse", action="store_true")
    ap.add_argument("--soft-mask", action="store_true")
    ap.add_argument("--nocopybord", action="store_true")
    ap.add_argument("--min-snr-db", type=float, default=20.0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return run(parse(argv))


if __name__ == "__main__":
    raise SystemExit(main())
