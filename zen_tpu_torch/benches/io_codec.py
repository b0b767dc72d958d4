"""Host I/O codec throughput (counterpart of ``benches/io_codec.py``).

    python -m zen_tpu_torch.benches.io_codec [--seconds 60] [--json out.json]

The corpus driver overlaps host I/O with device work
(``runtime/loader.py``), so a codec bounds a corpus only where it falls
below the device's rate; this instrument says where each rung sits.
Rungs, on ``--seconds`` of a 44.1 kHz mono tone with a noise floor,
through the port's native library (``runtime/native.py``, built from
``native/*.cpp`` at first use):

  flac_encode_native, flac_decode_native   the stem writer and reader
  wv_encode_native, wv_decode_native       WavPack, the same
  flac_encode_native_stereo, wv_encode_native_stereo
  wav_write_pcm16, wav_read                io/audio.py over the native wav
  vorbis / mp3 / mpc / opus _decode_native each decoder on a real encoded
                                           file, where one is present in
                                           ``--corpus`` (default: the
                                           checkout's tests/data)

plus the FLAC and WavPack size ratios against raw PCM16. Each rung is the
best of 3 calls, host wall. The JAX instrument's pure-Python FLAC and
WavPack rungs (``flac_encode_python``, ``flac_decode_python``,
``wv_encode_python``) are absent, with their codecs: the port carries no
pure-Python codec (``io/audio.py``). Host only: no device is touched, so
there is no ``--device``; the JSON names the host it ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import ARTIFACT_DIR
from ..io.audio import read_wav_mono, write_wav_pcm16
from ..runtime import native

ROOT = Path(__file__).resolve().parents[2]
# (rung, candidate file names, reader, note): the JAX instrument's corpus
# files first, then the checkout's regression files
FOREIGN = (
    ("vorbis_decode_native", ("TestBeat.ogg", "floor0_regression.ogg"), native.vorbis_read,
     "zenvorbis.cpp"),
    ("mp3_decode_native", ("acetylene.mp3", "lsf_regression.mp3"), native.mp3_read,
     "zenmp3.cpp"),
    ("mpc_decode_native", ("44_16_stereo.mpc",), native.mpc_read, "zenmpc.cpp"),
    ("opus_decode_native", ("detodos.opus", "ms_quad_regression.opus"), native.opus_read,
     "zenopus.cpp (48 kHz out)"),
)


def best_of(fn, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.benches.io_codec")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--corpus", default=str(ROOT / "tests" / "data"),
                    help="directory searched for the decoders' real encoded files")
    ap.add_argument("--json", default="")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, log=print) -> dict:
    fs = 44100
    n = int(fs * args.seconds)
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs
    x = (np.sin(2 * np.pi * 220 * t) * 0.35 + rng.standard_normal(n) * 0.02).astype(np.float32)
    x2 = np.stack([x, -0.5 * x], axis=1)
    rows = {}

    def record(name, seconds, samples=n, duration=args.seconds, note=""):
        rows[name] = {"ms": round(seconds * 1e3, 1),
                      "msamples_per_s": round(samples / seconds / 1e6, 2),
                      "x_realtime": round(duration / seconds, 0), "note": note}
        log(f"{name:26s} {seconds * 1e3:8.1f} ms  {samples / seconds / 1e6:7.2f} Msamples/s  "
            f"{duration / seconds:7.0f}x realtime  {note}")

    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    log(f"native library: loaded in {build_s:.2f} s (built at first use)")
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ARTIFACT_DIR)
    try:
        flac_p, wv_p, wav_p = (os.path.join(tmp, f"t.{e}") for e in ("flac", "wv", "wav"))
        record("flac_encode_native", best_of(lambda: native.flac_write(flac_p, fs, x)),
               note="zenflac_enc.cpp (stem writer)")
        record("flac_decode_native", best_of(lambda: native.flac_read(flac_p)),
               note="zenflac.cpp (read_audio_mono path)")
        record("wv_encode_native", best_of(lambda: native.wv_write(wv_p, fs, x)),
               note="zenwv.cpp encoder (stem writer)")
        record("wv_decode_native", best_of(lambda: native.wv_read(wv_p)),
               note="zenwv.cpp (its own encoder's file)")
        rows["wv_ratio_vs_pcm16"] = round(os.path.getsize(wv_p) / (n * 2), 3)
        f2, w2 = os.path.join(tmp, "t2.flac"), os.path.join(tmp, "t2.wv")
        record("flac_encode_native_stereo", best_of(lambda: native.flac_write(f2, fs, x2)),
               note="zenflac_enc.cpp stereo16")
        record("wv_encode_native_stereo", best_of(lambda: native.wv_write(w2, fs, x2)),
               note="zenwv.cpp stereo16")
        record("wav_write_pcm16", best_of(lambda: write_wav_pcm16(wav_p, fs, x)))
        record("wav_read", best_of(lambda: read_wav_mono(wav_p)))
        rows["flac_ratio_vs_pcm16"] = round(os.path.getsize(flac_p) / (n * 2), 3)
        log(f"flac size ratio vs raw PCM16: {rows['flac_ratio_vs_pcm16']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for name, fnames, reader, note in FOREIGN:
        path = next((p for f in fnames if (p := Path(args.corpus) / f).is_file()), None)
        if path is None:
            continue
        fs_dec, frames = reader(str(path))
        record(name, best_of(lambda: reader(str(path))), frames.size,
               frames.shape[0] / float(fs_dec), f"{note} ({path.name})")
    return {"seconds": args.seconds, "fs": fs, "rows": rows, "native_load_s": build_s,
            "host": {"machine": platform.machine(), "cpus": os.cpu_count(),
                     "python": platform.python_version()}}


def main(argv=None) -> int:
    args = parse(argv)
    result = run(args)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)
    print(json.dumps({"metric": "io_codec", "rungs": sorted(result["rows"]),
                      "host": result["host"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
