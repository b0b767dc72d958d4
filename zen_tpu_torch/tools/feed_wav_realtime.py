"""Simulated live input (counterpart of ``scripts/feed_wav_realtime.py``):
stream an audio file into ``LiveStream`` at real-time rate and write the
separated percussive stem.

    python -m zen_tpu_torch.tools.feed_wav_realtime in.wav out_perc.wav [hop]
        [--block-hops 16] [--device cuda]

The analog of the reference's virtual-mic plumbing (scripts/zen_mic.sh
pipes ffmpeg into a PulseAudio pipe-source): the producer loop pushes the
file into the native input ring hop by hop at wall-clock rate and polls
the service on the same thread (``LiveStream.poll``: the card's work is
issued from the calling thread), pulling the percussive stem as it
comes. At the end the input is zero-padded to a whole block and drained
until every pushed sample has come back out. Prints what was streamed
and a JSON line with the counts, the ring's overruns, the dropped output
samples and the device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..benches import describe_device
from ..device import resolve_device
from ..io.audio import peak_normalize, read_audio_mono, write_wav_pcm16
from ..runtime.stream import LiveStream


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m zen_tpu_torch.tools.feed_wav_realtime")
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("hop", type=int, nargs="?", default=256)
    ap.add_argument("--block-hops", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def feed(audio: np.ndarray, fs: int, hop: int, block_hops: int, device) -> tuple:
    """(the percussive stem, one sample per input sample; the stats)."""
    ls = LiveStream(float(fs), hop, 2.0, block_hops=block_hops, device=device).warmup()
    n_hops = len(audio) // hop
    hop_dt = hop / fs
    out = []
    t0 = time.perf_counter()
    late = 0.0
    for n in range(n_hops):
        target = t0 + n * hop_dt  # pace the producer at real time
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        else:
            late = max(late, now - target)
        ls.push(audio[n * hop : (n + 1) * hop])
        ls.poll()
        chunk = ls.pull("percussive", hop)
        if chunk is not None:
            out.append(chunk)
    # drain: poll() consumes whole blocks, so pad the input ring to the next
    # block boundary (after the file's tail), then pull until every pushed
    # sample has come back
    pushed = n_hops * hop
    tail = audio[n_hops * hop :]
    if len(tail):
        ls.push(tail)
        pushed += len(tail)
    pad = (-pushed) % (block_hops * hop)
    if pad:
        ls.push(np.zeros(pad, np.float32))
    deadline = time.perf_counter() + 5.0
    got = sum(len(c) for c in out)
    while got < pushed and time.perf_counter() < deadline:
        ls.poll()
        chunk = ls.pull("percussive", min(hop, pushed - got))
        if chunk is None:
            time.sleep(0.002)
            continue
        out.append(chunk)
        got += len(chunk)
    wall = time.perf_counter() - t0
    ls.stop()
    y = np.concatenate(out)[: len(audio)] if out else np.zeros(0, np.float32)
    return y, {"hops": n_hops, "recovered": len(y), "blocks": ls.blocks_processed,
               "overruns": ls.in_ring.overruns, "dropped": ls.dropped_out_samples,
               "wall_s": wall, "audio_s": len(audio) / fs, "max_late_s": late}


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    fs, audio = read_audio_mono(args.infile)
    y, st = feed(audio, fs, args.hop, args.block_hops, dev)
    print(f"streamed {st['hops']} hops at real time; recovered {st['recovered']} samples; "
          f"input overruns={st['overruns']}", flush=True)
    write_wav_pcm16(args.outfile, fs, peak_normalize(y))
    st["device"] = describe_device(dev)
    print(json.dumps({"metric": "feed_wav_realtime", **st}), flush=True)
    return st


if __name__ == "__main__":
    main()
