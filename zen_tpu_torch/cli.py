"""zen-torch CLI: the ``zen`` surface on the PyTorch/CUDA port.

Counterpart of ``zen_tpu/cli.py``. One subcommand is ported, ``stream``
(``cmd_stream``, zen_tpu/cli.py:410-607), flag for flag with the same
defaults, byte layout, stderr lines and ``stream_serving`` JSON line:

  zen-torch stream [--fs 44100] [--hop 256] [--stem percussive]
      [--block-hops 16] [--streams N] [--raw-scale] [--cpu]
      [--nocopybord] [--sse] [--soft-mask] [--stream-state f32|bf16]
      [--fft-impl auto|torch|dft|dft_bf16|dft_f32] [--device cuda|cpu]

also run as ``python -m zen_tpu_torch stream ...``. Differences from the
JAX command:

- ``--device`` (default ``cuda``) names the torch device; it replaces
  JAX's ``ZEN_TPU_PLATFORM``. ``--device cuda`` without a CUDA device
  exits 2 with a message, never falling back to the CPU.
- ``--cpu`` selects the 'replicate' border (the reference's CPU/IPP
  filters) and, unlike JAX's, does not choose the device.
- ``--median-impl`` and ``--fft-impl`` also take zen_tpu's names 'xla'
  and 'pallas', mapped as ``convert.config_from_fields`` maps them;
  ``--fft-impl auto`` is torch.fft, as zen_tpu's 'auto' is XLA's FFT
  off the TPU.
- ``--mesh`` exits 2 with one stderr line naming its ROADMAP queue 1
  item (9, the parallel layer).

offline, fakert, corpus, synth and the apps need audio I/O without
``zen_tpu.io`` (ROADMAP queue 1, items 5 and 6).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

PROG = "zen-torch"


def _border(args) -> str:
    if args.cpu:
        return "replicate"
    if args.nocopybord:
        return "valid"
    return "wrap"


def _impl_kw(args) -> dict:
    from .convert import FFT_IMPL_FROM_JAX, MEDIAN_IMPL_FROM_JAX

    return dict(
        fft_impl=FFT_IMPL_FROM_JAX.get(args.fft_impl, args.fft_impl),
        median_impl=MEDIAN_IMPL_FROM_JAX.get(args.median_impl, args.median_impl),
        stream_state=args.stream_state,
    )


def _parse_mesh_axes(spec: str, allowed: tuple):
    """Parse 'dp=2,sp=4' into {axis: size}. Returns (axes, None) or
    (None, error_message), as zen_tpu/cli.py:376-407 does."""
    axes = {}
    for part in spec.split(","):
        if "=" not in part:
            return None, f"bad mesh axis '{part}' (want name=N)"
        k, v = part.split("=", 1)
        try:
            n = int(v)
        except ValueError:
            return None, f"bad mesh axis size '{part}' (want an integer)"
        if n < 1:
            return None, f"mesh axis size must be >= 1 (got '{part}')"
        k = k.strip()
        if k in axes:
            return None, (
                f"duplicate mesh axis '{k}' (a typo like dp=2,dp=8 "
                f"would silently keep only the last value)"
            )
        axes[k] = n
    unknown = set(axes) - set(allowed)
    if unknown:
        return None, (
            f"mesh supports the {','.join(allowed)} "
            f"axis only (got {sorted(unknown)})"
            if len(allowed) == 1
            else f"mesh supports axes {','.join(allowed)} only "
            f"(got {sorted(unknown)})"
        )
    return axes, None


def _refuse(msg: str) -> int:
    print(f"{PROG} stream: {msg}", file=sys.stderr)
    return 2


def cmd_stream(args) -> int:
    """Unix-pipe streaming: raw float32 PCM on stdin -> one separated
    stem as raw float32 on stdout, causally, block by block, e.g.

      ffmpeg -i in.wav -f f32le -ac 1 -ar 44100 - \\
        | zen-torch stream --fs 44100 --stem percussive > perc.f32

    --streams N serves N independent streams through ONE pipe and ONE
    step per block (MultiStreamHPR): stdin/stdout carry N
    sample-interleaved float32 streams, the layout of N-channel f32le
    PCM.
    """
    import numpy as np

    from .device import resolve_device
    from .drivers.realtime import HPRRealtime, MultiStreamHPR
    from .engine.config import OUTPUT_ALL, OUTPUT_HARMONIC, OUTPUT_PERCUSSIVE
    from .errors import ZenError

    if args.mesh:
        _, err = _parse_mesh_axes(args.mesh, ("dp",))
        if err:
            print(f"stream {err}", file=sys.stderr)
            return 1
        return _refuse(
            "--mesh is not ported yet (ROADMAP queue 1, item 9: parallel layer)"
        )
    try:
        device = resolve_device(args.device)
    except ZenError as e:  # no CUDA device: exit 2, no fallback
        return _refuse(f"--device {args.device}: {e}")
    stem_flags = {
        "harmonic": (OUTPUT_HARMONIC, 0),
        "percussive": (OUTPUT_PERCUSSIVE, 1),
        # residual is 1-(hmask+pmask): both other masks must be computed
        # or it degenerates to a passthrough
        "residual": (OUTPUT_ALL, 2),
    }
    outputs, idx = stem_flags[args.stem]
    n_streams = max(1, args.streams)
    common = dict(
        outputs=outputs,
        border=_border(args),
        use_sse=args.sse,
        soft_mask=args.soft_mask,
        device=device,
        **_impl_kw(args),
    )
    multi = n_streams > 1
    t_proc = time.perf_counter()  # before warmup: captures the kernel build
    if multi:
        ms = MultiStreamHPR(n_streams, args.fs, args.hop, args.beta, **common)
        cfg = ms.cfg
        latency = args.hop  # the same one-hop OLA latency per stream
        ms.warmup(block_sizes=(args.block_hops,))
    else:
        rt = HPRRealtime(args.fs, args.hop, args.beta, **common)
        cfg = rt.cfg
        latency = rt.latency_samples
        rt.warmup(block_sizes=(args.block_hops,))
    # unit gain: the engine carries the reference's nfft*COLA synthesis
    # scale; --raw-scale keeps it
    out_scale = 1.0 if args.raw_scale else 1.0 / cfg.synth_scale
    print(
        f"zen stream ready: fs={args.fs:.0f} hop={args.hop} "
        f"stem={args.stem} block={args.block_hops} "
        f"streams={n_streams} "
        f"latency={latency + args.block_hops * args.hop} samples",
        file=sys.stderr,
        flush=True,
    )
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    block_bytes = args.block_hops * args.hop * 4 * n_streams

    def read_full_block():
        # a pipe may short-read mid-stream; a short read taken for the
        # ragged tail would advance the engine past phantom silence hops,
        # so read until the block is full or true EOF
        parts = []
        got = 0
        while got < block_bytes:
            part = stdin.read(block_bytes - got)
            if not part:
                break
            parts.append(part)
            got += len(part)
        return b"".join(parts)

    hops_out = 0
    t_start = time.perf_counter()
    t_first = t_last = None
    while True:
        buf = read_full_block()
        if not buf:
            break
        if len(buf) % 4:  # producer died mid-sample: drop the partial
            print(
                f"zen stream: dropping {len(buf) % 4} trailing bytes "
                "(not a whole float32)",
                file=sys.stderr,
            )
            buf = buf[: len(buf) - len(buf) % 4]
            if not buf:
                break
        samples = np.frombuffer(buf, np.float32)
        if n_streams > 1 and len(samples) % n_streams:
            # producer died mid-frame: drop the partial frame
            samples = samples[: len(samples) - len(samples) % n_streams]
            if not len(samples):
                break
        n = len(samples) // n_streams  # per-stream samples
        block_len = args.block_hops * args.hop
        if n < block_len:  # tail: zero-pad
            full = np.zeros(block_len * n_streams, np.float32)
            full[: n * n_streams] = samples
            samples = full
        if multi:
            # de-interleave [n*streams] -> [streams, B, hop]
            blocks = np.ascontiguousarray(samples.reshape(-1, n_streams).T).reshape(
                n_streams, args.block_hops, args.hop
            )
            outs = ms.process_block(blocks)  # [S, E, B*hop] compact
            chunk = outs[:, ms.stem_rows[args.stem], :n].cpu().numpy()
            out_frames = np.ascontiguousarray(chunk.T)  # re-interleave
        else:
            # a copy: torch warns on the read-only buffer of frombuffer
            outs = rt.process_block(samples.reshape(-1, args.hop).copy())
            out_frames = outs[idx, :n].cpu().numpy()
        if out_scale != 1.0:
            out_frames = out_frames * np.float32(out_scale)
        stdout.write(out_frames.astype(np.float32, copy=False).tobytes())
        stdout.flush()
        if t_first is None:
            t_first = time.perf_counter()
        t_last = time.perf_counter()
        hops_out += -(-n // args.hop)
    print(f"zen stream done: {hops_out} hops", file=sys.stderr)
    wall = (t_last - t_start) if t_last is not None else 0.0
    per_hop_us = wall / max(hops_out, 1) * 1e6
    print(
        json.dumps(
            {
                "metric": "stream_serving",
                "streams": n_streams,
                "mesh": "single-chip",
                "hops_per_stream": hops_out,
                "wall_s": round(wall, 6),
                # end-to-end pipe rate (stdin/stdout included): samples
                # through the engine per wall second, all streams, and
                # the per-stream block latency
                "samples_per_s": (
                    round(hops_out * args.hop * n_streams / wall) if wall > 0 else None
                ),
                "us_per_hop": round(per_hop_us, 3),
                # warmup_s: kernel build and warmup before 'ready';
                # first_block_s: from 'ready' to the first block out
                "warmup_s": round(t_start - t_proc, 6),
                "first_block_s": (
                    round(t_first - t_start, 6) if t_first is not None else None
                ),
                "block_latency_samples": latency + args.block_hops * args.hop,
            }
        ),
        file=sys.stderr,
        flush=True,
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="zen-tpu on PyTorch/CUDA: harmonic/percussive source separation",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    stp = sub.add_parser(
        "stream",
        help="raw float32 stdin -> separated stem on stdout (pipe mode)",
    )
    stp.add_argument("--fs", type=float, default=44100.0)
    stp.add_argument("--hop", type=int, default=256)
    stp.add_argument("--beta", type=float, default=2.0)
    stp.add_argument(
        "--stem", choices=("harmonic", "percussive", "residual"), default="percussive"
    )
    stp.add_argument("--block-hops", type=int, default=16)
    stp.add_argument(
        "--streams",
        type=int,
        default=1,
        help="serve N sample-interleaved streams (N-channel f32le "
        "layout) through one pipe and one step per block",
    )
    stp.add_argument(
        "--mesh", default="", help="not ported yet (ROADMAP queue 1, item 9)"
    )
    stp.add_argument(
        "--raw-scale",
        action="store_true",
        help="emit the engine's unnormalized scale instead of unit gain",
    )
    stp.add_argument(
        "--cpu", action="store_true", help="the 'replicate' border (reference CPU/IPP)"
    )
    stp.add_argument(
        "--sse", action="store_true", help="the SSE box filter instead of the medians"
    )
    stp.add_argument("--soft-mask", action="store_true")
    stp.add_argument(
        "--nocopybord", action="store_true", help="the 'valid' border (reference GPU)"
    )
    stp.add_argument(
        "--fft-impl",
        choices=("auto", "torch", "xla", "dft", "dft_bf16", "dft_f32"),
        default="auto",
        help="transform: torch.fft ('auto', 'torch', 'xla') or the DFT "
        "matmuls at float32, bf16x3 or bf16 products ('dft_f32', 'dft', "
        "'dft_bf16'; half spectrum only: --cpu and --nocopybord take torch.fft)",
    )
    stp.add_argument(
        "--median-impl",
        choices=("auto", "torch", "cuda", "xla", "pallas"),
        default="auto",
        help="median route: 'auto' = the CUDA kernels on --device cuda, "
        "their plain twins on the CPU ('xla' = 'torch', 'pallas' = 'cuda')",
    )
    stp.add_argument(
        "--stream-state",
        choices=("f32", "bf16"),
        default="f32",
        help="dtype of the streaming feature history: 'bf16' halves its "
        "traffic for bf16-quantized median features",
    )
    stp.add_argument(
        "--device",
        default="cuda",
        help="torch device the streams run on (default cuda; no fallback)",
    )
    stp.set_defaults(func=cmd_stream)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
