"""zen-torch CLI: the ``zen`` surface on the PyTorch/CUDA port.

Counterpart of ``zen_tpu/cli.py``. Ported flag for flag, with the same
defaults, echo blocks and JSON metric lines:

  zen-torch offline -i in.wav [--hps [hop-h beta-h hop-p beta-p]]
      [-o prefix] [--stem-format wav|flac|wv] [--only-percussive]
      [--blocked] [--strict-ref] [--cpu] [--sse] [--soft-mask]
      [--nocopybord] [--mesh tp=N] [impl flags] [--device cuda|cpu]
  zen-torch fakert -i in.wav [--hps [hop beta]] [-o out.wav]
      [--block-hops 32] [--cpu] [--sse] [--soft-mask] [--nocopybord]
      [impl flags] [--device cuda|cpu]
  zen-torch stream [--fs 44100] [--hop 256] [--stem percussive]
      [--block-hops 16] [--streams N] [--mesh dp=N] [--raw-scale] [--cpu]
      [--nocopybord] [--sse] [--soft-mask] [impl flags] [--device cuda|cpu]
  zen-torch corpus -i tracks... -o out_dir [--hps [hop-h beta-h hop-p beta-p]]
      [--mesh dp=N,sp=M] [--pp] [--prefetch 2] [--stem-format wav|flac|wv]
      [--nprocs N --coordinator HOST:PORT --proc-id I] [impl flags]
      [--device cuda|cpu]
  zen-torch pitch-track -i in.wav [--device cuda|cpu]
  zen-torch beat-track -i in.wav [--device cuda|cpu]
  zen-torch synth -o mix.wav [--fs] [--seconds] [--bpm] [--hits-per-beat]
      [--sawtooth] [--vibrato-cents] [--seed] [--stems]
  zen-torch version | -v | --version

  impl flags: [--fft-impl auto|torch|dft|dft_bf16|dft_f32]
      [--median-impl auto|torch|cuda] [--stream-state f32|bf16]

also run as ``python -m zen_tpu_torch ...``. Audio goes through the
port's own I/O (``io/audio.py`` over the native codecs). Differences from
the JAX command:

- ``--device`` (default ``cuda``) names the torch device; it replaces
  JAX's ``ZEN_TPU_PLATFORM``. ``--device cuda`` without a CUDA device
  exits 2 with a message, never falling back to the CPU.
- ``--cpu`` selects the 'replicate' border (the reference's CPU/IPP
  filters) and, unlike JAX's, does not choose the device.
- ``--median-impl`` and ``--fft-impl`` also take zen_tpu's names 'xla'
  and 'pallas', mapped as ``convert.config_from_fields`` maps them;
  ``--fft-impl auto`` is torch.fft, as zen_tpu's 'auto' is XLA's FFT
  off the TPU.
- ``--mesh`` (offline ``tp=N``, stream ``dp=N``, corpus ``dp=..,sp=..``)
  shards over ``make_mesh``'s first N visible devices of ``--device``'s
  type (``parallel/mesh.py``; ``--device cpu`` repeats the CPU for every
  shard); too few cards fail with its ZenError, as zen_tpu's CLI fails on
  too few chips. corpus without ``--mesh`` takes ``default_mesh``.
  corpus's ``--nprocs N --coordinator HOST:PORT --proc-id I`` runs one of N
  processes of a multi-process corpus (``torch.distributed`` over gloo;
  the mesh is global, its leading axes take the process split as
  zen_tpu's do, so ``--mesh sp=N`` puts one ring across the processes,
  and only process 0 writes), with zen_tpu's checks, stderr lines and
  exit codes.
- The lines that name the compute name the device, where zen_tpu's say
  "TPU-native"; the substrings parsers read ("Running zen-offline",
  "HPR-I-Offline took", "Running zen-fakert", "PRealtime") stay.
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


def _refuse(command: str, msg: str) -> int:
    print(f"{PROG} {command}: {msg}", file=sys.stderr)
    return 2


def _device_label(device) -> str:
    import torch

    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} ({device})"
    return str(device)


def _echo(lines):
    print("\n".join(lines))


def _echo_audio(fs: int, audio) -> None:
    _echo(["Audio file info:", f"\tsample rate: {fs}", f"\tlen samples: {len(audio)}",
           f"\tseconds: {len(audio) / fs}"])


def _mask_filter_lines(args) -> list:
    return ["\t\tmask: soft/Wiener" if args.soft_mask else "\t\tmask: hard/binary",
            "\t\tfilter: sse" if args.sse else "\t\tfilter: median"]


def _cascade(hps) -> tuple:
    """(hop_h, beta_h, hop_p, beta_p) from --hps's values, each missing one
    at its default: 4096, 2.0, 256, 2.0."""
    vals = (hps or []) + [None] * (4 - len(hps or []))
    return tuple(d if v is None else cast(v) for v, d, cast in
                 zip(vals, (4096, 2.0, 256, 2.0), (int, float, int, float)))


def cmd_offline(args) -> int:
    """Two-pass HPR-I on a whole file; stems written peak-normalized."""
    import torch

    from .device import resolve_device
    from .drivers.offline import LONG_TRACK_SAMPLES, HPRIOffline
    from .errors import ZenError
    from .io.audio import peak_normalize, read_audio_mono, write_audio_pcm16

    try:
        device = resolve_device(args.device)
    except ZenError as e:  # no CUDA device: exit 2, no fallback
        return _refuse("offline", f"--device {args.device}: {e}")
    _echo([
        "Running zen-offline with the following params:",
        f"\tinfile: {args.input}",
        f"\toutfile_prefix: {args.out_prefix or ''}",
        f"\tonly_percussive: {int(args.only_percussive)}",
        "\tdo hps: yes" if args.hps is not None else "\tdo hps: no",
    ])
    hop_h, beta_h, hop_p, beta_p = _cascade(args.hps)
    if args.hps is not None:
        _echo([f"\t\tharmonic hop: {hop_h}", f"\t\tharmonic beta: {beta_h}",
               f"\t\tpercussive hop: {hop_p}", f"\t\tpercussive beta: {beta_p}",
               *_mask_filter_lines(args)])
    label = _device_label(device)
    _echo([f"\tcompute: zen_tpu_torch on {label} (border={_border(args)})"])

    fs, audio = read_audio_mono(args.input)
    _echo_audio(fs, audio)
    if args.hps is not None:
        sep = HPRIOffline(fs, hop_h, hop_p, beta_h, beta_p, strict_ref=args.strict_ref,
                          border=_border(args), use_sse=args.sse, soft_mask=args.soft_mask,
                          device=device, **_impl_kw(args))
        mesh = None
        if args.mesh:
            # frequency tensor parallelism: every shard transforms, filters
            # and synthesizes its own bins (parallel/sharded.py:tp_separate)
            from .parallel.mesh import make_mesh
            from .parallel.sharded import tp_hpri_offline

            axes, err = _parse_mesh_axes(args.mesh, ("tp",))
            if err:
                print(f"zen offline: {err}", file=sys.stderr)
                return 2
            if sep.cfg_h.border != "wrap":
                print("zen offline: --mesh tp requires the wrap border (drop --nocopybord): "
                      "the sharded frequency-median halo ring is circular", file=sys.stderr)
                return 2
            n_tp = axes["tp"]
            for cfg in (sep.cfg_h, sep.cfg_p):
                if cfg.nfft % n_tp:
                    print(f"zen offline: tp={n_tp} must divide both pass nffts "
                          f"(got nfft={cfg.nfft} at hop={cfg.hop})", file=sys.stderr)
                    return 2
            mesh = make_mesh(axes, device=device)
            _echo([f"\tmesh: tp={n_tp} (frequency-sharded)"])
        # overlap-save past LONG_TRACK_SAMPLES: the batched pass holds the
        # whole spectrogram, ~160 bytes per sample
        long_track = len(audio) > LONG_TRACK_SAMPLES
        t1 = time.perf_counter()
        if mesh is not None:
            h, p, r = tp_hpri_offline(audio, sep.cfg_h, sep.cfg_p, mesh)
        elif args.blocked or long_track:
            if long_track and not args.blocked:
                print("long track: using constant-memory blocked mode")
            h, p, r = sep.process_blocked(audio)
        else:
            h, p, r = sep.process(audio)
        if device.type == "cuda":  # stop the clock when the card is done
            torch.cuda.synchronize(device)
        dur_ms = 1000 * (time.perf_counter() - t1)
        print(f"{label}: 2-pass HPR-I-Offline took {dur_ms:.0f} ms")
        print(json.dumps({"metric": "offline_2pass_ms", "value": dur_ms, "unit": "ms",
                          "audio_seconds": len(audio) / fs}))
        stems = {"harm": h.cpu().numpy(), "perc": p.cpu().numpy(), "residual": r.cpu().numpy()}
    else:
        stems = {"harm": audio, "perc": audio, "residual": audio}

    if args.out_prefix:
        names = ["perc"] if args.only_percussive else ["harm", "perc", "residual"]
        for name in names:
            write_audio_pcm16(f"{args.out_prefix}_{name}.{args.stem_format}", fs,
                              peak_normalize(stems[name]))
    return 0


def cmd_fakert(args) -> int:
    """The causal engine over a whole file in blocks of --block-hops hops,
    timed per hop against the hop's duration; the percussive stem is
    written peak-normalized."""
    from .device import resolve_device
    from .drivers.realtime import HPRRealtime
    from .engine.config import OUTPUT_PERCUSSIVE
    from .errors import ZenError
    from .io.audio import peak_normalize, read_audio_mono, write_audio_pcm16

    try:
        device = resolve_device(args.device)
    except ZenError as e:  # no CUDA device: exit 2, no fallback
        return _refuse("fakert", f"--device {args.device}: {e}")
    hop, beta = 256, 2.0
    if args.hps is not None:
        vals = args.hps + [None] * (2 - len(args.hps))
        hop = int(vals[0]) if vals[0] is not None else hop
        beta = float(vals[1]) if vals[1] is not None else beta
    label = _device_label(device)
    _echo([
        "Running zen-fakert with the following params:",
        f"\tinfile: {args.input}",
        f"\toutfile: {args.output or ''}",
        "\tdo hps: yes" if args.hps is not None else "\tdo hps: no",
        f"\t\thop: {hop}",
        f"\t\tbeta: {beta}",
        *_mask_filter_lines(args),
        f"\tcompute: zen_tpu_torch on {label} (border={_border(args)})",
    ])
    fs, audio = read_audio_mono(args.input)
    _echo_audio(fs, audio)
    n_hops = -(-len(audio) // hop)
    delta_t_ms = 1000.0 * hop / fs
    print(f"Slicing buffer size {len(audio)} into {n_hops} chunks of size {hop}")

    if args.hps is None:
        out = audio
    else:
        rt = HPRRealtime(fs, hop, beta, outputs=OUTPUT_PERCUSSIVE, border=_border(args),
                         use_sse=args.sse, soft_mask=args.soft_mask, device=device,
                         **_impl_kw(args))
        block_hops = max(1, int(args.block_hops))
        tail = n_hops % block_hops
        # every block size the stream runs, the ragged tail's too: no
        # kernel build or cuFFT plan may land inside the timed loop
        rt.warmup(block_sizes=(block_hops, tail) if tail else (block_hops,))
        t1 = time.perf_counter()
        outs = rt.process_stream(audio, block_hops=block_hops)  # host numpy: synchronized
        t2 = time.perf_counter()
        out = outs[1][: len(audio)]
        avg_us = 1e6 * (t2 - t1) / n_hops
        print(f"PRealtime {label}:  Δn = {hop}, Δt(ms) = {delta_t_ms:.4f},"
              f" average processing duration(us) = {avg_us:.2f}")
        print(json.dumps({"metric": "fakert_us_per_hop", "value": avg_us, "unit": "us",
                          "hop": hop, "block_hops": block_hops,
                          "budget_us": delta_t_ms * 1000,
                          "rtf": avg_us / (delta_t_ms * 1000)}))
    if args.output:
        write_audio_pcm16(args.output, fs, peak_normalize(out))
    return 0


def cmd_corpus(args) -> int:
    """Resumable multi-track separation: tracks batched over the mesh's
    dp axis, time blocks over sp, with crash-safe per-track journaling
    (drivers/corpus.py)."""
    import glob as globmod

    from .device import resolve_device
    from .drivers.corpus import separate_corpus
    from .errors import ZenError
    from .parallel.mesh import default_mesh, make_mesh

    paths = sorted(p for pat in args.inputs for p in globmod.glob(pat))
    if not paths:
        print("no input tracks matched", file=sys.stderr)
        return 1
    if args.nprocs <= 1 and (args.coordinator or args.proc_id):
        # without --nprocs, N processes would each separate the whole
        # corpus into the same out_dir
        print("corpus: --coordinator/--proc-id need --nprocs >= 2", file=sys.stderr)
        return 1
    if args.nprocs > 1:
        # join the process group before any device query, so that the
        # mesh is global; every process runs this command with its own
        # --proc-id, and the corpus driver does the rest (the same
        # batches on each, only process 0 writes)
        if not args.coordinator:
            print("corpus: --nprocs needs --coordinator HOST:PORT", file=sys.stderr)
            return 1
        if not 0 <= args.proc_id < args.nprocs:
            print(f"corpus: --proc-id {args.proc_id} outside 0..{args.nprocs - 1}",
                  file=sys.stderr)
            return 1
        from .parallel import multihost
        from .parallel.mesh import distributed_init

        try:
            distributed_init(args.coordinator, args.nprocs, args.proc_id)
        except (RuntimeError, ValueError):
            pass  # reported by the count below, as zen_tpu reports it
        if multihost.process_count() != args.nprocs:
            print(f"corpus: distributed bootstrap failed (process_count="
                  f"{multihost.process_count()}, expected {args.nprocs})", file=sys.stderr)
            return 1
    axes = None
    if args.mesh:
        axes, err = _parse_mesh_axes(args.mesh, ("dp", "sp"))
        if err:
            print(f"corpus {err}", file=sys.stderr)
            return 1
        axes.setdefault("dp", 1)
        axes.setdefault("sp", 1)
    try:
        device = resolve_device(args.device)
    except ZenError as e:  # no CUDA device: exit 2, no fallback
        return _refuse("corpus", f"--device {args.device}: {e}")
    if axes is not None:
        mesh = make_mesh(axes, device=device)
    else:
        mesh = default_mesh(n_channels_hint=len(paths), device=device)
    print(f"corpus: {len(paths)} tracks, mesh {mesh.shape}, out={args.out_dir}")
    hop_h, beta_h, hop_p, beta_p = _cascade(args.hps)
    res = separate_corpus(paths, args.out_dir, mesh, hop_h=hop_h, hop_p=hop_p, beta_h=beta_h,
                          beta_p=beta_p, pp=args.pp, prefetch=max(0, args.prefetch),
                          stem_format=args.stem_format, **_impl_kw(args))
    print(json.dumps({"metric": "corpus_tracks", **res}))
    if args.nprocs > 1:
        from .parallel import multihost

        multihost.leave()
    return 0


def _demo_audio(args, chunk: int) -> tuple:
    """(fs, audio) of the demo's input, after its echo block."""
    from .io.audio import read_audio_mono

    fs, audio = read_audio_mono(args.input)
    print(f"Slicing wav file into chunks of {chunk} samples...")
    _echo_audio(fs, audio)
    return fs, audio


def cmd_pitch_track(args) -> int:
    """Pitch tracking demo: MPM on harmonic-separated 4096-hops vs raw
    (reference: demos/pitch-tracking/main.cu:33-125)."""
    from .apps.mpm import MPM
    from .device import resolve_device
    from .drivers.realtime import HPRRealtime
    from .engine.config import OUTPUT_HARMONIC
    from .errors import ZenError

    try:
        device = resolve_device(args.device)
    except ZenError as e:  # no CUDA device: exit 2, no fallback
        return _refuse("pitch-track", f"--device {args.device}: {e}")
    chunk = 4096
    fs, audio = _demo_audio(args, chunk)
    n_chunks = len(audio) // chunk
    rt = HPRRealtime(fs, chunk, 2.5, outputs=OUTPUT_HARMONIC, device=device)
    harm = rt.process_stream(audio[: n_chunks * chunk], block_hops=8)[0]
    mpm = MPM(chunk, fs, device=device)
    p_h = mpm.pitch_batch(harm[: n_chunks * chunk].reshape(n_chunks, chunk))
    p_r = mpm.pitch_batch(audio[: n_chunks * chunk].reshape(n_chunks, chunk))
    t = 0.0
    for ph, pr in zip(p_h, p_r):
        print(f"t: {t:.2f},\tpitch (+HPR): {ph:.2f},\tpitch (-HPR): {pr:.2f}")
        t += chunk / fs
    return 0


def cmd_beat_track(args) -> int:
    """Beat tracking demo: BTrack on percussive-separated 256-hops vs raw
    (reference: demos/beat-tracking/main.cu:33-146)."""
    import numpy as np
    import torch

    from .apps.btrack import frames_from_hops, odf_batch, track_beats_from_odf
    from .device import resolve_device
    from .drivers.realtime import HPRRealtime
    from .engine.config import OUTPUT_PERCUSSIVE
    from .errors import ZenError

    try:
        device = resolve_device(args.device)
    except ZenError as e:  # no CUDA device: exit 2, no fallback
        return _refuse("beat-track", f"--device {args.device}: {e}")
    chunk = 256
    fs, audio = _demo_audio(args, chunk)
    cut = audio[: len(audio) // chunk * chunk]
    rt = HPRRealtime(fs, chunk, 2.5, outputs=OUTPUT_PERCUSSIVE, device=device)
    perc = rt.process_stream(cut, block_hops=64)[1][: len(cut)]
    beats = {}
    for name, sig in (("+HPR", perc), ("-HPR", cut)):
        frames = torch.from_numpy(frames_from_hops(sig)).to(device)
        flags, _ = track_beats_from_odf(odf_batch(frames).cpu().numpy(), fs)
        beats[name] = [f"{n * chunk / fs:.4f}" for n in np.nonzero(flags)[0]]
    print("+HPR beat timestamps: " + " ".join(beats["+HPR"]))
    print("-HPR beat timestamps: " + " ".join(beats["-HPR"]))
    return 0


def cmd_synth(args) -> int:
    """Write a deterministic synthetic test mixture (and its ground truth)."""
    import numpy as np

    from .io.audio import write_wav_pcm16
    from .io.synth import synth_mixture

    harm, perc, mix = synth_mixture(fs=args.fs, seconds=args.seconds, bpm=args.bpm,
                                    hits_per_beat=args.hits_per_beat, sawtooth=args.sawtooth,
                                    vibrato_cents=args.vibrato_cents, seed=args.seed)
    fs = int(args.fs)
    # one shared scale, so the stems stay sample-aligned with the mixture
    scale = 1.0 / max(np.abs(mix).max(), 1e-9)
    write_wav_pcm16(args.output, fs, mix * scale)
    print(f"wrote {args.output} ({args.seconds}s @ {fs} Hz)")
    if args.stems:
        base = args.output[:-4] if args.output.endswith(".wav") else args.output
        for name, sig in (("harm", harm), ("perc", perc)):
            path = f"{base}_{name}.wav"
            write_wav_pcm16(path, fs, sig * scale)
            print(f"wrote {path}")
    return 0


def cmd_version(args) -> int:
    from . import __version__

    print(f"version {__version__}")
    return 0


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

    n_streams = max(1, args.streams)
    mesh_axes = None
    if args.mesh:
        mesh_axes, err = _parse_mesh_axes(args.mesh, ("dp",))
        if err:
            print(f"stream {err}", file=sys.stderr)
            return 1
        if n_streams % mesh_axes["dp"]:
            print(f"--streams {n_streams} not divisible by dp={mesh_axes['dp']}",
                  file=sys.stderr)
            return 1
    try:
        device = resolve_device(args.device)
    except ZenError as e:  # no CUDA device: exit 2, no fallback
        return _refuse("stream", f"--device {args.device}: {e}")
    mesh = None
    if mesh_axes is not None:
        # the stream axis sharded over dp: pure data parallelism
        from .parallel.mesh import make_mesh

        mesh = make_mesh(mesh_axes, device=device)
    stem_flags = {
        "harmonic": (OUTPUT_HARMONIC, 0),
        "percussive": (OUTPUT_PERCUSSIVE, 1),
        # residual is 1-(hmask+pmask): both other masks must be computed
        # or it degenerates to a passthrough
        "residual": (OUTPUT_ALL, 2),
    }
    outputs, idx = stem_flags[args.stem]
    common = dict(
        outputs=outputs,
        border=_border(args),
        use_sse=args.sse,
        soft_mask=args.soft_mask,
        device=device,
        **_impl_kw(args),
    )
    multi = n_streams > 1 or mesh is not None  # a mesh implies MultiStreamHPR
    t_proc = time.perf_counter()  # before warmup: captures the kernel build
    if multi:
        ms = MultiStreamHPR(n_streams, args.fs, args.hop, args.beta, mesh=mesh, **common)
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
                "mesh": f"dp={mesh_axes['dp']}" if mesh_axes else "single-chip",
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


def _add_variant_flags(p):
    p.add_argument("--cpu", action="store_true",
                   help="the 'replicate' border (reference CPU/IPP)")
    p.add_argument("--sse", action="store_true",
                   help="the SSE box filter instead of the medians")
    p.add_argument("--soft-mask", action="store_true")
    p.add_argument("--nocopybord", action="store_true",
                   help="the 'valid' border (reference GPU)")


def _add_impl_flags(p):
    """The transform, median and state-dtype seams, and the device."""
    p.add_argument(
        "--fft-impl",
        choices=("auto", "torch", "xla", "dft", "dft_bf16", "dft_f32"),
        default="auto",
        help="transform: torch.fft ('auto', 'torch', 'xla') or the DFT "
        "matmuls at float32, bf16x3 or bf16 products ('dft_f32', 'dft', "
        "'dft_bf16'; half spectrum only: --cpu and --nocopybord take torch.fft)",
    )
    p.add_argument(
        "--median-impl",
        choices=("auto", "torch", "cuda", "xla", "pallas"),
        default="auto",
        help="median route: 'auto' = the CUDA kernels on --device cuda, "
        "their plain twins on the CPU ('xla' = 'torch', 'pallas' = 'cuda')",
    )
    p.add_argument(
        "--stream-state",
        choices=("f32", "bf16"),
        default="f32",
        help="dtype of the streaming feature history: 'bf16' halves its "
        "traffic for bf16-quantized median features; offline paths ignore it",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; no fallback)",
    )


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    ap = argparse.ArgumentParser(
        prog=PROG,
        description="zen-tpu on PyTorch/CUDA: harmonic/percussive source separation",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    off = sub.add_parser("offline", help="offline (process entire songs at a time)")
    off.add_argument("-i", "--input", required=True, help="input audio file")
    _add_variant_flags(off)
    off.add_argument(
        "--hps",
        nargs="*",
        default=None,
        metavar=("hop-h", "beta-h"),
        help="2-pass HPR-iterative, defaults: harmonic=4096,2.0 percussive=256,2.0",
    )
    off.add_argument("-o", "--out-prefix", default="")
    off.add_argument("--only-percussive", action="store_true")
    off.add_argument(
        "--blocked",
        action="store_true",
        help="constant-memory overlap-save mode (auto for tracks > 10 min)",
    )
    off.add_argument(
        "--strict-ref",
        action="store_true",
        help="bit-compatible reference quirks: pass-2 residual stem is "
        "silence, exactly like the upstream GPU binary (hps.cu:200-204)",
    )
    off.add_argument(
        "--stem-format", choices=("wav", "flac", "wv"), default="wav",
        help="stem container: PCM16 wav (reference behavior), lossless "
        "16-bit FLAC (~half the size) or lossless 16-bit WavPack",
    )
    off.add_argument(
        "--mesh",
        default="",
        help="frequency tensor parallelism, e.g. tp=4 (wrap border only; N "
        "must divide both pass nffts)",
    )
    _add_impl_flags(off)
    off.set_defaults(func=cmd_offline)

    frt = sub.add_parser("fakert", help="fakert (use slim rt algorithms with wav files)")
    frt.add_argument("-i", "--input", required=True, help="input audio file")
    _add_variant_flags(frt)
    frt.add_argument(
        "--hps",
        nargs="*",
        default=None,
        metavar=("hop", "beta"),
        help="1-pass P-realtime, defaults: 256,2.0",
    )
    frt.add_argument("-o", "--output", default="")
    frt.add_argument(
        "--block-hops",
        default=32,
        type=int,
        help="hops per step (the streaming granularity)",
    )
    _add_impl_flags(frt)
    frt.set_defaults(func=cmd_fakert)

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
        "--mesh",
        default="",
        help="shard the streams over devices, e.g. dp=4 (--streams must divide)",
    )
    stp.add_argument(
        "--raw-scale",
        action="store_true",
        help="emit the engine's unnormalized scale instead of unit gain",
    )
    _add_variant_flags(stp)
    _add_impl_flags(stp)
    stp.set_defaults(func=cmd_stream)

    cor = sub.add_parser(
        "corpus", help="resumable multi-track corpus separation over a device mesh")
    cor.add_argument("-i", "--inputs", nargs="+", required=True, help="track paths or globs")
    cor.add_argument("-o", "--out-dir", required=True)
    cor.add_argument("--hps", nargs="*", default=None, metavar=("hop-h", "beta-h"),
                     help="2-pass params, defaults 4096 2.0 256 2.0")
    cor.add_argument("--mesh", default="",
                     help="mesh axes, e.g. dp=4,sp=2 (default: all visible devices)")
    cor.add_argument("--pp", action="store_true",
                     help="pipelined cascade: track i+1's pass 1 overlaps track i's pass 2, "
                     "on the mesh's first two devices (two CUDA streams of one card; short "
                     "tracks; one process)")
    cor.add_argument("--prefetch", type=int, default=2, metavar="N",
                     help="decode N tracks ahead and encode stems on a background thread, "
                     "overlapping host IO with the card (0 = synchronous IO; default 2)")
    cor.add_argument("--coordinator", default="", metavar="HOST:PORT",
                     help="multi-host run: coordinator address (same on every process); run "
                     "this command once per process with its --proc-id")
    cor.add_argument("--nprocs", type=int, default=1,
                     help="multi-host run: total process count")
    cor.add_argument("--proc-id", type=int, default=0,
                     help="multi-host run: this process's rank (0..nprocs-1)")
    cor.add_argument("--stem-format", choices=("wav", "flac", "wv"), default="wav",
                     help="stem container: PCM16 wav or lossless 16-bit FLAC / WavPack")
    _add_impl_flags(cor)
    cor.set_defaults(func=cmd_corpus)

    for name, func, helptext in (
        ("pitch-track", cmd_pitch_track, "MPM pitch tracking demo (+/- HPR)"),
        ("beat-track", cmd_beat_track, "BTrack beat tracking demo (+/- HPR)"),
    ):
        p = sub.add_parser(name, help=helptext)
        p.add_argument("-i", "--input", required=True)
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; no fallback)")
        p.set_defaults(func=func)

    syn = sub.add_parser(
        "synth",
        help="generate a synthetic harmonic+percussive test mixture "
        "(the reference sample wavs ship as git-lfs pointers)",
    )
    syn.add_argument("-o", "--output", required=True, help="mixture wav path")
    syn.add_argument("--fs", type=float, default=44100.0)
    syn.add_argument("--seconds", type=float, default=4.0)
    syn.add_argument("--bpm", type=float, default=120.0)
    syn.add_argument("--hits-per-beat", type=int, default=1)
    syn.add_argument("--sawtooth", action="store_true")
    syn.add_argument("--vibrato-cents", type=float, default=0.0)
    syn.add_argument("--seed", type=int, default=42)
    syn.add_argument(
        "--stems",
        action="store_true",
        help="also write <out>_harm.wav / <out>_perc.wav ground truth",
    )
    syn.set_defaults(func=cmd_synth)

    sub.add_parser("version").set_defaults(func=cmd_version)
    # the reference CLI's flag forms (`zen -v | --version`)
    ap.add_argument("-v", "--version", action="version", version=f"version {__version__}")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
