"""Multi-process smoke (counterpart of ``scripts/multihost_smoke.py``): run
the port's sharded paths as real processes on localhost and hold what
each process ends with byte for byte against one process running the
same global mesh.

    python -m zen_tpu_torch.tools.multihost_smoke [--device cuda|cpu]
        [--nprocs 2] [--legs run,resume,cli,sp,sp_resume,tp,fleet] [--keep DIR]

The N worker processes join one ``torch.distributed`` group (gloo, a
port taken from a socket bound to port 0) and run on a global mesh, each
process holding its own entries (the card repeated, or the CPU). The
golden run is this process alone on a mesh of the same global shape (the
card given N times). The legs:

  run     ``separate_corpus`` on dp = N x sp = 2, each process holding
          the entries of its dp row; every stem byte-equal to the golden
          run's, and in every worker each sp ring inside one process;
  resume  that fleet SIGKILLed once the journal holds the first batch
          (the workers' reader holds the last track until the kill, so
          the kill lands before it), then run again: the journaled
          tracks are skipped and the stems still byte-match;
  cli     `python -m zen_tpu_torch corpus --mesh dp=N --nprocs N
          --coordinator 127.0.0.1:P --proc-id I` in N processes, against
          the golden run of the dp = N x sp = 1 mesh;
  sp      `zen-torch corpus --mesh sp=N --nprocs N ...` (the CLI's own
          code, in each worker) over one sp ring with a shard in each
          process, the last track routed long, so that every halo and
          the blocked scan's ring cross processes; stems byte-equal to
          the golden dp = 1 x sp = N run's, the mesh lines printed;
  sp_resume  that fleet SIGKILLed once the long track's pass 1 is
          checkpointed (the workers hold before its pass 2; the open
          batch, the track read before it, is not yet separated) and run
          again, resuming pass 1 from the checkpoint on every process;
          stems byte-equal to the golden run's;
  tp      ``tp_hpri_offline`` at ``{"tp": 2}`` and ``{"tp": 4}`` over 2
          processes (whatever --nprocs says): the halos at the cut edges
          and the ordered sums of the partial inverses cross processes;
          each process's stems byte-equal to the golden run's;
  fleet   ``MultiStreamHPR`` over ``{"dp": N}``: each process steps its
          own streams; its rows byte-equal to those slots of the golden
          fleet's, before and after a reset_streams across the split.

As zen_tpu's smoke does, the corpus legs' workers lower
``LONG_TRACK_SAMPLES`` so that the last track takes the long route
(``sharded_hpri_blocked`` at sp > 1, process 0's ``process_blocked`` at sp
= 1). The cli leg keeps the default, so every track is batched. Sizes: on
the CPU the corpus of zen_tpu's smoke (fs 8000, hops 256 / 64, tracks of
1.1-2.2 s), tp at 8 kHz hops 64 / 16 on 0.5 s, a fleet of 12 streams at
hop 64; on the card the corpus command's defaults (44.1 kHz, 4096 / 2.0
/ 256 / 2.0) on four tracks of 10-30 s and one of 50 s, tp at
BASELINE.json configs[0] (44.1 kHz, 4096 / 2.5 / 256 / 2.5) on the
161,571-sample clip, and the configs[3] fleet: 64 streams at hop 256,
blocks of 32 hops. ``--size cpu`` takes the CPU sizes on the card.

Each worker has a timeout and prints one JSON line: its results, its
median launches by route and on the rank routes' key store (all 0 on the
CPU, where the wrappers run their plain twins), its wall, and its
exchanges (``multihost.traffic``: bytes sent and seconds waited, by
kind: halos, ordered sums, gathers, agreements). The cli leg's processes
are the command itself, whose launches nobody reads. Processes that share
one card run by time slicing: the walls say nothing about scaling. The
last line is a JSON report of every leg.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULE = "zen_tpu_torch.tools.multihost_smoke"


@dataclasses.dataclass(frozen=True)
class Corpus:
    fs: int
    hop_h: int
    hop_p: int
    seconds: tuple  # the tracks' lengths; the last one is routed long
    long_cut: int  # the lowered LONG_TRACK_SAMPLES: the last track exceeds it x sp


CORPORA = {
    "cpu": Corpus(8000, 256, 64, (1.3, 1.7, 1.1, 1.5, 2.2), 8000),
    "cuda": Corpus(44100, 4096, 256, (10.0, 15.0, 20.0, 30.0, 50.0), 20 * 44100),
}


@dataclasses.dataclass(frozen=True)
class Rings:
    fs: float
    hop_h: int  # the tp cascade: hop_h / beta_h / hop_p / beta_p
    hop_p: int
    beta: float
    samples: int  # the tp clip
    streams: int  # the fleet: streams x hop, blocks of ``block`` hops
    fleet_fs: float
    hop: int
    block: int
    steps: int


RINGS = {
    "cpu": Rings(8000.0, 64, 16, 2.0, 4000, 12, 8000.0, 64, 8, 3),
    "cuda": Rings(44100.0, 4096, 256, 2.5, 161_571, 64, 44100.0, 256, 32, 4),
}


def _size(device: str, size: str = "") -> str:
    return size or ("cuda" if device.startswith("cuda") else "cpu")


def corpus_of(device: str, size: str = "") -> Corpus:
    return CORPORA[_size(device, size)]


def rings_of(device: str, size: str = "") -> Rings:
    return RINGS[_size(device, size)]


def long_cut(corpus: Corpus, sp: int) -> int:
    """The lowered LONG_TRACK_SAMPLES at sp: the corpus routes a track
    long past this x sp, the same threshold (long_cut x 2) at every sp, so
    that the last track alone goes long."""
    return corpus.long_cut * 2 // sp


def tp_clip(rings: Rings) -> np.ndarray:
    """The tp leg's clip: a sine chord under noise bursts and a 0.01 noise
    floor, from seed 5."""
    rng = np.random.default_rng(5)
    t = np.arange(rings.samples) / rings.fs
    x = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 330 * t)
    x += 0.01 * rng.standard_normal(rings.samples)
    for j in range(0, rings.samples, rings.samples // 7):
        span = min(rings.samples - j, int(rings.fs) // 100)
        x[j : j + span] += rng.standard_normal(span) * np.exp(-np.arange(span) / (span / 6))
    return x.astype(np.float32)


def fleet_blocks(rings: Rings) -> np.ndarray:
    """The fleet leg's blocks [steps, streams, block, hop], from seed 9."""
    rng = np.random.default_rng(9)
    shape = (rings.steps, rings.streams, rings.block, rings.hop)
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def digest(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(x.detach().cpu().numpy()).tobytes()).hexdigest()


def free_port() -> int:
    """A port no process listens on now (the OS's pick for port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_corpus(corpus_dir: str, corpus: Corpus) -> list:
    """The tracks as WAV files, sorted so that the long one is last: a
    sine per track under decaying noise bursts and a white noise floor
    (without one, bins that hold only FFT round-off flip their hard mask
    between two FFT libraries), from seed 7."""
    from ..io.audio import write_wav_pcm16

    os.makedirs(corpus_dir, exist_ok=True)
    rng = np.random.default_rng(7)
    paths = []
    for i, (f0, secs) in enumerate(zip((220.0, 330.0, 147.0, 262.0, 196.0), corpus.seconds)):
        n = int(corpus.fs * secs)
        t = np.arange(n) / corpus.fs
        harm = 0.5 * np.sin(2 * np.pi * f0 * t)
        perc = np.zeros(n)
        burst = corpus.fs * 300 // 8000
        for b in np.arange(0.2, secs, 0.4):
            j = int(b * corpus.fs)
            span = min(burst, n - j)
            perc[j : j + span] += rng.standard_normal(span) * np.exp(-np.arange(span) / (burst / 6))
        floor = 0.01 * rng.standard_normal(n)
        path = os.path.join(corpus_dir, f"track{i}.wav")
        write_wav_pcm16(path, corpus.fs, ((harm + perc + floor) * 0.5).astype(np.float32))
        paths.append(path)
    return paths


def read_launches() -> dict:
    """The median kernels' launches in this process by route, 'kernel/route',
    of each rank route's, those that took its steps kernel,
    'kernel/rank@steps', of K1's register route's and K2's network
    route's, those that took their shared core,
    'tap_median_time/register@core' and 'sliding_median_boundary/
    network@core', and of K2's rank route's, those on its key store,
    'sliding_median_boundary/rank@scratch'."""
    from ..ops import median_cuda as mc

    counts = {}
    for name in ("tap_median_time", "sliding_median_boundary"):
        wrapper = getattr(mc, name)
        counts.update({f"{name}/{route}": n for route, n in wrapper.routes.items()})
        counts[f"{name}/rank@steps"] = wrapper.steps
    counts["tap_median_time/register@core"] = mc.tap_median_time.cores
    counts["sliding_median_boundary/network@core"] = mc.sliding_median_boundary.cores
    counts["sliding_median_boundary/rank@scratch"] = mc.sliding_median_boundary.stores["scratch"]
    return counts


def _measured(fn, device: str) -> tuple:
    """(fn(), {its launches, its exchanges, its wall}) in this process."""
    import torch

    from ..parallel import multihost

    before = read_launches()
    multihost.reset_traffic()
    t0 = time.perf_counter()
    out = fn()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {"launches": {k: v - before[k] for k, v in read_launches().items()},
                 "traffic": {k: dict(v) for k, v in multihost.traffic.items()}, "wall_s": wall}


def _report(**kw) -> dict:
    from ..parallel import multihost

    return {"worker": multihost.process_index(), "nprocs": multihost.process_count(), **kw}


def separate(corpus_dir: str, out_dir: str, device: str, dp: int, sp: int, cut: bool,
             hold_last: bool = False, hold_s: float = 0.0, size: str = "",
             whole_rings: bool = True) -> dict:
    """This process's share of the corpus over the global mesh dp x sp
    (one process: the golden run; in a process group: its shards), the
    long threshold lowered when ``cut``: its report, with the launches and
    exchanges it made. ``whole_rings`` requires every sp ring inside one
    process (the run and resume legs)."""
    from ..drivers import offline
    from ..drivers.corpus import separate_corpus
    from ..io.audio import read_audio_mono
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    corpus = corpus_of(device, size)
    n_local = dp * sp // multihost.process_count()
    mesh = make_mesh({"dp": dp, "sp": sp}, devices=[device] * n_local)
    rings = [sorted(set(row.tolist())) for row in mesh.processes]
    if whole_rings and any(len(r) != 1 for r in rings):
        raise AssertionError(f"an sp ring spans processes: owners by dp row {rings}")
    tracks = sorted(os.path.join(corpus_dir, f) for f in os.listdir(corpus_dir)
                    if f.endswith(".wav"))

    def reader(path):
        if hold_last and path == tracks[-1]:
            time.sleep(hold_s)  # until the orchestrator's SIGKILL
        return read_audio_mono(path)

    long_samples = offline.LONG_TRACK_SAMPLES
    if cut:
        offline.LONG_TRACK_SAMPLES = long_cut(corpus, sp)
    try:
        res, measured = _measured(
            lambda: separate_corpus(tracks, out_dir, mesh, hop_h=corpus.hop_h,
                                    hop_p=corpus.hop_p, reader=reader), device)
    finally:
        offline.LONG_TRACK_SAMPLES = long_samples
    return _report(results=res, mesh=mesh.shape, owners=rings, **measured)


def run_tp(device: str, size: str = "") -> dict:
    """``tp_hpri_offline`` at {"tp": 2} and {"tp": 4} over this process's
    group (or this process alone): each mesh's stems' digests, launches,
    exchanges and wall; launches, exchanges and walls summed over both."""
    from ..drivers.offline import HPRIOffline
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import tp_hpri_offline

    rings = rings_of(device, size)
    sep = HPRIOffline(rings.fs, rings.hop_h, rings.hop_p, rings.beta, rings.beta,
                      fast_rfft=False, device=device)
    audio = tp_clip(rings)
    out = {}
    for tp in (2, 4):
        mesh = make_mesh({"tp": tp}, devices=[device] * (tp // multihost.process_count()))
        stems, measured = _measured(lambda: tp_hpri_offline(audio, sep.cfg_h, sep.cfg_p, mesh),
                                    device)
        out[f"tp{tp}"] = {"digests": [digest(x) for x in stems], **measured}
    traffic = {kind: _summed([out[k]["traffic"][kind] for k in out])
               for kind in out["tp2"]["traffic"]}
    return _report(**out, launches=_summed([out[k]["launches"] for k in out]), traffic=traffic,
                   wall_s=sum(out[k]["wall_s"] for k in out))


def run_fleet(device: str, n_dp: int, split: int, size: str = "") -> dict:
    """``MultiStreamHPR`` over {"dp": n_dp} in this process's group (or
    this process alone): for each step its rows' digests, in ``split``
    equal runs of slots (one in a process of the group: its own), a
    reset_streams across the first split after step 0; its slots,
    launches, exchanges and wall."""
    from ..drivers.realtime import MultiStreamHPR
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    rings = rings_of(device, size)
    mesh = make_mesh({"dp": n_dp}, devices=[device] * (n_dp // multihost.process_count()))
    fleet = MultiStreamHPR(rings.streams, rings.fleet_fs, rings.hop, device=device, mesh=mesh)
    per = rings.streams // n_dp

    def steps():
        digests = []
        for i, blk in enumerate(fleet_blocks(rings)):
            if i == 1:
                fleet.reset_streams([per - 1, per])
            rows = fleet.process_block(blk)
            digests.append([digest(r) for r in rows.chunk(split)])
        return digests

    digests, measured = _measured(steps, device)
    return _report(digests=digests, slots=[fleet.slots.start, fleet.slots.stop], **measured)


def run_cli(argv: list, device: str, rank: int, nprocs: int, hold_p2: bool, hold_s: float,
            size: str = "") -> dict:
    """``zen-torch corpus --mesh sp=nprocs`` (``cli.main``) in this
    process, the long threshold lowered to ``long_cut`` at that sp; with
    ``hold_p2`` each long
    track waits ``hold_s`` before its pass 2 (until the orchestrator's
    SIGKILL). The command joins and leaves the group itself."""
    from .. import cli
    from ..drivers import offline
    from ..parallel import sharded

    offline.LONG_TRACK_SAMPLES = long_cut(corpus_of(device, size), nprocs)
    if hold_p2:
        scan = sharded.sharded_separate_blocked_checkpointed

        def held(*a, tag="track", **kw):
            if tag.endswith(".p2"):
                time.sleep(hold_s)
            return scan(*a, tag=tag, **kw)

        sharded.sharded_separate_blocked_checkpointed = held
    rc, measured = _measured(lambda: cli.main(argv), device)
    if rc:
        raise RuntimeError(f"zen-torch corpus exited {rc}")
    return {"worker": rank, "nprocs": nprocs, **measured}


def worker(args) -> int:
    """One process of a fleet: join the group (the sp leg's command joins
    it itself), run its leg, print the report. On the CPU a worker
    computes on one thread: N processes of the machine's width each would
    oversubscribe it."""
    import torch

    from ..parallel import multihost
    from ..parallel.mesh import distributed_init

    if not args.device.startswith("cuda"):
        torch.set_num_threads(1)
    if args.leg == "sp":
        report = run_cli(args.cli_argv, args.device, args.proc_id, args.nprocs, args.hold,
                         args.timeout, args.size)
        print(json.dumps(report), flush=True)
        return 0
    distributed_init(f"127.0.0.1:{args.port}", args.nprocs, args.proc_id,
                     timeout=datetime.timedelta(seconds=args.timeout))
    if args.leg == "tp":
        report = run_tp(args.device, args.size)
    elif args.leg == "fleet":
        report = run_fleet(args.device, args.nprocs, 1, args.size)
    else:
        report = separate(args.corpus_dir, args.out_dir, args.device, args.dp, args.sp,
                          args.long_cut, args.hold, args.timeout, args.size)
    print(json.dumps(report), flush=True)
    multihost.leave()
    return 0


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _base_cmd(args, leg: str, rank: int, nprocs: int, port: int) -> list:
    return [sys.executable, "-m", MODULE, "--worker", "--leg", leg, "--device", args.device,
            "--size", args.size, "--proc-id", str(rank), "--nprocs", str(nprocs),
            "--port", str(port), "--timeout", str(args.timeout)]


def _worker_cmd(args, rank: int, port: int, out_dir: str, hold_last: bool = False) -> list:
    """A worker of the run and resume legs: dp = N x sp = 2, the long cut."""
    cmd = _base_cmd(args, "corpus", rank, args.nprocs, port) + [
        "--dp", str(args.nprocs), "--sp", "2", "--corpus-dir", args.corpus_dir,
        "--out-dir", out_dir, "--long-cut"]
    return cmd + ["--hold"] * hold_last


def _corpus_argv(args, rank: int, port: int, out_dir: str, mesh: str) -> list:
    corpus = corpus_of(args.device, args.size)
    return ["corpus", "-i", os.path.join(args.corpus_dir, "*.wav"), "-o", out_dir, "--hps",
            str(corpus.hop_h), "2.0", str(corpus.hop_p), "2.0", "--mesh", mesh,
            "--device", args.device, "--nprocs", str(args.nprocs),
            "--coordinator", f"127.0.0.1:{port}", "--proc-id", str(rank)]


def _cli_cmd(args, rank: int, port: int, out_dir: str) -> list:
    return [sys.executable, "-m", "zen_tpu_torch",
            *_corpus_argv(args, rank, port, out_dir, f"dp={args.nprocs}")]


def _sp_cmd(args, rank: int, port: int, out_dir: str, hold: bool = False) -> list:
    """A worker of the sp leg: the corpus command over sp = N, in-process."""
    cmd = _base_cmd(args, "sp", rank, args.nprocs, port) + ["--hold"] * hold
    return cmd + ["--", *_corpus_argv(args, rank, port, out_dir, f"sp={args.nprocs}")]


def _spawn(cmds: list) -> list:
    return [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for c in cmds]


def _wait(procs: list, timeout: float, what: str) -> list:
    """Every process's output; each must exit 0 within ``timeout``, else
    the whole fleet is killed and this raises with their output."""
    outs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"{what}: a process outlived {timeout} s") from None
    bad = [(i, p.returncode, o) for i, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise RuntimeError(f"{what}: " + "".join(f"\n--- process {i}, rc {rc} ---\n{o}"
                                                 for i, rc, o in bad))
    return outs


def _reports(outs: list) -> list:
    return [json.loads(line) for o in outs for line in o.splitlines()
            if line.startswith('{"worker"')]


def _fleet(args, cmds: list, what: str) -> dict:
    """Run ``cmds`` together; the leg's wall and workers' reports."""
    t0 = time.perf_counter()
    outs = _wait(_spawn(cmds), args.timeout, what)
    leg = {"wall_s": time.perf_counter() - t0, "workers": _reports(outs), "outputs": outs}
    leg["launches"] = _summed([w["launches"] for w in leg["workers"]])
    return leg


def _summed(counts: list) -> dict:
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def stems(out_dir: str) -> dict:
    """{file name: bytes} of the stems under ``out_dir``."""
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir)) if f.endswith(".wav")}


def _journal(out_dir: str) -> list:
    with open(os.path.join(out_dir, "progress.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _same(got: dict, want: dict, what: str) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{what}: stem files {sorted(got)} against {sorted(want)}")
    diff = [f for f in want if got[f] != want[f]]
    if diff:
        raise AssertionError(f"{what}: stems differ from the golden run's: {diff}")


def _golden(args, name: str, dp: int, sp: int, cut: bool) -> dict:
    """The golden corpus run: this process alone over the global mesh."""
    out = os.path.join(args.work, name)
    t0 = time.perf_counter()
    report = separate(args.corpus_dir, out, args.device, dp, sp, cut, size=args.size,
                      whole_rings=False)
    return {"wall_s": time.perf_counter() - t0, "workers": [report],
            "launches": report["launches"], "dir": out, "outputs": []}


def _kill_when(procs: list, ready, timeout: float, what: str) -> None:
    """SIGKILL the fleet once ``ready()`` holds; raise if it ends or
    stalls first."""
    deadline = time.monotonic() + timeout
    stalled = False
    while not ready():
        if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
            stalled = True
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
    outs = [p.communicate()[0] for p in procs]
    if stalled:
        raise RuntimeError(f"{what}: the fleet ended or stalled before the kill point:"
                           + "".join(f"\n--- process {i} ---\n{o}" for i, o in enumerate(outs)))


def _journal_len(out_dir: str) -> int:
    path = os.path.join(out_dir, "progress.jsonl")
    return len(_journal(out_dir)) if os.path.exists(path) else 0


def _tracks_lines(leg: dict) -> list:
    return [json.loads(line) for o in leg["outputs"] for line in o.splitlines()
            if '"metric": "corpus_tracks"' in line]


def _run_corpus_legs(args, legs: dict, total: int) -> None:
    n = args.nprocs
    want = {"done": 0, "processed": total}
    if {"run", "resume"} & set(args.legs):
        legs["golden"] = _golden(args, "golden", n, 2, True)
        golden = stems(legs["golden"]["dir"])
        if len(golden) != 3 * total:
            raise AssertionError(f"golden run wrote {sorted(golden)}")
    if "run" in args.legs:
        out = os.path.join(args.work, "run")
        port = free_port()
        leg = legs["run"] = _fleet(args, [_worker_cmd(args, i, port, out)
                                          for i in range(n)], "run")
        if [w["results"] for w in leg["workers"]] != [want] * n:
            raise AssertionError(f"run: results {[w['results'] for w in leg['workers']]}")
        _same(stems(out), golden, "run")
        leg["journal"] = _journal(out)
    if "resume" in args.legs:
        out = os.path.join(args.work, "resume")
        port = free_port()
        # the first batch is n tracks; the fleet holds the last track, so
        # it cannot journal past the batch before the kill
        _kill_when(_spawn([_worker_cmd(args, i, port, out, hold_last=True) for i in range(n)]),
                   lambda: _journal_len(out) >= n, args.timeout, "resume")
        done = _journal_len(out)
        if done != n:
            raise AssertionError(f"resume: the kill landed after {done} journaled tracks, not {n}")
        port = free_port()
        leg = legs["resume"] = _fleet(args, [_worker_cmd(args, i, port, out)
                                             for i in range(n)], "resume")
        leg["done_before"] = done
        want_r = {"done": done, "processed": total - done}
        if [w["results"] for w in leg["workers"]] != [want_r] * n:
            raise AssertionError(f"resume: results {[w['results'] for w in leg['workers']]}")
        _same(stems(out), golden, "resume")
        leg["journal"] = _journal(out)
    if "cli" in args.legs:
        legs["cli_golden"] = _golden(args, "cli_golden", n, 1, False)
        out = os.path.join(args.work, "cli")
        port = free_port()
        leg = legs["cli"] = _fleet(args, [_cli_cmd(args, i, port, out) for i in range(n)], "cli")
        if _tracks_lines(leg) != [{"metric": "corpus_tracks", **want}] * n:
            raise AssertionError(f"cli: last lines {_tracks_lines(leg)}")
        _same(stems(out), stems(legs["cli_golden"]["dir"]), "cli")
        leg["journal"] = _journal(out)


def _run_sp_leg(args, legs: dict, total: int) -> None:
    """The corpus command over sp = N (the sp leg), then killed before its
    long track's pass 2 and resumed (sp_resume), each against the golden
    dp = 1 x sp = N run."""
    n = args.nprocs
    legs["sp_golden"] = _golden(args, "sp_golden", 1, n, True)
    golden = stems(legs["sp_golden"]["dir"])
    if "sp" in args.legs:
        out = os.path.join(args.work, "sp")
        port = free_port()
        leg = legs["sp"] = _fleet(args, [_sp_cmd(args, i, port, out) for i in range(n)], "sp")
        if _tracks_lines(leg) != [{"metric": "corpus_tracks", "done": 0, "processed": total}] * n:
            raise AssertionError(f"sp: last lines {_tracks_lines(leg)}")
        leg["mesh_lines"] = [line for o in leg["outputs"] for line in o.splitlines()
                             if line.startswith("corpus: ")]
        _same(stems(out), golden, "sp")
        leg["journal"] = _journal(out)
    if "sp_resume" not in args.legs:
        return
    out = os.path.join(args.work, "sp_resume")
    tracks = sorted(f for f in os.listdir(args.corpus_dir) if f.endswith(".wav"))
    p1 = os.path.join(out, ".ckpt", f"{os.path.splitext(tracks[-1])[0]}.p1.ckpt.npz")
    # at dp = 1 each short track is a batch of its own, and a long track
    # is separated as it is read, before the open batch: the kill lands
    # with every track but the last two journaled
    port = free_port()
    _kill_when(_spawn([_sp_cmd(args, i, port, out, hold=True) for i in range(n)]),
               lambda: _journal_len(out) >= total - 2 and os.path.exists(p1), args.timeout,
               "sp resume")
    done = _journal_len(out)
    if done != total - 2:
        raise AssertionError(f"sp resume: the kill landed after {done} journaled tracks")
    port = free_port()
    leg = legs["sp_resume"] = _fleet(args, [_sp_cmd(args, i, port, out) for i in range(n)],
                                     "sp resume")
    leg["done_before"] = done
    want = {"metric": "corpus_tracks", "done": done, "processed": total - done}
    if _tracks_lines(leg) != [want] * n:
        raise AssertionError(f"sp resume: last lines {_tracks_lines(leg)}")
    _same(stems(out), golden, "sp resume")
    leg["journal"] = _journal(out)


def _run_tp_leg(args, legs: dict) -> None:
    """tp_hpri_offline at tp 2 and 4 over 2 processes against this
    process's run of the same meshes."""
    t0 = time.perf_counter()
    golden = run_tp(args.device, args.size)
    legs["tp_golden"] = {"wall_s": time.perf_counter() - t0, "workers": [golden],
                         "launches": golden["launches"], "outputs": []}
    port = free_port()
    leg = legs["tp"] = _fleet(args, [_base_cmd(args, "tp", i, 2, port) for i in range(2)], "tp")
    for w in leg["workers"]:
        for key in ("tp2", "tp4"):
            if w[key]["digests"] != golden[key]["digests"]:
                raise AssertionError(f"tp: process {w['worker']}'s {key} stems differ from "
                                     "the golden run's")


def _run_fleet_leg(args, legs: dict) -> None:
    """MultiStreamHPR over {"dp": N} in N processes against this
    process's fleet on the same mesh, row run by row run."""
    n = args.nprocs
    t0 = time.perf_counter()
    golden = run_fleet(args.device, n, n, args.size)
    legs["fleet_golden"] = {"wall_s": time.perf_counter() - t0, "workers": [golden],
                            "launches": golden["launches"], "outputs": []}
    port = free_port()
    leg = legs["fleet"] = _fleet(args, [_base_cmd(args, "fleet", i, n, port) for i in range(n)],
                                 "fleet")
    per = rings_of(args.device, args.size).streams // n
    for w in leg["workers"]:
        r = w["worker"]
        if w["slots"] != [r * per, (r + 1) * per]:
            raise AssertionError(f"fleet: process {r}'s slots {w['slots']}")
        if w["digests"] != [[step[r]] for step in golden["digests"]]:
            raise AssertionError(f"fleet: process {r}'s rows differ from the golden run's")


def run_legs(args) -> dict:
    """Run the legs named in ``args.legs``; raise on the first failure.
    The report: each leg's wall, summed launches, workers' reports (and a
    corpus leg's journal lines)."""
    report = {"nprocs": args.nprocs, "device": args.device, "legs": {}}
    legs = report["legs"]
    if {"run", "resume", "cli", "sp", "sp_resume"} & set(args.legs):
        paths = make_corpus(args.corpus_dir, corpus_of(args.device, args.size))
        report["tracks"] = len(paths)
        _run_corpus_legs(args, legs, len(paths))
        if {"sp", "sp_resume"} & set(args.legs):
            _run_sp_leg(args, legs, len(paths))
    if "tp" in args.legs:
        _run_tp_leg(args, legs)
    if "fleet" in args.legs:
        _run_fleet_leg(args, legs)
    for leg in legs.values():
        del leg["outputs"]
    return report


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--legs", default="run,resume,cli",
                    help="comma-separated: run, resume, cli, sp, sp_resume, tp, fleet")
    ap.add_argument("--size", default="", choices=("", "cpu", "cuda"),
                    help="the sizes of the corpus, the tp clip and the fleet (default: the "
                    "device's)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a leg (and a collective) may take")
    ap.add_argument("--keep", default="", metavar="DIR",
                    help="work under DIR and keep it (default: a temporary directory)")
    # a worker's own arguments (set by the orchestrator)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--leg", default="corpus", help=argparse.SUPPRESS)
    ap.add_argument("--proc-id", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--dp", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--sp", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--corpus-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--long-cut", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--hold", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("cli_argv", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.nprocs < 2:
        ap.error("--nprocs must be 2 or more")
    args.legs = [leg for leg in args.legs.split(",") if leg]
    if args.cli_argv[:1] == ["--"]:
        args.cli_argv = args.cli_argv[1:]
    return args


def traffic_line(traffic: dict) -> str:
    """A worker's exchanges: bytes sent and seconds waited, by kind."""
    return ", ".join(f"{k} {v['bytes']} B / {v['seconds']:.3f} s" for k, v in traffic.items()
                     if v["calls"])


def main(argv=None) -> int:
    args = parse(argv)
    if args.worker:
        return worker(args)
    args.work = args.keep or tempfile.mkdtemp(prefix="zen_torch_mh_")
    os.makedirs(args.work, exist_ok=True)
    args.corpus_dir = os.path.join(args.work, "corpus")
    try:
        report = run_legs(args)
    finally:
        if not args.keep:
            shutil.rmtree(args.work, ignore_errors=True)
    for name, leg in report["legs"].items():
        walls = ", ".join(f"{w['wall_s']:.2f}" for w in leg["workers"])
        sent = "; ".join(f"[{traffic_line(w['traffic'])}]" for w in leg["workers"]
                         if "traffic" in w)
        print(f"multihost_smoke {name}: {leg['wall_s']:.2f} s in all; workers' walls [{walls}] "
              f"s, their exchanges {sent or 'none'}; launches {leg['launches']}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
