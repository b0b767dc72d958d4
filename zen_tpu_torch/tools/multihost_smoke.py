"""Multi-process corpus smoke (counterpart of ``scripts/multihost_smoke.py``):
run ``separate_corpus`` as real processes on localhost and hold their stems
byte for byte against one process running the same global mesh.

    python -m zen_tpu_torch.tools.multihost_smoke [--device cuda|cpu]
        [--nprocs 2] [--legs run,resume,cli] [--keep DIR]

The N worker processes join one ``torch.distributed`` group (gloo, a
port taken from a socket bound to port 0) and run ``separate_corpus`` on
the global mesh dp = N x sp = 2, each process holding the entries of its dp
row (the card repeated, or the CPU). The golden run is this process
alone on a mesh of the same global shape. The legs:

  run     the N-process run; every stem byte-equal to the golden run's,
          and in every worker each sp ring inside one process;
  resume  the fleet SIGKILLed once the journal holds the first batch
          (the workers' reader holds the last track until the kill, so
          the kill lands before it), then run again: the journaled
          tracks are skipped and the stems still byte-match;
  cli     `python -m zen_tpu_torch corpus --mesh dp=N --nprocs N
          --coordinator 127.0.0.1:P --proc-id I` in N processes, against
          the golden run of the dp = N x sp = 1 mesh.

As zen_tpu's smoke does, the library legs' workers lower
``LONG_TRACK_SAMPLES`` so that the last track takes the long route
(``sharded_hpri_blocked`` at sp > 1, process 0's ``process_blocked`` at sp
= 1). The CLI leg keeps the default, so every track is batched. Sizes: on
the CPU the corpus of zen_tpu's smoke (fs 8000, hops 256 / 64, tracks of
1.1-2.2 s); on the card the corpus command's defaults (44.1 kHz, 4096 /
2.0 / 256 / 2.0), four tracks of 30-90 s and one of 150 s.

Each worker has a timeout and prints one JSON line: its results, its
median launches by route and on the rank routes' key store (all 0 on the
CPU, where the wrappers run their plain twins), its wall and the wall of its cross-process gathers. The
CLI leg's processes are the command itself, whose launches nobody reads.
Processes that share one card run by time slicing: the walls say nothing
about scaling. The last line is a JSON report of every leg.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
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
    "cuda": Corpus(44100, 4096, 256, (30.0, 45.0, 60.0, 90.0, 150.0), 60 * 44100),
}


def corpus_of(device: str) -> Corpus:
    return CORPORA["cuda" if device.startswith("cuda") else "cpu"]


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
    and of the rank route's, those on its key store, 'kernel/rank@scratch'."""
    from ..ops import median_cuda as mc

    counts = {}
    for name in ("tap_median_time", "sliding_median_boundary"):
        wrapper = getattr(mc, name)
        counts.update({f"{name}/{route}": n for route, n in wrapper.routes.items()})
        counts[f"{name}/rank@scratch"] = wrapper.stores["scratch"]
    return counts


def separate(corpus_dir: str, out_dir: str, device: str, dp: int, sp: int, long_cut: bool,
             hold_last: bool = False, hold_s: float = 0.0) -> dict:
    """This process's share of the corpus over the global mesh dp x sp
    (one process: the golden run; in a process group: its dp rows): its
    report, with the launches and cross-process gathers it made."""
    from ..drivers import offline
    from ..drivers.corpus import separate_corpus
    from ..io.audio import read_audio_mono
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    corpus = corpus_of(device)
    n_local = dp * sp // multihost.process_count()
    mesh = make_mesh({"dp": dp, "sp": sp}, devices=[device] * n_local)
    rings = [sorted(set(row.tolist())) for row in mesh.processes]
    if any(len(r) != 1 for r in rings):
        raise AssertionError(f"an sp ring spans processes: owners by dp row {rings}")
    tracks = sorted(os.path.join(corpus_dir, f) for f in os.listdir(corpus_dir)
                    if f.endswith(".wav"))

    def reader(path):
        if hold_last and path == tracks[-1]:
            time.sleep(hold_s)  # until the orchestrator's SIGKILL
        return read_audio_mono(path)

    gather = [0.0]
    allgather, long_samples = multihost.allgather, offline.LONG_TRACK_SAMPLES

    def timed_allgather(x):
        t = time.perf_counter()
        out = allgather(x)
        gather[0] += time.perf_counter() - t
        return out

    before = read_launches()
    multihost.allgather = timed_allgather
    if long_cut:
        offline.LONG_TRACK_SAMPLES = corpus.long_cut
    try:
        t0 = time.perf_counter()
        res = separate_corpus(tracks, out_dir, mesh, hop_h=corpus.hop_h, hop_p=corpus.hop_p,
                              reader=reader)
        wall = time.perf_counter() - t0
    finally:
        multihost.allgather, offline.LONG_TRACK_SAMPLES = allgather, long_samples
    launches = {k: v - before[k] for k, v in read_launches().items()}
    return {"worker": multihost.process_index(), "nprocs": multihost.process_count(),
            "results": res, "launches": launches, "wall_s": wall, "gather_s": gather[0],
            "mesh": mesh.shape, "owners": rings}


def worker(args) -> int:
    """One process of a fleet: join the group, separate, print the report.
    On the CPU a worker computes on one thread: N processes of the
    machine's width each would oversubscribe it."""
    import torch

    from ..parallel import multihost
    from ..parallel.mesh import distributed_init

    if not args.device.startswith("cuda"):
        torch.set_num_threads(1)

    distributed_init(f"127.0.0.1:{args.port}", args.nprocs, args.proc_id,
                     timeout=datetime.timedelta(seconds=args.timeout))
    print(json.dumps(separate(args.corpus_dir, args.out_dir, args.device, args.dp, args.sp,
                              args.long_cut, args.hold_last, args.timeout)), flush=True)
    multihost.leave()
    return 0


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _worker_cmd(args, rank: int, port: int, out_dir: str, hold_last: bool = False) -> list:
    """A worker of the library legs: dp = N x sp = 2, the long cut."""
    cmd = [sys.executable, "-m", MODULE, "--worker", "--device", args.device,
           "--proc-id", str(rank), "--nprocs", str(args.nprocs), "--dp", str(args.nprocs),
           "--sp", "2", "--port", str(port), "--corpus-dir", args.corpus_dir,
           "--out-dir", out_dir, "--timeout", str(args.timeout), "--long-cut"]
    return cmd + ["--hold-last"] * hold_last


def _cli_cmd(args, rank: int, port: int, out_dir: str) -> list:
    corpus = corpus_of(args.device)
    return [sys.executable, "-m", "zen_tpu_torch", "corpus", "-i",
            os.path.join(args.corpus_dir, "*.wav"), "-o", out_dir, "--hps", str(corpus.hop_h),
            "2.0", str(corpus.hop_p), "2.0", "--mesh", f"dp={args.nprocs}",
            "--device", args.device, "--nprocs", str(args.nprocs),
            "--coordinator", f"127.0.0.1:{port}", "--proc-id", str(rank)]


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


def _golden(args, name: str, sp: int, long_cut: bool) -> dict:
    """The golden run: this process alone over the global mesh."""
    out = os.path.join(args.work, name)
    t0 = time.perf_counter()
    report = separate(args.corpus_dir, out, args.device, args.nprocs, sp, long_cut)
    return {"wall_s": time.perf_counter() - t0, "workers": [report],
            "launches": report["launches"], "dir": out, "outputs": []}


def run_legs(args) -> dict:
    """Run the legs named in ``args.legs``; raise on the first failure.
    The report: each leg's wall, summed launches, workers' reports and
    journal lines."""
    n, total = args.nprocs, len(corpus_of(args.device).seconds)
    paths = make_corpus(args.corpus_dir, corpus_of(args.device))
    report = {"nprocs": n, "device": args.device, "tracks": len(paths), "legs": {}}
    legs = report["legs"]
    want = {"done": 0, "processed": total}
    if {"run", "resume"} & set(args.legs):
        legs["golden"] = _golden(args, "golden", 2, True)
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
        procs = _spawn([_worker_cmd(args, i, port, out, hold_last=True)
                        for i in range(n)])
        journal = os.path.join(out, "progress.jsonl")
        deadline = time.monotonic() + args.timeout
        try:
            # the first batch is n tracks; the fleet holds the last track,
            # so it cannot journal past the batch before the kill
            while len(_journal(out) if os.path.exists(journal) else []) < n:
                if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
                    raise RuntimeError("resume: the fleet ended or stalled before its first "
                                       "batch was journaled")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.kill(p.pid, signal.SIGKILL)
            for p in procs:
                p.communicate()
        done = len(_journal(out))
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
        legs["cli_golden"] = _golden(args, "cli_golden", 1, False)
        out = os.path.join(args.work, "cli")
        port = free_port()
        leg = legs["cli"] = _fleet(args, [_cli_cmd(args, i, port, out) for i in range(n)], "cli")
        lines = [json.loads(line) for o in leg["outputs"] for line in o.splitlines()
                 if '"metric": "corpus_tracks"' in line]
        if lines != [{"metric": "corpus_tracks", **want}] * n:
            raise AssertionError(f"cli: last lines {lines}")
        _same(stems(out), stems(legs["cli_golden"]["dir"]), "cli")
        leg["journal"] = _journal(out)
    for leg in legs.values():
        del leg["outputs"]
    return report


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--legs", default="run,resume,cli",
                    help="comma-separated: run, resume, cli")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a leg (and a collective) may take")
    ap.add_argument("--keep", default="", metavar="DIR",
                    help="work under DIR and keep it (default: a temporary directory)")
    # a worker's own arguments (set by the orchestrator)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--proc-id", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--dp", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--sp", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--corpus-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--long-cut", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--hold-last", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.nprocs < 2:
        ap.error("--nprocs must be 2 or more")
    args.legs = [leg for leg in args.legs.split(",") if leg]
    return args


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
        gathers = ", ".join(f"{w['gather_s']:.3f}" for w in leg["workers"])
        print(f"multihost_smoke {name}: {leg['wall_s']:.2f} s in all; workers' walls [{walls}] "
              f"s, their gathers [{gathers}] s; launches {leg['launches']}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
