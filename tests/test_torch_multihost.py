"""The port's multi-process corpus (zen_tpu_torch/parallel/mesh.py,
multihost.py, the multi-process branches of sharded.py and corpus.py, and
``zen-torch corpus --nprocs``) in real processes on the CPU, against
zen_tpu.

Each fleet is N python processes in one ``torch.distributed`` gloo group on
localhost (a port from a socket bound to port 0), each with a timeout.
Classes, each with its reason:
* ``_split_dcn``, the meshes' owners, the refusals, journal lines and
  result counts: equal to zen_tpu's (or to what its create_hybrid_device_mesh
  guarantees: no sp ring across processes);
* the N-process corpus (``tools/multihost_smoke.py --device cpu``) against
  the port's single-process run of the same global mesh: byte for byte,
  one arithmetic on each dp row;
* that run against zen_tpu's ``separate_corpus`` in one process on its
  forced-device CPU mesh of the same global shape (dp = N x sp = 2, the
  long track included): 5e-5 x max(1, max|ref|) per stem on the raw stems
  (tests/test_torch_corpus.py's class: only the FFTs round differently);
* the checkpointed blocked scan resumed across processes, and the
  pipelined cascade given the CPU twice: bitwise to one process.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu.io.audio as jaudio  # noqa: E402
from zen_tpu.drivers import corpus as jcorpus  # noqa: E402
from zen_tpu.drivers import offline as joff  # noqa: E402
from zen_tpu.parallel import mesh as jmesh  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
import zen_tpu_torch.io.audio as taudio  # noqa: E402
from zen_tpu_torch.cli import main  # noqa: E402
from zen_tpu_torch.drivers import corpus as tcorpus  # noqa: E402
from zen_tpu_torch.drivers import offline as toff  # noqa: E402
from zen_tpu_torch.drivers import pipeline as tpipe  # noqa: E402
from zen_tpu_torch.io.audio import peak_normalize, write_audio_pcm16  # noqa: E402
from zen_tpu_torch.ops import _build  # noqa: E402
from zen_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from zen_tpu_torch.parallel import sharded as tsh  # noqa: E402
from zen_tpu_torch.tools import multihost_smoke as smoke  # noqa: E402

pytestmark = pytest.mark.multihost

ROOT = Path(__file__).resolve().parents[1]
ATOL = 5e-5
FLEET_TIMEOUT = 180  # seconds a fleet of this file may take
CPU = smoke.CORPORA["cpu"]

# ---------------- _split_dcn ----------------

SHAPES = ([(s,) for s in (1, 2, 3, 4, 6, 8)]
          + [(a, b) for a in (1, 2, 3, 4, 6) for b in (1, 2, 3, 4)]
          + [(2, 2, 2), (4, 1, 2), (3, 2, 1), (1, 4, 2), (6, 1, 1)])


def _split_or_refusal(split, sizes, n_proc):
    try:
        return split(sizes, n_proc)
    except Exception as e:  # noqa: BLE001 — both packages' refusals, compared by class name and text
        return ("refusal", type(e).__name__, str(e))


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4, 6, 8])
def test_split_dcn_matches_zen_tpu(n_proc):
    """The process split of every mesh shape of the sweep: zen_tpu's tuples,
    and its refusal where the count does not factor."""
    refused = 0
    for sizes in SHAPES:
        want = _split_or_refusal(jmesh._split_dcn, sizes, n_proc)
        assert _split_or_refusal(tmesh._split_dcn, sizes, n_proc) == want, sizes
        refused += want[0] == "refusal"
    assert refused > 0 or n_proc == 1


# ---------------- fleets ----------------


def _fleet(code: str, n: int, *args) -> list:
    """Run ``code`` in n processes (argv: rank, n, port, *args); each must
    exit 0 within FLEET_TIMEOUT and print a JSON line last: the lines."""
    port = smoke.free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n), str(port),
                               *map(str, args)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=FLEET_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{out}\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


PRELUDE = """
import datetime, json, sys
import numpy as np, torch
import zen_tpu_torch as T
from zen_tpu_torch.parallel import mesh as m, multihost
rank, n, port = map(int, sys.argv[1:4])
torch.set_num_threads(1)  # n processes of the machine's width would oversubscribe it
m.distributed_init(f"127.0.0.1:{port}", n, rank, timeout=datetime.timedelta(seconds=120))

def refusal(fn):
    try:
        fn()
    except T.ZenError as e:
        return str(e)
    return None
"""

MESHES = PRELUDE + """
out = {"count": multihost.process_count(), "index": multihost.process_index()}
mesh = m.make_mesh({"dp": n, "sp": 2}, device="cpu")
out["owners"] = mesh.processes.tolist()
out["local"] = [[mesh.is_local(dp=i, sp=j) for j in range(2)] for i in range(n)]
out["first"] = m.make_mesh({"dp": n, "sp": 2}, devices=["cpu", "meta"]).first.type
out["wide"] = m.make_mesh({"dp": 2 * n, "sp": 3}, device="cpu").processes.tolist()
out["default"] = [m.default_mesh(hint, device="cpu").shape for hint in (0, 1, n, 5 * n)]
out["refused"] = [refusal(lambda: m.make_mesh(axes, device="cpu"))
                  for axes in ({"dp": 1, "sp": 2 * n}, {"sp": n}, {"tp": n}, {"dp": n + 1})]
out["count_refused"] = refusal(lambda: m.make_mesh({"dp": n, "sp": 2}, devices=["cpu"]))
out["gathered"] = multihost.allgather(torch.full((1, 2), float(rank))).tolist()
out["agreed"] = multihost.agree(7, "seven")
out["disagreed"] = refusal(lambda: multihost.agree(rank, "the rank"))
cfg = T.HPRIOffline(1000, 16, 8, device="cpu").cfg_h
tp = m.make_mesh({"dp": n, "tp": 2}, device="cpu")
from zen_tpu_torch.parallel.sharded import tp_separate
out["tp_refused"] = refusal(lambda: tp_separate(np.zeros(256, np.float32), cfg, tp))
out["fleet_refused"] = refusal(lambda: T.MultiStreamHPR(2 * n, 1000, 16, device="cpu", mesh=tp))
import os
from zen_tpu_torch.drivers import offline
from zen_tpu_torch.drivers.corpus import separate_corpus
corpus, out_dir = sys.argv[4], sys.argv[5]
out["pp_refused"] = refusal(lambda: separate_corpus(["x.wav"], out_dir, mesh, pp=True))
# at sp = 1 a long track is one device's blocked scan: process 0's alone
offline.LONG_TRACK_SAMPLES = int(sys.argv[6])
tracks = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
sp1 = m.make_mesh({"dp": n, "sp": 1}, device="cpu")
out["corpus"] = separate_corpus(tracks, out_dir, sp1, hop_h=256, hop_p=64)
print(json.dumps(out))
"""


@pytest.mark.parametrize("n", [2, 3])
def test_meshes_over_processes(n, tmp_path, monkeypatch):
    """make_mesh and default_mesh in an n-process gloo group on the CPU:
    dp takes the process split in rank order (each process's block
    contiguous, as create_hybrid_device_mesh lays it), every sp ring inside
    one process; a split that would cut sp or tp refuses; the exchanges
    gather in rank order and refuse a disagreement on every process;
    tp, MultiStreamHPR and the corpus's pp refuse a mesh across processes.
    At sp = 1 the lowered threshold routes both tracks of a two-track
    corpus long: process 0 computes each, the others count it, and the
    stems byte-match one process's run of the dp = n x 1 mesh."""
    paths = smoke.make_corpus(str(tmp_path / "corpus"),
                              dataclasses.replace(CPU, seconds=CPU.seconds[:2]))
    outs = _fleet(MESHES, n, tmp_path / "corpus", tmp_path / "out", CPU.long_cut)
    monkeypatch.setattr(toff, "LONG_TRACK_SAMPLES", CPU.long_cut)
    res = tcorpus.separate_corpus(paths, str(tmp_path / "one"),
                                  tmesh.make_mesh({"dp": n, "sp": 1}, device="cpu"),
                                  hop_h=CPU.hop_h, hop_p=CPU.hop_p)
    assert res == {"done": 0, "processed": 2}
    assert smoke.stems(tmp_path / "out") == smoke.stems(tmp_path / "one")
    assert len(_journal(tmp_path / "out")) == 2
    owners = [[i, i] for i in range(n)]
    wide = [[i // 2] * 3 for i in range(2 * n)]
    for rank, out in enumerate(outs):
        assert (out["count"], out["index"]) == (n, rank)
        assert out["owners"] == owners and out["wide"] == wide
        assert out["local"] == [[i == rank] * 2 for i in range(n)]
        assert out["first"] == "cpu"  # this process's own first entry
        assert out["default"] == [{"dp": n, "sp": 1}] * 4
        assert all(r and "across processes" in r for r in out["refused"][:3]), out["refused"]
        assert out["refused"][3] == f"process count {n} does not factor into mesh axes ({n + 1},)"
        assert out["count_refused"] == (f"mesh axes {{'dp': {n}, 'sp': 2}} need 2 devices in "
                                        f"each of {n} processes, got 1")
        assert out["gathered"] == [[float(r)] * 2 for r in range(n)]
        assert out["agreed"] == 7
        assert out["disagreed"] == ("the rank: disagreement across processes (per process: "
                                    f"{list(range(n))})")
        assert out["tp_refused"] == "tp_separate: the mesh spans processes; tp runs in one process"
        assert out["fleet_refused"] == ("MultiStreamHPR: the mesh spans processes; a fleet runs "
                                        "in one process")
        assert out["pp_refused"] == "corpus pp mode is single-host; pods should use dp/sp meshes"
        assert out["corpus"] == {"done": 0, "processed": 2}


CHECKPOINTS = PRELUDE + """
from zen_tpu_torch.parallel.sharded import sharded_separate_blocked_checkpointed as scan
audio = np.load(sys.argv[4])
cfg = T.HPRIOffline(1000, 16, 8, device="cpu").cfg_h
mesh = m.make_mesh({"dp": n, "sp": 2}, device="cpu")
kw = dict(block_frames=16, ckpt_every_blocks=1, tag="t")
ckpt, empty = sys.argv[5], sys.argv[6]
out = {"disagree": refusal(lambda: scan(audio, cfg, mesh, ckpt_dir=ckpt if rank == 0 else empty, **kw))}
real = np.fromfile
if rank == 1:
    def unreadable(*a, **k):
        raise OSError("no such file on this host")
    np.fromfile = unreadable
out["unreadable"] = refusal(lambda: scan(audio, cfg, mesh, ckpt_dir=ckpt, **kw))
np.fromfile = real
segments = []
stems = scan(audio, cfg, mesh, ckpt_dir=ckpt, on_segment=lambda b, nbl: segments.append(b), **kw)
out["segments"] = segments
out["stems"] = [stems[k].numpy().tobytes().hex() for k in ("harmonic", "percussive", "residual")]
print(json.dumps(out))
"""


def test_checkpointed_scan_over_processes(tmp_path):
    """sharded_separate_blocked_checkpointed over a dp=2 x sp=2 mesh of two
    processes, from a checkpoint one process left after its first segment:
    the processes refuse together when their checkpoints disagree and when
    one cannot read the stems file (never taking it for zeros); on a
    shared directory both resume after the durable segment, bitwise equal
    to an uninterrupted single-process scan."""
    cfg = T.HPRIOffline(1000, 16, 8, device="cpu").cfg_h
    audio = (np.random.default_rng(3).standard_normal(1500) * 0.5).astype(np.float32)
    np.save(tmp_path / "audio.npy", audio)
    mesh = tmesh.make_mesh({"dp": 2, "sp": 2}, device="cpu")
    want = tsh.sharded_separate_blocked(audio, cfg, mesh, block_frames=16)

    class Killed(Exception):
        pass

    def kill(b, nbl):
        raise Killed

    ckpt, empty = tmp_path / "ckpt", tmp_path / "empty"
    with pytest.raises(Killed):
        tsh.sharded_separate_blocked_checkpointed(audio, cfg, mesh, block_frames=16,
                                                  ckpt_dir=str(ckpt), tag="t",
                                                  ckpt_every_blocks=1, on_segment=kill)
    _, nbl = tsh._sharded_blocking(len(audio), cfg, 16, 2)
    assert nbl >= 3
    outs = _fleet(CHECKPOINTS, 2, tmp_path / "audio.npy", ckpt, empty)
    for rank, out in enumerate(outs):
        assert out["disagree"] == (
            "mid-track checkpoint of 't', the next block (ckpt_dir must be a shared filesystem): "
            "disagreement across processes (per process: [1, 0])")
        assert out["unreadable"] == (
            f"process 1 cannot read the resumed stems buffer {str(ckpt / 't.stems.f32')!r}: "
            "ckpt_dir must be a shared filesystem" if rank else
            "mid-track checkpoint of 't', the next block (ckpt_dir must be a shared filesystem): "
            "disagreement across processes (per process: [1, -1])")
        assert out["segments"] == list(range(2, nbl + 1))
        for k, hexed in zip(("harmonic", "percussive", "residual"), out["stems"]):
            assert bytes.fromhex(hexed) == want[k].numpy().tobytes(), (rank, k)
    assert not os.path.exists(empty / "t.stems.f32")  # only process 0 writes


# ---------------- the corpus: tools/multihost_smoke.py ----------------


def _smoke(work: Path, n: int, legs: str) -> dict:
    proc = subprocess.run([sys.executable, "-m", smoke.MODULE, "--device", "cpu", "--nprocs",
                           str(n), "--legs", legs, "--keep", str(work),
                           "--timeout", str(FLEET_TIMEOUT)],
                          cwd=ROOT, capture_output=True, text=True, timeout=4 * FLEET_TIMEOUT)
    assert proc.returncode == 0, f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    return json.loads(proc.stdout.splitlines()[-1])


def _port_corpus(paths, out_dir, n, monkeypatch) -> tuple:
    """The port's corpus in this process over the CPU mesh dp = n x sp, the
    long track routed as the smoke's workers route it: (results, {stem file
    name: raw stem}); the stems also written as the default writer would."""
    monkeypatch.setattr(toff, "LONG_TRACK_SAMPLES", CPU.long_cut)
    monkeypatch.setattr(taudio, "peak_normalize", lambda x: x)
    raw = {}

    def writer(path, fs, a):
        raw[os.path.basename(path)] = np.array(a, np.float32)
        write_audio_pcm16(path, fs, peak_normalize(np.asarray(a)))

    res = tcorpus.separate_corpus(paths, str(out_dir), tmesh.make_mesh({"dp": n, "sp": 2},
                                                                       device="cpu"),
                                  hop_h=CPU.hop_h, hop_p=CPU.hop_p, writer=writer)
    monkeypatch.undo()
    return res, raw


def _zen_tpu_corpus(paths, out_dir, n, monkeypatch) -> tuple:
    monkeypatch.setattr(joff, "LONG_TRACK_SAMPLES", CPU.long_cut)
    monkeypatch.setattr(jaudio, "peak_normalize", lambda x: x)
    raw = {}
    res = jcorpus.separate_corpus(
        paths, str(out_dir), jmesh.make_mesh({"dp": n, "sp": 2}), hop_h=CPU.hop_h,
        hop_p=CPU.hop_p, writer=lambda p, fs, a: raw.__setitem__(os.path.basename(p),
                                                                  np.array(a, np.float32)))
    monkeypatch.undo()
    return res, raw


def _journal(out_dir) -> list:
    with open(Path(out_dir) / "progress.jsonl") as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.parametrize("n, legs", [(2, "run,resume,cli"), (3, "run")])
def test_corpus_over_processes_matches_one_process_and_zen_tpu(tmp_path, monkeypatch, n, legs):
    """The smoke's legs (each checks its stems byte for byte against the
    golden single-process run of the same global mesh; 2 processes also
    the SIGKILL-and-resume leg and the CLI leg), then that golden run
    against the port's run in this process (byte for byte) and that run
    against zen_tpu's corpus (the class); journal lines and every
    process's counts equal zen_tpu's."""
    report = _smoke(tmp_path, n, legs)
    paths = sorted(str(p) for p in (tmp_path / "corpus").glob("*.wav"))
    assert len(paths) == 5 and report["tracks"] == 5
    res_t, raw_t = _port_corpus(paths, tmp_path / "here", n, monkeypatch)
    assert smoke.stems(tmp_path / "here") == smoke.stems(tmp_path / "golden")
    res_j, raw_j = _zen_tpu_corpus(paths, tmp_path / "jax", n, monkeypatch)
    assert res_t == res_j == {"done": 0, "processed": 5}
    assert raw_t.keys() == raw_j.keys() and len(raw_t) == 15
    for name, want in raw_j.items():
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(raw_t[name] / scale, want / scale, rtol=0, atol=ATOL,
                                   err_msg=name)
    journal = _journal(tmp_path / "jax")
    legs_run = report["legs"]
    assert legs_run["run"]["journal"] == journal
    assert [w["results"] for w in legs_run["run"]["workers"]] == [res_j] * n
    assert all(w["owners"] == [[i] for i in range(n)] for w in legs_run["run"]["workers"])
    if "resume" in legs:
        resume = legs_run["resume"]
        assert resume["done_before"] == n  # the kill landed after the first batch
        assert [w["results"] for w in resume["workers"]] == [{"done": n, "processed": 5 - n}] * n
        assert resume["journal"] == journal
    if "cli" in legs:
        assert len(legs_run["cli"]["journal"]) == 5  # process 0 alone wrote it


# ---------------- the CLI ----------------

# zen_tpu's CLI over a JSON list of argvs in one process: [rc, stderr] each
JAX_REFUSALS = (
    "import contextlib, io, json, sys; from zen_tpu.cli import main\n"
    "out = []\n"
    "for argv in json.loads(sys.argv[1]):\n"
    "    err = io.StringIO()\n"
    "    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):\n"
    "        rc = main(argv)\n"
    "    out.append([rc, err.getvalue()])\n"
    "print(json.dumps(out))"
)
NPROCS_REFUSALS = [
    (["--coordinator", "127.0.0.1:1"], "corpus: --coordinator/--proc-id need --nprocs >= 2"),
    (["--proc-id", "1"], "corpus: --coordinator/--proc-id need --nprocs >= 2"),
    (["--nprocs", "2"], "corpus: --nprocs needs --coordinator HOST:PORT"),
    (["--nprocs", "2", "--coordinator", "127.0.0.1:1", "--proc-id", "2"],
     "corpus: --proc-id 2 outside 0..1"),
    (["--nprocs", "3", "--coordinator", "127.0.0.1:1", "--proc-id", "-1"],
     "corpus: --proc-id -1 outside 0..2"),
]


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("nprocs") / "t.wav"
    write_audio_pcm16(str(path), 1000, peak_normalize(np.ones(300, np.float32)))
    return path


@pytest.fixture(scope="module")
def jax_refusals(wav):
    argvs = [["corpus", "-i", str(wav), "-o", str(wav.parent / "out"), *extra]
             for extra, _ in NPROCS_REFUSALS]
    proc = subprocess.run([sys.executable, "-c", JAX_REFUSALS, json.dumps(argvs)],
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env=dict(os.environ, ZEN_TPU_PLATFORM="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


def _in_process(*argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", range(len(NPROCS_REFUSALS)))
def test_corpus_nprocs_refusals_match_zen_tpu(wav, jax_refusals, case):
    """Every check of --nprocs / --coordinator / --proc-id: zen_tpu's exit
    code and stderr line, before any process group is joined."""
    extra, line = NPROCS_REFUSALS[case]
    rc, _, err = _in_process("corpus", "-i", wav, "-o", wav.parent / "out", *extra,
                             "--device", "cpu")
    assert (rc, err.strip().splitlines()) == (1, [line])
    want_rc, want_err = jax_refusals[case]
    assert (want_rc, want_err.strip().splitlines()[-1]) == (1, line)


def test_corpus_bootstrap_failure_line(wav):
    """A rendezvous that fails ends the command with zen_tpu's bootstrap
    line (zen_tpu/cli.py:658-663) and exit code 1, and joins no group."""
    rc, out, err = _in_process("corpus", "-i", wav, "-o", wav.parent / "out", "--nprocs", "2",
                               "--coordinator", "127.0.0.1:notaport", "--proc-id", "0",
                               "--device", "cpu")
    assert (rc, out, err.strip().splitlines()) == (
        1, "", ["corpus: distributed bootstrap failed (process_count=1, expected 2)"])
    assert not torch.distributed.is_initialized()


# ---------------- the pipelined cascade and the kernel build ----------------


def test_pipeline_devices_twice_equals_one_device():
    """PipelinedHPRIOffline(devices=("cpu", "cpu")) takes the one-device
    path: bitwise equal to device="cpu" and to process()."""
    sep = T.HPRIOffline(1000, 16, 8, device="cpu")
    tracks = [(np.random.default_rng(s).standard_normal(300 + 16 * s) * 0.5).astype(np.float32)
              for s in range(3)]
    one = list(tpipe.PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device="cpu")
               .process_stream(tracks))
    two = tpipe.PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, devices=("cpu", "cpu"))
    assert (two.dev_a, two.dev_b) == (torch.device("cpu"),) * 2
    got = list(two.process_stream(tracks))
    for audio, a, b in zip(tracks, one, got):
        for x, y, z in zip(a, b, sep.process(audio)):
            assert torch.equal(x, y) and torch.equal(y, z)


def test_corpus_pp_hands_the_pipeline_the_mesh_devices(tmp_path, monkeypatch):
    """corpus pp=True builds its pipeline over the mesh's devices (pass 1
    on the first, pass 2 on the second), not over its first alone."""
    seen = []
    real = tpipe.PipelinedHPRIOffline.__init__

    def spy(self, cfg_h, cfg_p, device="cuda", devices=None):
        seen.append(devices)
        real(self, cfg_h, cfg_p, device=device, devices=devices)

    monkeypatch.setattr(tpipe.PipelinedHPRIOffline, "__init__", spy)
    store = {str(tmp_path / f"t{i}.wav"): (1000, np.ones(200 + i, np.float32)) for i in range(2)}
    res = tcorpus.separate_corpus(sorted(store), str(tmp_path / "out"),
                                  tmesh.make_mesh({"dp": 2, "sp": 1}, device="cpu"), hop_h=16,
                                  hop_p=8, reader=lambda p: store[p], writer=lambda *a: None,
                                  pp=True)
    assert res == {"done": 0, "processed": 2}
    assert seen == [[torch.device("cpu")] * 2]


def test_library_builds_once_when_builders_start_together(tmp_path, monkeypatch):
    """Two builders of the kernel library started together (the processes
    of a multi-process corpus) build it once: the second waits on the
    library's lock, finds it built and loads it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    builds, loaded = [], []

    def slow_build(out, flags):
        builds.append(out)
        time.sleep(0.5)
        out.write_bytes(b"built")

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    def load(path):
        loaded.append(Path(path).read_bytes())
        return Lib()

    monkeypatch.setattr(_build, "_build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", load)
    threads = [threading.Thread(target=_build.library.__wrapped__) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and loaded == [b"built"] * 2
    assert builds[0].parent == tmp_path and builds[0].with_suffix(".lock").exists()
