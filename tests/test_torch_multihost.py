"""The port's multi-process paths (zen_tpu_torch/parallel/mesh.py,
multihost.py, the multi-process branches of sharded.py, corpus.py and
``MultiStreamHPR(mesh=)``, and ``zen-torch corpus --nprocs``) in real
processes on the CPU, against zen_tpu.

Each fleet is N python processes in one ``torch.distributed`` gloo group on
localhost (a port from a socket bound to port 0), each with a timeout.
Classes, each with its reason:
* ``_split_dcn``, the meshes' owners, default_mesh, the refusals, journal
  lines, mesh lines and result counts: equal to zen_tpu's (or to what its
  create_hybrid_device_mesh lays out);
* every N-process run (the corpus of ``tools/multihost_smoke.py --device
  cpu``, in test_torch_multihost_corpus.py, the sp rings cut across
  processes, tp rings cut across them, the fleet) against the port's
  single-process run of the same global mesh:
  byte for byte, the halos and sums carrying the very bits one process
  moves between its shards;
* those runs against zen_tpu in one process on its forced-device CPU mesh
  of the same global shape: 5e-5 x max(1, max|ref|) per stem for dp x sp,
  the blocked scan, the corpus and the fleet (tests/test_torch_corpus.py's
  class: only the FFTs round differently); 2e-4 x scale for tp
  (tests/test_parallel.py's: partial-DFT matmuls against an FFT);
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

import zen_tpu as J  # noqa: E402
from zen_tpu.parallel import mesh as jmesh  # noqa: E402
from zen_tpu.parallel import sharded as jsh  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
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
TP_RTOL = 2e-4
STEMS = ("harmonic", "percussive", "residual")
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
out["local"] = [[mesh.owner(dp=i, sp=j) == rank for j in range(2)] for i in range(n)]
out["first"] = m.make_mesh({"dp": n, "sp": 2}, devices=["cpu", "meta"]).first.type
out["wide"] = m.make_mesh({"dp": 2 * n, "sp": 3}, device="cpu").processes.tolist()
out["default"] = [m.default_mesh(hint, device="cpu").shape for hint in (0, 1, n, 5 * n)]
out["cut"] = [m.make_mesh(axes, device="cpu").processes.tolist()
              for axes in ({"dp": 1, "sp": 2 * n}, {"sp": n}, {"tp": n})]
out["refused"] = refusal(lambda: m.make_mesh({"dp": n + 1}, device="cpu"))
out["count_refused"] = refusal(lambda: m.make_mesh({"dp": n, "sp": 2}, devices=["cpu"]))
out["gathered"] = multihost.allgather(torch.full((1, 2), float(rank))).tolist()
out["agreed"] = multihost.agree(7, "seven")
out["disagreed"] = refusal(lambda: multihost.agree(rank, "the rank"))
cfg = T.HPRIOffline(1000, 16, 8, device="cpu").cfg_h
tp = m.make_mesh({"dp": n, "tp": 2}, device="cpu")
from zen_tpu_torch.parallel.sharded import tp_separate
stems = tp_separate(np.zeros(256, np.float32), cfg, tp)
out["tp_ran"] = {k: list(v.shape) for k, v in stems.items()}
fleet = T.MultiStreamHPR(2 * n, 1000, 16, device="cpu", mesh=tp)
out["fleet_slots"] = [fleet.slots.start, fleet.slots.stop, len(fleet.shards)]
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
# the corpus command on one track without --mesh: default_mesh(1), one sp
# ring across the processes; the command leaves the group at its end
import contextlib, io
from zen_tpu_torch.cli import main
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    out["cli_rc"] = main(["corpus", "-i", tracks[0], "-o", out_dir + "_cli", "--hps", "256", "2.0",
                          "64", "2.0", "--device", "cpu", "--nprocs", str(n), "--coordinator",
                          f"127.0.0.1:{port}", "--proc-id", str(rank)])
out["cli_lines"] = printed.getvalue().splitlines()
print(json.dumps(out))
"""


def _zen_tpu_default_shapes(n, hints, monkeypatch) -> list:
    """zen_tpu's default_mesh shapes over n devices (a run of n processes
    of one device each sees n)."""
    devices = jmesh.jax.devices()[:n]
    with monkeypatch.context() as mp:
        mp.setattr(jmesh.jax, "devices", lambda: devices)
        return [dict(zip(jm.axis_names, jm.devices.shape))
                for jm in (jmesh.default_mesh(h) for h in hints)]


@pytest.mark.parametrize("n", [2, 3])
def test_meshes_over_processes(n, tmp_path, monkeypatch):
    """make_mesh and default_mesh in an n-process gloo group on the CPU:
    the leading axes take the process split in rank order (each process's
    block contiguous, as create_hybrid_device_mesh lays it): dp where it
    can, else sp or tp, whose rings then cross processes; default_mesh is
    zen_tpu's over n devices; the exchanges gather in rank order and
    refuse a disagreement on every process; tp and MultiStreamHPR run on
    a dp x tp mesh whose split dp takes (each process its own row), and
    the corpus's pp refuses a mesh across processes. At sp = 1 the
    lowered threshold routes both tracks of a two-track corpus long:
    process 0 computes each, the others count it, and the stems
    byte-match one process's run of the dp = n x 1 mesh."""
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
        assert out["default"] == _zen_tpu_default_shapes(n, (0, 1, n, 5 * n), monkeypatch)
        assert out["default"] == [{"dp": 1, "sp": n}] * 2 + [{"dp": n, "sp": 1}] * 2
        assert out["cut"] == [[[i // 2 for i in range(2 * n)]], list(range(n)), list(range(n))]
        assert out["refused"] == f"process count {n} does not factor into mesh axes ({n + 1},)"
        assert out["count_refused"] == (f"mesh axes {{'dp': {n}, 'sp': 2}} need 2 devices in "
                                        f"each of {n} processes, got 1")
        assert out["gathered"] == [[float(r)] * 2 for r in range(n)]
        assert out["agreed"] == 7
        assert out["disagreed"] == ("the rank: disagreement across processes (per process: "
                                    f"{list(range(n))})")
        assert out["tp_ran"] == {k: [256] for k in STEMS}
        assert out["fleet_slots"] == [2 * rank, 2 * rank + 2, 1]
        assert out["pp_refused"] == "corpus pp mode is single-host; pods should use dp/sp meshes"
        assert out["corpus"] == {"done": 0, "processed": 2}
        assert out["cli_rc"] == 0
        assert out["cli_lines"] == [
            f"corpus: 1 tracks, mesh {_zen_tpu_default_shapes(n, (1,), monkeypatch)[0]}, "
            f"out={tmp_path / 'out'}_cli",
            json.dumps({"metric": "corpus_tracks", "done": 0, "processed": 1})]


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


# ---------------- rings and fleets across processes ----------------

RINGS = PRELUDE + """
from zen_tpu_torch.parallel import sharded as sh
data = np.load(sys.argv[4])
ckpt = sys.argv[5]
audio, mono, lengths = data["audio"], data["mono"], data["lengths"].tolist()
sep = T.HPRIOffline(1000, 16, 8, device="cpu")
STEMS = ("harmonic", "percussive", "residual")

def hexed(xs):
    return [x.numpy().tobytes().hex() for x in xs]

multihost.reset_traffic()
mesh = m.make_mesh({"dp": 1, "sp": n}, device="cpu")
out = {"owners": mesh.processes.tolist()}
out["separate"] = hexed(sh.sharded_separate(audio, sep.cfg_h, mesh).values())
out["hpri"] = hexed(sh.sharded_hpri_offline(audio, sep.cfg_h, sep.cfg_p, mesh, lengths=lengths))
stems, masks = sh.sharded_pass_masks(audio, sep.cfg_h, mesh)
out["masks"] = hexed([*stems.values(), *masks])
out["blocked"] = hexed(sh.sharded_hpri_blocked(mono, sep.cfg_h, sep.cfg_p, mesh, block_frames_h=16,
                                               block_frames_p=32))
segments = []
res = sh.sharded_separate_blocked_checkpointed(mono, sep.cfg_h, mesh, block_frames=16,
                                               ckpt_dir=ckpt, tag="t", ckpt_every_blocks=1,
                                               on_segment=lambda b, nbl: segments.append(b))
out["resumed"] = {"segments": segments, "stems": hexed(res[k] for k in STEMS)}
out["traffic"] = {k: dict(v) for k, v in multihost.traffic.items()}
fleet = T.MultiStreamHPR(6, 1000, 8, device="cpu", mesh=m.make_mesh({"dp": n}, device="cpu"))
per = 6 // n
rows = [fleet.process_block(data["blocks"][0])]
fleet.reset_streams([per - 1, per])  # across the split
rows.append(fleet.process_block(data["blocks"][1]))
out["fleet"] = {"slots": list(fleet.slots), "rows": hexed(rows)}
if n == 2:
    tsep = T.HPRIOffline(8000.0, 64, 16, fast_rfft=False, device="cpu")
    out["tp"] = [hexed(sh.tp_hpri_offline(data["tp_audio"], tsep.cfg_h, tsep.cfg_p,
                                          m.make_mesh(axes, device="cpu")))
                 for axes in ({"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2})]
print(json.dumps(out))
"""
TP_MESHES = ({"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2})
_RINGS: dict = {}


def _unhex(hexed: list, like: list) -> list:
    return [np.frombuffer(bytes.fromhex(h), np.float32).reshape(tuple(x.shape))
            for h, x in zip(hexed, like)]


def _rings_data(seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 600)) * 0.5).astype(np.float32)
    audio[1, 410:] = 0.0
    return {"audio": audio, "lengths": np.array([600, 410]),
            "mono": (rng.standard_normal(3000) * 0.5).astype(np.float32),
            "blocks": (rng.standard_normal((2, 6, 5, 8)) * 0.5).astype(np.float32),
            "tp_audio": (rng.standard_normal(4000) * 0.5).astype(np.float32)}


def _rings(n: int, tmp_path_factory) -> tuple:
    """(the inputs, each process's report) of the RINGS fleet of n
    processes, run once per n: its checkpointed scan resumes from a
    checkpoint one process left after the first segment."""
    if n not in _RINGS:
        work = tmp_path_factory.mktemp(f"rings{n}")
        data = _rings_data()
        np.savez(work / "data.npz", **data)
        cfg = T.HPRIOffline(1000, 16, 8, device="cpu").cfg_h

        class Killed(Exception):
            pass

        def kill(b, nbl):
            raise Killed

        with pytest.raises(Killed):
            tsh.sharded_separate_blocked_checkpointed(
                data["mono"], cfg, tmesh.make_mesh({"dp": 1, "sp": n}, device="cpu"),
                block_frames=16, ckpt_dir=str(work / "ckpt"), tag="t", ckpt_every_blocks=1,
                on_segment=kill)
        _RINGS[n] = data, _fleet(RINGS, n, work / "data.npz", work / "ckpt")
    return _RINGS[n]


def _scaled_close(got, want, what):
    """Within 5e-5 x max(1, max|want|)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("n", [2, 3])
def test_sp_rings_over_processes_match_one_process_and_zen_tpu(n, tmp_path_factory):
    """{"dp": 1, "sp": n} over n processes, one sp shard each, so every
    halo of every pass crosses a process: sharded_separate,
    sharded_hpri_offline(lengths=), sharded_pass_masks, the two-pass
    blocked scan and the checkpointed scan resumed after its first durable
    segment, each bitwise to one process's run of the same global mesh on
    every process, and within 5e-5 x max(1, max|ref|) of zen_tpu's sharded
    drivers on its forced-device CPU mesh of the same shape."""
    data, outs = _rings(n, tmp_path_factory)
    audio, mono, lengths = data["audio"], data["mono"], data["lengths"].tolist()
    sep = T.HPRIOffline(1000, 16, 8, device="cpu")
    jsep = J.HPRIOffline(1000, 16, 8, 2.0, 2.0, median_impl="xla", fft_impl="xla")
    mesh = tmesh.make_mesh({"dp": 1, "sp": n}, device="cpu")
    jm = jmesh.make_mesh({"dp": 1, "sp": n})
    stems, masks = tsh.sharded_pass_masks(audio, sep.cfg_h, mesh)
    want = {
        "separate": list(tsh.sharded_separate(audio, sep.cfg_h, mesh).values()),
        "hpri": list(tsh.sharded_hpri_offline(audio, sep.cfg_h, sep.cfg_p, mesh,
                                              lengths=lengths)),
        "masks": [*stems.values(), *masks],
        "blocked": list(tsh.sharded_hpri_blocked(mono, sep.cfg_h, sep.cfg_p, mesh,
                                                 block_frames_h=16, block_frames_p=32)),
    }
    blocked1 = tsh.sharded_separate_blocked(mono, sep.cfg_h, mesh, block_frames=16)
    want["resumed"] = [blocked1[k] for k in STEMS]
    ref = {
        "separate": [jsh.sharded_separate(audio, jsep.cfg_h, jm)[k] for k in STEMS],
        "hpri": jsh.sharded_hpri_offline(audio, jsep.cfg_h, jsep.cfg_p, jm, lengths=lengths),
        "blocked": jsh.sharded_hpri_blocked(mono, jsep.cfg_h, jsep.cfg_p, jm,
                                            block_frames_h=16, block_frames_p=32),
    }
    ref["resumed"] = [jsh.sharded_separate_blocked(mono, jsep.cfg_h, jm, block_frames=16)[k]
                      for k in STEMS]
    _, nbl = tsh._sharded_blocking(len(mono), sep.cfg_h, 16, n)
    for rank, out in enumerate(outs):
        assert out["owners"] == [list(range(n))]
        assert out["resumed"]["segments"] == list(range(2, nbl + 1))
        assert out["traffic"]["halo"]["bytes"] > 0 and out["traffic"]["gather"]["bytes"] > 0
        for key, tensors in want.items():
            got = out[key]["stems"] if key == "resumed" else out[key]
            for i, (g, w) in enumerate(zip(_unhex(got, tensors), tensors)):
                assert g.tobytes() == w.numpy().tobytes(), (rank, key, i)
                if key in ref:
                    _scaled_close(g, np.asarray(ref[key][i]), f"{key} {i} vs zen_tpu")


@pytest.mark.parametrize("n", [2, 3])
def test_fleet_over_processes_matches_one_process_and_zen_tpu(n, tmp_path_factory):
    """MultiStreamHPR(6 streams, mesh={"dp": n}) over n processes: each
    process steps its own rows (``slots``), bitwise to those rows of one
    process's fleet over the same global mesh, before and after a
    reset_streams whose slots straddle two processes; and within 5e-5 x
    scale of zen_tpu's fleet sharded over make_mesh({"dp": n})."""
    data, outs = _rings(n, tmp_path_factory)
    one = T.MultiStreamHPR(6, 1000, 8, mesh=tmesh.make_mesh({"dp": n}, device="cpu"))
    jms = J.MultiStreamHPR(6, 1000, 8, mesh=jmesh.make_mesh({"dp": n}), median_impl="xla",
                           fft_impl="xla")
    per = 6 // n
    want, ref = [], []
    for i, blk in enumerate(data["blocks"]):
        if i == 1:
            one.reset_streams([per - 1, per])
            jms.reset_streams([per - 1, per])
        want.append(one.process_block(blk))
        ref.append(np.asarray(jms.process_block(blk)))
    for rank, out in enumerate(outs):
        slots = list(range(rank * per, (rank + 1) * per))
        assert out["fleet"]["slots"] == slots
        rows = [w[slots[0] : slots[-1] + 1] for w in want]
        for step, (g, w, r) in enumerate(zip(_unhex(out["fleet"]["rows"], rows), rows, ref)):
            assert g.tobytes() == w.numpy().tobytes(), (rank, step)
            _scaled_close(g, r[slots[0] : slots[-1] + 1], f"process {rank} step {step}")


def test_tp_rings_over_processes_match_one_process_and_zen_tpu(tmp_path_factory):
    """tp_hpri_offline over 2 processes at {"tp": 2} (a shard each: both
    ring edges cut), {"tp": 4} (two shards each, two cut edges) and
    {"dp": 2, "tp": 2} (each process its own row's ring, no exchange):
    on every process bitwise to one process's run of the same global
    mesh (the halos and the ordered sum of the partial inverses), and
    within 2e-4 x scale of zen_tpu's tp_hpri_offline
    (tests/test_parallel.py's class)."""
    data, outs = _rings(2, tmp_path_factory)
    tsep = T.HPRIOffline(8000.0, 64, 16, fast_rfft=False, device="cpu")
    jsep = J.HPRIOffline(8000.0, 64, 16, 2.0, 2.0, median_impl="xla", fft_impl="xla")
    jcfgs = [dataclasses.replace(c, fast_rfft=False) for c in (jsep.cfg_h, jsep.cfg_p)]
    for j, axes in enumerate(TP_MESHES):
        want = tsh.tp_hpri_offline(data["tp_audio"], tsep.cfg_h, tsep.cfg_p,
                                   tmesh.make_mesh(axes, device="cpu"))
        ref = jsh.tp_hpri_offline(data["tp_audio"], *jcfgs, jmesh.make_mesh(axes))
        for rank, out in enumerate(outs):
            for i, (g, w, r) in enumerate(zip(_unhex(out["tp"][j], want), want, ref)):
                assert g.tobytes() == w.numpy().tobytes(), (axes, rank, i)
                r = np.asarray(r)
                scale = max(np.abs(r).max(), 1e-3)
                np.testing.assert_allclose(g, r, rtol=TP_RTOL, atol=TP_RTOL * scale,
                                           err_msg=f"{axes} stem {i} vs zen_tpu")


def _journal(out_dir) -> list:
    with open(Path(out_dir) / "progress.jsonl") as fh:
        return [json.loads(line) for line in fh if line.strip()]


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
