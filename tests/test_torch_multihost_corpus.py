"""The port's corpus across processes (``zen-torch corpus --nprocs``, through
``tools/multihost_smoke.py --device cpu``) against one process and
zen_tpu: the corpus tests of test_torch_multihost.py, in a file of their
own so that the test workers share that file's time; its classes and
helpers (the module note there) hold here.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu.io.audio as jaudio  # noqa: E402
from test_torch_multihost import CPU, FLEET_TIMEOUT, ROOT, _journal, _scaled_close  # noqa: E402
from zen_tpu.drivers import corpus as jcorpus  # noqa: E402
from zen_tpu.drivers import offline as joff  # noqa: E402
from zen_tpu.parallel import mesh as jmesh  # noqa: E402
import zen_tpu_torch.io.audio as taudio  # noqa: E402
from zen_tpu_torch.drivers import corpus as tcorpus  # noqa: E402
from zen_tpu_torch.drivers import offline as toff  # noqa: E402
from zen_tpu_torch.io.audio import peak_normalize, write_audio_pcm16  # noqa: E402
from zen_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from zen_tpu_torch.tools import multihost_smoke as smoke  # noqa: E402

pytestmark = pytest.mark.multihost


# ---------------- the corpus: tools/multihost_smoke.py ----------------


def _smoke(work: Path, n: int, legs: str) -> dict:
    proc = subprocess.run([sys.executable, "-m", smoke.MODULE, "--device", "cpu", "--nprocs",
                           str(n), "--legs", legs, "--keep", str(work),
                           "--timeout", str(FLEET_TIMEOUT)],
                          cwd=ROOT, capture_output=True, text=True, timeout=4 * FLEET_TIMEOUT)
    assert proc.returncode == 0, f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    return json.loads(proc.stdout.splitlines()[-1])


def _port_corpus(paths, out_dir, n, monkeypatch, sp=2) -> tuple:
    """The port's corpus in this process over the CPU mesh dp = n x sp, the
    long track routed as the smoke's workers route it: (results, {stem file
    name: raw stem}); the stems also written as the default writer would."""
    monkeypatch.setattr(toff, "LONG_TRACK_SAMPLES", smoke.long_cut(CPU, sp))
    monkeypatch.setattr(taudio, "peak_normalize", lambda x: x)
    raw = {}

    def writer(path, fs, a):
        raw[os.path.basename(path)] = np.array(a, np.float32)
        write_audio_pcm16(path, fs, peak_normalize(np.asarray(a)))

    res = tcorpus.separate_corpus(paths, str(out_dir), tmesh.make_mesh({"dp": n, "sp": sp},
                                                                       device="cpu"),
                                  hop_h=CPU.hop_h, hop_p=CPU.hop_p, writer=writer)
    monkeypatch.undo()
    return res, raw


def _zen_tpu_corpus(paths, out_dir, n, monkeypatch, sp=2) -> tuple:
    monkeypatch.setattr(joff, "LONG_TRACK_SAMPLES", smoke.long_cut(CPU, sp))
    monkeypatch.setattr(jaudio, "peak_normalize", lambda x: x)
    raw = {}
    res = jcorpus.separate_corpus(
        paths, str(out_dir), jmesh.make_mesh({"dp": n, "sp": sp}), hop_h=CPU.hop_h,
        hop_p=CPU.hop_p, writer=lambda p, fs, a: raw.__setitem__(os.path.basename(p),
                                                                  np.array(a, np.float32)))
    monkeypatch.undo()
    return res, raw


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
    _raw_close(raw_t, raw_j)
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


def _raw_close(got: dict, want: dict) -> None:
    """Every raw stem of a corpus run within the class of zen_tpu's."""
    assert got.keys() == want.keys() and len(got) == 15
    for name, w in want.items():
        _scaled_close(got[name], w, name)


def test_corpus_sp_ring_over_processes_matches_one_process_and_zen_tpu(tmp_path, monkeypatch):
    """The smoke's sp leg: `zen-torch corpus --nprocs 2 --mesh sp=2` (one sp
    ring, a shard in each process; the last track routed long, so the
    blocked scan's ring is cut too), then killed before the long track's
    pass 2 and resumed from its pass-1 checkpoint, each byte for byte
    against the golden single-process run of the same global mesh; that
    run against the port's in this process (byte for byte) and zen_tpu's
    corpus on {"dp": 1, "sp": 2} (the class); the printed mesh line,
    journal lines and counts equal zen_tpu's."""
    report = _smoke(tmp_path, 2, "sp,sp_resume")
    paths = sorted(str(p) for p in (tmp_path / "corpus").glob("*.wav"))
    _, raw_t = _port_corpus(paths, tmp_path / "here", 1, monkeypatch, sp=2)
    assert smoke.stems(tmp_path / "here") == smoke.stems(tmp_path / "sp_golden")
    res_j, raw_j = _zen_tpu_corpus(paths, tmp_path / "jax", 1, monkeypatch, sp=2)
    assert res_j == {"done": 0, "processed": 5}
    _raw_close(raw_t, raw_j)
    legs = report["legs"]
    jm = jmesh.make_mesh({"sp": 2, "dp": 1})  # the CLI's --mesh sp=2
    line = (f"corpus: 5 tracks, mesh {dict(zip(jm.axis_names, jm.devices.shape))}, "
            f"out={tmp_path / 'sp'}")
    assert legs["sp"]["mesh_lines"] == [line] * 2
    journal = _journal(tmp_path / "jax")
    assert legs["sp"]["journal"] == legs["sp_resume"]["journal"] == journal
    assert legs["sp_resume"]["done_before"] == 3
    for name in ("sp", "sp_resume"):
        assert all(w["traffic"]["halo"]["bytes"] > 0 for w in legs[name]["workers"]), name
