"""The port's ``--mesh`` surfaces (zen_tpu_torch/cli.py: ``offline --mesh
tp=N``, ``stream --mesh dp=N``, ``corpus --mesh dp=..,sp=..``) on the CPU
(``--device cpu``, the CPU repeated for every shard), against ``python
-m zen_tpu.cli`` with the same mesh on XLA's forced 8-device CPU host
(tests/conftest.py's flag is kept here).

Classes, each with its reason:
* the port's command against the port's library on the same input:
  bitwise (the same arithmetic, then the same writer);
* against zen_tpu: stems within ``pcm16_bound`` (tests/test_torch_offline_
  cli.py's derivation) of the raw-stem class, 2e-4 x scale for TP
  (tests/test_parallel.py's) and 5e-5 for dp x sp; the stream's samples
  within 5e-5 x max(1, max|ref|) per stream;
* refusals: zen_tpu's exit code and stderr line, case for case.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.cli import main  # noqa: E402
from zen_tpu_torch.io.audio import peak_normalize, read_audio_mono, write_audio_pcm16  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HPS = ["--hps", "64", "2.0", "16", "2.0"]
STEMS = ("harm", "perc", "residual")
STREAM = ["stream", "--fs", "4000", "--hop", "16", "--block-hops", "8"]
# runs the port's CLI in-process and fails if it pulled in JAX
NO_JAX = (
    "import sys; from zen_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
    "assert 'jax' not in sys.modules and 'zen_tpu' not in sys.modules, "
    "'the port CLI imported jax'; sys.exit(rc)"
)
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


def _env():
    return dict(os.environ, ZEN_TPU_PLATFORM="cpu")


def _port(*args, data=None):
    return subprocess.run([sys.executable, "-c", NO_JAX, *map(str, args)], input=data,
                          capture_output=True, cwd=ROOT, timeout=300)


def _jax(*args, data=None):
    return subprocess.run([sys.executable, "-m", "zen_tpu.cli", *map(str, args)], input=data,
                          capture_output=True, cwd=ROOT, timeout=300, env=_env())


def _in_process(*args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in args])
    return rc, out.getvalue(), err.getvalue()


def _ok(proc) -> str:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.decode()


def pcm16_bound(stem: np.ndarray, eps: float) -> int:
    """tests/test_torch_offline_cli.py's bound at raw-stem class ``eps``:
    through peak normalization and PCM16 rounding, in levels."""
    peak = float(np.abs(stem).max())
    scale = max(1.0, peak) * (1 + eps)
    return math.floor(32767 * 2 * eps * scale / (peak - eps * scale)) + 1


def _levels(path) -> np.ndarray:
    return np.round(read_audio_mono(str(path))[1].astype(np.float64) * 32768).astype(np.int64)


def _echo(stdout: str) -> list:
    """The echo lines, without those that name the compute or carry a
    time or the output."""
    return [ln for ln in stdout.splitlines()
            if not ln.startswith(("{", "\toutfile")) and "compute:" not in ln and "took" not in ln]


@pytest.fixture(scope="module")
def mix(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    for name, fs, seconds, seed in (("mix", 4000, "1.5", 0), ("t0", 4000, "1.2", 1),
                                    ("t1", 4000, "1.0", 2), ("t2", 3000, "1.1", 3)):
        rc, _, err = _in_process("synth", "-o", d / f"{name}.wav", "--fs", fs,
                                 "--seconds", seconds, "--seed", seed)
        assert rc == 0, err
    (d / "tracks").mkdir()
    for name in ("t0", "t1", "t2"):
        (d / f"{name}.wav").rename(d / "tracks" / f"{name}.wav")
    return d


def test_offline_mesh_tp_matches_the_library_and_zen_tpu(mix):
    """``offline --mesh tp=2``: zen_tpu's echo block with its mesh line;
    stems equal to the writer over tp_hpri_offline on the same file, and
    within the TP class of zen_tpu's ``--mesh tp=2`` stems."""
    wav = mix / "mix.wav"
    got = _ok(_port("offline", "-i", wav, *HPS, "--mesh", "tp=2", "-o", mix / "port",
                    "--device", "cpu"))
    want = _ok(_jax("offline", "-i", wav, *HPS, "--mesh", "tp=2", "-o", mix / "jax"))
    assert "\tmesh: tp=2 (frequency-sharded)" in got.splitlines()
    assert _echo(got) == _echo(want)
    fs, audio = read_audio_mono(str(wav))
    sep = T.HPRIOffline(fs, 64, 16, 2.0, 2.0, device="cpu")
    stems = T.tp_hpri_offline(audio, sep.cfg_h, sep.cfg_p,
                              T.make_mesh({"tp": 2}, device="cpu"))
    for name, stem in zip(STEMS, stems):
        write_audio_pcm16(str(mix / "ref.wav"), fs, peak_normalize(stem.numpy()))
        assert (mix / f"port_{name}.wav").read_bytes() == (mix / "ref.wav").read_bytes(), name
        g, w = _levels(mix / f"port_{name}.wav"), _levels(mix / f"jax_{name}.wav")
        assert np.abs(g - w).max() <= pcm16_bound(stem.numpy(), 2e-4), name


def test_stream_mesh_dp_matches_unsharded_and_zen_tpu():
    """``stream --streams 4 --mesh dp=2``: the same bytes as the unsharded
    ``--streams 4`` (a shard's step is the fleet's on its rows); zen_tpu's
    ``--mesh dp=2`` within the class per stream; the serving line's mesh
    reads dp=2 in both."""
    rng = np.random.default_rng(5)
    n = 4 * 8 * 16 + 40
    streams = (0.5 * rng.standard_normal((4, n))).astype(np.float32)
    data = np.ascontiguousarray(streams.T).tobytes()
    sharded = _port(*STREAM, "--streams", "4", "--mesh", "dp=2", "--device", "cpu", data=data)
    plain = _port(*STREAM, "--streams", "4", "--device", "cpu", data=data)
    ref = _jax(*STREAM, "--streams", "4", "--mesh", "dp=2", data=data)
    for proc in (sharded, plain, ref):
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert sharded.stdout == plain.stdout and len(sharded.stdout) == 4 * n * 4

    def serving(proc):
        lines = [ln for ln in proc.stderr.decode().splitlines() if ln.startswith("{")]
        return json.loads(lines[-1])

    assert serving(sharded)["mesh"] == serving(ref)["mesh"] == "dp=2"
    assert serving(plain)["mesh"] == "single-chip"
    got = np.frombuffer(sharded.stdout, np.float32).reshape(-1, 4).T
    want = np.frombuffer(ref.stdout, np.float32).reshape(-1, 4).T
    for i in range(4):
        scale = max(1.0, float(np.abs(want[i]).max()))
        np.testing.assert_allclose(got[i] / scale, want[i] / scale, rtol=0, atol=5e-5,
                                   err_msg=str(i))


def test_corpus_mesh_dp_sp_matches_zen_tpu(mix, tmp_path):
    """``corpus --mesh dp=2,sp=2`` on three tracks (two rates): zen_tpu's
    stdout lines but the directory (the mesh line reads {'dp': 2, 'sp':
    2}), its file names and journal, stems within pcm16_bound of zen_tpu's
    and equal to the port's unsharded corpus's."""
    glob = str(mix / "tracks" / "t*.wav")
    want = _ok(_jax("corpus", "-i", glob, "-o", tmp_path / "jax", *HPS, "--mesh", "dp=2,sp=2"))
    want = [ln for ln in want.splitlines() if ln.startswith(("corpus:", "{"))]
    rc, got, err = _in_process("corpus", "-i", glob, "-o", tmp_path / "port", *HPS,
                               "--mesh", "dp=2,sp=2", "--device", "cpu")
    assert rc == 0, err
    assert got.splitlines()[0].startswith("corpus: 3 tracks, mesh {'dp': 2, 'sp': 2}, out=")
    assert got.splitlines() == [ln.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                                for ln in want]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert (tmp_path / "port" / "progress.jsonl").read_text() == (
        tmp_path / "jax" / "progress.jsonl").read_text()
    rc, _, err = _in_process("corpus", "-i", glob, "-o", tmp_path / "one", *HPS,
                             "--mesh", "dp=1", "--device", "cpu")
    assert rc == 0, err
    for name in sorted(os.listdir(tmp_path / "port")):
        if name.endswith(".wav"):
            g = _levels(tmp_path / "port" / name)
            assert np.array_equal(g, _levels(tmp_path / "one" / name)), name
            w = _levels(tmp_path / "jax" / name)
            assert np.abs(g - w).max() <= pcm16_bound(w / 32768.0, 5e-5), name


REFUSALS = [
    # offline: on a real file with --hps, where zen_tpu checks the mesh
    (["offline", "-i", "{wav}", *HPS, "--mesh", "tp"], 2,
     "zen offline: bad mesh axis 'tp' (want name=N)"),
    (["offline", "-i", "{wav}", *HPS, "--mesh", "dp=2"], 2,
     "zen offline: mesh supports the tp axis only (got ['dp'])"),
    (["offline", "-i", "{wav}", *HPS, "--mesh", "tp=2", "--nocopybord"], 2,
     "zen offline: --mesh tp requires the wrap border (drop --nocopybord): the sharded "
     "frequency-median halo ring is circular"),
    (["offline", "-i", "{wav}", *HPS, "--mesh", "tp=3"], 2,
     "zen offline: tp=3 must divide both pass nffts (got nfft=256 at hop=64)"),
    ([*STREAM, "--mesh", "dp"], 1, "stream bad mesh axis 'dp' (want name=N)"),
    ([*STREAM, "--mesh", "sp=2"], 1, "stream mesh supports the dp axis only (got ['sp'])"),
    ([*STREAM, "--streams", "3", "--mesh", "dp=2"], 1, "--streams 3 not divisible by dp=2"),
    (["corpus", "-i", "{wav}", "-o", "{out}", "--mesh", "tp=2"], 1,
     "corpus mesh supports axes dp,sp only (got ['tp'])"),
    (["corpus", "-i", "{wav}", "-o", "{out}", "--mesh", "dp=0"], 1,
     "corpus mesh axis size must be >= 1 (got 'dp=0')"),
]


def _argv(argv, mix, tmp_path) -> list:
    return [a.format(wav=mix / "mix.wav", out=tmp_path) for a in argv]


@pytest.fixture(scope="module")
def jax_refusals(mix, tmp_path_factory):
    out = tmp_path_factory.mktemp("refusals")
    argvs = [_argv(argv, mix, out) for argv, _, _ in REFUSALS]
    proc = subprocess.run([sys.executable, "-c", JAX_REFUSALS, json.dumps(argvs)],
                          capture_output=True, text=True, cwd=ROOT, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_mesh_refusals_match_zen_tpu(mix, tmp_path, jax_refusals, case):
    argv, rc, line = REFUSALS[case]
    got_rc, _, err = _in_process(*_argv(argv, mix, tmp_path), "--device", "cpu")
    assert (got_rc, err.strip().splitlines()) == (rc, [line])
    want_rc, want_err = jax_refusals[case]
    assert (want_rc, want_err.strip().splitlines()[-1]) == (rc, line)


def test_corpus_nprocs_needs_a_coordinator(mix, tmp_path):
    """--nprocs 2 without --coordinator exits 1 with zen_tpu's one stderr
    line, before any process group is joined (tests/test_torch_multihost.py
    holds every such check against zen_tpu's CLI)."""
    rc, out, err = _in_process("corpus", "-i", mix / "mix.wav", "-o", tmp_path, "--nprocs", "2",
                               "--device", "cpu")
    assert rc == 1 and out == ""
    assert err.strip().splitlines() == ["corpus: --nprocs needs --coordinator HOST:PORT"]
    assert not torch.distributed.is_initialized()


def test_mesh_wider_than_the_cards_raises_without_fallback(mix, tmp_path):
    """A card mesh needs its cards: here (no CUDA device) each command
    refuses --device cuda before any mesh is made, and make_mesh on the
    card raises; on a host with too few cards make_mesh's ZenError ends
    the command (chip_smoke.py's phase 20 runs that half on the card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py holds the card's half")
    for argv in (["offline", "-i", mix / "mix.wav", *HPS, "--mesh", "tp=2"],
                 [*STREAM, "--streams", "2", "--mesh", "dp=2"],
                 ["corpus", "-i", mix / "mix.wav", "-o", tmp_path, "--mesh", "dp=2"]):
        rc, _, err = _in_process(*argv)
        assert rc == 2 and "torch.cuda.is_available() is False" in err, argv
    with pytest.raises(T.ZenError, match="is_available"):
        T.make_mesh({"dp": 2})
