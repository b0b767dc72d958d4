"""The port's file commands (zen_tpu_torch/cli.py: offline, fakert, synth,
version) in subprocesses on the CPU (``--device cpu``), through a guard
that fails if the port's CLI pulled in JAX.

Held against the port's own library on the same file (stems sample for
sample: both sides are the port on the CPU, then the same writer), and
against ``python -m zen_tpu.cli`` (``ZEN_TPU_PLATFORM=cpu``): the echo
blocks line for line but the lines naming the compute, the JSON metric
lines' keys, synth's files byte for byte, and the stems within
``pcm16_bound`` of zen_tpu's.

How the stem bound is derived. The raw stems of the two packages agree
to eps * S per sample, eps = 5e-5 and S = max(1, max|x|) (the offline
parity class, tests/test_engine_parity.py:271-275; only the FFTs round
differently). Peak normalization divides each by its own peak P, and
the peaks differ by at most eps * S, so the normalized stems differ by
at most 2 * eps * S / (P - eps * S). PCM16 scales that by 32767 and each
side rounds to its nearest level, which adds at most one level.
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
from zen_tpu_torch.io.audio import (  # noqa: E402
    peak_normalize,
    read_audio_mono,
    write_audio_pcm16,
)

ROOT = Path(__file__).resolve().parents[1]
EPS = 5e-5
HPS = ["--hps", "64", "2.0", "16", "2.0"]
FAKERT_HPS = ["--hps", "32", "2.0"]
# runs the port's CLI in-process and fails if it pulled in JAX
NO_JAX = (
    "import sys; from zen_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
    "assert 'jax' not in sys.modules and 'zen_tpu' not in sys.modules, "
    "'the port CLI imported jax'; sys.exit(rc)"
)


def _port(*args):
    return subprocess.run([sys.executable, "-c", NO_JAX, *map(str, args)], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)


def _in_process(*args):
    """The same CLI called in this process (no interpreter start-up):
    (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main([str(a) for a in args])
        except SystemExit as e:  # argparse's --version
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _jax(*args):
    env = dict(os.environ, ZEN_TPU_PLATFORM="cpu")
    return subprocess.run([sys.executable, "-m", "zen_tpu.cli", *map(str, args)],
                          capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)


def _ok(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _metric(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


def _echo(stdout: str) -> list:
    """The echo lines, without those that name the compute, carry a time
    or name the output."""
    return [ln for ln in stdout.splitlines()
            if not ln.startswith(("{", "PRealtime", "\toutfile"))
            and "compute:" not in ln and "took" not in ln]


def pcm16_bound(stem: np.ndarray) -> int:
    """Largest PCM16 level difference between the two packages' written
    stems (module docstring), from the port's raw stem."""
    peak = float(np.abs(stem).max())
    scale = max(1.0, peak) * (1 + EPS)
    return math.floor(32767 * 2 * EPS * scale / (peak - EPS * scale)) + 1


def _levels(path) -> np.ndarray:
    return np.round(read_audio_mono(str(path))[1].astype(np.float64) * 32768).astype(np.int64)


@pytest.fixture(scope="module")
def mix(tmp_path_factory):
    """A 1.5 s mixture at 4 kHz from the port's synth, and zen_tpu's
    offline and fakert runs on it."""
    d = tmp_path_factory.mktemp("cli")
    _ok(_port("synth", "-o", d / "mix.wav", "--fs", "4000", "--seconds", "1.5", "--stems"))
    jax_off = _ok(_jax("offline", "-i", d / "mix.wav", *HPS, "-o", d / "jax"))
    jax_rt = _ok(_jax("fakert", "-i", d / "mix.wav", *FAKERT_HPS, "-o", d / "jax_rt.wav",
                      "--block-hops", "8"))
    return d, jax_off, jax_rt


@pytest.mark.parametrize("fmt,blocked,subproc", [("wav", False, True), ("flac", False, True),
                                                 ("wv", False, False), ("wav", True, False)])
def test_offline_stems_match_the_library_and_zen_tpu(mix, fmt, blocked, subproc):
    d, jax_off, _ = mix
    prefix = d / f"port_{fmt}_{int(blocked)}"
    args = ["offline", "-i", d / "mix.wav", *HPS, "-o", prefix, "--stem-format", fmt,
            "--device", "cpu", *(["--blocked"] if blocked else [])]
    if subproc:
        out = _ok(_port(*args))
    else:
        rc, out, err = _in_process(*args)
        assert rc == 0, err
    assert "Running zen-offline" in out and "HPR-I-Offline took" in out
    assert _echo(out) == _echo(jax_off)
    line, want_line = _metric(out), _metric(jax_off)
    assert line.keys() == want_line.keys() and line["metric"] == "offline_2pass_ms"
    assert line["audio_seconds"] == want_line["audio_seconds"] == 1.5

    fs, audio = read_audio_mono(str(d / "mix.wav"))
    sep = T.HPRIOffline(fs, 64, 16, 2.0, 2.0, device="cpu")
    stems = sep.process_blocked(audio) if blocked else sep.process(audio)
    for name, stem in zip(("harm", "perc", "residual"), stems):
        stem = stem.numpy()
        got = prefix.parent / f"{prefix.name}_{name}.{fmt}"
        ref = d / f"lib_{name}.{fmt}"
        write_audio_pcm16(str(ref), fs, peak_normalize(stem))
        np.testing.assert_array_equal(read_audio_mono(str(got))[1], read_audio_mono(str(ref))[1])
        assert got.read_bytes() == ref.read_bytes()
        diff = np.abs(_levels(got) - _levels(d / f"jax_{name}.wav")).max()
        assert diff <= pcm16_bound(stem), (name, diff, pcm16_bound(stem))


@pytest.mark.parametrize("flags,kw", [
    (["--cpu"], {"border": "replicate"}),
    (["--nocopybord", "--soft-mask"], {"border": "valid", "soft_mask": True}),
    (["--sse", "--strict-ref"], {"use_sse": True, "strict_ref": True}),
    (["--fft-impl", "dft_f32", "--median-impl", "xla"], {"fft_impl": "dft_f32",
                                                         "median_impl": "torch"}),
])
def test_offline_flags_map_to_the_separator(mix, flags, kw):
    """Each variant flag reaches HPRIOffline as zen_tpu's CLI maps it
    (--cpu is the replicate border only; 'xla' is the plain median)."""
    d, _, _ = mix
    prefix = d / f"flags_{'_'.join(f.strip('-') for f in flags)}"
    rc, _, err = _in_process("offline", "-i", d / "mix.wav", *HPS, "-o", prefix,
                             "--device", "cpu", *flags)
    assert rc == 0, err
    fs, audio = read_audio_mono(str(d / "mix.wav"))
    stems = T.HPRIOffline(fs, 64, 16, 2.0, 2.0, device="cpu", **kw).process(audio)
    for name, stem in zip(("harm", "perc", "residual"), stems):
        write_audio_pcm16(str(d / "lib_flags.wav"), fs, peak_normalize(stem.numpy()))
        assert (d / f"{prefix.name}_{name}.wav").read_bytes() == (d / "lib_flags.wav").read_bytes()


def test_offline_without_hps_writes_the_input(mix):
    d, _, _ = mix
    rc, _, err = _in_process("offline", "-i", d / "mix.wav", "-o", d / "copy",
                             "--only-percussive", "--device", "cpu")
    assert rc == 0, err
    assert sorted(p.name for p in d.glob("copy_*")) == ["copy_perc.wav"]
    write_audio_pcm16(str(d / "lib_copy.wav"), 4000,
                      peak_normalize(read_audio_mono(str(d / "mix.wav"))[1]))
    assert (d / "copy_perc.wav").read_bytes() == (d / "lib_copy.wav").read_bytes()


def test_fakert_matches_the_library_and_zen_tpu(mix):
    d, _, jax_rt = mix
    out = _ok(_port("fakert", "-i", d / "mix.wav", *FAKERT_HPS, "-o", d / "port_rt.wav",
                    "--block-hops", "8", "--device", "cpu"))
    assert "Running zen-fakert" in out and "PRealtime" in out
    assert _echo(out) == _echo(jax_rt)
    line, want_line = _metric(out), _metric(jax_rt)
    assert line.keys() == want_line.keys() and line["metric"] == "fakert_us_per_hop"
    assert (line["hop"], line["block_hops"], line["budget_us"]) == (32, 8, 8000.0)
    assert line["rtf"] == pytest.approx(line["value"] / line["budget_us"])

    fs, audio = read_audio_mono(str(d / "mix.wav"))
    rt = T.HPRRealtime(fs, 32, 2.0, outputs=T.OUTPUT_PERCUSSIVE, device="cpu")
    perc = rt.process_stream(audio, block_hops=8)[1][: len(audio)]
    write_audio_pcm16(str(d / "lib_perc_rt.wav"), fs, peak_normalize(perc))
    assert (d / "port_rt.wav").read_bytes() == (d / "lib_perc_rt.wav").read_bytes()
    diff = np.abs(_levels(d / "port_rt.wav") - _levels(d / "jax_rt.wav")).max()
    assert diff <= pcm16_bound(perc), (diff, pcm16_bound(perc))


def test_synth_is_byte_identical_to_zen_tpu(tmp_path):
    args = ["--fs", "8000", "--seconds", "0.75", "--bpm", "150", "--hits-per-beat", "2",
            "--sawtooth", "--vibrato-cents", "20", "--seed", "3", "--stems"]
    port_out = _ok(_port("synth", "-o", tmp_path / "p.wav", *args))
    jax_out = _ok(_jax("synth", "-o", tmp_path / "j.wav", *args))
    assert port_out.replace("p.wav", "j.wav").replace("/p_", "/j_") == jax_out
    for suffix in (".wav", "_harm.wav", "_perc.wav"):
        assert (tmp_path / f"p{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()


def test_version_matches_zen_tpu():
    want = _ok(_jax("version"))
    assert want.startswith("version ")
    assert _ok(_port("version")) == want
    assert _in_process("-v") == (0, want, "")


@pytest.mark.parametrize("args,text", [
    (["offline", "-i", "x.wav", *HPS, "--mesh", "tp=3", "--device", "cpu"],
     "zen offline: tp=3 must divide both pass nffts (got nfft=256 at hop=64)"),
    (["offline", "-i", "x.wav", *HPS, "--mesh", "tp", "--device", "cpu"],
     "zen offline: bad mesh axis 'tp' (want name=N)"),
])
def test_offline_mesh_exits_2(mix, args, text):
    """zen_tpu's order: the echo block and the file are read first, then
    the mesh is checked (tests/test_torch_parallel_cli.py holds every
    refusal against zen_tpu's)."""
    d, _, _ = mix
    rc, out, err = _in_process(*[d / "mix.wav" if a == "x.wav" else a for a in args])
    lines = err.strip().splitlines()
    assert rc == 2 and out.startswith("Running zen-offline")
    assert len(lines) == 1 and lines[0].startswith(text), lines


@pytest.mark.parametrize("command", ["offline", "fakert"])
def test_missing_cuda_device_exits_2_without_fallback(command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs for real")
    rc, out, err = _in_process(command, "-i", "x.wav")
    lines = err.strip().splitlines()
    assert rc == 2 and not out and len(lines) == 1
    assert lines[0].startswith(f"zen-torch {command}: --device cuda: ")
    assert "torch.cuda.is_available() is False" in lines[0]
