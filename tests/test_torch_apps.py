"""The port's demo apps (zen_tpu_torch/apps: MPM pitch, BTrack beats) and
the CLI's corpus, pitch-track and beat-track against zen_tpu's, on the CPU.

Inputs are tests/test_apps.py's. Tolerances, each with its reason:
* autocorrelation: 1e-5 x max|acf| (torch.fft and XLA's CPU FFT round
  differently; 2.2e-7 measured on the chord, 4.1e-7 with strict_ref,
  whose complex division by 2N also rounds differently);
* pitch: 1e-3 Hz (the parabolic interpolation is continuous in the ACF;
  the 0.93 cutoff did not flip a peak on these inputs); through the CLI,
  one unit of the printed 0.01 Hz (close values may round apart);
* ODF: 1e-5 x max|odf| on noise and the click track (the FFTs again,
  then cos and atan2; 7e-8 measured on the click track); on steady
  partials, per frame within chip_smoke.odf_tolerance, over a noise
  floor: their complex spectral difference cancels, and a bin holding only
  round-off has a noise phase that a frame two hops later reads at full
  weight (without a floor the demo mixes' ODFs differ at burst onsets;
  their beats are held instead). The signed zeros of an all-zero frame's spectrum, where
  torch's FFT returns -0.0 and zen_tpu's +0.0, are made +0.0 first:
  without that the phase of a silent frame is +-pi against 0 and the ODF
  two frames later differs by up to 8%;
* the beat state machine, the tables and the streaming ODF: bitwise
  (host numpy copied from zen_tpu);
* beats from each package's own ODF: the same frames (the CLI test allows
  one ODF frame, 256/fs, for a threshold the ODF's rounding could cross);
* corpus stems through the CLI: within ``pcm16_bound`` of
  tests/test_torch_offline_cli.py (the 5e-5 class carried through peak
  normalization and PCM16 rounding).
"""
import contextlib
import hashlib
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

import jax.numpy as jnp  # noqa: E402

from zen_tpu.apps import btrack as jb  # noqa: E402
from zen_tpu.apps import mpm as jm  # noqa: E402
from zen_tpu_torch.apps import btrack as tb  # noqa: E402
from zen_tpu_torch.apps import mpm as tm  # noqa: E402
from zen_tpu_torch.cli import main  # noqa: E402
from zen_tpu_torch.io.audio import read_audio_mono  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EPS = 5e-5
FS = 44100
NO_JAX = (
    "import sys; from zen_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
    "assert 'jax' not in sys.modules and 'zen_tpu' not in sys.modules, "
    "'the port CLI imported jax'; sys.exit(rc)"
)


def _tone(f0, n=4096, fs=FS, amp=0.6):
    t = np.arange(n) / fs
    return (amp * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def _chord(n=4096, fs=FS):
    t = np.arange(n) / fs
    return sum(0.3 * np.sin(2 * np.pi * f * t) for f in (220.0, 275.0, 330.0)).astype(np.float32)


def _click_track(seconds=6, bpm=120.0, fs=FS, seed=2):
    n = fs * seconds
    audio = np.zeros(n, np.float32)
    rng = np.random.default_rng(seed)
    for i in range(0, n - 600, int(60.0 / bpm * fs)):
        audio[i : i + 600] += (rng.standard_normal(600) * np.exp(-np.arange(600) / 120)).astype(
            np.float32)
    return audio


def _acf_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


# ---------------- MPM ----------------


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("signal", ["chord", "tone", "noisy_batch"])
def test_autocorr_matches_zen_tpu(strict, signal):
    if signal == "chord":
        x, n = _chord(), 4096
    elif signal == "tone":
        x, n = _tone(220.0), 4096
    else:
        rng = np.random.default_rng(0)
        t = np.arange(1024) / 8000
        x = np.stack([0.5 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal(1024)
                      for f0 in (110, 220, 330)]).astype(np.float32)
        n = 1024
    want = np.asarray(jm._autocorr_batch(jnp.asarray(x), n, strict))
    got = tm._autocorr_batch(torch.from_numpy(x), n, strict).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    _acf_close(got, want)


@pytest.mark.parametrize("strict", [False, True])
def test_mpm_pitch_matches_zen_tpu(strict):
    """Pure tones, the chord, silence and a tone under the 80 Hz cutoff:
    the same decisions, pitches within 1e-3 Hz."""
    mj, mt = jm.MPM(4096, FS, strict_ref=strict), tm.MPM(4096, FS, strict_ref=strict, device="cpu")
    for x in (_tone(110.0), _tone(220.0), _tone(441.0), _chord(), np.zeros(4096, np.float32),
              _tone(50.0)):
        want, got = mj.pitch(x), mt.pitch(x)
        assert (got == -1.0) == (want == -1.0)
        assert abs(got - want) < 1e-3, (got, want)
    assert mt.pitch(np.zeros(4096, np.float32)) == -1.0 and mt.pitch(_tone(50.0)) == -1.0
    if not strict:
        for f0 in (110.0, 220.0, 441.0):
            assert abs(mt.pitch(_tone(f0)) - f0) < 1.5


def test_mpm_pitch_batch_matches_single_and_zen_tpu():
    rng = np.random.default_rng(0)
    t = np.arange(1024) / 8000
    chunks = np.stack([0.5 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.standard_normal(1024)
                       for f0 in (110, 220, 330)]).astype(np.float32)
    mt = tm.MPM(1024, 8000, device="cpu")
    batch = mt.pitch_batch(chunks)
    assert batch.dtype == np.float32
    np.testing.assert_allclose(batch, [mt.pitch(c) for c in chunks], rtol=1e-4)
    np.testing.assert_allclose(batch, jm.MPM(1024, 8000).pitch_batch(chunks), rtol=0, atol=1e-3)


def test_mpm_strict_ref_reproduces_the_quirk():
    """strict_ref's half-scaled spectrum differs from the textbook ACF and
    biases the tone's pitch; lag 0 of the textbook ACF is the energy."""
    chord = _chord()
    fix = tm._autocorr_batch(torch.from_numpy(chord), 4096, False).numpy()
    ref = tm._autocorr_batch(torch.from_numpy(chord), 4096, True).numpy()
    assert not np.allclose(fix, ref, rtol=1e-3, atol=1e-3)
    energy = float(np.dot(chord, chord))
    assert abs(fix[0] - energy) / energy < 1e-4
    p_fix = tm.MPM(4096, FS, device="cpu").pitch(_tone(220.0))
    p_ref = tm.MPM(4096, FS, strict_ref=True, device="cpu").pitch(_tone(220.0))
    assert abs(p_fix - 220.0) < 1.5 and p_ref > 0 and abs(p_ref - p_fix) > 5.0


def test_host_peak_picking_is_zen_tpu_s():
    """The host decisions are a copy: bitwise on the same ACFs."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        acf = np.asarray(jm._autocorr_batch(jnp.asarray(rng.standard_normal(512).astype(
            np.float32)), 512, False))
        assert tm._peak_picking(acf) == jm._peak_picking(acf)
        assert tm.pitch_from_acf(acf, 8000.0) == jm.pitch_from_acf(acf, 8000.0)


# ---------------- BTrack ----------------


def test_tables_are_zen_tpu_s():
    np.testing.assert_array_equal(tb.rayleigh_weighting(), jb.rayleigh_weighting())
    np.testing.assert_array_equal(tb.tempo_transition_matrix(), jb.tempo_transition_matrix())
    np.testing.assert_array_equal(tb._odf_window(), jb._hanning_symmetric(512))


def test_odf_window_is_read_only_and_not_shared():
    """The cached window every ODF shares refuses writes, and the CPU
    tensor odf_batch multiplies by is a copy of it, not a view."""
    win = tb._odf_window()
    with pytest.raises(ValueError, match="read-only"):
        win[0] = 1.0
    dev = tb._device_window(torch.device("cpu"))
    assert dev.data_ptr() != win.ctypes.data
    np.testing.assert_array_equal(dev.numpy(), jb._hanning_symmetric(512))


@pytest.mark.parametrize("signal", ["noise", "click_track", "one_frame"])
def test_odf_batch_matches_zen_tpu(signal, monkeypatch):
    if signal == "noise":
        audio = np.random.default_rng(1).standard_normal(256 * 24).astype(np.float32) * 0.2
    elif signal == "click_track":
        audio = _click_track()
    else:
        audio = np.random.default_rng(4).standard_normal(256).astype(np.float32)
    frames = jb.frames_from_hops(audio)
    np.testing.assert_array_equal(tb.frames_from_hops(audio), frames)
    sha_before = hashlib.sha256(frames.tobytes()).hexdigest()
    want = np.asarray(jb.odf_batch(frames))
    # keep the FFT's input (a copy made before the FFT, and the buffer the
    # FFT read) and the spectra odf_batch computes, for the evidence on a
    # failure
    inputs, spectra = [], []
    fft_input, from_spectrum = tb.odf_fft_input, tb.odf_from_spectrum
    monkeypatch.setattr(tb, "odf_fft_input",
                        lambda x: (inputs.append((y := fft_input(x), y.clone())), y)[1])
    monkeypatch.setattr(tb, "odf_from_spectrum",
                        lambda spec: spectra.append(spec) or from_spectrum(spec))
    got = tb.odf_batch(torch.from_numpy(frames)).numpy()
    monkeypatch.undo()
    assert got.shape == want.shape == (len(audio) // 256,) and got.dtype == np.float32
    try:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    except AssertionError as err:
        evidence = _odf_evidence(frames, got, spectra[0], *inputs[0], sha_before)
        raise AssertionError(f"{err}\n{evidence}") from None


def _odf_evidence(frames: np.ndarray, got: np.ndarray, spec: torch.Tensor,
                  fft_in: torch.Tensor, fft_in_copy: torch.Tensor, sha_before: str) -> str:
    """What the process carries when the port's ODF misses zen_tpu's
    (ROADMAP Queue 3 item 8): the xdist worker and the test modules it has
    imported (what it ran before), torch's thread counts and MKL's, the
    calling thread's rounding mode (fegetround, which reads the x87
    control word alone: 0 to nearest, 0x400 down, 0x800 up, 0xc00 toward
    zero), MXCSR (the SSE/AVX state the FFT's vector code obeys: 0x1f80 is
    round to nearest with no FTZ/DAZ; its low 6 bits are exception flags)
    on the calling thread and on every thread of torch's OpenMP pool, the
    live Python threads, whether two more calls on the same frames give
    the first call's bits (a transient) or not (state the process holds),
    which rows of the first call's spectrum differ from the later calls',
    each row's error against a float64 FFT of the same rows beside the
    later calls', which rows of the first call's FFT input (``fft_in``,
    the buffer the FFT read; ``fft_in_copy``, a copy made before the FFT)
    differ from a later call's or moved during the FFT, the SHA-256 of
    ``frames`` before the zen_tpu call and now, and whether JAX takes
    ``frames`` zero-copy (its buffer the numpy array's memory), as the
    zen_tpu call did where it does."""
    import ctypes
    import ctypes.util
    import threading

    import jax.numpy as jnp

    from zen_tpu_torch.tools import odf_fp_probe as probe

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fp = probe.fp_state(probe.helper())
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    modules = sorted(name for name, m in list(sys.modules.items())
                     if (getattr(m, "__file__", None) or "").startswith(tests_dir + os.sep))
    x = torch.from_numpy(frames)
    again = [tb.odf_batch(x).numpy() for _ in range(2)]
    same = [bool(np.array_equal(a.view(np.uint32), got.view(np.uint32))) for a in again]
    moved = [np.nonzero(a != got)[0].tolist() for a in again]
    later_in = tb.odf_fft_input(x)
    later = torch.fft.fft(later_in, dim=-1).numpy()
    first = spec.numpy()
    rows = np.nonzero((first != later).any(-1))[0].tolist()

    def differ(a, b):
        return np.nonzero((a.numpy() != b.numpy()).any(-1))[0].tolist()

    in_rows, in_moved = differ(fft_in_copy, later_in), differ(fft_in_copy, fft_in)
    exact = np.fft.fft(later_in.double().numpy(), axis=-1)
    exact_first = np.fft.fft(fft_in_copy.double().numpy(), axis=-1)
    err, err_later = probe._row_errors(first, exact), probe._row_errors(later, exact)
    err_own = probe._row_errors(first, exact_first)
    alias = int(jnp.asarray(frames).unsafe_buffer_pointer()) == frames.ctypes.data
    return (f"evidence: xdist worker {os.environ.get('PYTEST_XDIST_WORKER', 'none')}, "
            f"test modules imported {modules}, "
            f"frames SHA-256 before the zen_tpu call {sha_before}, now "
            f"{hashlib.sha256(frames.tobytes()).hexdigest()}, JAX takes frames zero-copy: "
            f"{alias} (frames at {frames.ctypes.data:#x}, {frames.ctypes.data % 64} past 64 "
            f"bytes), FFT input rows of call 1 that differ from call 4's: {in_rows}, that "
            f"moved during call 1's FFT: {in_moved}, call 1's spectrum error against a float64 "
            f"FFT of its own input on those rows {[err_own[r] for r in rows]}, "
            f"torch threads {torch.get_num_threads()} (interop "
            f"{torch.get_num_interop_threads()}, MKL {probe.mkl_threads()}), rounding mode "
            f"{libm.fegetround():#x}, x87 control word {fp['x87_cw']}, MXCSR {fp['mxcsr']} "
            f"(pool {fp['pool_mxcsr']}), live threads {[t.name for t in threading.enumerate()]}, "
            f"calls 2 and 3 bit-equal to call 1: {same} (frames that moved: {moved}); spectrum "
            f"rows of call 1 that differ from call 4's: {rows}, their error against float64 "
            f"{[err[r] for r in rows]} (call 4: {[err_later[r] for r in rows]}); "
            f"call 1 {got.tolist()}")


def test_odf_of_steady_partials_within_the_derived_bound():
    """A steady chord under drums over a 0.01 noise floor: per frame within
    chip_smoke.odf_tolerance (the complex spectral difference of a steady
    partial cancels, so the FFTs' rounding enters as its square root);
    the beats found from the two ODFs are the same frames."""
    import chip_smoke
    from zen_tpu_torch.io.synth import synth_mixture

    _, _, mix = synth_mixture(fs=44100.0, seconds=10, bpm=120, hits_per_beat=4)
    x = (mix / np.abs(mix).max()
         + 0.01 * np.random.default_rng(19).standard_normal(len(mix))).astype(np.float32)
    frames = jb.frames_from_hops(x)
    want = np.asarray(jb.odf_batch(frames))
    got = tb.odf_batch(torch.from_numpy(frames)).numpy()
    assert (np.abs(got - want) <= chip_smoke.odf_tolerance(frames)).all()
    np.testing.assert_array_equal(tb.track_beats_from_odf(got, FS)[0],
                                  jb.track_beats_from_odf(want, FS)[0])


def test_odf_batch_matches_the_streaming_odf():
    audio = np.random.default_rng(1).standard_normal(256 * 24).astype(np.float32) * 0.2
    batched = tb.odf_batch(torch.from_numpy(tb.frames_from_hops(audio))).numpy()
    bt, bj = tb.BTrack(FS), jb.BTrack(FS)
    streamed = []
    for n in range(24):
        bt.process_hop(audio[n * 256 : (n + 1) * 256])
        bj.process_hop(audio[n * 256 : (n + 1) * 256])
        assert bt.last_onset == bj.last_onset  # host numpy, a copy
        streamed.append(bt.last_onset)
    np.testing.assert_allclose(batched, np.array(streamed), rtol=2e-3)


@pytest.mark.parametrize("fs", [44100, 96000])
def test_beat_state_machine_is_zen_tpu_s(fs):
    """On one ODF the two state machines agree bitwise (beats, tempi);
    on each package's own ODF of the click track they find the same beats,
    which lock onto its 120 BPM."""
    audio = _click_track(fs=fs)
    frames = jb.frames_from_hops(audio)
    odf = np.asarray(jb.odf_batch(frames))
    fb_t, tempi_t = tb.track_beats_from_odf(odf, fs)
    fb_j, tempi_j = jb.track_beats_from_odf(odf, fs)
    np.testing.assert_array_equal(fb_t, fb_j)
    np.testing.assert_array_equal(tempi_t, tempi_j)
    own, _ = tb.track_beats_from_odf(tb.odf_batch(torch.from_numpy(frames)).numpy(), fs)
    np.testing.assert_array_equal(own, fb_j)
    if fs == 44100:
        beats = np.nonzero(own)[0] * 256 / fs
        assert abs(np.median(np.diff(beats)) - 0.5) < 0.03, beats


# ---------------- the CLI against python -m zen_tpu.cli ----------------


def _port(*args):
    return subprocess.run([sys.executable, "-c", NO_JAX, *map(str, args)], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)


def _in_process(*args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in args])
    return rc, out.getvalue(), err.getvalue()


def _jax(*args):
    """zen_tpu's CLI on a one-device CPU host (the suite's conftest asks
    XLA for eight)."""
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    env = dict(os.environ, ZEN_TPU_PLATFORM="cpu", XLA_FLAGS=flags)
    return subprocess.run([sys.executable, "-m", "zen_tpu.cli", *map(str, args)],
                          capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)


def _ok(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def pcm16_bound(stem: np.ndarray) -> int:
    """tests/test_torch_offline_cli.py's bound: the 5e-5 class through
    peak normalization and PCM16 rounding, in levels."""
    peak = float(np.abs(stem).max())
    scale = max(1.0, peak) * (1 + EPS)
    return math.floor(32767 * 2 * EPS * scale / (peak - EPS * scale)) + 1


def _levels(path) -> np.ndarray:
    return np.round(read_audio_mono(str(path))[1].astype(np.float64) * 32768).astype(np.int64)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The mixture of docs/DEMOS.md's command (44.1 kHz, 3 s), and zen_tpu's
    two demo commands on it."""
    d = tmp_path_factory.mktemp("demo")
    _ok(_port("synth", "-o", d / "demo.wav", "--sawtooth", "--vibrato-cents",
              "17", "--bpm", "120", "--hits-per-beat", "4", "--seconds", "3"))
    return (d, _ok(_jax("pitch-track", "-i", d / "demo.wav")),
            _ok(_jax("beat-track", "-i", d / "demo.wav")))


def _pitches(stdout):
    rows = [ln for ln in stdout.splitlines() if ln.startswith("t:")]
    return [tuple(float(x.split(":")[1].strip()) for x in ln.split(",\t")) for ln in rows]


def _beats(stdout, name):
    line = next(ln for ln in stdout.splitlines() if ln.startswith(f"{name} beat timestamps:"))
    return np.array([float(x) for x in line.split(":", 1)[1].split()])


def test_pitch_track_cli_matches_zen_tpu(demo):
    d, want, _ = demo
    got = _ok(_port("pitch-track", "-i", d / "demo.wav", "--device", "cpu"))
    head = [ln for ln in got.splitlines() if not ln.startswith("t:")]
    assert head == [ln for ln in want.splitlines() if not ln.startswith("t:")]
    g, w = _pitches(got), _pitches(want)
    assert len(g) == len(w) == 32
    for a, b in zip(g, w):
        assert a[0] == b[0]  # the chunk's time
        # in units of the printed 0.01 Hz (a difference of 0.01 may read 0.010000000000005)
        assert all(abs(round(x * 100) - round(y * 100)) <= 1 for x, y in zip(a[1:], b[1:])), (a, b)


def test_beat_track_cli_matches_zen_tpu(demo):
    d, _, want = demo
    rc, got, _ = _in_process("beat-track", "-i", d / "demo.wav", "--device", "cpu")
    assert rc == 0
    head = [ln for ln in got.splitlines() if "beat timestamps" not in ln]
    assert head == [ln for ln in want.splitlines() if "beat timestamps" not in ln]
    for name in ("+HPR", "-HPR"):
        g, w = _beats(got, name), _beats(want, name)
        assert len(g) == len(w) and len(g) >= 4, (name, g, w)
        assert np.abs(g - w).max() <= 256 / 44100 + 1e-4, (name, g, w)


@pytest.mark.parametrize("command", ["pitch-track", "beat-track", "corpus"])
def test_demo_and_corpus_refuse_a_missing_card(tmp_path, command):
    """--device cuda without a card: exit 2 and a ZenError's message, no
    fallback (the default device is the card)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = (["corpus", "-i", str(ROOT / "pyproject.toml"), "-o", str(tmp_path)]
            if command == "corpus" else [command, "-i", str(tmp_path / "none.wav")])
    rc, out, err = _in_process(*args)
    assert rc == 2 and "torch.cuda.is_available() is False" in err and out == ""


def test_corpus_cli_matches_zen_tpu(tmp_path):
    """Three synth tracks (one at another rate): the same stdout lines
    but the output directory, the same file names and journal, stems
    within pcm16_bound of zen_tpu's; a second port run resumes zen_tpu's
    journal with nothing to do."""
    (tmp_path / "in").mkdir()
    for i, fs in enumerate((4000, 4000, 3000)):
        assert _in_process("synth", "-o", tmp_path / "in" / f"t{i}.wav", "--fs", fs,
                           "--seconds", f"1.{i}", "--seed", i)[0] == 0
    glob = str(tmp_path / "in" / "t*.wav")
    hps = ["--hps", "64", "2.0", "16", "2.0"]
    want = _ok(_jax("corpus", "-i", glob, "-o", tmp_path / "jax", *hps)).splitlines()
    want = [ln for ln in want if ln.startswith(("corpus:", "{"))]
    got = _ok(_port("corpus", "-i", glob, "-o", tmp_path / "port", *hps, "--device", "cpu"))
    assert got.splitlines() == [ln.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                                for ln in want]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert (tmp_path / "port" / "progress.jsonl").read_text() == (
        tmp_path / "jax" / "progress.jsonl").read_text()
    for name in sorted(os.listdir(tmp_path / "port")):
        if name.endswith(".wav"):
            g, w = _levels(tmp_path / "port" / name), _levels(tmp_path / "jax" / name)
            assert np.abs(g - w).max() <= pcm16_bound(w / 32768.0), name
    rc, out, _ = _in_process("corpus", "-i", glob, "-o", tmp_path / "jax", *hps, "--device", "cpu")
    assert rc == 0 and json.loads(out.splitlines()[-1]) == {
        "metric": "corpus_tracks", "done": 3, "processed": 0}


@pytest.mark.parametrize("argv,rc,msg", [
    (["--nprocs", "2"], 1, "--nprocs needs --coordinator HOST:PORT"),
    (["--coordinator", "h:1"], 1, "--coordinator/--proc-id need --nprocs >= 2"),
    (["--proc-id", "1"], 1, "--coordinator/--proc-id need --nprocs >= 2"),
    (["--mesh", "dp=0"], 1, "mesh axis size must be >= 1"),
    (["--mesh", "tp=2"], 1, "mesh supports axes dp,sp only"),
])
def test_corpus_cli_refusals(tmp_path, argv, rc, msg):
    got, out, err = _in_process("corpus", "-i", str(ROOT / "pyproject.toml"), "-o", tmp_path,
                                *argv, "--device", "cpu")
    assert got == rc and msg in err and len(err.strip().splitlines()) == 1 and out == ""
    rc2, _, err2 = _in_process("corpus", "-i", str(tmp_path / "nothing*.wav"), "-o", tmp_path)
    assert rc2 == 1 and "no input tracks matched" in err2
