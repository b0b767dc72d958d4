"""The port's ``stream`` subcommand (zen_tpu_torch/cli.py) through real
subprocess pipes, on the CPU (``--device cpu``).

Held against the port's own library (the same arithmetic: 1e-6 at unit
gain, as tests/test_cli_io.py:213 holds zen_tpu's command) and against
``python -m zen_tpu.cli stream`` on the same bytes (the realtime parity
class, 5e-5 x max(1, max|ref|) per stream; only the FFTs round
differently), under the median path, SSE and the float32 DFT. ``--mesh``
is held in tests/test_torch_parallel_cli.py.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu_torch as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FS, HOP, BLOCK = 4000.0, 16, 8
ARGS = ["stream", "--fs", "4000", "--hop", "16", "--block-hops", "8"]
GLOG_LINE = re.compile(r"[IWEF]\d{4} \d\d:\d\d:\d\d\.\d+\s+\d+ \S+:\d+\] ")
# runs the port's CLI in-process and fails if it pulled in JAX
NO_JAX = (
    "import sys; from zen_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
    "assert 'jax' not in sys.modules and 'zen_tpu' not in sys.modules, "
    "'the port CLI imported jax'; sys.exit(rc)"
)


def _run(cmd, data: bytes, env=None):
    return subprocess.run(cmd, input=data, capture_output=True, cwd=ROOT,
                          timeout=300, env=env)


def _port(args, data: bytes):
    return _run([sys.executable, "-c", NO_JAX, *args], data)


def _streams(s: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return np.stack([
        (0.5 * np.sin(2 * np.pi * f0 * t) + 0.3 * rng.standard_normal(n)).astype(np.float32)
        for f0 in np.linspace(200.0, 800.0, s)
    ])


def _serving_line(stderr: bytes) -> dict:
    # XLA's C++ runtime may log to the same stderr (glog lines such as
    # "E1016 21:56:35.355607 23728 cpu_aot_loader.cc:210] ..." when a cached
    # executable was compiled on a host with other CPU features); those
    # lines are not the command's, every other line is held as before.
    lines = [ln for ln in stderr.decode().strip().splitlines()
             if not GLOG_LINE.match(ln)]
    assert lines[0].startswith("zen stream ready: fs=4000 hop=16"), lines
    assert lines[-2].startswith("zen stream done: "), lines
    return json.loads(lines[-1])


@pytest.mark.parametrize("flag,border", [("--cpu", "replicate"), ("--nocopybord", "valid")])
def test_single_stream_pipe_matches_library(flag, border):
    """One stream, ragged tail: --cpu is the replicate border, --nocopybord
    the valid one; unit gain (1/synth_scale)."""
    n = HOP * 40 + 7
    audio = _streams(1, n, 5)[0]
    proc = _port([*ARGS, flag, "--device", "cpu"], audio.tobytes())
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    got = np.frombuffer(proc.stdout, np.float32)
    assert len(got) == n
    rt = T.HPRRealtime(FS, HOP, 2.0, outputs=T.OUTPUT_PERCUSSIVE, border=border, device="cpu")
    want = rt.process_stream(audio, block_hops=BLOCK)[1][:n] / rt.cfg.synth_scale
    np.testing.assert_allclose(got, want, atol=1e-6)
    line = _serving_line(proc.stderr)
    assert line["metric"] == "stream_serving" and line["hops_per_stream"] == 41
    assert set(line) == {
        "metric", "streams", "mesh", "hops_per_stream", "wall_s", "samples_per_s",
        "us_per_hop", "warmup_s", "first_block_s", "block_latency_samples"}


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_multistream_pipe_matches_zen_tpu_cli(state):
    """3 sample-interleaved streams, --cpu: the port's pipe against
    zen_tpu's command on the same bytes, stream by stream, and against
    the port's MultiStreamHPR."""
    s, n = 3, HOP * 32 + 5
    streams = _streams(s, n, 9)
    data = np.ascontiguousarray(streams.T).tobytes()
    args = [*ARGS, "--cpu", "--streams", str(s), "--stream-state", state]
    proc = _port([*args, "--device", "cpu"], data)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    env = dict(os.environ, ZEN_TPU_PLATFORM="cpu")
    jax_proc = _run([sys.executable, "-m", "zen_tpu.cli", *args], data, env)
    assert jax_proc.returncode == 0, jax_proc.stderr.decode()[-2000:]
    got = np.frombuffer(proc.stdout, np.float32).reshape(n, s).T
    want = np.frombuffer(jax_proc.stdout, np.float32).reshape(n, s).T
    assert _serving_line(proc.stderr).keys() == _serving_line(jax_proc.stderr).keys()
    ms = T.MultiStreamHPR(s, FS, HOP, outputs=T.OUTPUT_PERCUSSIVE, border="replicate",
                          stream_state=state, device="cpu")
    padded = np.zeros((s, 40 * HOP), np.float32)
    padded[:, :n] = streams
    lib = torch.cat([ms.process_block(padded[:, j * 128:(j + 1) * 128].reshape(s, BLOCK, HOP))
                     for j in range(5)], dim=2)[:, 0, :n].numpy() / ms.cfg.synth_scale
    for i in range(s):
        scale = max(1.0, float(np.abs(want[i]).max()))
        np.testing.assert_allclose(got[i] / scale, want[i] / scale, atol=5e-5, err_msg=str(i))
        np.testing.assert_allclose(got[i], lib[i], atol=1e-6, err_msg=str(i))


@pytest.mark.parametrize(
    "flags,cfg_kw",
    [(["--sse"], {"use_sse": True}),
     (["--sse", "--cpu"], {"use_sse": True, "border": "replicate"}),
     (["--fft-impl", "dft_f32"], {"fft_impl": "dft_f32"})],
)
def test_sse_and_dft_pipes_match_zen_tpu_cli(flags, cfg_kw):
    """--sse and --fft-impl dft_f32, 3 streams: the port's pipe against
    zen_tpu's command on the same bytes, stream by stream, at the
    realtime parity class, and against the port's MultiStreamHPR. The
    DFT case keeps the 'wrap' border: --cpu (replicate) runs the full
    spectrum, where both packages take the FFT whatever --fft-impl
    says."""
    s, n = 3, HOP * 24 + 9
    streams = _streams(s, n, 13)
    data = np.ascontiguousarray(streams.T).tobytes()
    args = [*ARGS, "--streams", str(s), *flags]
    proc = _port([*args, "--device", "cpu"], data)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    env = dict(os.environ, ZEN_TPU_PLATFORM="cpu")
    jax_proc = _run([sys.executable, "-m", "zen_tpu.cli", *args], data, env)
    assert jax_proc.returncode == 0, jax_proc.stderr.decode()[-2000:]
    got = np.frombuffer(proc.stdout, np.float32).reshape(n, s).T
    want = np.frombuffer(jax_proc.stdout, np.float32).reshape(n, s).T
    assert np.isfinite(got).all()
    ms = T.MultiStreamHPR(s, FS, HOP, outputs=T.OUTPUT_PERCUSSIVE, device="cpu", **cfg_kw)
    padded = np.zeros((s, 32 * HOP), np.float32)
    padded[:, :n] = streams
    lib = torch.cat([ms.process_block(padded[:, j * 128:(j + 1) * 128].reshape(s, BLOCK, HOP))
                     for j in range(4)], dim=2)[:, 0, :n].numpy() / ms.cfg.synth_scale
    for i in range(s):
        scale = max(1.0, float(np.abs(want[i]).max()))
        np.testing.assert_allclose(got[i] / scale, want[i] / scale, atol=5e-5, err_msg=str(i))
        np.testing.assert_allclose(got[i], lib[i], atol=1e-6, err_msg=str(i))


def test_missing_cuda_device_exits_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs for real")
    proc = _port([*ARGS, "--streams", "2"], np.zeros(64, np.float32).tobytes())
    assert proc.returncode == 2 and not proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr.decode()


def test_module_entry_point_and_malformed_mesh():
    """python -m zen_tpu_torch is the same CLI; a malformed --mesh takes
    zen_tpu's bad-mesh path (exit 1, one stderr line)."""
    proc = _run([sys.executable, "-m", "zen_tpu_torch", *ARGS, "--mesh", "dp"], b"")
    assert proc.returncode == 1
    assert proc.stderr.decode().strip() == "stream bad mesh axis 'dp' (want name=N)"
