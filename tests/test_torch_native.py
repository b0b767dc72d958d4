"""The port's native runtime (zen_tpu_torch/runtime/native.py): the codec
and ring library built from native/*.cpp into build/zen_tpu_torch/native/
at first use, its ring buffer (the cases of tests/test_native.py:20-68),
FLAC's CRCs, and LiveStream (runtime/stream.py) on the CPU, bitwise to
HPRRealtime.process_stream on the same audio and block size.
"""
import hashlib
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu_torch as T  # noqa: E402
from zen_tpu_torch.errors import ZenError  # noqa: E402
from zen_tpu_torch.runtime import native  # noqa: E402
from zen_tpu_torch.runtime.stream import LiveStream  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FS, HOP = 2000.0, 16


def _tree(d: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.iterdir()) if p.suffix in (".cpp", ".h") or p.name == "Makefile"}


def test_builds_into_the_build_dir_and_leaves_native_alone():
    before = _tree(native.NATIVE_DIR)
    lib = native.library()
    path = native.library_path()
    assert path.parent == ROOT / "build" / "zen_tpu_torch" / "native"
    assert path.exists() and path.name.startswith("libzenio_")
    assert Path(lib._name) == path
    assert _tree(native.NATIVE_DIR) == before
    # the port's build leaves no object or library of its own under native/
    assert not [p for p in native.NATIVE_DIR.iterdir()
                if p.suffix == ".o" or p.name.startswith("libzenio_")]


def test_second_load_reuses_the_build():
    path = native.library_path()
    native.library()
    stamp = path.stat().st_mtime_ns
    names = sorted(p.name for p in native.BUILD_DIR.iterdir())
    code = ("from zen_tpu_torch.runtime import native; "
            "print(native.library()._name)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == str(path) and path.stat().st_mtime_ns == stamp
    assert sorted(p.name for p in native.BUILD_DIR.iterdir()) == names


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    for name in native.SOURCES:
        (src / f"{name}.cpp").write_text("int ok_%s;\n" % name)
    (src / "zenio.cpp").write_text("int broken = ;\n")
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    out = native.library_path()
    with pytest.raises(ZenError, match="(?s)building the codec library failed.*zenio.cpp"):
        native._build(out)
    assert not out.exists()
    assert not list((tmp_path / "build").glob("*.o"))


def test_ring_buffer_basic():
    r = native.RingBuffer(1 << 10)
    assert r.read(4) is None
    assert r.write(np.arange(8, dtype=np.float32)) == 8
    assert r.available_samples == 8
    np.testing.assert_array_equal(r.read(8), np.arange(8, dtype=np.float32))
    assert r.overruns == 0
    r.close()
    with pytest.raises(ZenError, match="power of two"):
        native.RingBuffer(1000)


def test_ring_buffer_overrun_and_wraparound():
    r = native.RingBuffer(16)
    assert r.write(np.ones(20, np.float32)) == 16
    assert r.overruns == 1
    assert r.read(16) is not None
    for k in range(10):
        x = np.full(12, float(k), np.float32)
        assert r.write(x) == 12
        np.testing.assert_array_equal(r.read(12), x)
    r.close()


def test_ring_buffer_threaded_stream():
    """Single producer, single consumer: 100k samples through a 4k ring,
    in order and complete."""
    r = native.RingBuffer(1 << 12)
    n = 100_000
    src = np.arange(n, dtype=np.float32)
    got = np.empty(n, np.float32)

    def producer():
        i = 0
        while i < n:
            i += r.write(src[i : i + 512])

    t = threading.Thread(target=producer)
    t.start()
    i = 0
    deadline = time.monotonic() + 60
    while i < n and time.monotonic() < deadline:
        chunk = r.read(min(512, n - i))
        if chunk is not None:
            got[i : i + len(chunk)] = chunk
            i += len(chunk)
    t.join(timeout=10)
    assert not t.is_alive() and i == n
    np.testing.assert_array_equal(got, src)
    r.close()


def _crc(data: bytes, bits: int, poly: int) -> int:
    crc, top, mask = 0, 1 << (bits - 1), (1 << bits) - 1
    for byte in data:
        crc ^= byte << (bits - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
    return crc


@pytest.mark.parametrize("data", [b"", b"\xff\xf8\x69\x18", bytes(range(256)) * 3])
def test_flac_crcs(data):
    assert native.crc8(data) == _crc(data, 8, 0x07)
    assert native.crc16(data) == _crc(data, 16, 0x8005)


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return (0.5 * np.sin(2 * np.pi * 150 * t) + 0.4 * (rng.random(n) > 0.97)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("block_hops", [1, 4])
def test_live_stream_matches_process_stream(threaded, block_hops):
    """Pushed audio comes out of the three output rings bitwise equal to
    process_stream at the same block size, polled or from the feeder
    thread."""
    n = 24 * HOP
    audio = _audio(n, 7 + block_hops)
    want = T.HPRRealtime(FS, HOP, device="cpu").process_stream(audio, block_hops=block_hops)
    live = LiveStream(FS, HOP, block_hops=block_hops, ring_capacity=1 << 10, device="cpu")
    assert live.push(audio) == n
    if threaded:
        live.start(timeout=60)
        deadline = time.monotonic() + 60
        while live.blocks_processed < n // (block_hops * HOP) and time.monotonic() < deadline:
            time.sleep(0.001)
        live.stop()
        assert not live._thread.is_alive()
    else:
        live.warmup()
        while live.poll():
            pass
    assert live.blocks_processed == n // (block_hops * HOP)
    for i, stem in enumerate(("harmonic", "percussive", "residual")):
        np.testing.assert_array_equal(live.pull(stem, n), want[i], err_msg=stem)
        assert live.pull(stem, 1) is None
    assert live.dropped_out_samples == 0 and live.in_ring.overruns == 0


def test_live_stream_counts_dropped_output():
    """A consumer that never pulls: the output rings fill and every lost
    sample is counted."""
    live = LiveStream(FS, HOP, block_hops=2, ring_capacity=64, device="cpu")
    for block in _audio(8 * HOP, 3).reshape(4, 2 * HOP):
        assert live.push(block) == 2 * HOP
        assert live.poll() and not live.poll()
    assert live.blocks_processed == 4
    assert live.dropped_out_samples == 3 * (8 * HOP - 64)
