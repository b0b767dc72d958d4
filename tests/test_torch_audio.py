"""The port's audio I/O (zen_tpu_torch/io/audio.py over the native codecs
of runtime/native.py) against zen_tpu.io.audio, on the CPU.

Both packages read the same files and write the same samples. The bar is
bit-identity: decoded samples bitwise equal (float32), written files
byte for byte, since both sides run the same native decoders and
encoders (zen_tpu's pure-Python encoders are pinned byte-identical to
them) and the same float32 arithmetic around them.
"""
import struct
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

import zen_tpu.io.audio as J  # noqa: E402
from zen_tpu.io.flac import FlacError
from zen_tpu.io.flac import skip_id3 as jax_skip_id3
import zen_tpu_torch.io.audio as T  # noqa: E402
from zen_tpu_torch.errors import ZenError

DATA = Path(__file__).resolve().parent / "data"
ID3 = b"ID3\x04\x00\x00\x00\x00\x00\x15" + bytes(0x15)  # a 31-byte empty ID3v2.4 tag


def _same_read(path):
    fs_j, x_j = J.read_audio_mono(str(path))
    fs_t, x_t = T.read_audio_mono(str(path))
    assert fs_t == fs_j and x_t.dtype == np.float32 and x_t.shape == x_j.shape
    np.testing.assert_array_equal(x_t, x_j)
    return x_t


def _signal(n, channels, seed, peak=0.9):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000.0
    x = np.stack([peak * np.sin(2 * np.pi * (220.0 + 110 * c) * t)
                  + 0.05 * rng.standard_normal(n) for c in range(channels)], axis=1)
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def _wav_bytes(fmt_tag, channels, fs, bits, payload: bytes, extensible_tag=None) -> bytes:
    """A RIFF/WAVE file; WAVE_FORMAT_EXTENSIBLE (0xFFFE) carries the sample
    format in its sub-format GUID."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, fs, fs * block, block, bits)
    if extensible_tag is not None:
        guid = struct.pack("<H", extensible_tag) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt += struct.pack("<HHI", 22, bits, (1 << channels) - 1) + guid
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _pcm24(x: np.ndarray) -> bytes:
    q = np.round(x * (2**23 - 1)).astype(np.int32).reshape(-1)
    return b"".join(int(v).to_bytes(3, "little", signed=True) for v in q)


@pytest.mark.parametrize("name", ["floor0_regression.ogg", "lsf_regression.mp3",
                                  "ms_quad_regression.opus"])
def test_committed_files_read_bitwise(name):
    assert len(_same_read(DATA / name)) > 0


@pytest.mark.parametrize("kind", [
    "pcm16", "pcm16_stereo", "pcm24", "pcm24_stereo", "int32", "int32_stereo",
    "float32", "float32_stereo", "uint8", "extensible_pcm16", "extensible_pcm24",
    "extensible_float32"])
def test_wav_reads_bitwise(tmp_path, kind):
    """PCM16 and float32 take the native parser on both sides; the other
    sample formats (and WAVE_FORMAT_EXTENSIBLE) scipy's."""
    channels = 2 if kind.endswith("stereo") else 1
    x = _signal(700, channels, seed=3)
    path = tmp_path / f"{kind}.wav"
    if kind.startswith("pcm16"):
        wavfile.write(path, 8000, np.round(x * 32767).astype(np.int16))
    elif kind.startswith("int32"):
        wavfile.write(path, 8000, np.round(x * (2**31 - 256)).astype(np.int32))
    elif kind.startswith("float32"):
        wavfile.write(path, 8000, x)
    elif kind == "uint8":
        wavfile.write(path, 8000, np.round(x[:, 0] * 127 + 128).astype(np.uint8))
    elif kind.startswith("pcm24"):
        path.write_bytes(_wav_bytes(1, channels, 8000, 24, _pcm24(x)))
    elif kind == "extensible_pcm16":
        pcm = np.round(x * 32767).astype("<i2").tobytes()
        path.write_bytes(_wav_bytes(0xFFFE, 1, 8000, 16, pcm, extensible_tag=1))
    elif kind == "extensible_pcm24":
        path.write_bytes(_wav_bytes(0xFFFE, 1, 8000, 24, _pcm24(x), extensible_tag=1))
    else:
        path.write_bytes(_wav_bytes(0xFFFE, 1, 8000, 32, x.astype("<f4").tobytes(),
                                    extensible_tag=3))
    got = _same_read(path)
    # 8-bit levels are 1/128 apart and were written as x * 127 + 128
    np.testing.assert_allclose(got, x.mean(axis=1), atol=3.0 / 128 if kind == "uint8" else 2.0**-14)


@pytest.mark.parametrize("id3", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("ext", ["flac", "wv"])
def test_lossless_reads_bitwise(tmp_path, ext, channels, id3):
    """Files zen_tpu's writer made, mono and stereo, with and without a
    leading ID3v2 tag."""
    x = _signal(5000, channels, seed=4)
    path = tmp_path / f"x.{ext}"
    J.write_audio_pcm16(str(path), 8000, x if channels == 2 else x[:, 0])
    if id3:
        path.write_bytes(ID3 + path.read_bytes())
    got = _same_read(path)
    np.testing.assert_allclose(got, x.mean(axis=1), atol=2.0 / 32768)


def _ties(n):
    """Samples whose float32 product with 32767 is exactly k + 0.5: where
    numpy's round-half-even and C's round-half-away differ."""
    k = np.arange(1, 4 * n, dtype=np.float64)
    x = ((k + 0.5) / 32767).astype(np.float32)
    x = x[x * np.float32(32767.0) == (k + 0.5).astype(np.float32)]
    return np.concatenate([x[:n], -x[:n]])


@pytest.mark.parametrize("ext,channels", [("wav", 1), ("flac", 1), ("flac", 2),
                                          ("wv", 1), ("wv", 2)])
def test_writers_byte_identical(tmp_path, ext, channels):
    """Clipped samples and rounding ties included."""
    x = _signal(3000, channels, seed=5, peak=1.3)
    ties = _ties(50)
    assert len(ties) == 100
    x[: len(ties), 0] = ties
    arr = x if channels == 2 else x[:, 0]
    J.write_audio_pcm16(str(tmp_path / f"j.{ext}"), 8000, arr)
    T.write_audio_pcm16(str(tmp_path / f"t.{ext}"), 8000, arr)
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    _same_read(tmp_path / f"t.{ext}")


def test_write_wav_pcm16_rounds_half_to_even(tmp_path):
    """The levels the wav writer stores are numpy's round(clip(x) * 32767),
    ties to even, as zen_tpu's scipy writer stores them."""
    x = np.concatenate([_ties(20), [1.5, -1.5, 0.0]]).astype(np.float32)
    T.write_wav_pcm16(str(tmp_path / "t.wav"), 8000, x)
    _, data = wavfile.read(tmp_path / "t.wav")
    want = np.round(np.clip(x, -1, 1) * np.float32(32767.0)).astype(np.int16)
    np.testing.assert_array_equal(data, want)
    with pytest.raises(ZenError, match="mono"):
        T.write_wav_pcm16(str(tmp_path / "s.wav"), 8000, np.zeros((4, 2), np.float32))


@pytest.mark.parametrize("x", [
    np.array([-2.0, 1.0, 0.25], np.float32),
    np.array([0.5, -0.1, 3.0], np.float32),
    np.zeros(6, np.float32),
    (np.random.default_rng(6).standard_normal(999) * 40).astype(np.float32),
])
def test_peak_normalize_bitwise(x):
    got, want = T.peak_normalize(x), J.peak_normalize(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if not x.any():
        np.testing.assert_array_equal(got, x)  # silence stays as it is


@pytest.mark.parametrize("head", [
    b"ID3\x03\x00\x00\x00\x00\x02\x01", b"ID3\x04\x00\x10\x00\x00\x00\x7f",
    b"fLaC\x00\x00\x00\x22\x00\x00", b"ID3", b"ID3\x04\x00\x00\x00\x80\x00\x00"])
def test_skip_id3_matches_zen_tpu(head):
    try:
        want = jax_skip_id3(head)
    except FlacError:
        with pytest.raises(ZenError, match="synchsafe"):
            T.skip_id3(head)
        return
    assert T.skip_id3(head) == want


def test_malformed_inputs_raise(tmp_path):
    sv7 = tmp_path / "old.mpc"
    sv7.write_bytes(b"MP+\x07" + bytes(64))
    with pytest.raises(ZenError, match="SV7"):
        T.read_audio_mono(str(sv7))
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(ZenError, match="zen_flac_decode_file failed"):
        T.read_audio_mono(str(bad))
    with pytest.raises(ValueError):  # zen_tpu raises too
        J.read_audio_mono(str(bad))
    with pytest.raises(ZenError, match="mono"):
        T.write_audio_pcm16(str(tmp_path / "x.flac"), 8000, np.zeros((4, 3), np.float32))
