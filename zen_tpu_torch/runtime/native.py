"""ctypes binding of the repository's native host runtime (``native/*.cpp``).

Counterpart of ``zen_tpu/runtime/native.py``: the same C ABI (the SPSC
float ring buffer, the wav codec, FLAC decode and encode with its CRCs,
WavPack decode and encode, and the Ogg Opus, Ogg Vorbis, MP3 and
Musepack SV8 decoders), built differently. The library is compiled at
first use from the sources of ``native/`` (``SOURCES``, the ``SRCS`` of
``native/Makefile``, with its flags) by one ``g++ -c`` per source, all
started together, and one link, into
``build/zen_tpu_torch/native/libzenio_<hash>.so`` at the repository
root. The hash covers the sources, every header of ``native/`` and the
flags, so an edited source rebuilds and an unchanged tree reuses the
library. ``native/`` itself is only read: nothing here runs ``make`` or
writes ``native/libzenio.so``. Processes that build at once (test
workers) take turns on a file lock; the one that finds the library built
loads it.

There is no fallback: a failed build raises ``ZenError`` with the
compiler's stderr, and no pure-Python codec stands behind the library.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..errors import ZenError

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "zen_tpu_torch" / "native"
SOURCES = ("zenio", "zenflac", "zenflac_enc", "zenwv", "zenvorbis", "zenmp3",
           "zenmpc", "zenopus", "zenopus_silk", "zenopus_celt")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17")
# zen_wav_info's code for a header it parses but does not decode (it
# takes PCM16 and float32 only)
_WAV_UNSUPPORTED = -4

_F = ctypes.POINTER(ctypes.c_float)
_U64, _I32, _U32, _P = ctypes.c_uint64, ctypes.c_int32, ctypes.c_uint32, ctypes.c_void_p
_S = ctypes.c_char_p
_PF, _PU64, _PI32 = ctypes.POINTER(_F), ctypes.POINTER(_U64), ctypes.POINTER(_I32)
_DECODERS = ("zen_wv", "zen_vorbis", "zen_mp3", "zen_mpc", "zen_opus")


class UnsupportedWav(ZenError):
    """A wav file whose sample format the native parser does not decode."""


class WavInfo(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_uint32), ("n_frames", ctypes.c_uint32),
                ("n_channels", ctypes.c_uint16), ("format", ctypes.c_uint16)]


# name -> (argtypes, restype)
_SIGNATURES = {
    "zen_ring_create": ([_U64], _P),
    "zen_ring_destroy": ([_P], None),
    "zen_ring_write": ([_P, _F, _U64], _U64),
    "zen_ring_read": ([_P, _F, _U64], _U64),
    "zen_ring_available": ([_P], _U64),
    "zen_ring_overruns": ([_P], _U64),
    "zen_wav_info": ([_S, ctypes.POINTER(WavInfo)], ctypes.c_int),
    "zen_wav_read_mono": ([_S, _F, _U32], ctypes.c_int),
    "zen_wav_write_pcm16": ([_S, _U32, _F, _U32], ctypes.c_int),
    # path, out, frames, fs, channels, bits
    "zen_flac_decode_file": ([_S, _PF, _PU64, _PI32, _PI32, _PI32], ctypes.c_int),
    "zen_flac_free": ([_F], None),
    "zen_crc16": ([_S, _U64], ctypes.c_uint16),
    "zen_crc8": ([_S, _U64], ctypes.c_uint8),
    # path, fs, audio, frames, channels, bits, block size
    "zen_flac_encode": ([_S, _U32, _F, _U64, _U32, _U32, _U32], ctypes.c_int),
    # path, fs, audio, frames, channels, bits, block samples
    "zen_wv_encode": ([_S, _I32, _F, _U64, _I32, _I32, _I32], ctypes.c_int),
    # path, out, frames, fs, channels
    **{f"{p}_decode_file": ([_S, _PF, _PU64, _PI32, _PI32], ctypes.c_int) for p in _DECODERS},
    **{f"{p}_free": ([_F], None) for p in _DECODERS},
}


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise ZenError("g++ not found on PATH: the port's codec library is built "
                       "from native/*.cpp at first use")
    return cxx


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    files = [NATIVE_DIR / f"{s}.cpp" for s in SOURCES] + sorted(NATIVE_DIR.glob("*.h"))
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libzenio_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """One g++ -c per source, all started together, then one link to a
    temporary name and a rename, under the build directory's lock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return
        cxx, tag = _cxx(), f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{s}.o" for s in SOURCES]
        try:
            procs = [subprocess.Popen([cxx, *CXX_FLAGS, "-c", "-o", str(obj),
                                       str(NATIVE_DIR / f"{s}.cpp")],
                                      stderr=subprocess.PIPE, text=True)
                     for s, obj in zip(SOURCES, objs)]
            errors = [(p, p.communicate()[1]) for p in procs]
            failed = [f"{' '.join(p.args)}\n{err[-4000:]}" for p, err in errors if p.returncode]
            if failed:
                raise ZenError("building the codec library failed:\n" + "\n".join(failed))
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run([cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                                  stderr=subprocess.PIPE, text=True)
            if link.returncode:
                raise ZenError(f"linking the codec library failed:\n{link.stderr[-4000:]}")
            os.replace(tmp, out)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the codec library; raise on failure."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _floats(x: np.ndarray):
    return x.ctypes.data_as(_F)


class RingBuffer:
    """Lock-free single-producer single-consumer float ring buffer
    (``native/zenio.cpp``): the host transport between a real-time audio
    producer and the thread that feeds the card (the reference's IOGPU,
    io.h:16-81)."""

    def __init__(self, capacity_pow2: int):
        self._h = None
        self._lib = library()
        self._h = self._lib.zen_ring_create(capacity_pow2)
        if not self._h:
            raise ZenError(f"ring capacity must be a power of two, got {capacity_pow2}")

    def write(self, samples: np.ndarray) -> int:
        """Write what fits; returns the samples written (an overrun when
        fewer than given)."""
        x = np.ascontiguousarray(samples, np.float32)
        return self._lib.zen_ring_write(self._h, _floats(x), len(x))

    def read(self, n: int) -> np.ndarray | None:
        """``n`` samples, or None (nothing consumed) when fewer are there."""
        out = np.empty(n, np.float32)
        got = self._lib.zen_ring_read(self._h, _floats(out), n)
        return out if got == n else None

    @property
    def available_samples(self) -> int:
        return self._lib.zen_ring_available(self._h)

    @property
    def overruns(self) -> int:
        return self._lib.zen_ring_overruns(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.zen_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def wav_read_mono(path: str):
    """Native wav decode of PCM16 or float32, channels averaged: (fs,
    float32 [n]). Raises UnsupportedWav for other sample formats and
    ZenError for a file it cannot parse."""
    lib = library()
    info = WavInfo()
    rc = lib.zen_wav_info(path.encode(), ctypes.byref(info))
    if rc == _WAV_UNSUPPORTED:
        raise UnsupportedWav(f"{path}: a wav sample format other than PCM16 and float32")
    if rc != 0:
        raise ZenError(f"zen_wav_info failed: {rc}")
    out = np.empty(info.n_frames, np.float32)
    rc = lib.zen_wav_read_mono(path.encode(), _floats(out), info.n_frames)
    if rc != 0:
        raise ZenError(f"zen_wav_read_mono failed: {rc}")
    return int(info.sample_rate), out


def wav_write_pcm16(path: str, fs: int, audio: np.ndarray) -> None:
    """Mono PCM16 wav of float [-1, 1] (clipped, rounded half away from
    zero)."""
    x = np.ascontiguousarray(audio, np.float32)
    rc = library().zen_wav_write_pcm16(path.encode(), int(fs), _floats(x), len(x))
    if rc != 0:
        raise ZenError(f"zen_wav_write_pcm16 failed: {rc}")


def _channels(x: np.ndarray) -> int:
    if x.ndim == 1:
        return 1
    if x.ndim == 2 and x.shape[1] in (1, 2):
        return x.shape[1]
    raise ZenError("audio must be [n] mono or [n, 2] stereo")


def flac_write(path: str, fs: int, audio: np.ndarray, bits: int = 16,
               block_size: int = 4096) -> None:
    """FLAC of float mono [n] or stereo [n, 2] at 8-24 bits, byte-identical
    to zen_tpu's (native and pure-Python) FLAC encoders."""
    x = np.ascontiguousarray(audio, np.float32)
    rc = library().zen_flac_encode(path.encode(), int(fs), _floats(x), x.shape[0],
                                   _channels(x), int(bits), int(block_size))
    if rc != 0:
        raise ZenError(f"zen_flac_encode failed: {rc}")


def wv_write(path: str, fs: int, audio: np.ndarray, bits: int = 16,
             block_samples: int = 22050) -> None:
    """WavPack of float mono [n] or L/R stereo [n, 2] at 8, 16 or 24 bits,
    byte-identical to zen_tpu's (native and pure-Python) WavPack encoders."""
    x = np.ascontiguousarray(audio, np.float32)
    rc = library().zen_wv_encode(path.encode(), int(fs), _floats(x), x.shape[0],
                                 _channels(x), int(bits), int(block_samples))
    if rc != 0:
        raise ZenError(f"zen_wv_encode failed: {rc}")


def crc8(data: bytes) -> int:
    """FLAC's frame-header CRC-8 (poly 0x07)."""
    return int(library().zen_crc8(data, len(data)))


def crc16(data: bytes) -> int:
    """FLAC's frame CRC-16 (poly 0x8005)."""
    return int(library().zen_crc16(data, len(data)))


def _decode(prefix: str, path: str, *extra):
    """Call ``<prefix>_decode_file``, copy the interleaved float32 frames
    out and free the native buffer: (fs, [frames, channels])."""
    lib = library()
    out, frames, fs, ch = _F(), _U64(), _I32(), _I32()
    rc = getattr(lib, f"{prefix}_decode_file")(
        path.encode(), ctypes.byref(out), ctypes.byref(frames), ctypes.byref(fs),
        ctypes.byref(ch), *map(ctypes.byref, extra))
    if rc != 0:
        raise ZenError(f"{prefix}_decode_file failed: {rc}")
    n = frames.value * ch.value
    try:
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    finally:
        getattr(lib, f"{prefix}_free")(out)
    return int(fs.value), arr.reshape(frames.value, ch.value)


def flac_read(path: str):
    """FLAC decode (frame CRCs and the STREAMINFO MD5 checked natively):
    (fs, float32 [frames, channels] in [-1, 1])."""
    return _decode("zen_flac", path, _I32())


def wv_read(path: str):
    """WavPack decode (block CRCs checked natively): (fs, [frames, channels])."""
    return _decode("zen_wv", path)


def opus_read(path: str):
    """Ogg Opus decode, always at 48 kHz: (fs, [frames, channels])."""
    return _decode("zen_opus", path)


def vorbis_read(path: str):
    """Ogg Vorbis decode: (fs, [frames, channels])."""
    return _decode("zen_vorbis", path)


def mp3_read(path: str):
    """MPEG-1/2/2.5 Layer III decode: (fs, [frames, channels])."""
    return _decode("zen_mp3", path)


def mpc_read(path: str):
    """Musepack SV8 decode: (fs, [frames, channels])."""
    return _decode("zen_mpc", path)
