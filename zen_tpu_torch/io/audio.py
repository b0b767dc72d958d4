"""Audio file I/O of the port (counterpart of ``zen_tpu/io/audio.py``).

The reference's libnyquist decode and encode (zen/offline.h:88-117,
193-253) over the repository's native codecs (``runtime/native.py``):
containers are sniffed by their magic, channels averaged to mono, stems
peak-normalized and written as 16-bit wav, FLAC or WavPack. Every codec
goes through the native library, wav too. The one exception is a wav
sample format that the native parser does not decode (8-, 24- or 32-bit
integers, WAVE_FORMAT_EXTENSIBLE): those go through scipy's reader, as
they do in zen_tpu. No pure-Python FLAC or WavPack codec stands behind
the library (zen_tpu's ``io/flac.py`` and ``io/wavpack.py``, which its
native encoders match byte for byte, are not carried).
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile

from ..errors import ZenError
from ..runtime import native


def skip_id3(data: bytes) -> int:
    """Bytes to skip for a leading ID3v2 tag (0 when absent): its
    synchsafe size (7 bits a byte) plus the 10-byte header, plus 10 more
    when the footer flag (bit 4) is set (zen_tpu/io/flac.py:762)."""
    if len(data) < 10 or data[:3] != b"ID3":
        return 0
    if any(b & 0x80 for b in data[6:10]):
        raise ZenError("corrupt ID3 synchsafe size")
    size = ((data[6] << 21) | (data[7] << 14) | (data[8] << 7) | data[9]) + 10
    if data[5] & 0x10:
        size += 10  # footer present
    return size


def _mono(decoded) -> tuple:
    fs, frames = decoded
    x = frames.mean(axis=1) if frames.shape[1] > 1 else frames[:, 0]
    return fs, np.ascontiguousarray(x, np.float32)


def read_audio_mono(path: str):
    """Load an audio file as float32 mono in [-1, 1]: (fs, audio). The
    container is sniffed by its magic (past a leading ID3v2 tag): RIFF
    wav, FLAC, WavPack, Ogg Vorbis, Ogg Opus (48 kHz out), MP3 and
    Musepack SV8."""
    had_id3 = False
    with open(path, "rb") as f:
        head = f.read(10)
        magic = head[:4]
        if head[:3] == b"ID3":
            # FLAC and MP3 files tagged by common tools carry an ID3v2 tag
            # before the payload; sniff past it as the decoders do
            had_id3 = True
            try:
                f.seek(skip_id3(head))
                magic = f.read(4)
            except ZenError:
                pass
    if magic[:3] == b"MP+":
        raise ZenError("legacy Musepack SV7 (MP+) is not supported; "
                       "re-encode as SV8 or transcode to wav/flac")
    if magic == b"MPCK":
        return _mono(native.mpc_read(path))
    if magic == b"OggS":
        with open(path, "rb") as f:
            page = f.read(1024)
        return _mono(native.opus_read(path) if b"OpusHead" in page else native.vorbis_read(path))
    if magic == b"wvpk":
        return _mono(native.wv_read(path))
    if magic == b"fLaC":
        return _mono(native.flac_read(path))
    if (
        (len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0
         and magic != b"\xff\xfe\x00\x00")  # an MPEG frame sync, not a UTF-32 mark
        or had_id3  # tagged and none of the above: MP3 by elimination
        or (path.lower().endswith(".mp3") and magic != b"RIFF")
    ):
        return _mono(native.mp3_read(path))
    return read_wav_mono(path)


def read_wav_mono(path: str):
    """Load a wav file as float32 mono in [-1, 1]: (fs, audio). Channels
    are averaged, as nqr::StereoToMono (zen/offline.h:106-113). PCM16 and
    float32 decode natively; other sample formats through scipy, scaled
    as zen_tpu scales them."""
    try:
        return native.wav_read_mono(path)
    except native.UnsupportedWav:
        pass
    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    return int(fs), np.ascontiguousarray(audio, np.float32)


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """Normalize to [-1, 1] by the max of (-min, max), as the reference's
    encode path (zen/offline.h:182-191). A silent signal is returned
    unchanged (the reference would divide by zero)."""
    x = np.asarray(x, np.float32)
    peak = max(-float(x.min(initial=0.0)), float(x.max(initial=0.0)))
    if peak == 0.0:
        return x
    return x / np.float32(peak)


def write_wav_pcm16(path: str, fs: int, x: np.ndarray) -> None:
    """Mono PCM16 wav of float [-1, 1], no dither (nqr::PCMFormat::PCM_16,
    zen/offline.h:193-197), byte-identical to zen_tpu's.

    zen_tpu rounds ``clip(x) * 32767`` half to even (numpy); the native
    writer rounds half away from zero. It is handed the rounded levels
    k / 32767, which it scales back to within 0.004 of k and so writes
    exactly k."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    if x.ndim != 1:
        raise ZenError(f"write_wav_pcm16 writes mono [n] audio, got shape {x.shape}")
    levels = np.round(x * 32767.0)
    native.wav_write_pcm16(path, fs, levels / np.float32(32767.0))


def write_audio_pcm16(path: str, fs: int, x: np.ndarray) -> None:
    """16-bit encode routed by extension: ``.flac`` lossless FLAC (stems at
    roughly half the wav size), ``.wv`` lossless WavPack, anything else
    PCM16 wav. Mono [n] or stereo [n, 2] for FLAC and WavPack; all three
    are byte-identical to zen_tpu's ``write_audio_pcm16``."""
    lower = path.lower()
    if lower.endswith(".wv"):
        native.wv_write(path, int(fs), np.asarray(x, np.float32), bits=16)
    elif lower.endswith(".flac"):
        native.flac_write(path, int(fs), np.asarray(x, np.float32), bits=16)
    else:
        write_wav_pcm16(path, fs, x)
