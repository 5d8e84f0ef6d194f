"""Audio file I/O (counterpart of ``audiotokenization_tpu/data/audio_io.py``).

- WAV: parsed with the standard library (PCM16/24/32 and float32) and
  written as PCM16.
- FLAC: the repo's native decoder (``native/flacdec.cpp``, ``data/flac.py``).

Samples are float32 in [-1, 1], channel first: (channels, T).
"""
from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np


def read_wav(path) -> tuple[np.ndarray, int]:
    """Returns (samples float32 (channels, T) normalized to [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file: {path}")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x << 8 >> 8).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit: {path}")
    return x.reshape(-1, channels).T.copy(), sr


def write_wav(path, samples: np.ndarray, sample_rate: int):
    """samples: (T,) or (channels, T) float in [-1, 1] -> PCM16 WAV."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None]
    pcm = np.clip(x.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_flac(path) -> tuple[np.ndarray, int]:
    from .flac import decode_flac_file

    return decode_flac_file(path)


def read_audio(path) -> tuple[np.ndarray, int]:
    """Dispatch by extension. Returns (float32 (channels, T), sample_rate)."""
    suffix = Path(path).suffix.lower()
    if suffix == ".wav":
        return read_wav(path)
    if suffix == ".flac":
        return read_flac(path)
    raise ValueError(f"unsupported audio format: {path}")
