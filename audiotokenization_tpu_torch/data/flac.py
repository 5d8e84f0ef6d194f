"""ctypes binding of the FLAC decoder (counterpart of
``audiotokenization_tpu/data/flac.py``), from the port's own copy of the
repo's ``native/flacdec.cpp``: ``csrc/flacdec.cpp``, which ships with the
package.

The first decode compiles the source with ``g++ -O3`` into
``<cache>/native/libflacdec-<hash>.so`` (``<cache>``: the port's
``utils/compile_cache.py::kernel_cache_dir()``, ``build/`` beside the
package in a source tree; the hash is the source's, so an edited source
builds anew). A failed build raises; there is no other decoder. Samples
come back as float32 in [-1, 1], (channels, T), as ``audio_io.read_wav``
returns them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.compile_cache import PACKAGE_DIR, kernel_cache_dir

_SRC = PACKAGE_DIR / "csrc" / "flacdec.cpp"
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return kernel_cache_dir() / "native" / f"libflacdec-{digest}.so"


def _build(so: Path):
    """Compile into a file of this process's own, then rename it into place,
    so that a concurrent process never loads a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the FLAC decoder failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, so)


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.flac_decode.restype = ctypes.c_int
        lib.flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.flac_free.restype = None
        lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
        return lib


def decode_flac_bytes(data: bytes) -> tuple[np.ndarray, int]:
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_int64()
    ch = ctypes.c_int()
    sr = ctypes.c_int()
    bps = ctypes.c_int()
    rc = lib.flac_decode(data, len(data), ctypes.byref(out), ctypes.byref(n),
                         ctypes.byref(ch), ctypes.byref(sr), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc})")
    try:
        count = n.value * ch.value
        arr = np.ctypeslib.as_array(out, shape=(count,)).copy()
    finally:
        lib.flac_free(out)
    scale = float(1 << (bps.value - 1))
    x = (arr.astype(np.float32) / scale).reshape(n.value, ch.value).T.copy()
    return x, sr.value


def decode_flac_file(path) -> tuple[np.ndarray, int]:
    return decode_flac_bytes(Path(path).read_bytes())
