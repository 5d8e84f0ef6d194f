"""Where the port keeps what it compiles (counterpart of
``audiotokenization_tpu/utils/compile_cache.py``, JAX's persistent XLA
cache).

The port's compiled artefacts are the shared libraries it builds on first
use: the CUDA kernels (``ops/cuda/build.py``, under ``kernels/``) and the
FLAC decoder (``data/flac.py``, under ``native/``). Each is named by the
hash of its sources, so a library built once is loaded by every later
invocation and an edited source builds anew. ``kernel_cache_dir()`` is the
first of:

1. ``$ATT_TORCH_CACHE``, when it is set;
2. ``build/`` beside the package, when the package sits in a source tree
   (a ``pyproject.toml`` in its parent directory);
3. ``~/.cache/audiotokenization_tpu_torch`` (an installed package, whose
   directory may not be writable).

It is read at each build, so a process may set the variable before its
first kernel call.
"""
from __future__ import annotations

import os
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
ENV = "ATT_TORCH_CACHE"


def kernel_cache_dir() -> Path:
    env = os.environ.get(ENV)
    if env:
        return Path(env).expanduser()
    if (PACKAGE_DIR.parent / "pyproject.toml").is_file():
        return PACKAGE_DIR.parent / "build"
    return Path.home() / ".cache" / "audiotokenization_tpu_torch"
