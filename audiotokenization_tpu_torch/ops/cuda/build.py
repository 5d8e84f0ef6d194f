"""Build the package's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so
nvcc takes seconds) and is compiled on first use for Hopper into
``<cache>/kernels/<name>-<hash>.so``, the hash taken over the source and
every ``csrc/*.cuh`` header it may include, and ``<cache>`` the port's
``utils/compile_cache.py::kernel_cache_dir()`` (``build/`` beside the
package in a source tree). The sources ship with the package (its package
data), so an installed port builds from its own copy:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

No ``--use_fast_math``: the kernels' sinf/expf/sqrtf and divisions stay
IEEE-accurate, or tokens drift from the plain versions. A failed build
raises; nothing falls back. ``build_all`` starts one nvcc per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ...utils.compile_cache import PACKAGE_DIR, kernel_cache_dir

CSRC_DIR = PACKAGE_DIR / "csrc"
KERNELS = ("vq_argmin", "residual_unit", "probe_unit")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                           "or set CUDA_HOME")
    return str(path)


def build_dir() -> Path:
    """Where the libraries are built and found: ``<cache>/kernels``."""
    return kernel_cache_dir() / "kernels"


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every source in ``names`` whose library is missing, one nvcc
    process each, all started together. Returns each source's ptxas report
    (registers, shared memory, spills); raises if any build fails."""
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{reports[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiling it on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
