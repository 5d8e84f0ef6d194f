"""K1: fused L2-normalise + distance + argmin codebook search.

Counterpart of ``audiotokenization_tpu/ops/pallas/vq_kernel.py::vq_argmin``.
On a CUDA tensor ``vq_argmin`` launches the Hopper kernel of
``csrc/vq_argmin.cu``; on a CPU tensor it computes ``vq_argmin_plain``, the
JAX package's XLA expression (``factorized_vq.py::nearest_code_indices``
with ``use_pallas=False``), which the kernel is held against.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

MAX_D = 32


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """F.normalize: x / max(‖x‖, eps)."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(n, eps)


def vq_argmin_plain(enc, codebook):
    """enc (M, D), codebook (N, D) -> (M,) int32: argmin over codes of the
    fp32 (‖e‖² - 2e·c) + ‖c‖² between the normalised rows, lowest index on ties."""
    enc_n = l2_normalize(enc.float())
    cb_n = l2_normalize(codebook.float())
    dist = (torch.sum(enc_n * enc_n, dim=1, keepdim=True)
            - 2.0 * (enc_n @ cb_n.T)
            + torch.sum(cb_n * cb_n, dim=1)[None, :])
    return torch.argmin(dist, dim=1).to(torch.int32)


def _lib():
    lib = build.load("vq_argmin")
    if lib.vq_argmin_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vq_argmin_tiles.argtypes = [i]
        lib.vq_argmin_tiles.restype = i
        lib.vq_argmin_launch.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.vq_argmin_launch.restype = i
    return lib


def _check(enc, codebook):
    if not (enc.is_cuda and codebook.device == enc.device):
        raise ValueError(f"vq_argmin: tensors must share one CUDA device, got "
                         f"{enc.device} and {codebook.device}")
    for name, t in (("enc", enc), ("codebook", codebook)):
        if t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"vq_argmin: {name} must be a contiguous 2-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    (m, d), (n, dc) = enc.shape, codebook.shape
    if d != dc or not 1 <= d <= MAX_D or n < 1 or n >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"vq_argmin: the kernel takes D <= {MAX_D} and "
                         f"matching widths, got enc {tuple(enc.shape)}, "
                         f"codebook {tuple(codebook.shape)}")


def vq_argmin(enc, codebook):
    """enc: (M, D) fp32 latents; codebook: (N, D). Returns (M,) int32 indices.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (counted in ``vq_argmin.launches``) for any M and N and D <= 32, or
    raise; nothing falls back.
    """
    if enc.device.type == "cpu":
        return vq_argmin_plain(enc, codebook)
    _check(enc, codebook)
    m, d = enc.shape
    n = codebook.shape[0]
    cb_n = l2_normalize(codebook)
    sc = torch.sum(cb_n * cb_n, dim=1)
    if d % 8:  # the kernel is built for D in {8, 16, 24, 32}; zeros change no norm or dot
        pad = 8 - d % 8
        enc, cb_n = F.pad(enc, (0, pad)), F.pad(cb_n, (0, pad))
    out = torch.empty((m,), dtype=torch.int32, device=enc.device)
    if m == 0:
        return out
    lib = _lib()
    partial = torch.empty((m, lib.vq_argmin_tiles(n)), dtype=torch.int64,
                          device=enc.device)
    with torch.cuda.device(enc.device):
        err = lib.vq_argmin_launch(
            enc.data_ptr(), cb_n.data_ptr(), sc.data_ptr(), partial.data_ptr(),
            out.data_ptr(), m, n, enc.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin kernel launch failed: CUDA error {err}")
    vq_argmin.launches += 1
    return out


vq_argmin.launches = 0
