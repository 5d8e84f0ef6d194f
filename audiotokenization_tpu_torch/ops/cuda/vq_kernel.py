"""K1: fused L2-normalise + distance + argmin codebook search.

Counterpart of ``audiotokenization_tpu/ops/pallas/vq_kernel.py::vq_argmin``.
On a CUDA tensor ``vq_argmin`` launches the Hopper kernel of
``csrc/vq_argmin.cu``: one thread-block-cluster launch that normalises the
raw codebook on chip, with no PyTorch op around it (at D = 8 a call is one
device kernel). Its geometry comes from ``k1_geometry``. On a CPU tensor it
computes ``vq_argmin_plain``, the JAX package's XLA expression
(``factorized_vq.py::nearest_code_indices`` with ``use_pallas=False``),
which the kernel is held against.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


class K1Geometry(NamedTuple):
    """How ``csrc/vq_argmin.cu`` lays one call out: ``clusters`` clusters of
    ``cluster_size`` blocks; a cluster takes ``rows`` rows, block s of it the
    codes [s * share, (s + 1) * share) (the last one fewer), streamed through
    ``buffers`` shared-memory tiles of ``tile`` codes."""
    d: int             # D padded to a multiple of 8, the width the kernel is built for
    rows: int          # rows per cluster: 32 row groups x rows per thread
    clusters: int
    cluster_size: int  # S <= 8 blocks, each owning one share of the codes
    share: int
    tile: int
    buffers: int       # 1, or 2 where a share streams through tiles
    smem_bytes: int    # the rows' keys, the rows and ||e||^2, then the tiles (planes + ||c||^2)


THREADS, LANES = 256, 8    # a block: 32 row groups x 8 code lanes
ROWS_PER_THREAD = {8: 3, 16: 2}  # else 1; as csrc/vq_argmin.cu::rows_per_thread
MAX_CLUSTER = 8            # the portable cluster size
TILE_FLOATS = 2048         # a tile's planes: 256 codes at D = 8, 64 at D = 32


@functools.lru_cache(maxsize=256)
def k1_geometry(m: int, n: int, d: int) -> K1Geometry:
    """The launch geometry of ``vq_argmin`` for enc (m, d) and a codebook
    (n, d); the kernel refuses any that does not fit its layout. Shared
    memory stays under 48 KB (24 KB at the flagship)."""
    d = -(-d // 8) * 8
    rows = (THREADS // LANES) * ROWS_PER_THREAD.get(d, 1)
    s = min(MAX_CLUSTER, n)
    share = -(-n // s)
    s = -(-n // share)  # no block without codes
    tile = min(share, TILE_FLOATS // d)
    buffers = 1 if share <= tile else 2
    smem = rows * (8 + 4 * (d + 1)) + buffers * 4 * (tile * d + -(-tile // 4) * 4)
    return K1Geometry(d, rows, -(-m // rows), s, share, tile, buffers, smem)


def k1_shares(g: K1Geometry, n: int) -> list[tuple[int, int]]:
    """[start, stop) of the codes each block of a cluster owns, in rank order."""
    return [(s * g.share, min(n, (s + 1) * g.share)) for s in range(g.cluster_size)]


def _lib():
    lib = build.load("vq_argmin")
    if lib.vq_argmin_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vq_argmin_max_clusters.argtypes = [i, i, i]
        lib.vq_argmin_max_clusters.restype = i
        lib.vq_argmin_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        lib.vq_argmin_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _placeable(device: int, d: int, cluster_size: int, smem_bytes: int) -> None:
    """Once per device and cluster shape: raise unless the card can place one
    such cluster at once."""
    n = _lib().vq_argmin_max_clusters(d, cluster_size, smem_bytes)
    if n <= 0:
        raise RuntimeError(f"vq_argmin: the card places no cluster of {cluster_size} blocks "
                           f"with {smem_bytes} bytes of shared memory each "
                           f"({'CUDA error ' + str(-n) if n else '0 clusters'})")


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


def _launch(enc, codebook):
    """One launch of the kernel, counted; raises on anything it does not take."""
    _check(enc, codebook)
    m, d = enc.shape
    n = codebook.shape[0]
    if d % 8:  # the kernel is built for D in {8, 16, 24, 32}; zeros change no norm or dot
        pad = 8 - d % 8
        enc, codebook = F.pad(enc, (0, pad)), F.pad(codebook, (0, pad))
    out = torch.empty((m,), dtype=torch.int32, device=enc.device)
    if m == 0:
        return out
    g = k1_geometry(m, n, d)
    with torch.cuda.device(enc.device):
        _placeable(enc.device.index, g.d, g.cluster_size, g.smem_bytes)
        err = _lib().vq_argmin_launch(
            enc.data_ptr(), codebook.data_ptr(), out.data_ptr(), m, n, g.d, g.cluster_size,
            g.share, g.tile, g.rows, g.smem_bytes, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin kernel launch failed: CUDA error {err}")
    vq_argmin.launches += 1
    return out


class VQArgminFn(torch.autograd.Function):
    """K1 under autograd, the counterpart of the JAX kernel's custom VJP
    (zero cotangents): the launch records no graph, its int32 indices are
    not differentiable, and the backward gives ``enc`` and ``codebook`` no
    gradient. The VQ around it trains through its straight-through
    estimator and commitment losses."""

    @staticmethod
    def forward(ctx, enc, codebook):
        out = _launch(enc, codebook)
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return None, None


def vq_argmin(enc, codebook):
    """enc: (M, D) fp32 latents; codebook: (N, D). Returns (M,) int32 indices.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (counted in ``vq_argmin.launches``) for any M and N and D <= 32, or
    raise; nothing falls back. No gradient flows through the search.
    """
    if enc.device.type == "cpu":
        return vq_argmin_plain(enc, codebook)
    return VQArgminFn.apply(enc, codebook)


vq_argmin.launches = 0
