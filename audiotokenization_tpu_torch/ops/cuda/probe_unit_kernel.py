"""P1: the time-major timing probe's unit as one call.

    out = x + sin(sin(x) ⊛_d W7) · W1        x, out (B, T, C); no biases

Counterpart of the Pallas kernel in ``scripts/probe_v5.py`` (``make_call``),
a cut-down ResidualUnit with sin for both activations, and its XLA oracle
``xla_unit``. Weights come in the probe's layouts: ``w7t`` (7C, C) with
``w7t[tap * C + ci, co] = W7[co, ci, tap]`` and ``w1t`` (C, C) with
``w1t[ci, co] = W1[co, ci]``. On CUDA tensors ``probe_unit`` launches K2's
split-TF32 template instantiated for this unit (``csrc/probe_unit.cu``); on
CPU tensors it computes ``probe_unit_plain``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build


def _oih(w7t, w1t):
    """The probe's weights as conv weights: W7 (C, C, 7), W1 (C, C, 1)."""
    C = w1t.shape[0]
    return (w7t.reshape(7, C, C).permute(2, 1, 0).contiguous(),
            w1t.t().contiguous()[:, :, None])


def probe_unit_plain(x, w7t, w1t, *, dilation: int = 3):
    """``xla_unit`` of the probe in PyTorch, taking and returning (B, T, C)."""
    w7, w1 = _oih(w7t, w1t)
    xc = x.transpose(1, 2)
    y = F.conv1d(torch.sin(xc), w7, padding=3 * dilation, dilation=dilation)
    return (xc + F.conv1d(torch.sin(y), w1)).transpose(1, 2).contiguous()


def _lib():
    lib = build.load("probe_unit")
    if lib.probe_unit_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_unit_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.probe_unit_launch.restype = i
    return lib


def _check(x, w7t, w1t, dilation):
    if not x.is_cuda:
        raise ValueError(f"probe_unit: expected a CUDA tensor, got {x.device}")
    if x.ndim != 3:
        raise ValueError(f"probe_unit: x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    for name, t, shape in (("x", x, None), ("w7t", w7t, (7 * C, C)), ("w1t", w1t, (C, C))):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"probe_unit: {name} must be contiguous float32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"probe_unit: {name} must be {shape}, got {tuple(t.shape)}")
    # the two time-major staging slots fit in shared memory
    if not (1 <= dilation <= 64 and 1 <= B <= 65535 and 1 <= C <= 4096 and 1 <= T < 2 ** 31):
        raise ValueError(f"probe_unit: the kernel takes dilation <= 64, B <= 65535, "
                         f"C <= 4096, got dilation {dilation}, shape {tuple(x.shape)}")


def probe_unit(x, w7t, w1t, *, dilation: int = 3):
    """x (B, T, C) fp32; w7t (7C, C); w1t (C, C). Returns (B, T, C).

    The probe's own ``call`` returns (B, t_pad, C), whose rows from T on are
    padding; this returns the T real rows only.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (counted once per call in ``probe_unit.launches``) or raise; nothing
    falls back.
    """
    if x.device.type == "cpu":
        return probe_unit_plain(x, w7t, w1t, dilation=dilation)
    _check(x, w7t, w1t, dilation)
    B, T, C = x.shape
    w7, w1 = _oih(w7t, w1t)
    z = torch.empty_like(x)  # sin of the k7 conv, between the kernel's two passes
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.probe_unit_launch(x.data_ptr(), w7.data_ptr(), w1.data_ptr(), z.data_ptr(),
                                    out.data_ptr(), B, C, T, dilation,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe_unit kernel launch failed: CUDA error {err}")
    probe_unit.launches += 1
    return out


probe_unit.launches = 0
