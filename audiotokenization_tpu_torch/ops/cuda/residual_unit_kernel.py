"""K2: the BigCodec ResidualUnit as one call.

    out = x + W1 · snakeβ₂(W7 ⊛_d snakeβ₁(x) + b7) + b1

Counterpart of ``audiotokenization_tpu/ops/pallas/residual_unit_kernel.py::
fused_residual_unit`` (non-causal, no anti-aliasing). On CUDA tensors
``fused_residual_unit`` launches the Hopper kernel of
``csrc/residual_unit.cu`` (two split-TF32 tensor-core passes, see
``csrc/split_tf32_unit.cuh``), for every channel count, inside
``ResidualUnitFn``, whose backward recomputes the unit with autograd; on
CPU tensors it computes ``residual_unit_plain``, the unit as the JAX
package's XLA path computes it (``models/bigcodec.py::residual_unit``).
The kernel, the plain version and the backward's recompute all compute
the snakes as sin² (``ops/snake.py``'s ``cos_form`` is not used here).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..snake import snake_beta
from . import build


def residual_unit_plain(x, w7, b7, w1, b1, alpha1, beta1, alpha2, beta2, *,
                        dilation: int):
    y = snake_beta(x, alpha1, beta1)
    y = F.conv1d(y, w7, b7, padding=3 * dilation, dilation=dilation)
    y = snake_beta(y, alpha2, beta2)
    return x + F.conv1d(y, w1, b1)


def _lib():
    lib = build.load("residual_unit")
    if lib.residual_unit_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.residual_unit_launch.argtypes = [p] * 11 + [i] * 4 + [p]
        lib.residual_unit_launch.restype = i
    return lib


def _check(x, tensors, dilation):
    if not x.is_cuda:
        raise ValueError(f"fused_residual_unit: expected a CUDA tensor, got {x.device}")
    if x.ndim != 3:
        raise ValueError(f"fused_residual_unit: x must be (B, C, T), got {tuple(x.shape)}")
    B, C, T = x.shape
    shapes = {"w7": (C, C, 7), "b7": (C,), "w1": (C, C, 1), "b1": (C,),
              "alpha1": (C,), "beta1": (C,), "alpha2": (C,), "beta2": (C,)}
    for name, t in {"x": x, **tensors}.items():
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_residual_unit: {name} must be contiguous float32 "
                             f"on {x.device}, got {t.dtype} on {t.device}")
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_residual_unit: {name} must be {shapes[name]}, "
                             f"got {tuple(t.shape)}")
    # the two staging slots and the snake parameters fit in shared memory
    if not (1 <= dilation <= 64 and 1 <= B <= 65535 and 1 <= C <= 4096
            and 1 <= T < 2 ** 31):
        raise ValueError(f"fused_residual_unit: the kernel takes dilation <= 64, "
                         f"B <= 65535, C <= 4096, got dilation {dilation}, "
                         f"shape {tuple(x.shape)}")


def _launch(x, w7, b7, w1, b1, alpha1, beta1, alpha2, beta2, *, dilation: int):
    """One launch of the kernel on fp32 CUDA tensors, counted; raises on
    anything the kernel does not take."""
    tensors = {"w7": w7, "b7": b7, "w1": w1, "b1": b1, "alpha1": alpha1,
               "beta1": beta1, "alpha2": alpha2, "beta2": beta2}
    _check(x, tensors, dilation)
    B, C, T = x.shape
    z = torch.empty_like(x)  # snake2 of the k7 conv, between the kernel's two passes
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.residual_unit_launch(
            x.data_ptr(), *(t.data_ptr() for t in tensors.values()),
            z.data_ptr(), out.data_ptr(), B, C, T, dilation,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"residual_unit kernel launch failed: CUDA error {err}")
    fused_residual_unit.launches += 1
    return out


class ResidualUnitFn(torch.autograd.Function):
    """K2 under autograd. Forward: ``launch`` (the kernel; a test hands in
    another callable of the same signature), on fp32 copies of bf16 inputs,
    the result cast back. It saves only the inputs. Backward: the unit is
    recomputed with ``residual_unit_plain`` in the caller's dtype under
    autograd, which returns the gradients for all nine inputs; a remat of
    one unit, and what the JAX package differentiates (XLA), since its K2
    has no VJP."""

    @staticmethod
    def forward(ctx, launch, dilation, *inputs):
        ctx.dilation = dilation
        ctx.save_for_backward(*inputs)
        dtype = inputs[0].dtype
        if dtype == torch.bfloat16:
            inputs = [t.float().contiguous() for t in inputs]
        return launch(*inputs, dilation=dilation).to(dtype)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = residual_unit_plain(*inputs, dilation=ctx.dilation)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def fused_residual_unit(x, w7, b7, w1, b1, alpha1, beta1, alpha2, beta2, *,
                        dilation: int):
    """x (B, C, T) fp32 or bf16; w7 (C, C, 7); w1 (C, C, 1); biases and
    log-scale snake parameters (C,), all of x's dtype. Returns (B, C, T).

    CPU tensors take the plain version (autograd as usual). CUDA tensors go
    through ``ResidualUnitFn``: the kernel's launch (counted once per call
    in ``fused_residual_unit.launches``) or an error, and a differentiable
    result; nothing falls back.
    """
    args = (x, w7, b7, w1, b1, alpha1, beta1, alpha2, beta2)
    if x.device.type == "cpu":
        return residual_unit_plain(*args, dilation=dilation)
    return ResidualUnitFn.apply(_launch, dilation, *args)


fused_residual_unit.launches = 0
