// K2: the BigCodec ResidualUnit on Hopper (sm_90a), in split-TF32.
//
//   out = x + W1 . snake2(W7 *_d snake1(x) + b7) + b1
//
// with snake(v) = v + sin^2(e^alpha v) / (e^beta + 1e-9) per channel, W7 a
// k=7 conv of dilation d and zero padding 3d, W1 pointwise, all fp32,
// activations (B, C, T).
//
// Replaces the Pallas TPU kernels of
// audiotokenization_tpu/ops/pallas/residual_unit_kernel.py
// (fused_residual_unit: _unit_kernel, _unit_kernel_v2 .. _unit_kernel_v5, five
// schedules of this one function). Unlike them it takes every channel count,
// C = 768 included.
//
// What bounds it on the H100: 16*C^2*T flops per sample against about 20
// bytes per (c, t) for two passes, so the unit is bound by operations at
// every codec width. The JAX reference computes its dots at
// Precision.HIGHEST, which the TPU's MXU runs as several bf16 passes; the
// counterpart here is split-TF32, three TF32 tensor-core products per fp32
// product: 495 / 3 = 165 TFLOP/s of fp32-grade products against the 67 of
// the SIMT pipes. For the main path's 30 launches (15 shapes of one
// tokenize, 15 of one decode, B = 32) the bound falls from 36.17 ms (fp32
// SIMT) to 14.7 ms (split-TF32); bytes take 1.94 ms per tokenize.
//
// Design (split_tf32_unit.cuh): two launches on the caller's stream,
//   (a) z   = snake2(W7 *_d snake1(x) + b7)   implicit GEMM, M = C_out,
//       N = time, K = 7 C_in, B read as 7 shifted views of one staged tile
//       of snake1(x) with its 3d halo; b7 and snake2 in the epilogue;
//   (b) out = x + W1 . z + b1                 plain GEMM on the same machinery.
// mma.sync m16n8k8 TF32 (not wgmma: the tap offsets tap * d break the
// descriptors' alignment), each 8-channel stage's products summed from zero
// and added to fp32 accumulators with a rounded add (one TF32 sum over all
// of K drifts 6-28x past fp32's error); the hi/lo split taken once
// per staged element; a two-slot cp.async ring with one barrier per stage.
// Tiles: 48 x 256 where C is not a multiple of 96 (C = 48), else 96 x 256,
// or 96 x 200 at T = 400 (no padded column; its pointwise pass 48 x 200);
// each warp owns 48 x 64 (or 48 x 40) outputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, without fast math.
#include "split_tf32_unit.cuh"

extern "C" {

// x, z, out (B, C, T); w7 (C, C, 7); w1 (C, C, 1); b7, b1, alpha1, beta1,
// alpha2, beta2 (C,): fp32, contiguous, one device. z is scratch for
// snake2(y). Returns the cudaError_t of the launches (0 on success).
int residual_unit_launch(const float* x, const float* w7, const float* b7,
                         const float* w1, const float* b1, const float* alpha1,
                         const float* beta1, const float* alpha2, const float* beta2,
                         float* z, float* out, int B, int C, int T, int dilation,
                         void* stream) {
  return (int)tf32unit::unit_launch<tf32unit::kSnake, false>(
      x, w7, b7, w1, b1, alpha1, beta1, alpha2, beta2, z, out, B, C, T, dilation,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
