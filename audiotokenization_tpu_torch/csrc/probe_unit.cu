// P1: the time-major timing probe's unit on Hopper (sm_90a), in split-TF32.
//
//   out = x + sin(sin(x) *_d W7) . W1      x, out (B, T, C); no biases
//
// Replaces the Pallas TPU kernel of scripts/probe_v5.py (make_call's kernel,
// pallas_call at :78): a cut-down K2 with sin for both activations, no
// biases and time-major activations, which the TPU probe timed as seven
// shifted dots and as one im2col dot.
//
// It is K2's template (split_tf32_unit.cuh) instantiated with sin and the
// time-major layout: the kernel reads and writes (B, T, C) itself, so no
// activation is transposed around the launch. The wrapper lays the weights
// out as K2's (C, C, 7) and (C, C, 1). Bounds and design as K2's
// (residual_unit.cu): operations at every width, split-TF32 at 165 TFLOP/s
// of fp32-grade products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, without fast math.
#include "split_tf32_unit.cuh"

extern "C" {

// x, z, out (B, T, C); w7 (C, C, 7); w1 (C, C, 1): fp32, contiguous, one
// device. z is scratch for sin(y). Returns the cudaError_t of the launches.
int probe_unit_launch(const float* x, const float* w7, const float* w1, float* z, float* out,
                      int B, int C, int T, int dilation, void* stream) {
  return (int)tf32unit::unit_launch<tf32unit::kSin, true>(
      x, w7, nullptr, w1, nullptr, nullptr, nullptr, nullptr, nullptr, z, out, B, C, T,
      dilation, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
