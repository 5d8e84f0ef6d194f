// The throughput ceiling of mma.sync.m16n8k8 TF32 on this card: a
// measurement, not a kernel of any path (ops/cuda/mma_peak.py runs it).
//
// Each warp issues K2's product pattern from registers only, with no memory
// traffic: 3 row tiles x 8 column tiles x 3 split-TF32 products per k-chunk.
//   mode 0: the products accumulate in the tensor cores (acc += a . b), as
//           K2's stage sums do;
//   mode 1: each k-chunk's three products sum from zero in a temporary
//           fragment, then one rounded add per accumulator.
// What one launch reaches is the most a split-TF32 kernel built on
// mma.sync can reach, whatever its staging.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MODE>
__global__ void __launch_bounds__(256) peak_kernel(float* out, int iters) {
  uint32_t ah[3][4], al[3][4], bh[8][2], bl[8][2];
  for (int i = 0; i < 3; ++i)
    for (int r = 0; r < 4; ++r) {
      ah[i][r] = 0x3f800000u + 977u * (i + 4 * r + threadIdx.x);  // values near 1
      al[i][r] = ah[i][r] - 0x06000000u;                           // ~2^-12 of them
    }
  for (int j = 0; j < 8; ++j)
    for (int r = 0; r < 2; ++r) {
      bh[j][r] = 0x3f800000u + 631u * (j + 8 * r + threadIdx.x);
      bl[j][r] = bh[j][r] - 0x06000000u;
    }
  float acc[3][8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (MODE == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma(acc[i][j], al[i], bh[j]);
          mma(acc[i][j], ah[i], bl[j]);
          mma(acc[i][j], ah[i], bh[j]);
        }
      } else {
        float t[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int r = 0; r < 4; ++r) t[i][r] = 0.f;
          mma(t[i], al[i], bh[j]);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) mma(t[i], ah[i], bl[j]);
#pragma unroll
        for (int i = 0; i < 3; ++i) mma(t[i], ah[i], bh[j]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += t[i][r];
      }
    }
  }
  float s = 0.f;  // keep every product live
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 8; ++j)
      for (int r = 0; r < 4; ++r) s += acc[i][j][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// out: blocks * 256 floats. 72 mma per warp per iteration. Returns the
// cudaError_t of the launch.
int mma_peak_launch(float* out, int blocks, int iters, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    peak_kernel<0><<<blocks, 256, 0, s>>>(out, iters);
  else
    peak_kernel<1><<<blocks, 256, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
