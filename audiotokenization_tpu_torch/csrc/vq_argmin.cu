// K1: nearest-code search of the factorized VQ on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotokenization_tpu/ops/pallas/vq_kernel.py
// (_vq_argmin_kernel, launched by _vq_argmin_call through vq_argmin). For each
// latent row e (M x D) it L2-normalises the row, x / max(||x||, 1e-12), forms
// the fp32 distance (||e||^2 - 2 e.c) + ||c||^2 to every code c of the
// pre-normalised codebook (N x D) and returns the argmin, ties to the lowest
// index. The codebook's normalisation and ||c||^2 are computed by the caller.
//
// What bounds it on the H100: 2*M*N*D flops (335.5 MFLOP for the flagship,
// M = 2560, N = 8192, D = 8) against 67 TFLOP/s of fp32 is about 5 us, and
// the bytes (~0.35 MB) less than that, so the kernel is compute-bound on
// paper and launch overhead dominates in practice.
//
// Design. The flagship codebook (8192 x 8 x 4 B = 256 KB) exceeds the 227 KB
// of shared memory a block may hold, and 2560 rows alone would occupy only a
// few of the 132 SMs. So the grid splits both ways: blockIdx.x takes 128 rows
// (one per thread, the row and its norm kept in registers), blockIdx.y takes a
// tile of 256 codes staged once in shared memory and read as broadcasts. Each
// thread scans its tile in increasing index with a strict '<', so the lowest
// index wins inside a tile, and writes one 64-bit key per (row, tile):
// order-preserving distance bits << 32 | code index. A second kernel takes the
// minimum key over the tiles of each row, which is the exact lowest-index
// argmin, with no atomics and the same result on every run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, without fast math:
// sqrtf and the divisions stay IEEE-accurate.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // rows per block, one per thread
constexpr int kCodes = 256;  // codes per block, staged in shared memory

// Unsigned integer order equals float order (for non-NaN values).
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int D>
__global__ void __launch_bounds__(kRows)
vq_partial_kernel(const float* __restrict__ enc, const float* __restrict__ cbn,
                  const float* __restrict__ sc, unsigned long long* __restrict__ partial,
                  int M, int N) {
  __shared__ float cs[kCodes * D];
  __shared__ float ss[kCodes];
  const int tile = blockIdx.y;
  const int base = tile * kCodes;
  const int n_here = min(kCodes, N - base);
  for (int i = threadIdx.x; i < n_here * D; i += kRows) cs[i] = cbn[(size_t)base * D + i];
  for (int i = threadIdx.x; i < n_here; i += kRows) ss[i] = sc[base + i];
  __syncthreads();

  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= M) return;
  float e[D];
  float nrm2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    e[d] = enc[(size_t)row * D + d];
    nrm2 += e[d] * e[d];
  }
  const float den = fmaxf(sqrtf(nrm2), 1e-12f);
  float se = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    e[d] = e[d] / den;
    se += e[d] * e[d];
  }

  float best = INFINITY;
  int best_j = 0;
  for (int j = 0; j < n_here; ++j) {
    float cross = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) cross += e[d] * cs[j * D + d];
    const float dist = (se - 2.f * cross) + ss[j];
    if (dist < best) {
      best = dist;
      best_j = j;
    }
  }
  partial[(size_t)row * gridDim.y + tile] =
      ((unsigned long long)ordered_bits(best) << 32) | (uint32_t)(base + best_j);
}

__global__ void vq_reduce_kernel(const unsigned long long* __restrict__ partial,
                                 int* __restrict__ out, int M, int tiles) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  unsigned long long best = ~0ull;
  for (int t = 0; t < tiles; ++t) {
    const unsigned long long k = partial[(size_t)row * tiles + t];
    best = k < best ? k : best;
  }
  out[row] = (int)(best & 0xffffffffu);
}

template <int D>
void launch_partial(const float* enc, const float* cbn, const float* sc,
                    unsigned long long* partial, int M, int N, cudaStream_t s) {
  const dim3 grid((M + kRows - 1) / kRows, (N + kCodes - 1) / kCodes);
  vq_partial_kernel<D><<<grid, kRows, 0, s>>>(enc, cbn, sc, partial, M, N);
}

}  // namespace

extern "C" {

// Number of code tiles, i.e. the width of the (M, tiles) int64 scratch.
int vq_argmin_tiles(int N) { return (N + kCodes - 1) / kCodes; }

// enc (M, D), cbn (N, D), sc (N,) fp32 contiguous; D in {8, 16, 24, 32};
// partial (M, vq_argmin_tiles(N)) int64 scratch; out (M,) int32.
// Returns the cudaError_t of the launches (0 on success).
int vq_argmin_launch(const float* enc, const float* cbn, const float* sc,
                     unsigned long long* partial, int* out, int M, int N, int D,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: launch_partial<8>(enc, cbn, sc, partial, M, N, s); break;
    case 16: launch_partial<16>(enc, cbn, sc, partial, M, N, s); break;
    case 24: launch_partial<24>(enc, cbn, sc, partial, M, N, s); break;
    case 32: launch_partial<32>(enc, cbn, sc, partial, M, N, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vq_reduce_kernel<<<(M + 255) / 256, 256, 0, s>>>(partial, out, M, vq_argmin_tiles(N));
  return (int)cudaGetLastError();
}

}  // extern "C"
