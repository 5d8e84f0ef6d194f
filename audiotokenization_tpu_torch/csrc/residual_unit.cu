// K2: the BigCodec ResidualUnit on Hopper (sm_90a).
//
//   out = x + W1 . snake2(W7 *_d snake1(x) + b7) + b1
//
// with snake(v) = v + sin^2(e^alpha v) / (e^beta + 1e-9) per channel, W7 a
// k=7 conv of dilation d and zero padding 3d, W1 pointwise, all fp32.
//
// Replaces the Pallas TPU kernels of
// audiotokenization_tpu/ops/pallas/residual_unit_kernel.py
// (fused_residual_unit: _unit_kernel, _unit_kernel_v2 .. _unit_kernel_v5, five
// schedules of this one function). Unlike them it takes every channel count,
// C = 768 included.
//
// What bounds it on the H100: 16*C^2*T flops per sample (14 C^2 for the k7
// conv, 2 C^2 for the k1) against about 8*C*T bytes, so ~2C flop/byte, far
// above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 flop/byte for every
// codec width (C = 48 .. 768): the unit is compute-bound on fp32 FMA. The
// conformant path forbids TF32, so the tensor cores are out and the ceiling
// is the 67 TFLOP/s of the SIMT pipes.
//
// Design (first, simple form). Two kernels, one launch each:
//   (a) z   = snake2(W7 *_d snake1(x) + b7)
//   (b) out = x + W1 . z + b1
// Both are direct convolutions tiled over (64 output channels x 256 time
// steps) per block of 256 threads, each thread holding an 8 x 8 register tile
// of fp32 accumulators (8 adjacent channels x 8 steps 32 apart), fed from
// shared memory by 8 conflict-free loads of the input and two 16-byte
// broadcasts of the weights per 64 FMAs (accumulate below). (a) stages 8
// input channels at a time, the x slice with its 3d halo (zero outside
// [0, T)) with snake1 applied as it is loaded, and applies snake2 once per
// output in its epilogue. (b) is a plain channel GEMM; with no snake to apply
// it streams 16 input channels at a time through two cp.async stages, so the
// next stage's loads overlap this stage's FMAs. (Applying snake2 while (b)
// loads z, as the k7 pass applies snake1, recomputes it once per 64-channel
// output tile -- 12 times at C = 768 -- and made (b) a quarter of the unit's
// time for an eighth of its flops.)
// The price of two passes is one extra (B, C, T) round trip of z: about 20
// bytes per (c, t) instead of the fused form's 8, i.e. intensity 0.8C
// instead of 2C flop/byte -- 38 at C = 48, still above the ridge, so the unit
// stays compute-bound. A single pass must keep snake2(y) for all C channels
// of a time tile on chip (96 KB at C = 768 and 32 steps), which is the later,
// faster design; PERF.md records the variants measured.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, without fast math:
// sinf, expf and the division stay IEEE-accurate.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileCo = 64;   // output channels per block
constexpr int kTileT = 256;   // time steps per block
constexpr int kTy = 8;        // threads along channels
constexpr int kTx = 32;       // threads along time (one warp)
constexpr int kRc = kTileCo / kTy;     // 8 adjacent output channels per thread
constexpr int kRt = kTileT / kTx;      // 8 time steps per thread, 32 apart
constexpr int kWStride = kTileCo + 4;  // 16-byte weight rows, 4-way staging conflicts
constexpr int kTci7 = 8;               // input channels per stage, k7 pass
constexpr int kTci1 = 16;              // input channels per stage, k1 pass
static_assert(kThreads == kTileT, "the k1 pass stages one time step per thread");

__device__ __forceinline__ float snake(float v, float a, float inv) {
  const float s = sinf(v * a);
  return v + inv * (s * s);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));  // 0 bytes read: zero fill
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[i][j] += sum over the TCI staged input channels and K taps of
// w[co(i)][c][k] * x[c][t(j) + k * dil], with co(i) = 8 ty + i, t(j) = tx + 32 j.
// xs [TCI][width] (halo included); ws [TCI * K][kWStride], rows 16-byte aligned.
template <int K, int TCI>
__device__ __forceinline__ void accumulate(const float* xs, const float* ws, int width,
                                           int dil, int tx, int ty,
                                           float (&acc)[kRc][kRt]) {
#pragma unroll
  for (int c = 0; c < TCI; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float wr[kRc], xr[kRt];
      const float4* wrow =
          reinterpret_cast<const float4*>(ws + (c * K + k) * kWStride + ty * kRc);
#pragma unroll
      for (int i = 0; i < kRc / 4; ++i) {
        const float4 v = wrow[i];  // the same address across the warp: a broadcast
        wr[4 * i] = v.x;
        wr[4 * i + 1] = v.y;
        wr[4 * i + 2] = v.z;
        wr[4 * i + 3] = v.w;
      }
      const float* xrow = xs + c * width + k * dil + tx;
#pragma unroll
      for (int j = 0; j < kRt; ++j) xr[j] = xrow[j * kTx];
#pragma unroll
      for (int i = 0; i < kRc; ++i)
#pragma unroll
        for (int j = 0; j < kRt; ++j) acc[i][j] = fmaf(wr[i], xr[j], acc[i][j]);
    }
  }
}

// Pass (a): z = snake2(W7 *_d snake1(x) + b7). x, z (B, C, T); w7 (C, C, 7).
// Input channels are staged 8 at a time: the x slice with its 3d halo (zero
// outside [0, T)), snake1 applied as it is loaded, and the weights as
// [ci][k][co] rows.
__global__ void __launch_bounds__(kThreads, 2)
conv7_snake_kernel(const float* __restrict__ x, const float* __restrict__ w7,
                   const float* __restrict__ b7, const float* __restrict__ alpha1,
                   const float* __restrict__ beta1, const float* __restrict__ alpha2,
                   const float* __restrict__ beta2, float* __restrict__ z, int C, int T,
                   int dil) {
  constexpr int K = 7;
  extern __shared__ __align__(16) float smem[];
  const int halo = 3 * dil;
  const int width = kTileT + 2 * halo;
  float* ws = smem;                         // [kTci7 * K][kWStride]
  float* s_a = ws + kTci7 * K * kWStride;   // [C] e^alpha1
  float* s_inv = s_a + C;                   // [C] 1 / (e^beta1 + 1e-9)
  float* xs = s_inv + C;                    // [kTci7][width] snake1(x)

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kTileCo;
  const int t0 = blockIdx.x * kTileT;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const float* x_b = x + (size_t)b * C * T;

  for (int c = tid; c < C; c += kThreads) {
    s_a[c] = expf(alpha1[c]);
    s_inv[c] = 1.0f / (expf(beta1[c]) + 1e-9f);
  }
  __syncthreads();

  float acc[kRc][kRt];
#pragma unroll
  for (int i = 0; i < kRc; ++i)
#pragma unroll
    for (int j = 0; j < kRt; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += kTci7) {
    for (int i = tid; i < kTci7 * width; i += kThreads) {
      const int c = i / width;
      const int t = t0 - halo + (i - c * width);
      const int ci = ci0 + c;
      float v = 0.f;
      if (ci < C && t >= 0 && t < T) {
        v = x_b[(size_t)ci * T + t];
        v = snake(v, s_a[ci], s_inv[ci]);
      }
      xs[i] = v;
    }
    for (int i = tid; i < kTileCo * kTci7 * K; i += kThreads) {
      const int co = i / (kTci7 * K);
      const int r = i - co * (kTci7 * K);  // = c * K + k
      const int ci = ci0 + r / K;
      float v = 0.f;
      if (co0 + co < C && ci < C) v = w7[((size_t)(co0 + co) * C + ci) * K + r % K];
      ws[r * kWStride + co] = v;
    }
    __syncthreads();
    accumulate<K, kTci7>(xs, ws, width, dil, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRc; ++i) {
    const int co = co0 + ty * kRc + i;
    if (co >= C) continue;
    const float bv = b7[co];
    const float a = expf(alpha2[co]);
    const float inv = 1.0f / (expf(beta2[co]) + 1e-9f);
    const size_t row = ((size_t)b * C + co) * T;
#pragma unroll
    for (int j = 0; j < kRt; ++j) {
      const int t = t0 + tx + j * kTx;
      if (t < T) z[row + t] = snake(acc[i][j] + bv, a, inv);
    }
  }
}

// Pass (b): out = x + W1 . z + b1. x, z, out (B, C, T); w1 (C, C, 1).
// Input channels stream 16 at a time through two shared-memory stages:
// cp.async fills the next while the block computes on the current one.
__global__ void __launch_bounds__(kThreads, 2)
conv1_residual_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ x,
                      float* __restrict__ out, int C, int T) {
  constexpr int kWs = kTci1 * kWStride;  // one stage of weights, [ci][co]
  constexpr int kXs = kTci1 * kTileT;    // one stage of z, [ci][t]
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kTileCo;
  const int t0 = blockIdx.x * kTileT;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const float* z_b = z + (size_t)b * C * T;

  auto stage = [&](int ci0, int buf) {
    float* xd = smem + 2 * kWs + buf * kXs;
    float* wd = smem + buf * kWs;
#pragma unroll
    for (int c = 0; c < kTci1; ++c) {
      const int ci = ci0 + c;
      const int t = t0 + tid;
      const bool ok = ci < C && t < T;
      cp_async4(xd + c * kTileT + tid, ok ? z_b + (size_t)ci * T + t : z_b, ok);
    }
#pragma unroll
    for (int i = tid; i < kTileCo * kTci1; i += kThreads) {
      const int co = i / kTci1;
      const int ci = ci0 + i - co * kTci1;
      const bool ok = co0 + co < C && ci < C;
      cp_async4(wd + (ci - ci0) * kWStride + co, ok ? w1 + (size_t)(co0 + co) * C + ci : w1,
                ok);
    }
    cp_async_commit();
  };

  float acc[kRc][kRt];
#pragma unroll
  for (int i = 0; i < kRc; ++i)
#pragma unroll
    for (int j = 0; j < kRt; ++j) acc[i][j] = 0.f;

  stage(0, 0);
  cp_async_wait_all();
  __syncthreads();
  const int n_stages = (C + kTci1 - 1) / kTci1;
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1;
    if (st + 1 < n_stages) stage((st + 1) * kTci1, cur ^ 1);
    accumulate<1, kTci1>(smem + 2 * kWs + cur * kXs, smem + cur * kWs, kTileT, 0, tx, ty,
                         acc);
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRc; ++i) {
    const int co = co0 + ty * kRc + i;
    if (co >= C) continue;
    const float bv = b1[co];
    const size_t row = ((size_t)b * C + co) * T;
#pragma unroll
    for (int j = 0; j < kRt; ++j) {
      const int t = t0 + tx + j * kTx;
      if (t < T) out[row + t] = x[row + t] + (acc[i][j] + bv);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// x, z, out (B, C, T); w7 (C, C, 7); w1 (C, C, 1); b7, b1, alpha1, beta1,
// alpha2, beta2 (C,): fp32, contiguous, one device. z is scratch for
// snake2(y). Returns the cudaError_t of the launches (0 on success).
int residual_unit_launch(const float* x, const float* w7, const float* b7,
                         const float* w1, const float* b1, const float* alpha1,
                         const float* beta1, const float* alpha2, const float* beta2,
                         float* z, float* out, int B, int C, int T, int dilation,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTileT - 1) / kTileT, (C + kTileCo - 1) / kTileCo, B);

  const size_t smem7 =
      sizeof(float) * (kTci7 * 7 * kWStride + 2 * C + kTci7 * (kTileT + 6 * dilation));
  cudaError_t err = allow_smem(conv7_snake_kernel, smem7);
  if (err != cudaSuccess) return (int)err;
  conv7_snake_kernel<<<grid, kThreads, smem7, s>>>(x, w7, b7, alpha1, beta1, alpha2, beta2,
                                                   z, C, T, dilation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem1 = sizeof(float) * 2 * (kTci1 * kWStride + kTci1 * kTileT);
  err = allow_smem(conv1_residual_kernel, smem1);
  if (err != cudaSuccess) return (int)err;
  conv1_residual_kernel<<<grid, kThreads, smem1, s>>>(z, w1, b1, x, out, C, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
