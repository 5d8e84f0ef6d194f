// One template for the two passes of a residual unit on Hopper's tensor cores,
// in split-TF32: fp32-grade products from three TF32 products each.
//
//   pass (a)  z   = act_out(W7 *_d act_in(x) + b7)     implicit GEMM, K = 7 C
//   pass (b)  out = x + W1 . z + b1                     plain GEMM,    K = C
//
// M = output channels, N = time steps of one sample, K = (input channel, tap).
// A is the weight in its own (C_out, C_in, TAPS) layout, already M x K
// row-major with k = ci * TAPS + tap. B is read as TAPS shifted views (offset
// tap * d) of one staged tile act_in(x)[ci][t0 - 3d, t0 + BN + 3d): no im2col
// is written anywhere, and act_in runs once per staged element, halo included.
//
// Split-TF32: v = hi + lo, hi = tf32(v), lo = tf32(v - hi) (cvt.rna), taken
// once per staged element for both operands. A product is hi*hi' + hi*lo' +
// lo*hi' (the lo*lo' term is below fp32's rounding), each an
// mma.sync.m16n8k8 TF32 product. The tensor cores do not round their sums to
// nearest, so a running sum kept in them over all of K drifts by up to an ulp
// per step (measured: 6-28x the fp32 plain version's error against float64
// over the codec's widths). As Ootomo & Yokota (IJHPCA 2022) recommend, the
// sums leave the tensor cores before they grow: each stage's products (K =
// 56 in the k7 pass) sum from zero in a second set of fragments, small terms
// first, and are added to the fp32 accumulators with a rounded FADD. (One
// rounded add per 8-deep k-chunk is 2-3x more accurate still, but it slows
// the products by about a quarter: ops/cuda/mma_peak.py.)
//
// Staging: a ring of two shared-memory slots filled by cp.async, 16 bytes a
// copy where the shapes allow it (C, and T for channel-major, multiples of 4;
// the tile is placed so that its time steps start on a 16-byte boundary),
// else 4. Each thread splits in place exactly the chunks it copied itself
// (hi over the raw value, lo into the slot's lo array), so its own
// cp.async.wait is all the split needs, and one barrier per stage publishes
// the slot and retires the previous one. The next stage's copies are issued
// right after that barrier and land while the tensor cores work.
//
// Layouts in shared memory are padded so that every fragment load is free of
// bank conflicts: A rows of TAPS*KC + 4 words (the 8 rows of a fragment fall
// on 8 distinct 4-bank groups, also with the tap stride of 7); channel-major
// B rows of a width = 8 (mod 32) words (the 4 k-rows of a fragment fall 8
// banks apart); time-major B rows of KC + 4 words, one per time step.
//
// Parameters chosen at compile time: the tile (warps and fragments per
// warp), TAPS and the staging depth KC, the activation applied as B is staged
// and in the epilogue (none, snake, sin), whether activations are
// channel-major (B, C, T) or time-major (B, T, C), and the copy width. Any C
// and T are masked at the edges. Built without fast math: sinf, expf and
// divisions stay IEEE.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32unit {

enum Act { kNone = 0, kSnake = 1, kSin = 2 };

// A warp owns (16 MT) x (8 NT) outputs; the block has WM x WN warps.
template <int MT_, int NT_, int WM_, int WN_>
struct Tile {
  static constexpr int MT = MT_, NT = NT_, WM = WM_, WN = WN_;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 8 * NT * WN;
  static constexpr int kThreads = 32 * WM * WN;
};

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v -> (hi, lo), stored as the bit patterns the mma reads.
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = __uint_as_float(tf32_bits(v));
  lo = __uint_as_float(tf32_bits(v - hi));
}

// d = a (16x8, row) . b (8x8, col) + d, TF32 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy V floats (V = 4: 16 bytes, V = 1: 4 bytes); the first `bytes` come
// from src, the rest are zero-filled.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(d), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(d), "l"(src),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// snake(v) = v + sin^2(a v) * inv with a = e^alpha, inv = 1 / (e^beta + 1e-9).
template <int ACT>
__device__ __forceinline__ float activate(float v, float a, float inv) {
  if (ACT == kSnake) {
    const float s = sinf(v * a);
    return v + inv * (s * s);
  }
  if (ACT == kSin) return sinf(v);
  return v;
}

template <int V>
struct Vec;
template <>
struct Vec<4> { using T = float4; };
template <>
struct Vec<1> { using T = float; };

__device__ __forceinline__ float& lane(float4& v, int e) { return (&v.x)[e]; }
__device__ __forceinline__ float& lane(float& v, int) { return v; }

__host__ __device__ inline int b_stride(int width) {
  return ((width + 23) / 32) * 32 + 8;  // >= width, = 8 (mod 32)
}

// One stage: KC input channels of A (all TAPS taps) and of the staged B tile,
// copied and split in chunks of V floats.
template <class Tl, int TAPS, int KC, int IN_ACT, bool TMAJOR, int V>
struct Stage {
  static constexpr int KA = TAPS * KC;  // A columns per stage
  static constexpr int SA = KA + 4;     // A row stride
  static constexpr int SBT = KC + 4;    // time-major B row stride (one time step)
  using VT = typename Vec<V>::T;

  // The B tile spans time steps [t0 - hp, t0 + BN + hp), hp = halo rounded
  // up to a multiple of 4, so that a 16-byte chunk never straddles T.
  static __host__ __device__ int pad(int dil) { return ((TAPS / 2) * dil + 3) / 4 * 4; }
  static __host__ __device__ int width(int dil) { return Tl::BN + 2 * pad(dil); }
  static __host__ __device__ int b_words(int w) { return TMAJOR ? w * SBT : KC * b_stride(w); }
  static __host__ __device__ int slot_words(int w) { return 2 * (Tl::BM * SA + b_words(w)); }

  // Chunk i of this stage's A (row m, column k) and B (channel c, step j):
  // its shared-memory index and, through `bytes`, how much of it lies inside
  // [0, C) x [0, T).
  static constexpr int A_CHUNKS = Tl::BM * KA / V;
  static __device__ __forceinline__ int a_chunk(int i, int co0, int ci0, int C, int& gofs,
                                                int& bytes) {
    const int m = i / (KA / V), k = (i - m * (KA / V)) * V;
    const int left = (C - ci0) * TAPS - k;  // valid k columns from here
    bytes = co0 + m < C ? 4 * max(0, min(V, left)) : 0;
    gofs = ((co0 + m) * C + ci0) * TAPS + k;
    return m * SA + k;
  }
  static __device__ __forceinline__ int b_chunks(int w) { return KC * w / V; }
  static __device__ __forceinline__ int b_chunk(int i, int w, int sb, int t_lo, int ci0, int C,
                                                int T, int& c, size_t& gofs, int& bytes) {
    int j;
    if (TMAJOR) {
      j = i / (KC / V);
      c = (i - j * (KC / V)) * V;
    } else {
      c = i / (w / V);
      j = (i - c * (w / V)) * V;
    }
    const int t = t_lo + j, ci = ci0 + c;
    const bool t_ok = TMAJOR ? (t >= 0 && t < T) : (t >= 0 && t + V <= T);
    const int n_ok = TMAJOR ? max(0, min(V, C - ci)) : (ci < C ? V : 0);
    bytes = t_ok ? 4 * n_ok : 0;
    gofs = TMAJOR ? (size_t)t * C + ci : (size_t)ci * T + t;
    return TMAJOR ? j * SBT + c : c * sb + j;
  }

  // Issue this thread's copies of the stage at ci0 into the slot's hi arrays
  // and commit them as one group.
  static __device__ __forceinline__ void issue(float* slot, int w, int sb, const float* wt,
                                               const float* in_b, int ci0, int co0, int t_lo,
                                               int C, int T) {
    float* a_hi = slot;
    float* b_hi = slot + 2 * Tl::BM * SA;
    for (int i = threadIdx.x; i < A_CHUNKS; i += Tl::kThreads) {
      int g, bytes;
      const int e = a_chunk(i, co0, ci0, C, g, bytes);
      cp_async<V>(a_hi + e, bytes ? wt + g : wt, bytes);
    }
    const int nb = b_chunks(w);
    for (int i = threadIdx.x; i < nb; i += Tl::kThreads) {
      int c, bytes;
      size_t g;
      const int e = b_chunk(i, w, sb, t_lo, ci0, C, T, c, g, bytes);
      cp_async<V>(b_hi + e, bytes ? in_b + g : in_b, bytes);
    }
    cp_async_commit();
  }

  // Split this thread's own chunks of the stage at ci0 in place: hi over the
  // raw value, lo beside it in the lo array. B gets act_in first
  // (act_in(0) = 0 keeps the zero padding). s_a, s_inv: act_in's parameters
  // per channel, 0 beyond C.
  static __device__ __forceinline__ void split_own(float* slot, int w, int sb, int ci0, int C,
                                                   const float* s_a, const float* s_inv) {
    float* a_hi = slot;
    float* a_lo = slot + Tl::BM * SA;
    float* b_hi = slot + 2 * Tl::BM * SA;
    float* b_lo = b_hi + b_words(w);
    for (int i = threadIdx.x; i < A_CHUNKS; i += Tl::kThreads) {
      int g, bytes;
      const int e = a_chunk(i, 0, ci0, C, g, bytes);
      VT v = *reinterpret_cast<VT*>(a_hi + e), hi, lo;
#pragma unroll
      for (int k = 0; k < V; ++k) split(lane(v, k), lane(hi, k), lane(lo, k));
      *reinterpret_cast<VT*>(a_hi + e) = hi;
      *reinterpret_cast<VT*>(a_lo + e) = lo;
    }
    const int nb = b_chunks(w);
    for (int i = threadIdx.x; i < nb; i += Tl::kThreads) {
      int c, bytes;
      size_t g;
      const int e = b_chunk(i, w, sb, 0, ci0, C, 0, c, g, bytes);
      VT v = *reinterpret_cast<VT*>(b_hi + e), hi, lo;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        // time-major chunks hold V channels, channel-major ones V steps of one
        const int ch = ci0 + c + (TMAJOR ? k : 0);
        const float a = IN_ACT == kSnake ? s_a[ch] : 0.f;
        const float inv = IN_ACT == kSnake ? s_inv[ch] : 0.f;
        split(activate<IN_ACT>(lane(v, k), a, inv), lane(hi, k), lane(lo, k));
      }
      *reinterpret_cast<VT*>(b_hi + e) = hi;
      *reinterpret_cast<VT*>(b_lo + e) = lo;
    }
  }
};

// The unit's GEMM. in, out (and resid) are (B, C, T), or (B, T, C) when
// TMAJOR; w is (C, C, TAPS). bias, resid may be null. in_alpha/in_beta are
// act_in's snake parameters, out_alpha/out_beta act_out's (log scale, (C,)).
template <class Tl, int TAPS, int KC, int IN_ACT, int OUT_ACT, bool TMAJOR, int V>
__global__ void __launch_bounds__(Tl::kThreads)
unit_gemm(const float* __restrict__ in, const float* __restrict__ w,
          const float* __restrict__ bias, const float* __restrict__ in_alpha,
          const float* __restrict__ in_beta, const float* __restrict__ out_alpha,
          const float* __restrict__ out_beta, const float* __restrict__ resid,
          float* __restrict__ out, int C, int T, int dil) {
  using St = Stage<Tl, TAPS, KC, IN_ACT, TMAJOR, V>;
  constexpr int MT = Tl::MT, NT = Tl::NT, SA = St::SA, SBT = St::SBT;
  extern __shared__ __align__(16) float smem[];

  const int hp = St::pad(dil);
  const int shift = hp - (TAPS / 2) * dil;  // B column of tap 0 at output step 0
  const int width = St::width(dil);
  const int sb = b_stride(width);
  const int n_stages = (C + KC - 1) / KC;
  const int c_pad = n_stages * KC;
  float* s_a = smem;  // [c_pad] act_in parameters (snake only)
  float* s_inv = s_a + c_pad;
  float* slots = smem + (IN_ACT == kSnake ? (2 * c_pad + 3) / 4 * 4 : 0);
  const int slot_words = St::slot_words(width);
  const int b_words = St::b_words(width);

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * Tl::BM;
  const int t0 = blockIdx.x * Tl::BN;
  const size_t plane = (size_t)C * T;
  const float* in_b = in + b * plane;

  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int g = ln / 4, tig = ln % 4;
  const int wm0 = (warp / Tl::WN) * 16 * MT;  // warp's first row in the block tile
  const int wn0 = (warp % Tl::WN) * 8 * NT;   // warp's first column

  St::issue(slots, width, sb, w, in_b, 0, co0, t0 - hp, C, T);
  if (IN_ACT == kSnake) {
    for (int c = threadIdx.x; c < c_pad; c += Tl::kThreads) {
      const bool ok = c < C;
      s_a[c] = ok ? expf(in_alpha[c]) : 0.f;
      s_inv[c] = ok ? 1.0f / (expf(in_beta[c]) + 1e-9f) : 0.f;
    }
    __syncthreads();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    float* slot = slots + (s & 1) * slot_words;
    cp_async_wait_all();  // this thread's copies of stage s have landed
    St::split_own(slot, width, sb, s * KC, C, s_a, s_inv);
    __syncthreads();      // stage s visible to all; stage s-1's slot is free
    if (s + 1 < n_stages)
      St::issue(slots + ((s + 1) & 1) * slot_words, width, sb, w, in_b, (s + 1) * KC, co0,
                t0 - hp, C, T);

    const float* a_hi = slot;
    const float* a_lo = slot + Tl::BM * SA;
    const float* b_hi = slot + 2 * Tl::BM * SA;
    const float* b_lo = b_hi + b_words;
    // The stage's products (TAPS * KC/8 k-chunks x 3 terms) sum from zero in
    // the tensor cores; the stage's sum is then added to acc, rounded.
    float ts[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) ts[i][j][r] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int col = wn0 + g + tap * dil + shift;  // B column of this lane's n
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const int k0 = (kk * 8 + tig) * TAPS + tap;  // A column of k-row tig
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r0 = (wm0 + 16 * i + g) * SA + k0;
          const int offs[4] = {r0, r0 + 8 * SA, r0 + 4 * TAPS, r0 + 8 * SA + 4 * TAPS};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ah[i][r] = __float_as_uint(a_hi[offs[r]]);
            al[i][r] = __float_as_uint(a_lo[offs[r]]);
          }
        }
        const int kr = kk * 8 + tig;  // B k-row of this lane
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = TMAJOR ? (col + 8 * j) * SBT + kr : kr * sb + col + 8 * j;
          const int o4 = TMAJOR ? o + 4 : o + 4 * sb;  // k-row + 4
          const uint32_t bh[2] = {__float_as_uint(b_hi[o]), __float_as_uint(b_hi[o4])};
          const uint32_t bl[2] = {__float_as_uint(b_lo[o]), __float_as_uint(b_lo[o4])};
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_tf32(ts[i][j], al[i], bh);  // small terms first
            mma_tf32(ts[i][j], ah[i], bl);
            mma_tf32(ts[i][j], ah[i], bh);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += ts[i][j][r];  // rounded to nearest
  }

  // Epilogue: + bias, act_out, + resid; rows g and g + 8 of each fragment.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + wm0 + 16 * i + g + 8 * h;
      if (co >= C) continue;
      const float bv = bias ? bias[co] : 0.f;
      float a = 0.f, inv = 0.f;
      if (OUT_ACT == kSnake) {
        a = expf(out_alpha[co]);
        inv = 1.0f / (expf(out_beta[co]) + 1e-9f);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + wn0 + 8 * j + 2 * tig + e;
          if (t >= T) continue;
          const size_t idx = b * plane + (TMAJOR ? (size_t)t * C + co : (size_t)co * T + t);
          float v = activate<OUT_ACT>(acc[i][j][2 * h + e] + bv, a, inv);
          if (resid) v += resid[idx];
          out[idx] = v;
        }
      }
    }
  }
}

template <class Tl, int TAPS, int KC, int IN_ACT, int OUT_ACT, bool TMAJOR, int V>
cudaError_t launch_v(const float* in, const float* w, const float* bias, const float* in_alpha,
                     const float* in_beta, const float* out_alpha, const float* out_beta,
                     const float* resid, float* out, int B, int C, int T, int dil,
                     cudaStream_t stream) {
  using St = Stage<Tl, TAPS, KC, IN_ACT, TMAJOR, V>;
  auto kernel = unit_gemm<Tl, TAPS, KC, IN_ACT, OUT_ACT, TMAJOR, V>;
  const int c_pad = (C + KC - 1) / KC * KC;
  const size_t smem = sizeof(float) * ((IN_ACT == kSnake ? (2 * c_pad + 3) / 4 * 4 : 0) +
                                       2 * St::slot_words(St::width(dil)));
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + Tl::BN - 1) / Tl::BN, (C + Tl::BM - 1) / Tl::BM, B);
  kernel<<<grid, Tl::kThreads, smem, stream>>>(in, w, bias, in_alpha, in_beta, out_alpha,
                                               out_beta, resid, out, C, T, dil);
  return cudaGetLastError();
}

// 16-byte copies where every chunk is aligned: C a multiple of 4, and T too
// for channel-major rows.
template <class Tl, int TAPS, int KC, int IN_ACT, int OUT_ACT, bool TMAJOR>
cudaError_t launch(const float* in, const float* w, const float* bias, const float* in_alpha,
                   const float* in_beta, const float* out_alpha, const float* out_beta,
                   const float* resid, float* out, int B, int C, int T, int dil,
                   cudaStream_t stream) {
  const bool vec = C % 4 == 0 && (TMAJOR || T % 4 == 0);
  return vec ? launch_v<Tl, TAPS, KC, IN_ACT, OUT_ACT, TMAJOR, 4>(
                   in, w, bias, in_alpha, in_beta, out_alpha, out_beta, resid, out, B, C, T,
                   dil, stream)
             : launch_v<Tl, TAPS, KC, IN_ACT, OUT_ACT, TMAJOR, 1>(
                   in, w, bias, in_alpha, in_beta, out_alpha, out_beta, resid, out, B, C, T,
                   dil, stream);
}

// Tiles: 48 rows for widths that are not multiples of 96 (C = 48 wastes no
// row), 96 rows otherwise; 256 time steps, or 200 where 256 would pad T by
// more than a tenth (T = 400: 22% of a 512-step grid, none of 400). The
// 10-warp tile's registers are capped at 168 (3 warps on one sub-partition),
// which its pointwise pass overflows, so that pass runs 48 x 200 tiles.
using TileS = Tile<3, 8, 1, 4>;    // 48 x 256, 4 warps
using TileL = Tile<3, 8, 2, 4>;    // 96 x 256, 8 warps
using TileT = Tile<3, 5, 2, 5>;    // 96 x 200, 10 warps
using TileT1 = Tile<3, 5, 1, 5>;   // 48 x 200, 5 warps

// Both passes of one unit on one stream, with tiles TA (k7) and TB (k1).
template <class TA, class TB, int ACT, bool TMAJOR>
cudaError_t unit_launch_tile(const float* x, const float* w7, const float* b7, const float* w1,
                             const float* b1, const float* alpha1, const float* beta1,
                             const float* alpha2, const float* beta2, float* z, float* out,
                             int B, int C, int T, int dil, cudaStream_t s) {
  const cudaError_t err = launch<TA, 7, 8, ACT, ACT, TMAJOR>(
      x, w7, b7, alpha1, beta1, alpha2, beta2, nullptr, z, B, C, T, dil, s);
  if (err != cudaSuccess) return err;
  // the pointwise pass stages 32 channels on 96-row tiles, 16 on 48-row ones
  // (C = 48 is 3 x 16)
  constexpr int KC1 = TB::BM == 96 ? 32 : 16;
  return launch<TB, 1, KC1, kNone, kNone, TMAJOR>(z, w1, b1, nullptr, nullptr, nullptr, nullptr,
                                                 x, out, B, C, T, 1, s);
}

// x, z, out share a layout; w7 is (C, C, 7), w1 (C, C, 1).
template <int ACT, bool TMAJOR>
cudaError_t unit_launch(const float* x, const float* w7, const float* b7, const float* w1,
                        const float* b1, const float* alpha1, const float* beta1,
                        const float* alpha2, const float* beta2, float* z, float* out, int B,
                        int C, int T, int dil, cudaStream_t s) {
  if (C % 96 != 0)
    return unit_launch_tile<TileS, TileS, ACT, TMAJOR>(x, w7, b7, w1, b1, alpha1, beta1,
                                                       alpha2, beta2, z, out, B, C, T, dil, s);
  if (10 * ((T + 255) / 256 * 256 - T) > T)
    return unit_launch_tile<TileT, TileT1, ACT, TMAJOR>(x, w7, b7, w1, b1, alpha1, beta1,
                                                        alpha2, beta2, z, out, B, C, T, dil, s);
  return unit_launch_tile<TileL, TileL, ACT, TMAJOR>(x, w7, b7, w1, b1, alpha1, beta1, alpha2,
                                                     beta2, z, out, B, C, T, dil, s);
}

}  // namespace tf32unit
