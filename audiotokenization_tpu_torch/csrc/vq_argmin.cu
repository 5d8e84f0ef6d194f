// K1: nearest-code search of the factorized VQ on Hopper (sm_90a), one
// thread-block-cluster launch per call.
//
// Replaces the Pallas TPU kernel audiotokenization_tpu/ops/pallas/vq_kernel.py
// (_vq_argmin_kernel, launched by _vq_argmin_call through vq_argmin, whose
// codebook normalisation XLA fuses into the same dispatch). For each latent row
// e (M x D) and every code c of the raw codebook (N x D) it L2-normalises both,
// x / max(||x||, 1e-12), forms the fp32 distance (||e||^2 - 2 e.c) + ||c||^2
// and returns the argmin as int32, ties to the lowest index.
//
// What bounds it on the H100: M*N*(2D + 3) operations (2560 x 8192 x 19 =
// 398 M for the flagship) against 67 TFLOP/s of fp32 on the FMA pipes is
// 5.9 us; its bytes (~0.35 MB) take less. That is about what one launch
// costs, so per call the host's pace bounds it. The design therefore makes a
// call one launch: no PyTorch op around it, no scratch, no second kernel.
//
// Design. The flagship book (8192 x 8 fp32, 256 KB) exceeds a block's 227 KB
// of shared memory, and 2560 rows alone fill few SMs. So a cluster of S <= 8
// blocks shares the book. Block s owns the codes [s*share, (s+1)*share), in
// index order: it copies them with cp.async (16 bytes a copy where the book
// is 16-byte aligned, else 4) into float4 planes, through two tiles so the
// next tile lands while one is scanned, normalises each code once in shared
// memory and keeps ||c||^2 beside it. Every block of the cluster takes the
// cluster's R rows; threads 0..R-1 normalise one each into shared memory.
// Thread (g, l) holds the R/32 rows of row group g in registers and scans
// codes l, l+8, ... of each tile in increasing order with a strict '<',
// keeping per row the 64-bit key ordered_bits(dist) << 32 | index; shuffles
// across the 8 lanes of a group leave each row's minimum key in the block's
// shared memory. After cluster.sync() block s takes, for the rows s, s+S, ...,
// the minimum over the S blocks' keys through distributed shared memory and
// writes out. A second cluster barrier keeps every block's shared memory
// alive until its neighbours have read it. The result is the exact
// lowest-index argmin, the same on every run, with no atomics.
// Flagship: R = 96, S = 8, a share of 1024 codes in 256-code tiles (22 KB of
// shared memory), 27 clusters = 216 blocks of 256 threads on the 132 SMs.
//
// The geometry (S, share, tile, R, shared bytes) comes from
// ops/cuda/vq_kernel.py::k1_geometry; the launch refuses one that does not
// fit the layout here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3, without fast math:
// sqrtf and the divisions stay IEEE-accurate; sums run in order d = 0..D-1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                      // code lanes of a row group
constexpr int kGroups = kThreads / kLanes;     // row groups of a block
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr int kMaxSmem = 48 * 1024;            // dynamic shared memory without an opt-in

// Rows held by each thread: at most 32 floats of them. At D = 8, 3 rows make
// R = 96 and put the flagship's 2560 rows on 27 clusters (216 blocks, at most
// two on an SM); 4 would leave 160 blocks, 28 SMs doing twice the work.
template <int D>
__host__ __device__ constexpr int rows_per_thread() { return D == 8 ? 3 : D == 16 ? 2 : 1; }

// Words of one tile: D float planes of `tile` codes, then ||c||^2 padded to
// 16 bytes, so the next tile's planes stay float4-aligned.
__host__ __device__ __forceinline__ size_t tile_words(int D, int tile) {
  return (size_t)tile * D + (size_t)(tile + 3) / 4 * 4;
}

// Unsigned integer order equals float order (for non-NaN values); negative
// distances, which a row equal to a code can give, order below zero.
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy codes [c0, c0 + n) into a tile: plane p, slot j holds code c0 + j's
// values 4p..4p+3, so the 8 lanes of a group read 8 consecutive float4s.
template <int D>
__device__ void load_tile(float* buf, int tile, const float* __restrict__ cb, int c0, int n,
                          bool vec) {
  constexpr int P = D / 4;
  const float* src = cb + (size_t)c0 * D;
  if (vec) {
    for (int i = threadIdx.x; i < n * P; i += kThreads) {
      const int j = i / P, p = i % P;
      cp_async16(buf + ((size_t)p * tile + j) * 4, src + (size_t)j * D + 4 * p);
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int j = i / D, d = i % D;
      cp_async4(buf + ((size_t)(d / 4) * tile + j) * 4 + d % 4, src + (size_t)j * D + d);
    }
  }
  cp_async_commit();
}

// Normalise the tile's n codes in place and store ||c||^2 after the planes.
template <int D>
__device__ void normalise_tile(float* buf, int tile, int n) {
  constexpr int P = D / 4;
  float4* c4 = reinterpret_cast<float4*>(buf);
  float* sc = buf + (size_t)tile * D;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float c[D];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 v = c4[p * tile + j];
      c[4 * p] = v.x, c[4 * p + 1] = v.y, c[4 * p + 2] = v.z, c[4 * p + 3] = v.w;
    }
    float n2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) n2 += c[d] * c[d];
    const float den = fmaxf(sqrtf(n2), 1e-12f);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      c[d] = c[d] / den;
      s += c[d] * c[d];
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      c4[p * tile + j] = make_float4(c[4 * p], c[4 * p + 1], c[4 * p + 2], c[4 * p + 3]);
    sc[j] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_argmin_cluster(const float* __restrict__ enc, const float* __restrict__ cb,
                  int* __restrict__ out, int M, int N, int S, int share, int tile, bool vec) {
  constexpr int RPT = rows_per_thread<D>();
  constexpr int R = kGroups * RPT;
  constexpr int P = D / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* rows = reinterpret_cast<float*>(keys + R);  // R normalised rows, then their ||e||^2
  float* row_se = rows + R * D;
  float* bufs = row_se + R;
  const size_t words = tile_words(D, tile);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / S) * R;
  const int c_begin = (int)min((long long)N, (long long)rank * share);
  const int c_end = (int)min((long long)N, (long long)c_begin + share);
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;

  const int n_codes = c_end - c_begin;
  const int n_tiles = (n_codes + tile - 1) / tile;
  if (n_tiles > 0) load_tile<D>(bufs, tile, cb, c_begin, min(tile, n_codes), vec);

  // the cluster's rows, each normalised once while the first tile lands;
  // rows past M repeat the last row and are never written
  if (threadIdx.x < R) {
    const float* src = enc + (size_t)min(row0 + (int)threadIdx.x, M - 1) * D;
    float x[D];
    float nrm2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = src[d];
      nrm2 += x[d] * x[d];
    }
    const float den = fmaxf(sqrtf(nrm2), 1e-12f);
    float se = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = x[d] / den;
      se += x[d] * x[d];
      rows[threadIdx.x * D + d] = x[d];
    }
    row_se[threadIdx.x] = se;
  }
  __syncthreads();

  // this thread's rows, in registers for the whole scan
  float e[RPT][D], se[RPT], best[RPT];
  uint32_t arg[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = group * RPT + i;
#pragma unroll
    for (int d = 0; d < D; ++d) e[i][d] = rows[r * D + d];
    se[i] = row_se[r];
    best[i] = INFINITY;
    arg[i] = 0xffffffffu;
  }

  for (int t = 0; t < n_tiles; ++t) {
    float* buf = bufs + (t & 1) * words;
    const int c0 = c_begin + t * tile;
    const int n = min(tile, c_end - c0);
    if (t + 1 < n_tiles) {  // the next tile lands while this one is scanned
      load_tile<D>(bufs + ((t + 1) & 1) * words, tile, cb, c0 + tile,
                   min(tile, c_end - c0 - tile), vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    normalise_tile<D>(buf, tile, n);
    __syncthreads();

    const float4* c4 = reinterpret_cast<const float4*>(buf) + lane;
    const float* sc = buf + (size_t)tile * D + lane;
    for (int j = lane; j < n; j += kLanes, c4 += kLanes, sc += kLanes) {
      float c[D];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 v = c4[p * tile];
        c[4 * p] = v.x, c[4 * p + 1] = v.y, c[4 * p + 2] = v.z, c[4 * p + 3] = v.w;
      }
      const float s = *sc;
      const uint32_t idx = (uint32_t)(c0 + j);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float cross = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) cross = fmaf(e[i][d], c[d], cross);
        // (||e||^2 - 2 e.c) + ||c||^2, with one rounding for the first sum:
        // 2 e.c is exact
        const float dist = fmaf(-2.f, cross, se[i]) + s;
        if (dist < best[i]) {
          best[i] = dist;
          arg[i] = idx;
        }
      }
    }
    __syncthreads();  // the buffer is free before tile t + 2 is copied into it
  }

  // each row's minimum key over the group's lanes
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    unsigned long long k = ((unsigned long long)ordered_bits(best[i]) << 32) | arg[i];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
      k = o < k ? o : k;
    }
    if (lane == 0) keys[group * RPT + i] = k;
  }

  cluster.sync();  // every block's keys are written and visible to the cluster
  for (int r = rank + S * (int)threadIdx.x; r < R; r += S * kThreads) {
    unsigned long long k = ~0ull;
    for (int q = 0; q < S; ++q) {
      const unsigned long long v = cluster.map_shared_rank(keys, q)[r];
      k = v < k ? v : k;
    }
    if (row0 + r < M) out[row0 + r] = (int)(uint32_t)k;
  }
  // no block's shared memory goes while a neighbour reads it; the reads above
  // have completed (their values are used), so the arrive needs no fence
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int D>
cudaError_t launch(const float* enc, const float* cb, int* out, int M, int N, int S, int share,
                   int tile, int rows, int smem, cudaStream_t stream) {
  const long long clusters = (M + (long long)rows - 1) / rows;
  const int buffers = share > tile ? 2 : 1;
  if (rows != kGroups * rows_per_thread<D>() || M < 1 || N < 1 || S < 1 || S > kMaxCluster ||
      share < 1 || tile < 1 || (long long)S * share < N || (long long)(S - 1) * share >= N ||
      smem > kMaxSmem ||
      (size_t)smem < rows * (sizeof(unsigned long long) + (D + 1) * sizeof(float)) +
                         buffers * tile_words(D, tile) * sizeof(float) ||
      clusters * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * S));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, vq_argmin_cluster<D>, enc, cb, out, M, N, S, share, tile, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of S blocks with `smem` bytes each the card can hold at
// once (0: none can be placed), or minus a cudaError_t.
template <int D>
int max_clusters(int S, int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, vq_argmin_cluster<D>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace

extern "C" {

// D in {8, 16, 24, 32}; S <= 8; the rest as k1_geometry gives it.
int vq_argmin_max_clusters(int D, int S, int smem) {
  if (S < 1 || S > kMaxCluster || smem < 0 || smem > kMaxSmem)
    return -(int)cudaErrorInvalidValue;
  switch (D) {
    case 8: return max_clusters<8>(S, smem);
    case 16: return max_clusters<16>(S, smem);
    case 24: return max_clusters<24>(S, smem);
    case 32: return max_clusters<32>(S, smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// enc (M, D) and cb (N, D) fp32 contiguous, cb the raw codebook; out (M,)
// int32. Returns the cudaError_t of the launch (0 on success).
int vq_argmin_launch(const float* enc, const float* cb, int* out, int M, int N, int D, int S,
                     int share, int tile, int rows, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return (int)launch<8>(enc, cb, out, M, N, S, share, tile, rows, smem, s);
    case 16: return (int)launch<16>(enc, cb, out, M, N, S, share, tile, rows, smem, s);
    case 24: return (int)launch<24>(enc, cb, out, M, N, S, share, tile, rows, smem, s);
    case 32: return (int)launch<32>(enc, cb, out, M, N, S, share, tile, rows, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
