// Streaming k-means assignment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kmeans_assign.py::kmeans_assign (body _assign_kernel).
// For rows x f32[M, D] and centroids c f32[C, D] it returns, per row,
//
//   idx  = argmin_c ( ||c||^2 - 2 bf16(x) . bf16(c) )   (f32 accumulation)
//   dist = that minimum (the per-row ||x||^2 is rank-invariant and dropped)
//
// with the lowest centroid index winning a tie, as the TPU kernel's
// first-index argmin inside a block plus strict '<' across blocks gives.
// ||c||^2 comes from the f32 centroids (computed by the caller).
//
// What bounds it on this card: operations.  Each row meets all C centroids,
// about C/2 flop per byte of x (512 at C = 1024), above the H100's ~295
// flop/byte bf16 ridge, so the tensor cores are the limit.
//
// What the design does about it: a block owns a 128-row tile of x and loops
// over every 128-centroid tile inside the block — the loop takes the place
// of the TPU grid's sequential centroid axis, so the running (min, argmin)
// stays in registers and the [M, C] distance matrix is never written.  The
// products run on the tensor cores (WMMA bf16, f32 accumulate); operands are
// converted f32 -> bf16 in registers on their way to shared memory, and the
// next stage's global loads are issued before the current stage's MMAs.
// Ragged M, C and D are masked in the kernel.
//
// The ablation rung `fused_conversion=False` multiplies in f32, without the
// bf16 rounding: kmeans_assign_f32_kernel does the same row-tile loop with
// FFMA on the CUDA cores (an 8 x 8 product tile per thread; the card's f32
// peak is 67 TFLOP/s against 989 for bf16 tensor cores) and shares the
// argmin.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;          // rows per block
constexpr int BN = 128;          // centroids per inner tile
constexpr int BK = 32;           // depth per pipeline stage
constexpr int LDS = BK + 8;      // padded shared row, bf16 elements
constexpr int THREADS = 256;     // 8 warps: 2 (rows) x 4 (centroids)
constexpr int STAGE_LD = BN + 4; // f32 staging row for the reduction
constexpr int V = BK / 4;        // float4 per tile row
constexpr int XV = BM * V / THREADS;
constexpr int CV = BN * V / THREADS;
constexpr int TILE_BYTES = (BM + BN) * LDS * 2;
constexpr int SMEM_BYTES = TILE_BYTES + BM * STAGE_LD * 4;

__device__ __forceinline__ float4 load4(const float* __restrict__ base,
                                        int row, int nrows, int k, int D,
                                        int vec4) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < nrows) {
    const float* p = base + (size_t)row * D + k;
    if (vec4 && k + 3 < D) {
      v = *reinterpret_cast<const float4*>(p);
    } else {
      if (k < D) v.x = p[0];
      if (k + 1 < D) v.y = p[1];
      if (k + 2 < D) v.z = p[2];
      if (k + 3 < D) v.w = p[3];
    }
  }
  return v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* s, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(s)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(s)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Folds one staged [BM, BN] tile of products (centroid tile `ct`) into the
// running best of row r: thread pair (2r, 2r+1) scans 64 columns each in
// ascending order (first index wins), the pair merges, and strict '<'
// across tiles keeps a tie with the earlier (lower-index) tile.
__device__ __forceinline__ void fold_tile(const float* stage,
                                          const float* __restrict__ cnorm,
                                          int ct, int C, int r, int half,
                                          float& best, int& best_i) {
  const int cbase = ct * BN + half * 64;
  const float* srow = stage + r * STAGE_LD + half * 64;
  float lb = INFINITY;
  int li = cbase;
  for (int c = 0; c < 64; ++c) {
    if (cbase + c < C) {
      const float d = cnorm[cbase + c] - 2.f * srow[c];
      if (d < lb) {
        lb = d;
        li = cbase + c;
      }
    }
  }
  const float ob = __shfl_xor_sync(0xffffffffu, lb, 1);
  const int oi = __shfl_xor_sync(0xffffffffu, li, 1);
  if (ob < lb || (ob == lb && oi < li)) {
    lb = ob;
    li = oi;
  }
  if (lb < best) {
    best = lb;
    best_i = li;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
kmeans_assign_kernel(const float* __restrict__ x,
                     const float* __restrict__ cent,
                     const float* __restrict__ cnorm, int* __restrict__ idx,
                     float* __restrict__ dist, int M, int C, int D,
                     int vec4) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sC = sX + BM * LDS;
  float* stage = reinterpret_cast<float*>(smem + TILE_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * BM;
  const int nk = (D + BK - 1) / BK;
  const int nct = (C + BN - 1) / BN;
  const int total = nk * nct;

  float4 rx[XV], rc[CV];
  auto fetch = [&](int s) {
    const int c0 = (s / nk) * BN, k0 = (s % nk) * BK;
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int e = tid + i * THREADS;
      rx[i] = load4(x, m0 + e / V, M, k0 + (e % V) * 4, D, vec4);
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const int e = tid + i * THREADS;
      rc[i] = load4(cent, c0 + e / V, C, k0 + (e % V) * 4, D, vec4);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int e = tid + i * THREADS;
      store4(sX + (e / V) * LDS + (e % V) * 4, rx[i]);
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const int e = tid + i * THREADS;
      store4(sC + (e / V) * LDS + (e % V) * 4, rc[i]);
    }
  };

  // two threads per row: thread pair (2r, 2r+1) reduces row r's 128
  // centroid columns, 64 each, and both keep the row's running best
  const int r = tid >> 1, half = tid & 1;
  float best = INFINITY;
  int best_i = 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
  fetch(0);
  int s = 0;
  for (int ct = 0; ct < nct; ++ct) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int kt = 0; kt < nk; ++kt, ++s) {
      stash();
      __syncthreads();
      if (s + 1 < total) fetch(s + 1);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j],
                                 sC + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::load_matrix_sync(fa, sX + (wm * 64 + i * 16) * LDS + kk,
                                 LDS);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            stage + (wm * 64 + i * 16) * STAGE_LD + wn * 32 + j * 16,
            acc[i][j], STAGE_LD, wmma::mem_row_major);
    __syncthreads();

    fold_tile(stage, cnorm, ct, C, r, half, best, best_i);
    __syncthreads();
  }
  if (half == 0 && m0 + r < M) {
    idx[m0 + r] = best_i;
    dist[m0 + r] = best;
  }
}

// f32 products (fused_conversion=False).  Each stage holds FK columns of the
// row and centroid tiles transposed in shared memory; thread (ty, tx) of a
// 16 x 16 grid owns rows ty + 16 i and centroids tx + 16 j (i, j < 8).
constexpr int FK = 16;
constexpr int FLD = BM + 1;      // padded transposed row, f32 elements
constexpr int F_TILE_BYTES = 2 * FK * FLD * 4;
constexpr int F_SMEM_BYTES = F_TILE_BYTES + BM * STAGE_LD * 4;
static_assert(BM == BN, "the f32 tiles share one layout");
static_assert(F_TILE_BYTES % 16 == 0, "stage must stay 16-byte aligned");

__global__ void __launch_bounds__(THREADS)
kmeans_assign_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ cent,
                         const float* __restrict__ cnorm,
                         int* __restrict__ idx, float* __restrict__ dist,
                         int M, int C, int D, int vec4) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sXt = reinterpret_cast<float*>(smem);
  float* sCt = sXt + FK * FLD;
  float* stage = reinterpret_cast<float*>(smem + F_TILE_BYTES);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int r = tid >> 1, half = tid & 1;
  float best = INFINITY;
  int best_i = 0;

  for (int ct = 0; ct * BN < C; ++ct) {
    const int c0 = ct * BN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += FK) {
#pragma unroll
      for (int i = 0; i < BM * FK / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int row = e / (FK / 4), kq = (e % (FK / 4)) * 4;
        const float4 v = load4(x, m0 + row, M, k0 + kq, D, vec4);
        const float4 w = load4(cent, c0 + row, C, k0 + kq, D, vec4);
        sXt[(kq + 0) * FLD + row] = v.x;
        sXt[(kq + 1) * FLD + row] = v.y;
        sXt[(kq + 2) * FLD + row] = v.z;
        sXt[(kq + 3) * FLD + row] = v.w;
        sCt[(kq + 0) * FLD + row] = w.x;
        sCt[(kq + 1) * FLD + row] = w.y;
        sCt[(kq + 2) * FLD + row] = w.z;
        sCt[(kq + 3) * FLD + row] = w.w;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sXt[k * FLD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = sCt[k * FLD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        stage[(ty + 16 * i) * STAGE_LD + tx + 16 * j] = acc[i][j];
    __syncthreads();
    fold_tile(stage, cnorm, ct, C, r, half, best, best_i);
    __syncthreads();
  }
  if (half == 0 && m0 + r < M) {
    idx[m0 + r] = best_i;
    dist[m0 + r] = best;
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  `f32` selects the f32-product
// variant.  Launches on `stream` and returns the first CUDA error (attribute
// set or launch), else 0.
extern "C" int kmeans_assign_launch(const float* x, const float* cent,
                                    const float* cnorm, int* idx,
                                    float* dist, int M, int C, int D,
                                    int vec4, int f32, void* stream) {
  const void* kernel = f32 ? reinterpret_cast<const void*>(
                                 kmeans_assign_f32_kernel)
                           : reinterpret_cast<const void*>(
                                 kmeans_assign_kernel);
  const int smem = f32 ? F_SMEM_BYTES : SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    kmeans_assign_f32_kernel<<<grid, THREADS, smem, st>>>(
        x, cent, cnorm, idx, dist, M, C, D, vec4);
  else
    kmeans_assign_kernel<<<grid, THREADS, smem, st>>>(
        x, cent, cnorm, idx, dist, M, C, D, vec4);
  return static_cast<int>(cudaGetLastError());
}
