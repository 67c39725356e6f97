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
// Two variants of the bf16 product, chosen by the wrapper from shapes and
// alignment alone:
//
// `wgmma` (D % 4 == 0, 16-byte-aligned x and centroids, any depth): wgmma
// products from bf16 A fragments that the consumer threads convert from TMA
// boxes of f32 rows (the TPU kernel's fused conversion: every row read as
// f32 and converted once per pass), bf16 centroids from a prepare pass that
// rounds them once per call (2 MB at C = D = 1024) and takes their norms,
// one producer warp keeping a ring of TMA stages full (full/empty mbarrier
// pairs; a stage is free again when the consumers of every block of the
// cluster are done with it), two consumer warpgroups with the accumulator
// in registers that fold each finished centroid tile into a running (min,
// first index) straight from the accumulator fragments.  A persistent grid
// of clusters walks the work items.  Two modes, by D:
//
//  * resident (D <= 1024, where all MAX_STAGES ring stages fit beside the
//    row tile; the kernel takes up to D = 1536, MIN_STAGES stages, but
//    with fewer than four the streamed mode is faster on an H100).
//    2-block clusters; a block holds a 64-row
//    tile of x as bf16 for all of D and loops over every centroid tile
//    against it, a loop that takes the place of the TPU grid's sequential
//    centroid axis.  The tile's first 256 of depth go to registers as A
//    fragments (each consumer warpgroup holds its own copy), the rest to
//    shared memory in the 128-byte-swizzled K-major layout a wgmma
//    descriptor reads, which leaves room for a fourth ring stage at D =
//    1024.  Centroids stream through a ring of 256-centroid x 64-deep
//    stages, each block of a cluster loading one half of a stage and
//    TMA-multicasting it to both; the warpgroups run m64n128k16 on one
//    128-centroid half each.  At D = 1024 the stream of stages into each
//    SM, not the tensor cores, sets the pace, so a stage is released as
//    soon as its products are done.
//  * streamed (D > 1024; a 64-row bf16 tile is 256 KB at D = 2048, more
//    than an SM holds).  No resident tile: 4-block clusters share one
//    128-row tile of x, and block r of a cluster owns every fourth
//    centroid tile of the item (C/4 centroids each at C = 1024).  Two
//    rings: 32-deep f32 slabs of the tile (16 KB; each block loads a
//    quarter and TMA-multicasts it to all four; six slots, each freed for
//    the cluster as soon as every block has converted it into A
//    fragments) and the block's own 256 x 64 bf16 centroid slabs (32 KB;
//    four slots, freed when their products are done).  The stream is
//    bound by the round trip of a slot, not by bandwidth, so the rings
//    fill shared memory and the x slots, which the whole cluster waits
//    on, are held for the conversion only.  Each consumer warpgroup
//    converts its 64 rows of a slab and queues its products (m64n128k16
//    twice per depth step, both halves of the centroid slab) before it
//    waits for the slab before, so the tensor cores always have the next
//    group (no branch between a group's issue and its wait that ptxas
//    could take for divergent: it would serialize every wgmma); the
//    producer warpgroup hands its registers to the consumers
//    (setmaxnreg).  x is read from device memory once per pass as f32
//    (8.2 GB at M = 1 M, D = 2048, under the 4.2 ms the products take) and
//    the centroids come from L2.  The four blocks (and the centroid
//    slices below) merge per row with a 64-bit atomicMin on a key ordered
//    as (dist, idx), and the last of them to finish a row tile writes its
//    rows out.
//
// When M is small the centroid tiles are split across clusters (`nsplit`,
// a launch parameter; the streamed mode also halves its centroid tile to
// 128) and the slices merge the same way.
//
// `generic` (any shape): a block owns a 128-row tile of x and loops over
// every 128-centroid tile; WMMA bf16 with f32 accumulation, operands
// converted f32 -> bf16 on their way to shared memory, the product tile
// staged in shared memory for the argmin.  Ragged M, C and D are masked in
// the kernel.
//
// The ablation rung `fused_conversion=False` multiplies in f32, without the
// bf16 rounding, with FFMA on the CUDA cores (67 TFLOP/s against 989 for
// bf16 tensor cores, so bound by operations): a register-tiled SGEMM whose
// argmin is folded from the accumulators.  A block owns 128 rows of x and
// loops over 256-centroid tiles (x is read C / 256 times, from L2 or device
// memory, under the FFMA time); each of 256 threads holds an 8 x 16
// product tile.  Where x and the centroids are 16-byte aligned and D % 4
// == 0, TMA brings 32-deep slabs of both into a 4-slot ring
// (kmeans_assign_f32_tma_kernel: no thread instruction or register spent
// on a load, conflict-free float4 shared loads through the swizzle, 32
// FFMA a load); otherwise kmeans_assign_f32_kernel stages 16-deep slabs
// through registers into transposed, padded, double-buffered shared
// memory with masked loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "scan_stream.cuh"

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

// f32 products (fused_conversion=False), any shape: a register-tiled
// SGEMM whose masked loads take ragged M, C and D and any alignment (the
// TMA-fed kernel below takes the aligned shapes).  Warp w
// of 8 owns rows 64 (w / 4) .. +63 and centroids 4 TN (w % 4) .. of the
// 128 x 16 TN block tile; lane l of it rows 4 (l % 8) + {0..3, 32..35} and
// centroids 4 (l / 8) + 16 q + {0..3} (q < TN / 4) of those, so a depth
// step reads two float4 of x and TN / 4 of centroids, each a conflict-free
// (broadcast) shared load.  The slabs are stored transposed, rows padded by
// 4 floats so that the scalar transposed stores hit 32 banks.
namespace f32k {
constexpr int TN = 16;             // centroids of a thread's tile
constexpr int BM = 128;            // rows of x per block
constexpr int BN = 16 * TN;        // centroids per tile
constexpr int BK = 16;             // depth per slab
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;
constexpr int LDB = BN + 4;
constexpr int XQ = BM * BK / 4 / THREADS;   // float4 of x a thread loads
constexpr int CQ = BN * BK / 4 / THREADS;   // float4 of centroids
constexpr int SMEM_BYTES = 2 * BK * (LDA + LDB) * 4 + 4 * BM * 8;
static_assert(XQ == 2 && CQ % 2 == 0, "a slab row is two 8-deep halves");

__global__ void __launch_bounds__(THREADS, 1)
kmeans_assign_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ cent,
                         const float* __restrict__ cnorm,
                         int* __restrict__ idx, float* __restrict__ dist,
                         int M, int C, int D, int vec4) {
  extern __shared__ __align__(16) float smem_f[];
  float (*sA)[BK][LDA] = reinterpret_cast<float (*)[BK][LDA]>(smem_f);
  float (*sB)[BK][LDB] =
      reinterpret_cast<float (*)[BK][LDB]>(smem_f + 2 * BK * LDA);
  float (*red_d)[BM] =
      reinterpret_cast<float (*)[BM]>(smem_f + 2 * BK * (LDA + LDB));
  int (*red_i)[BM] = reinterpret_cast<int (*)[BM]>(red_d + 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4, lr = lane % 8, lc = lane / 8;
  const int ar = 64 * wm + 4 * lr;         // first of the thread's rows
  const int bc = 4 * TN * wn + 4 * lc;     // first of its centroid columns
  const int m0 = blockIdx.x * BM;
  const int nk = (D + BK - 1) / BK;
  const int nct = (C + BN - 1) / BN;
  const int total = nk * nct;

  // the slab loads: row (or centroid) tid / 2 (+ 128 j), depth 8 j' +
  // 4 (tid % 2): a warp's stores of one float4 slot fall in 32 banks
  const int lrow = tid >> 1, lk = (tid & 1) * 4;
  float4 ra[XQ], rb[CQ];
  // slab (ct, kt): centroid tile ct, depth kt * BK
  auto fetch = [&](int ct, int kt) {
    const int c0 = ct * BN, k0 = kt * BK + lk;
#pragma unroll
    for (int j = 0; j < XQ; ++j)
      ra[j] = load4(x, m0 + lrow, M, k0 + 8 * j, D, vec4);
#pragma unroll
    for (int j = 0; j < CQ; ++j)
      rb[j] = load4(cent, c0 + lrow + BM * (j >> 1), C, k0 + 8 * (j & 1), D,
                    vec4);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < XQ; ++j) {
      sA[buf][lk + 8 * j + 0][lrow] = ra[j].x;
      sA[buf][lk + 8 * j + 1][lrow] = ra[j].y;
      sA[buf][lk + 8 * j + 2][lrow] = ra[j].z;
      sA[buf][lk + 8 * j + 3][lrow] = ra[j].w;
    }
#pragma unroll
    for (int j = 0; j < CQ; ++j) {
      const int k = lk + 8 * (j & 1), c = lrow + BM * (j >> 1);
      sB[buf][k + 0][c] = rb[j].x;
      sB[buf][k + 1][c] = rb[j].y;
      sB[buf][k + 2][c] = rb[j].z;
      sB[buf][k + 3][c] = rb[j].w;
    }
  };

  // the thread's running best per row over its own columns, which it
  // meets in ascending order (strict '<': the first index wins)
  float best[8];
  int bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    bi[i] = 0;
  }
  float acc[8][TN];
  fetch(0, 0);
  stash(0);
  __syncthreads();
  int s = 0;
  for (int ct = 0; ct < nct; ++ct) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++s) {
      const int buf = s & 1;
      if (s + 1 < total) {
        if (kt + 1 < nk)
          fetch(ct, kt + 1);
        else
          fetch(ct + 1, 0);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sA[buf][k][ar]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sA[buf][k][ar + 32]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(&sB[buf][k][bc + 16 * q]);
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (s + 1 < total) stash(buf ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = ct * BN + bc + 16 * (j / 4) + j % 4;
      if (col < C) {
        const float cn = __ldg(cnorm + col);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = cn - 2.f * acc[i][j];
          if (v < best[i]) {
            best[i] = v;
            bi[i] = col;
          }
        }
      }
    }
  }
  // merge the 16 threads of each row: the 4 lanes of a warp (l / 8), then
  // the 4 warps (w % 4) through shared memory, lexicographic on (dist, idx)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off <= 16; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (ob < best[i] || (ob == best[i] && oi < bi[i])) {
        best[i] = ob;
        bi[i] = oi;
      }
    }
    if (lc == 0) {
      const int r = ar + 32 * (i / 4) + i % 4;
      red_d[wn][r] = best[i];
      red_i[wn][r] = bi[i];
    }
  }
  __syncthreads();
  if (tid < BM && m0 + tid < M) {
    float d = red_d[0][tid];
    int b = red_i[0][tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float od = red_d[w][tid];
      const int oi = red_i[w][tid];
      if (od < d || (od == d && oi < b)) {
        d = od;
        b = oi;
      }
    }
    idx[m0 + tid] = b;
    dist[m0 + tid] = d;
  }
}


// Component k (a constant after unrolling) of a float4.
__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// A thread's 8 rows (128 * 8 bytes apart from `rows`), physical chunk pc
// of each.
__device__ __forceinline__ void load_rows(float4 (&a)[8], const uint8_t* rows,
                                          int pc) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = *reinterpret_cast<const float4*>(rows + i * 8 * 128 + (pc << 4));
}

// acc[i][j] += the 4 depth steps of chunk c: rows a against the thread's 16
// centroids (4 * 128 bytes apart from `cols`, the odd ones 4 rows further
// in the swizzle), eight centroids at a time, so each step is 64
// independent FFMA.
__device__ __forceinline__ void group_products(float (&acc)[8][16],
                                               const float4 (&a)[8],
                                               const uint8_t* cols, int c,
                                               int lc) {
  const int ce = (c ^ lc) << 4, co = (c ^ (lc + 4)) << 4;
#pragma unroll
  for (int jh = 0; jh < 16; jh += 8) {
    float4 b[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      b[jj] = *reinterpret_cast<const float4*>(cols + (jh + jj) * 4 * 128 +
                                               ((jj & 1) ? co : ce));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[i][jh + jj] =
              fmaf(lane4(a[i], kk), lane4(b[jj], kk), acc[i][jh + jj]);
  }
}

// The same products where TMA can feed them (16-byte-aligned x and
// centroids, D % 4 == 0): a 32-deep slab is two TMA boxes (128 rows of x,
// 256 centroids; 128-byte swizzled, zero-filled past M, C and D) in a
// ring of TMA_STAGES, so no thread spends an instruction or a register on
// a slab in flight and shared memory keeps the rows' own layout.  A thread
// takes its 8 rows (64 (w / 4) + l % 8 + 8 i) as one float4 of depth each
// per 4 depth steps, then each of its 16 centroids (64 (w % 4) + l / 8 +
// 4 j) as a float4 against them: 32 FFMA a shared load, the loads
// conflict-free through the swizzle (a quarter warp reads 8 rows at 8
// distinct chunks, or one address).  Warps free a slot through an empty
// barrier and thread 0 refills it a slab late, so no block barrier lines
// the warps up between slabs.
constexpr int TMA_BK = 32;                       // f32 depth of a box
constexpr int TMA_STAGES = 4;
constexpr int TMA_A_BYTES = BM * TMA_BK * 4;
constexpr int TMA_STAGE_BYTES = TMA_A_BYTES + 256 * TMA_BK * 4;
constexpr int TMA_SMEM_BYTES = 1024 + TMA_STAGES * TMA_STAGE_BYTES +
                               2 * TMA_STAGES * 8 + 4 * BM * 8;
static_assert(BN == 256, "the centroid box is 256 rows");

__global__ void __launch_bounds__(THREADS, 1)
kmeans_assign_f32_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap c_map,
                             const float* __restrict__ cnorm,
                             int* __restrict__ idx, float* __restrict__ dist,
                             int M, int C, int D) {
  using scan_stream::smem_u32;
  extern __shared__ uint8_t smem_t[];
  const uint32_t base = smem_u32(smem_t);
  uint8_t* ring = smem_t + ((1024 - (base & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + TMA_STAGES * TMA_STAGE_BYTES);
  uint64_t* empty = full + TMA_STAGES;
  float (*red_d)[BM] = reinterpret_cast<float (*)[BM]>(empty + TMA_STAGES);
  int (*red_i)[BM] = reinterpret_cast<int (*)[BM]>(red_d + 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4, lr = lane % 8, lc = lane / 8;
  const int m0 = blockIdx.x * BM;
  const int nk = (D + TMA_BK - 1) / TMA_BK;
  const int nct = (C + BN - 1) / BN;
  const int total = nk * nct;
  if (tid == 0) {
    for (int i = 0; i < TMA_STAGES; ++i) {
      scan_stream::bar_init(&full[i], 1);
      scan_stream::bar_init(&empty[i], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // slab s (centroid tile s / nk, depth s % nk) into slot s % TMA_STAGES
  auto issue = [&](int s) {
    uint8_t* st = ring + (s % TMA_STAGES) * TMA_STAGE_BYTES;
    uint64_t* bar = &full[s % TMA_STAGES];
    scan_stream::bar_expect_tx(bar, TMA_STAGE_BYTES);
    scan_stream::tma_load(st, &x_map, bar, (s % nk) * TMA_BK, m0);
    scan_stream::tma_load(st + TMA_A_BYTES, &c_map, bar, (s % nk) * TMA_BK,
                          (s / nk) * BN);
  };
  if (tid == 0)
    for (int s = 0; s < TMA_STAGES && s < total; ++s) issue(s);

  // the thread's rows are 64 wm + lr + 8 i (row & 7 == lr), its centroids
  // 64 wn + lc + 4 j (& 7 == lc + 4 (j & 1)): chunk c of a row sits at
  // chunk c ^ (row & 7)
  const uint32_t a_off = (64 * wm + lr) * 128;
  const uint32_t b_off = TMA_A_BYTES + (64 * wn + lc) * 128;
  float best[8];
  int bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    bi[i] = 0;
  }
  float acc[8][16];
  int s = 0;
  for (int ct = 0; ct < nct; ++ct) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++s) {
      scan_stream::bar_wait(&full[s % TMA_STAGES], (s / TMA_STAGES) & 1);
      const uint8_t* st = ring + (s % TMA_STAGES) * TMA_STAGE_BYTES;
#pragma unroll 1
      for (int c = 0; c < TMA_BK / 4; ++c) {
        float4 a[8];
        load_rows(a, st + a_off, c ^ lr);
        group_products(acc, a, st + b_off, c, lc);
      }
      // this warp is done with the slot; thread 0 refills the slot of the
      // slab before once every warp is done with it (a slab late, so no
      // barrier lines the warps up: they drift and cover each other's
      // shared-load stalls)
      __syncwarp();
      if (lane == 0) scan_stream::bar_arrive(&empty[s % TMA_STAGES]);
      if (tid == 0 && s > 0 && s - 1 + TMA_STAGES < total) {
        scan_stream::bar_wait(&empty[(s - 1) % TMA_STAGES],
                              ((s - 1) / TMA_STAGES) & 1);
        issue(s - 1 + TMA_STAGES);
      }
    }
    // the thread's columns in ascending order, strict '<'
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = ct * BN + 64 * wn + lc + 4 * j;
      if (col < C) {
        const float cn = __ldg(cnorm + col);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = cn - 2.f * acc[i][j];
          if (v < best[i]) {
            best[i] = v;
            bi[i] = col;
          }
        }
      }
    }
  }
  // merge the 16 threads of each row: the 4 lanes of a warp (l / 8), then
  // the 4 warps (w % 4) through shared memory, lexicographic on (dist, idx)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off <= 16; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (ob < best[i] || (ob == best[i] && oi < bi[i])) {
        best[i] = ob;
        bi[i] = oi;
      }
    }
    if (lc == 0) {
      red_d[wn][64 * wm + lr + 8 * i] = best[i];
      red_i[wn][64 * wm + lr + 8 * i] = bi[i];
    }
  }
  __syncthreads();
  if (tid < BM && m0 + tid < M) {
    float d = red_d[0][tid];
    int b = red_i[0][tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float od = red_d[w][tid];
      const int oi = red_i[w][tid];
      if (od < d || (od == d && oi < b)) {
        d = od;
        b = oi;
      }
    }
    idx[m0 + tid] = b;
    dist[m0 + tid] = d;
  }
}

}  // namespace f32k

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// `wgmma` variant.  The host-side sizes are mirrored in
// kernels/kmeans_assign.py, which chooses the variant, the mode and the C
// split.
namespace wg {

constexpr int ROWS = 64;                 // resident rows of x (the wgmma M)
constexpr int CTILE = 256;               // centroids per stage
constexpr int HALF = CTILE / 2;          // a warpgroup's, and a block's load
constexpr int KSLAB = 64;                // bf16 depth of a slab / stage
constexpr int SLAB_BYTES = ROWS * 128;   // one 64-deep slab of the row tile
constexpr int XBOX = 32;                 // f32 depth of an x box (128 bytes)
constexpr int XCHUNK = 4 * XBOX;         // f32 depth of an x stage
constexpr int XBOX_BYTES = ROWS * 128;
constexpr int STAGE_BYTES = CTILE * 128;
constexpr int HALF_BYTES = HALF * 128;
constexpr int REG_CHUNKS = 2;            // x chunks held in registers
constexpr int REG_SLABS = 2 * REG_CHUNKS;
constexpr int REG_STEPS = REG_SLABS * KSLAB / 16;
constexpr int CLUSTER = 2;               // blocks sharing each centroid stage
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 4;
constexpr int ALIGN = 1024;              // the 128-byte swizzle repeats per KB
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
constexpr int MERGE_BYTES = 2 * ROWS * 8;  // the two warpgroups' row minima
constexpr int SMEM_LIMIT = 232448;
static_assert(STAGE_BYTES == 4 * XBOX_BYTES, "an x stage fills a ring stage");

// The streamed mode: a 128-row tile of x shared by a 4-block cluster.  Two
// rings: 32-deep f32 slabs of the tile (each block loads a quarter and
// multicasts it; a slot is free once every block has converted it) and
// the block's 64-deep bf16 centroid slabs (free once their products are
// done).
constexpr int S_CLUSTER = 4;                  // blocks sharing each x slab
constexpr int S_ROWS = 2 * ROWS;              // rows of a cluster's row tile
constexpr int S_XROWS = S_ROWS / S_CLUSTER;   // rows of a block's x box
constexpr int S_XSTAGE_BYTES = S_ROWS * 128;  // a 32-deep f32 slab of the tile
constexpr int S_XSTAGES = 6;
constexpr int S_CSTAGES = 4;
constexpr int S_FLAG_BYTES = 16;
constexpr int S_THREADS = CONSUMERS + 128;    // + a producer warpgroup
constexpr int S_PRODUCER_REGS = 40;           // setmaxnreg: 128 x 40 +
constexpr int S_CONSUMER_REGS = 232;          // 256 x 232 <= 64 K registers
constexpr int S_SMEM_BYTES = ALIGN + S_XSTAGES * S_XSTAGE_BYTES +
                             S_CSTAGES * STAGE_BYTES +
                             2 * (S_XSTAGES + S_CSTAGES) * 8 + S_FLAG_BYTES;
static_assert(S_XSTAGE_BYTES == XBOX * 4 * S_ROWS, "x slab is one box deep");
static_assert(S_SMEM_BYTES <= SMEM_LIMIT, "the streamed rings must fit");

// x chunks of XCHUNK f32 per row tile.
inline int chunks(int D) { return (D + XCHUNK - 1) / XCHUNK; }
// Whether the first REG_CHUNKS chunks of the row tile live in registers
// (each consumer warpgroup holds them as wgmma A fragments), which leaves
// shared memory for one more ring stage at D = 1024.
inline bool reg_part(int D) { return chunks(D) > REG_CHUNKS; }
// The row tile's bf16 slabs in shared memory.
inline int tile_bytes(int D) {
  return (2 * chunks(D) - (reg_part(D) ? REG_SLABS : 0)) * SLAB_BYTES;
}
inline int fixed_bytes(int D) {
  return ALIGN + tile_bytes(D) + BAR_BYTES + MERGE_BYTES;
}
// Ring stages that fit beside the row tile (< MIN_STAGES: the shape is the
// generic variant's).
inline int ring_stages(int D) {
  const int s = (SMEM_LIMIT - fixed_bytes(D)) / STAGE_BYTES;
  return s > MAX_STAGES ? MAX_STAGES : s;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Arrive on the barrier at `bar`'s offset in cluster block `rank`.
__device__ __forceinline__ void arrive_in(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(scan_stream::smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// A lane-0 release of ring stage `bar` to this block's producer, once the
// whole warp is done with it.
__device__ __forceinline__ void release_local(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) scan_stream::bar_arrive(bar);
}

// A lane-0 release of ring stage `bar` to the producers of the cluster's
// `n` blocks, once the whole warp is done with it.
__device__ __forceinline__ void release(uint64_t* bar, int lane,
                                        uint32_t n = CLUSTER) {
  __syncwarp();
  if (lane == 0)
    for (uint32_t r = 0; r < n; ++r) arrive_in(bar, r);
}

// One TMA box written at dst's offset in every block of `mask`, each
// block's barrier at bar's offset completing on its bytes.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          scan_stream::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(scan_stream::smem_u32(bar)),
      "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// The two consumer warpgroups (named barrier 1; the producer never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma descriptor of a K-major bf16 operand, 128-byte swizzle: rows of
// 128 bytes, 8-row core groups 1 KB apart (SBO), one 16-deep step per 32
// bytes of start address inside the swizzle span.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A[64 x 16] . B[128 x 16]^T, bf16, f32 accumulator; B K-major in
// shared memory (descriptor db), A K-major in shared memory (descriptor da)
// or in registers (a: the mma.m16n8k16 A fragment of warp w's rows 16w..).
// Thread t of the warpgroup holds d[4j + 2h + e] = row 16 (t / 32) +
// (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Keeps A fragments that an issued wgmma reads live (and unmoved) until the
// wait that follows.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The slices' merge key: the order-preserving bits of dist (-0.0 taken as
// +0.0) above the index, so an unsigned min is the lexicographic min of
// (dist, idx).
__device__ __forceinline__ unsigned long long merge_key(float d, int i) {
  if (d == 0.f) d = 0.f;
  uint32_t u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(i);
}

__device__ __forceinline__ void unpack_key(unsigned long long k, int* idx,
                                           float* dist) {
  uint32_t u = static_cast<uint32_t>(k >> 32);
  u = (u & 0x80000000u) ? (u ^ 0x80000000u) : ~u;
  *idx = static_cast<int>(static_cast<uint32_t>(k));
  *dist = __uint_as_float(u);
}

// Row tiles of the grid's tile pairs (the last pair's second tile may lie
// past M); a split launch keeps a slice counter for each.
__host__ __device__ inline int counted_tiles(int M) {
  return ((M + ROWS - 1) / ROWS + CLUSTER - 1) / CLUSTER * CLUSTER;
}

// Row tiles of the streamed mode, each with a counter of finished blocks.
__host__ __device__ inline int s_tiles(int M) {
  return (M + S_ROWS - 1) / S_ROWS;
}

// The launch's operands besides x, in one pass: cb bf16[Cp, Dp] (the
// centroids rounded to bf16, zero past C and D), cnorm f32[Cp] (||c||^2 of
// the f32 centroids, +inf past C, so padding never wins the argmin) and,
// when blocks merge through keys, the M merge keys set to their maximum and
// the n_keys - M row tiles' counters to 0.  One warp per centroid row; D %
// 4 == 0 and 16-byte-aligned rows, as the variant requires.
__global__ void prepare(const float* __restrict__ cent,
                        __nv_bfloat16* __restrict__ cb,
                        float* __restrict__ cnorm,
                        unsigned long long* __restrict__ keys, int M,
                        int n_keys, int C, int D, int Cp, int Dp) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32, n_threads = gridDim.x * blockDim.x;
  for (int c = tid / 32; c < Cp; c += n_threads / 32) {
    float s = 0.f;
    for (int k = 4 * lane; k < Dp; k += 128) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < C && k < D)
        v = __ldg(reinterpret_cast<const float4*>(
            cent + static_cast<size_t>(c) * D + k));
      s = fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, fmaf(v.x, v.x, s))));
      uint2 w;
      w.x = pack_bf16(make_float2(v.x, v.y));
      w.y = pack_bf16(make_float2(v.z, v.w));
      *reinterpret_cast<uint2*>(cb + static_cast<size_t>(c) * Dp + k) = w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) cnorm[c] = c < C ? s : INFINITY;
  }
  if (keys != nullptr)
    for (int i = tid; i < n_keys; i += n_threads)
      keys[i] = i < M ? ~0ull : 0ull;
}

// Converts ring stage `st` (64 rows x 128 f32 of one depth chunk: four
// swizzled boxes of 32) into bf16 slabs `slab`, `slab` + 1 of the row tile.
__device__ __forceinline__ void chunk_to_tile(const uint8_t* st,
                                              uint8_t* tile, int slab,
                                              int ctid) {
#pragma unroll
  for (int i = 0; i < ROWS * XCHUNK / 4 / CONSUMERS; ++i) {
    const int e = ctid + i * CONSUMERS;
    const int row = e >> 5, u = e & 31, b = u >> 3, ub = u & 7;
    const float4 v = *reinterpret_cast<const float4*>(
        st + b * XBOX_BYTES + row * 128 + ((ub ^ (row & 7)) << 4));
    const int unit = ((b & 1) << 2) + (ub >> 1);
    uint2 w;
    w.x = pack_bf16(make_float2(v.x, v.y));
    w.y = pack_bf16(make_float2(v.z, v.w));
    *reinterpret_cast<uint2*>(tile + (slab + (b >> 1)) * SLAB_BYTES +
                              row * 128 + ((unit ^ (row & 7)) << 4) +
                              ((ub & 1) << 3)) = w;
  }
}

// Converts STEPS wgmma depth steps of f32 boxes at `st` (32 deep, BOXB
// bytes apart, 128-byte swizzled rows) into this thread's A fragments:
// a[s][hr + 2 hk] packs row row0 + lane / 4 + 8 hr, depth 16 s + 2 (lane %
// 4) + 8 hk (+ 1).
template <int STEPS, int BOXB>
__device__ __forceinline__ void slab_to_regs(const uint8_t* st,
                                             uint32_t (*a)[4], int row0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + g + 8 * hr;
        const int f = 16 * (s & 1) + 2 * t + 8 * hk;   // f32 in its box
        const float2 v = *reinterpret_cast<const float2*>(
            st + (s >> 1) * BOXB + row * 128 +
            (((f >> 2) ^ (row & 7)) << 4) + ((f & 3) << 2));
        a[s][hr + 2 * hk] = pack_bf16(v);
      }
}

// Folds one 128-centroid half of a finished tile (columns cbase ..) into
// the running (min, first index) of the thread's two rows: its columns in
// ascending order, strict '<' (the norms stay in L1 after a block's first
// tile).
__device__ __forceinline__ void fold_half(const float (&acc)[64],
                                          const float* __restrict__ cnorm,
                                          int cbase, int lane,
                                          float (&best)[2], int (&bi)[2]) {
  const int c0 = cbase + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 cn = __ldg(reinterpret_cast<const float2*>(cnorm + c0 + 8 * j));
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = (e ? cn.y : cn.x) - 2.f * acc[4 * j + 2 * h + e];
        if (v < best[h]) {
          best[h] = v;
          bi[h] = c0 + 8 * j + e;
        }
      }
  }
}

// Work item it of a cluster: row-tile pair it / nsplit (the block of rank
// r takes tile 2 pair + r), centroid slice it % nsplit.
struct Item {
  int row0, ct0, ct1;
  __device__ Item(int it, int nsplit, int tps, int nct, uint32_t rank) {
    row0 = ((it / nsplit) * CLUSTER + static_cast<int>(rank)) * ROWS;
    ct0 = (it % nsplit) * tps;
    ct1 = ct0 + tps < nct ? ct0 + tps : nct;
  }
};

// One ring stage of products for warpgroup wgi: A from the row tile's slab
// at a_slab (shared memory) or from registers, B from the stage's half.
template <bool FROM_REGS>
__device__ __forceinline__ void stage_products(float (&acc)[64],
                                               const uint32_t (*a)[4],
                                               uint32_t a_slab, uint32_t b,
                                               bool first) {
#pragma unroll
  for (int k = 0; k < KSLAB / 16; ++k) {
    if constexpr (FROM_REGS)
      wgmma_rs(acc, a[k], desc_sw128(b + 32 * k), !(first && k == 0));
    else
      wgmma_ss(acc, desc_sw128(a_slab + 32 * k), desc_sw128(b + 32 * k),
               !(first && k == 0));
  }
}

// REG: the row tile's first REG_CHUNKS chunks are held in registers.
template <bool REG>
__global__ void __launch_bounds__(THREADS, 1)
kmeans_assign_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap c_map,
                           const float* __restrict__ cnorm,
                           int* __restrict__ idx, float* __restrict__ dist,
                           unsigned long long* __restrict__ keys, int M,
                           int D, int Cp, int nsplit, int stages) {
  using scan_stream::bar_expect_tx;
  using scan_stream::bar_init;
  using scan_stream::bar_wait;
  using scan_stream::smem_u32;
  constexpr int RC = REG ? REG_CHUNKS : 0;      // chunks held in registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t a0 = smem_u32(smem_raw);
  uint8_t* tile = smem_raw + ((ALIGN - (a0 & (ALIGN - 1))) & (ALIGN - 1));
  const int fs = (D + XCHUNK - 1) / XCHUNK;     // x stages per row tile
  const int kb_n = 2 * fs;                      // 64-deep slabs
  uint8_t* ring = tile + (kb_n - 2 * RC) * SLAB_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  float* m_dist = reinterpret_cast<float*>(empty + MAX_STAGES);  // [2][ROWS]
  int* m_idx = reinterpret_cast<int*>(m_dist + 2 * ROWS);
  const uint32_t rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], CLUSTER * CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both blocks' barriers exist before any multicast or remote arrive
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  const int n_pairs = counted_tiles(M) / CLUSTER;
  const int nct = Cp / CTILE;
  const int tps = (nct + nsplit - 1) / nsplit;
  const int n_slices = (nct + tps - 1) / tps;   // the non-empty ones
  const int items = n_pairs * nsplit;
  const int cid = blockIdx.x / CLUSTER, n_cl = gridDim.x / CLUSTER;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == CONSUMERS / 32) {
    // producer: lane 0 streams every stage in the consumers' order
    if (lane == 0) {
      scan_stream::Ring r(stages);
      for (int it = cid; it < items; it += n_cl) {
        const Item w(it, nsplit, tps, nct, rank);
        if (w.ct0 >= w.ct1) continue;
        for (int q = 0; q < fs; ++q) {
          bar_wait(&empty[r.stage], r.phase ^ 1u);
          bar_expect_tx(&full[r.stage], STAGE_BYTES);
          uint8_t* st = ring + r.stage * STAGE_BYTES;
          for (int b = 0; b < 4; ++b)
            scan_stream::tma_load(st + b * XBOX_BYTES, &x_map, &full[r.stage],
                                  q * XCHUNK + b * XBOX, w.row0);
          r.advance();
        }
        for (int ct = w.ct0; ct < w.ct1; ++ct)
          for (int kb = 0; kb < kb_n; ++kb) {
            bar_wait(&empty[r.stage], r.phase ^ 1u);
            bar_expect_tx(&full[r.stage], STAGE_BYTES);
            tma_load_multicast(ring + r.stage * STAGE_BYTES +
                                   rank * HALF_BYTES,
                               &c_map, &full[r.stage], kb * KSLAB,
                               ct * CTILE + rank * HALF,
                               static_cast<uint16_t>((1u << CLUSTER) - 1));
            r.advance();
          }
      }
    }
  } else {
    const int wgi = warp / 4, wl = warp % 4, ctid = threadIdx.x;
    const uint32_t tile_a = smem_u32(tile), ring_a = smem_u32(ring);
    scan_stream::Ring r(stages);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t areg[REG ? REG_STEPS : 1][4];
    for (int it = cid; it < items; it += n_cl) {
      const Item w(it, nsplit, tps, nct, rank);
      if (w.ct0 >= w.ct1) continue;
      // the row tile: f32 boxes -> bf16 A fragments and resident slabs
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        bar_wait(&full[r.stage], r.phase);
        slab_to_regs<XCHUNK / 16, XBOX_BYTES>(ring + r.stage * STAGE_BYTES,
                                              areg + q * XCHUNK / 16, 16 * wl,
                                              lane);
        release(&empty[r.stage], lane);
        r.advance();
      }
      for (int q = RC; q < fs; ++q) {
        bar_wait(&full[r.stage], r.phase);
        chunk_to_tile(ring + r.stage * STAGE_BYTES, tile, 2 * (q - RC), ctid);
        release(&empty[r.stage], lane);
        r.advance();
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();

      float best[2] = {INFINITY, INFINITY};
      int bi[2] = {0, 0};
      for (int ct = w.ct0; ct < w.ct1; ++ct) {
        // each stage is released as soon as its products are done: the
        // ring's depth, not the tensor cores, bounds the stream here, so
        // every slot not being read is a load in flight
#pragma unroll
        for (int kb = 0; kb < 2 * RC; ++kb) {
          bar_wait(&full[r.stage], r.phase);
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          stage_products<true>(acc, areg + kb * (KSLAB / 16), 0,
                               ring_a + r.stage * STAGE_BYTES +
                                   wgi * HALF_BYTES,
                               kb == 0);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_acc(acc);
          release(&empty[r.stage], lane);
          r.advance();
        }
        for (int kb = 2 * RC; kb < kb_n; ++kb) {
          bar_wait(&full[r.stage], r.phase);
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          stage_products<false>(acc, areg,
                                tile_a + (kb - 2 * RC) * SLAB_BYTES,
                                ring_a + r.stage * STAGE_BYTES +
                                    wgi * HALF_BYTES,
                                kb == 0);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_acc(acc);
          release(&empty[r.stage], lane);
          r.advance();
        }
        fold_half(acc, cnorm, ct * CTILE + wgi * HALF, lane, best, bi);
      }
      // merge the quad (lexicographic on (dist, idx)), then the warpgroups
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[h], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[h], off);
          if (ob < best[h] || (ob == best[h] && oi < bi[h])) {
            best[h] = ob;
            bi[h] = oi;
          }
        }
        if ((lane & 3) == 0) {
          const int rr = wl * 16 + (lane >> 2) + 8 * h;
          m_dist[wgi * ROWS + rr] = best[h];
          m_idx[wgi * ROWS + rr] = bi[h];
        }
      }
      consumers_sync();
      if (ctid < ROWS && w.row0 + ctid < M) {
        float d = m_dist[ctid];
        int i = m_idx[ctid];
        const float d1 = m_dist[ROWS + ctid];
        const int i1 = m_idx[ROWS + ctid];
        if (d1 < d || (d1 == d && i1 < i)) {
          d = d1;
          i = i1;
        }
        const int row = w.row0 + ctid;
        if (keys != nullptr) {
          atomicMin(keys + row, merge_key(d, i));
          __threadfence();
        } else {
          idx[row] = i;
          dist[row] = d;
        }
      }
      if (keys != nullptr) {
        // the last slice of this row tile to finish writes its rows out
        consumers_sync();
        if (ctid == 0) {
          const unsigned long long done =
              atomicAdd(keys + M + w.row0 / ROWS, 1ull);
          __threadfence();
          m_idx[0] = done + 1 == static_cast<unsigned long long>(n_slices);
        }
        consumers_sync();
        const int row = w.row0 + ctid;
        if (m_idx[0] && ctid < ROWS && row < M)
          unpack_key(__ldcg(keys + row), idx + row, dist + row);
      }
    }
  }
  // no block leaves while its peer may still write or arrive in it
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Work item it of the streamed grid: row tile it / nsplit, centroid slice
// it % nsplit (tiles ct0 .. ct1, a multiple of S_CLUSTER of them but the
// last slice's), which the cluster's blocks take in passes of S_CLUSTER
// tiles, block r the pass's tile r.
struct SItem {
  int row0, ct0, ct1;
  __device__ SItem(int it, int nsplit, int tps, int nct) {
    row0 = (it / nsplit) * S_ROWS;
    ct0 = (it % nsplit) * tps;
    ct1 = ct0 + tps < nct ? ct0 + tps : nct;
  }
};

// Issues one 64-deep slab of products for a warpgroup: A from registers,
// B the stage's HALVES centroid halves; one commit group.
template <int HALVES>
__device__ __forceinline__ void issue_slab(float (&acc)[HALVES][64],
                                           uint32_t (&a)[KSLAB / 16][4],
                                           uint32_t b, bool first) {
#pragma unroll
  for (int h = 0; h < HALVES; ++h) fence_acc(acc[h]);
  fence_regs(a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < KSLAB / 16; ++k)
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      wgmma_rs(acc[h], a[k], desc_sw128(b + h * HALF_BYTES + 32 * k),
               !(first && k == 0));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The streamed mode: HALVES 128-centroid halves per block tile (2, or 1
// when the launch is split to reach more SMs).
template <int HALVES>
__global__ void __launch_bounds__(S_THREADS, 1)
kmeans_assign_streamed_kernel(const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ CUtensorMap c_map,
                              const float* __restrict__ cnorm,
                              int* __restrict__ idx, float* __restrict__ dist,
                              unsigned long long* __restrict__ keys, int M,
                              int D, int Cp, int nsplit) {
  using scan_stream::bar_expect_tx;
  using scan_stream::bar_init;
  using scan_stream::bar_wait;
  using scan_stream::Ring;
  using scan_stream::smem_u32;
  constexpr int STEPS = KSLAB / 16;             // wgmma depth steps a slab
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* xring = smem_raw + ((ALIGN - (base & (ALIGN - 1))) & (ALIGN - 1));
  uint8_t* cring = xring + S_XSTAGES * S_XSTAGE_BYTES;
  uint64_t* x_full =
      reinterpret_cast<uint64_t*>(cring + S_CSTAGES * STAGE_BYTES);
  uint64_t* x_empty = x_full + S_XSTAGES;
  uint64_t* c_full = x_empty + S_XSTAGES;
  uint64_t* c_empty = c_full + S_CSTAGES;
  int* flag = reinterpret_cast<int*>(c_empty + S_CSTAGES);
  const uint32_t rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int i = 0; i < S_XSTAGES; ++i) {
      bar_init(&x_full[i], 1);
      bar_init(&x_empty[i], S_CLUSTER * CONSUMERS / 32);
    }
    for (int i = 0; i < S_CSTAGES; ++i) {
      bar_init(&c_full[i], 1);
      bar_init(&c_empty[i], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any multicast or remote arrive
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  constexpr int width = HALVES * HALF;          // centroids of a block tile
  const int nct = Cp / width;
  int tps = (nct + nsplit - 1) / nsplit;
  tps = (tps + S_CLUSTER - 1) / S_CLUSTER * S_CLUSTER;
  const int n_slices = (nct + tps - 1) / tps;   // the non-empty ones
  const int items = s_tiles(M) * nsplit;
  const int kb_n = (D + KSLAB - 1) / KSLAB;
  const int cid = blockIdx.x / S_CLUSTER, n_cl = gridDim.x / S_CLUSTER;
  // warp-uniform to the compiler (a broadcast), so no branch on the role or
  // on a warpgroup's work looks divergent: ptxas serializes wgmma issued in
  // a path it cannot prove convergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (warp >= CONSUMERS / 32) {
    // the producer warpgroup gives its registers to the consumers; lane 0
    // of its first warp streams both rings in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        S_PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      Ring rx(S_XSTAGES), rc(S_CSTAGES);
      for (int it = cid; it < items; it += n_cl) {
        const SItem w(it, nsplit, tps, nct);
        if (w.ct0 >= w.ct1) continue;
        for (int p0 = w.ct0; p0 < w.ct1; p0 += S_CLUSTER) {
          const int ct = p0 + static_cast<int>(rank);
          const bool mine = ct < w.ct1;
          for (int kb = 0; kb < kb_n; ++kb) {
            // this block's quarter of the tile's two 32-deep slabs, to
            // every block of the cluster
            for (int hx = 0; hx < 2; ++hx) {
              bar_wait(&x_empty[rx.stage], rx.phase ^ 1u);
              bar_expect_tx(&x_full[rx.stage], S_XSTAGE_BYTES);
              tma_load_multicast(
                  xring + rx.stage * S_XSTAGE_BYTES + rank * S_XROWS * 128,
                  &x_map, &x_full[rx.stage], kb * KSLAB + hx * XBOX,
                  w.row0 + rank * S_XROWS,
                  static_cast<uint16_t>((1u << S_CLUSTER) - 1));
              rx.advance();
            }
            if (mine) {
              bar_wait(&c_empty[rc.stage], rc.phase ^ 1u);
              bar_expect_tx(&c_full[rc.stage], HALVES * HALF_BYTES);
              for (int h = 0; h < HALVES; ++h)
                scan_stream::tma_load(
                    cring + rc.stage * STAGE_BYTES + h * HALF_BYTES, &c_map,
                    &c_full[rc.stage], kb * KSLAB, ct * width + h * HALF);
              rc.advance();
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        S_CONSUMER_REGS));
    const int wgi = warp / 4, wl = warp % 4, ctid = threadIdx.x;
    const int row0 = 64 * wgi + 16 * wl;        // the warp's rows in a tile
    Ring rx(S_XSTAGES), rc(S_CSTAGES);
    float acc[HALVES][64];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    uint32_t a0[STEPS][4], a1[STEPS][4];
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a0[i][j] = a1[i][j] = 0u;
    for (int it = cid; it < items; it += n_cl) {
      const SItem w(it, nsplit, tps, nct);
      if (w.ct0 >= w.ct1) continue;
      // a warpgroup whose 64 rows all lie past M only keeps the rings going
      const bool rows_live = w.row0 + 64 * wgi < M;
      float best[2] = {INFINITY, INFINITY};
      int bi[2] = {0, 0};
      for (int p0 = w.ct0; p0 < w.ct1; p0 += S_CLUSTER) {
        const int ct = p0 + static_cast<int>(rank);
        const bool mine = ct < w.ct1;
        const bool work = __shfl_sync(0xffffffffu, rows_live && mine, 0);
        // a 64-deep slab's A fragments from its two x slots, each freed
        // for the cluster as soon as it is converted
        auto take_x = [&](uint32_t (&a)[STEPS][4]) {
#pragma unroll
          for (int hx = 0; hx < 2; ++hx) {
            bar_wait(&x_full[rx.stage], rx.phase);
            slab_to_regs<STEPS / 2, S_XSTAGE_BYTES>(
                xring + rx.stage * S_XSTAGE_BYTES, a + 2 * hx, row0, lane);
            release(&x_empty[rx.stage], lane, S_CLUSTER);
            rx.advance();
          }
        };
        auto c_slab = [&](const Ring& q) {
          return smem_u32(cring + q.stage * STAGE_BYTES);
        };
        // slab kb's products (A fragments `cur`) are in flight: convert and
        // issue slab kb + 1's (into `nxt`) before waiting for them, so the
        // tensor cores always have the next group queued
        auto step = [&](int kb, uint32_t (&cur)[STEPS][4],
                        uint32_t (&nxt)[STEPS][4]) {
          Ring nc = rc;
          nc.advance();
          if (kb + 1 < kb_n) {
            take_x(nxt);
            bar_wait(&c_full[nc.stage], nc.phase);
            issue_slab<HALVES>(acc, nxt, c_slab(nc), false);
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          } else {
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          }
#pragma unroll
          for (int h = 0; h < HALVES; ++h) fence_acc(acc[h]);
          fence_regs(cur);
          release_local(&c_empty[rc.stage], lane);
          rc = nc;
        };
        if (work) {
          take_x(a0);
          bar_wait(&c_full[rc.stage], rc.phase);
          issue_slab<HALVES>(acc, a0, c_slab(rc), true);
          for (int kb = 0; kb < kb_n; kb += 2) {
            step(kb, a0, a1);
            if (kb + 1 < kb_n) step(kb + 1, a1, a0);
          }
          // drained on every path to the fold, as ptxas must see: a read
          // of the accumulators it cannot prove after the last wait would
          // serialize every wgmma of the kernel
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
          for (int h = 0; h < HALVES; ++h) fence_acc(acc[h]);
#pragma unroll
          for (int h = 0; h < HALVES; ++h)
            fold_half(acc[h], cnorm, ct * width + h * HALF, lane, best, bi);
        } else {
          // no rows or no tile here: keep both rings turning
          for (int kb = 0; kb < kb_n; ++kb) {
            for (int hx = 0; hx < 2; ++hx) {
              bar_wait(&x_full[rx.stage], rx.phase);
              release(&x_empty[rx.stage], lane, S_CLUSTER);
              rx.advance();
            }
            if (mine) {
              bar_wait(&c_full[rc.stage], rc.phase);
              release_local(&c_empty[rc.stage], lane);
              rc.advance();
            }
          }
        }
      }
      // the quad's minimum per row (lexicographic on (dist, idx)) into the
      // row's key, if this block had a tile of the item
      const bool had = w.ct0 + static_cast<int>(rank) < w.ct1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[h], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[h], off);
          if (ob < best[h] || (ob == best[h] && oi < bi[h])) {
            best[h] = ob;
            bi[h] = oi;
          }
        }
        const int row = w.row0 + row0 + (lane >> 2) + 8 * h;
        if (had && (lane & 3) == 0 && row < M)
          atomicMin(keys + row, merge_key(best[h], bi[h]));
      }
      __threadfence();
      // the last block of the row tile's S_CLUSTER x n_slices writes it out
      consumers_sync();
      if (ctid == 0) {
        const unsigned long long done =
            atomicAdd(keys + M + w.row0 / S_ROWS, 1ull);
        __threadfence();
        *flag = done + 1 == static_cast<unsigned long long>(S_CLUSTER) *
                               static_cast<unsigned long long>(n_slices);
      }
      consumers_sync();
      const int row = w.row0 + ctid;
      if (*flag && ctid < S_ROWS && row < M)
        unpack_key(__ldcg(keys + row), idx + row, dist + row);
    }
  }
  // no block leaves while a peer may still write or arrive in it
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int grid,
                                         int threads, int smem, int cluster,
                                         cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `kernel` (`cluster` blocks each) that fit on the card at
// `smem` bytes a block, computed once per (card, kernel, smem); 0 on an
// error (in *err).
template <typename Kernel>
int max_clusters(Kernel kernel, int threads, int smem, int cluster,
                 int* err) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> known;
  int dev = 0, n = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    std::lock_guard<std::mutex> lock(mu);
    const auto key =
        std::make_tuple(dev, reinterpret_cast<const void*>(kernel), smem);
    const auto hit = known.find(key);
    if (hit != known.end()) {
      n = hit->second;
    } else {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          cluster_config(&attr, cluster, threads, smem, cluster, 0);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (e == cudaSuccess && n < 1) e = cudaErrorInvalidConfiguration;
      if (e == cudaSuccess) known[key] = n;
    }
  }
  *err = static_cast<int>(e);
  return e == cudaSuccess ? n : 0;
}

template <bool REG>
int launch_kernel(const CUtensorMap& xm, const CUtensorMap& cm,
                  const float* cnorm, int* idx, float* dist,
                  unsigned long long* keys, int M, int D, int Cp, int nsplit,
                  cudaStream_t s) {
  // the persistent grid: every cluster that fits, at most one per item
  const int stages = ring_stages(D);
  const int smem = fixed_bytes(D) + stages * STAGE_BYTES;
  int err = 0;
  const int fit = max_clusters(kmeans_assign_wgmma_kernel<REG>, THREADS,
                               smem, CLUSTER, &err);
  if (err) return err;
  const int items = counted_tiles(M) / CLUSTER * nsplit;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, (items < fit ? items : fit) * CLUSTER, THREADS, smem, CLUSTER,
      s);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kmeans_assign_wgmma_kernel<REG>, xm, cm, cnorm,
                         idx, dist, keys, M, D, Cp, nsplit, stages));
}

template <int HALVES>
int launch_streamed(const CUtensorMap& xm, const CUtensorMap& cm,
                    const float* cnorm, int* idx, float* dist,
                    unsigned long long* keys, int M, int D, int Cp,
                    int nsplit, cudaStream_t s) {
  int err = 0;
  const int fit = max_clusters(kmeans_assign_streamed_kernel<HALVES>,
                               S_THREADS, S_SMEM_BYTES, S_CLUSTER, &err);
  if (err) return err;
  const int items = s_tiles(M) * nsplit;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, (items < fit ? items : fit) * S_CLUSTER, S_THREADS, S_SMEM_BYTES,
      S_CLUSTER, s);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kmeans_assign_streamed_kernel<HALVES>, xm, cm, cnorm, idx, dist,
      keys, M, D, Cp, nsplit));
}

int launch(const float* x, const float* cent, __nv_bfloat16* cb,
           float* cnorm, int* idx, float* dist, unsigned long long* keys,
           int M, int C, int D, int Cp, int Dp, int nsplit, int streamed,
           int halves, cudaStream_t s) {
  if (nsplit < 1 || Cp % CTILE != 0 || Cp < C || Dp < D || Dp % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (streamed ? (keys == nullptr || (halves != 1 && halves != 2))
               : (ring_stages(D) < MIN_STAGES ||
                  (keys == nullptr) != (nsplit == 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, cm;
  int err = scan_stream::encode_2d(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                   M, D, XBOX, streamed ? S_XROWS : ROWS);
  if (err == 0)
    err = scan_stream::encode_2d(&cm, cb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                 Cp, Dp, KSLAB, HALF);
  if (err) return err;
  const int n_keys = keys == nullptr ? 0
                     : M + (streamed ? s_tiles(M) : counted_tiles(M));
  prepare<<<(Cp + 7) / 8, 256, 0, s>>>(cent, cb, cnorm, keys, M, n_keys, C,
                                       D, Cp, Dp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (streamed)
    err = halves == 2 ? launch_streamed<2>(xm, cm, cnorm, idx, dist, keys, M,
                                           D, Cp, nsplit, s)
                      : launch_streamed<1>(xm, cm, cnorm, idx, dist, keys, M,
                                           D, Cp, nsplit, s);
  else
    err = reg_part(D) ? launch_kernel<true>(xm, cm, cnorm, idx, dist, keys, M,
                                            D, Cp, nsplit, s)
                      : launch_kernel<false>(xm, cm, cnorm, idx, dist, keys,
                                             M, D, Cp, nsplit, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// Plain C entry point (loaded through ctypes).  `f32` selects the f32-product
// variant.  Launches on `stream` and returns the first CUDA error (attribute
// set or launch), else 0.
extern "C" int kmeans_assign_launch(const float* x, const float* cent,
                                    const float* cnorm, int* idx,
                                    float* dist, int M, int C, int D,
                                    int vec4, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32 && vec4) {
    CUtensorMap xm, cm;
    int err = scan_stream::encode_2d(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                     4, M, D, f32k::TMA_BK, f32k::BM);
    if (err == 0)
      err = scan_stream::encode_2d(&cm, cent, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                   4, C, D, f32k::TMA_BK, f32k::BN);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(
        f32k::kmeans_assign_f32_tma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, f32k::TMA_SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    f32k::kmeans_assign_f32_tma_kernel<<<(M + f32k::BM - 1) / f32k::BM,
                                         f32k::THREADS, f32k::TMA_SMEM_BYTES,
                                         st>>>(xm, cm, cnorm, idx, dist, M, C,
                                               D);
    return static_cast<int>(cudaGetLastError());
  }
  if (f32) {
    const cudaError_t e = cudaFuncSetAttribute(
        f32k::kmeans_assign_f32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, f32k::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    f32k::kmeans_assign_f32_kernel<<<(M + f32k::BM - 1) / f32k::BM,
                                     f32k::THREADS, f32k::SMEM_BYTES, st>>>(
        x, cent, cnorm, idx, dist, M, C, D, vec4);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t e = cudaFuncSetAttribute(
      kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  kmeans_assign_kernel<<<(M + BM - 1) / BM, THREADS, SMEM_BYTES, st>>>(
      x, cent, cnorm, idx, dist, M, C, D, vec4);
  return static_cast<int>(cudaGetLastError());
}

// The `wgmma` variant in nsplit centroid slices, resident (streamed == 0)
// or streamed (halves 128-centroid halves per block tile).  Scratch from
// the caller: cb bf16[Cp, Dp] and cnorm f32[Cp] (Cp % 256 == 0, Dp % 8 ==
// 0; filled here) and keys u64 (the rows' merge keys, then a counter per
// row tile): resident, M + 2 ceil(ceil(M / 64) / 2) when nsplit > 1, else
// null; streamed, always M + ceil(M / 128).  The caller has checked the
// variant's shape and alignment rules.
extern "C" int kmeans_assign_wgmma_launch(const float* x, const float* cent,
                                          void* cb, float* cnorm, int* idx,
                                          float* dist, void* keys, int M,
                                          int C, int D, int Cp, int Dp,
                                          int nsplit, int streamed,
                                          int halves, void* stream) {
  return wg::launch(x, cent, static_cast<__nv_bfloat16*>(cb), cnorm, idx,
                    dist, static_cast<unsigned long long*>(keys), M, C, D, Cp,
                    Dp, nsplit, streamed, halves,
                    static_cast<cudaStream_t>(stream));
}
