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
// `wgmma` (D % 4 == 0, 16-byte-aligned x and centroids, the row tile beside
// at least MIN_STAGES ring stages in shared memory): a persistent grid of
// 2-block clusters.  A block holds a 64-row tile of x as bf16 for all of D
// and loops over every centroid tile against it, a loop that takes the
// place of the TPU grid's sequential centroid axis.  The tile is filled from
// TMA boxes of f32 rows that the consumer threads convert (the TPU kernel's
// fused conversion), so every row is read from device memory once and
// converted once: its first 256 of depth go to registers as wgmma A
// fragments (each consumer warpgroup holds its own copy), the rest to
// shared memory in the 128-byte-swizzled K-major layout a wgmma descriptor
// reads, which leaves room for a fourth ring stage at D = 1024.  A prepare
// pass rounds the centroids to bf16 once per call (2 MB at C = D = 1024)
// and takes their norms; they stream through a ring of 256-centroid x
// 64-deep stages, each block of a cluster loading one half of a stage and
// TMA-multicasting it to both.  One producer warp keeps the ring full
// (full/empty mbarrier pairs; a stage is free again when the consumers of
// both blocks are done with it); two consumer warpgroups run wgmma
// m64n128k16, one 128-centroid half of a stage each, with the accumulator
// in registers, and fold each finished centroid tile into a running (min,
// first index) straight from the accumulator fragments; the warpgroups
// merge once per row tile through 1 KB of shared memory.  At D = 1024 the
// stream of stages into each SM, not the tensor cores, sets the pace, so a
// stage is released as soon as its products are done.  When M is small the
// centroid tiles are split across clusters (`nsplit`, a launch parameter)
// and the slices merge with a 64-bit atomicMin on a key ordered as
// (dist, idx).
//
// `generic` (any shape): a block owns a 128-row tile of x and loops over
// every 128-centroid tile; WMMA bf16 with f32 accumulation, operands
// converted f32 -> bf16 on their way to shared memory, the product tile
// staged in shared memory for the argmin.  Ragged M, C and D are masked in
// the kernel.
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


__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// `wgmma` variant.  The host-side sizes are mirrored in
// kernels/kmeans_assign.py, which chooses the variant and the C split.
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

// A lane-0 release of ring stage `bar` to both blocks' producers, once the
// whole warp is done with it.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0)
    for (uint32_t r = 0; r < CLUSTER; ++r) arrive_in(bar, r);
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

// The launch's operands besides x, in one pass: cb bf16[Cp, Dp] (the
// centroids rounded to bf16, zero past C and D), cnorm f32[Cp] (||c||^2 of
// the f32 centroids, +inf past C, so padding never wins the argmin) and,
// when the centroids are split, the merge keys set to their maximum and
// the row tiles' slice counters to 0.  One warp per centroid row; D % 4 ==
// 0 and 16-byte-aligned rows, as the variant requires.
__global__ void prepare(const float* __restrict__ cent,
                        __nv_bfloat16* __restrict__ cb,
                        float* __restrict__ cnorm,
                        unsigned long long* __restrict__ keys, int M, int C,
                        int D, int Cp, int Dp) {
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
  if (keys != nullptr) {
    const int n = M + counted_tiles(M);
    for (int i = tid; i < n; i += n_threads) keys[i] = i < M ? ~0ull : 0ull;
  }
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

// Converts ring stage `st` (one depth chunk, as above) into this thread's
// A fragments for the chunk's 8 wgmma depth steps: a[s][hr + 2 hk] packs
// row 16 wl + lane / 4 + 8 hr, depth 16 s + 2 (lane % 4) + 8 hk (+ 1).
__device__ __forceinline__ void chunk_to_regs(const uint8_t* st,
                                              uint32_t (*a)[4], int wl,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < XCHUNK / 16; ++s)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * wl + g + 8 * hr;
        const int f = 16 * (s & 1) + 2 * t + 8 * hk;   // f32 in its box
        const float2 v = *reinterpret_cast<const float2*>(
            st + (s >> 1) * XBOX_BYTES + row * 128 +
            (((f >> 2) ^ (row & 7)) << 4) + ((f & 3) << 2));
        a[s][hr + 2 * hk] = pack_bf16(v);
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
        chunk_to_regs(ring + r.stage * STAGE_BYTES, areg + q * XCHUNK / 16,
                      wl, lane);
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
        // fold: this thread's columns in ascending order, strict '<' (the
        // 4 KB of norms stay in L1 after a block's first tile)
        const int cbase = ct * CTILE + wgi * HALF + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 cn =
              __ldg(reinterpret_cast<const float2*>(cnorm + cbase + 8 * j));
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = (e ? cn.y : cn.x) - 2.f * acc[4 * j + 2 * h + e];
              if (v < best[h]) {
                best[h] = v;
                bi[h] = cbase + 8 * j + e;
              }
            }
        }
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

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int grid,
                                         int smem, cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `kernel` that fit on the card at `smem` bytes a block,
// computed once per (card, kernel, smem); 0 on an error (in *err).
template <typename Kernel>
int max_clusters(Kernel kernel, int smem, int* err) {
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
      const cudaLaunchConfig_t cfg = cluster_config(&attr, CLUSTER, smem, 0);
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
  const int fit = max_clusters(kmeans_assign_wgmma_kernel<REG>, smem, &err);
  if (err) return err;
  const int items = counted_tiles(M) / CLUSTER * nsplit;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, (items < fit ? items : fit) * CLUSTER, smem, s);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kmeans_assign_wgmma_kernel<REG>, xm, cm, cnorm,
                         idx, dist, keys, M, D, Cp, nsplit, stages));
}

int launch(const float* x, const float* cent, __nv_bfloat16* cb,
           float* cnorm, int* idx, float* dist, unsigned long long* keys,
           int M, int C, int D, int Cp, int Dp, int nsplit, cudaStream_t s) {
  if (ring_stages(D) < MIN_STAGES || nsplit < 1 || Cp % CTILE != 0 ||
      Cp < C || Dp < D || Dp % 8 != 0 || (keys == nullptr) != (nsplit == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, cm;
  int err = scan_stream::encode_2d(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                   M, D, XBOX, ROWS);
  if (err == 0)
    err = scan_stream::encode_2d(&cm, cb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                 Cp, Dp, KSLAB, HALF);
  if (err) return err;
  prepare<<<(Cp + 7) / 8, 256, 0, s>>>(cent, cb, cnorm, keys, M, C, D, Cp,
                                       Dp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  err = reg_part(D) ? launch_kernel<true>(xm, cm, cnorm, idx, dist, keys, M,
                                          D, Cp, nsplit, s)
                    : launch_kernel<false>(xm, cm, cnorm, idx, dist, keys, M,
                                           D, Cp, nsplit, s);
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

// The `wgmma` variant in nsplit centroid slices.  Scratch from the caller:
// cb bf16[Cp, Dp] and cnorm f32[Cp] (Cp % 256 == 0, Dp % 8 == 0; filled
// here), and when nsplit > 1 keys u64[M + 2 ceil(ceil(M / 64) / 2)] (the
// rows' merge keys, then a slice counter per row tile), else null.  The
// caller has checked the variant's shape and alignment rules.
extern "C" int kmeans_assign_wgmma_launch(const float* x, const float* cent,
                                          void* cb, float* cnorm, int* idx,
                                          float* dist, void* keys, int M,
                                          int C, int D, int Cp, int Dp,
                                          int nsplit, void* stream) {
  return wg::launch(x, cent, static_cast<__nv_bfloat16*>(cb), cnorm, idx,
                    dist, static_cast<unsigned long long*>(keys), M, C, D, Cp,
                    Dp, nsplit, static_cast<cudaStream_t>(stream));
}
