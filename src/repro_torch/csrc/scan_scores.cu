// Fused similarity scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scan_scores.py::scan_scores
// (body _scan_scores_kernel).  Computes, for queries Q f32[B, D] and database
// rows DB f32[N, D]:
//
//   S = bf16(Q) . bf16(DB)^T          accumulated in f32
//   S = norms - 2 S                   for the l2 metric (query norm dropped)
//   S[:, n] = -inf (ip) / +inf (l2)   where ids[n] < 0 (empty/tombstoned slot)
//
// What bounds it on this card: bytes.  Every DB row is streamed once as f32
// (4 B/component) and meets at most B queries, so the work is B/2 flop per
// byte — far under the H100's ~295 flop/byte bf16 ridge for every batch the
// router sends here (B = 1 probed, B >= 2 full scan).
//
// What the design does about it: each block streams a 128-row DB tile once,
// converts f32 -> bf16 in registers on its way to shared memory (the bf16
// copy never exists in device memory, as in the TPU kernel's in-VREG
// conversion), and multiplies it against every query of its query tile on
// the tensor cores (WMMA bf16, f32 accumulate).  The next stage's global
// loads are issued into registers before the current stage's MMAs, so load
// latency overlaps compute.  The norm/mask epilogue is fused: scores leave
// the block once, coalesced along N.  Ragged B, N and D are masked in the
// kernel (zero-filled operands, guarded stores), so no padding is needed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 128;          // DB rows per block (4 warps x 32)
constexpr int BK = 32;           // depth per pipeline stage
constexpr int LDS = BK + 8;      // padded shared row, bf16 elements
constexpr int THREADS = 128;
constexpr int STAGE_LD = BN + 4; // f32 staging row for the epilogue

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

// MF = 16-row query fragments per block (BM = 16 * MF queries).
template <int MF>
__global__ void __launch_bounds__(THREADS)
scan_scores_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const int* __restrict__ ids,
                   const float* __restrict__ norms, float* __restrict__ out,
                   int B, int N, int D, int l2, int vec4) {
  constexpr int BM = 16 * MF;
  constexpr int TILE_BYTES = (BM + BN) * LDS * 2;
  constexpr int STAGE_BYTES = BM * STAGE_LD * 4;
  constexpr int SMEM = TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;
  constexpr int V = BK / 4;                  // float4 per tile row
  constexpr int QV = BM * V / THREADS;       // query float4 per thread
  constexpr int DV = BN * V / THREADS;       // DB float4 per thread
  static_assert(QV >= 1 && BM * V % THREADS == 0, "query tile split");
  static_assert(DV >= 1 && BN * V % THREADS == 0, "db tile split");

  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sD = sQ + BM * LDS;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  float4 rq[QV], rd[DV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int e = tid + i * THREADS;
      rq[i] = load4(q, m0 + e / V, B, k0 + (e % V) * 4, D, vec4);
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int e = tid + i * THREADS;
      rd[i] = load4(db, n0 + e / V, N, k0 + (e % V) * 4, D, vec4);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int e = tid + i * THREADS;
      store4(sQ + (e / V) * LDS + (e % V) * 4, rq[i]);
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int e = tid + i * THREADS;
      store4(sD + (e / V) * LDS + (e % V) * 4, rd[i]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < D) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sD + (warp * 32 + j * 16) * LDS + kk,
                               LDS);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sQ + i * 16 * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: stage the f32 tile in shared memory (reusing the operand
  // space), then write it out coalesced along N with the norm/mask applied
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + i * 16 * STAGE_LD + warp * 32 + j * 16,
                              acc[i][j], STAGE_LD, wmma::mem_row_major);
  __syncthreads();
  const float mask_val = l2 ? INFINITY : -INFINITY;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int b = m0 + r, n = n0 + c;
    if (b < B && n < N) {
      float s = stage[r * STAGE_LD + c];
      if (l2) s = norms[n] - 2.f * s;
      if (ids[n] < 0) s = mask_val;
      out[(size_t)b * N + n] = s;
    }
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Launches on `stream` and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int scan_scores_launch(const float* q, const float* db,
                                  const int* ids, const float* norms,
                                  float* out, int B, int N, int D, int l2,
                                  int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(THREADS);
  if (B <= 16) {
    dim3 grid((N + BN - 1) / BN, (B + 15) / 16);
    scan_scores_kernel<1><<<grid, block, 0, s>>>(q, db, ids, norms, out, B,
                                                 N, D, l2, vec4);
  } else {
    dim3 grid((N + BN - 1) / BN, (B + 63) / 64);
    scan_scores_kernel<4><<<grid, block, 0, s>>>(q, db, ids, norms, out, B,
                                                 N, D, l2, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
