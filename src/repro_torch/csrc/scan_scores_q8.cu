// Quantized coarse scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scan_scores.py::scan_scores_q8
// (body _scan_scores_q8_kernel).  For int8 query codes QC[B, D] with per-query
// scale sq[b] and correction corr[b] = sq[b] * sum_d QC[b, d], and the affine
// int8 row store CODES[N, D] (row_n ~= scale_n * codes_n + zero_n):
//
//   acc[b, n] = sum_d QC[b, d] * CODES[n, d]           exact, in int32
//   S[b, n]   = (float(acc) * sq[b]) * scale_n + corr[b] * zero_n
//   S[b, n]   = norms_n - 2 S[b, n]                    for the l2 metric
//   S[:, n]   = -inf (ip) / +inf (l2)                  where ids[n] < 0
//
// in the reference's operation order, each f32 step rounded on its own
// (__fmul_rn / __fadd_rn, which the compiler never contracts into an FMA),
// so the scores equal the plain version's bit for bit when the accumulator
// does.
//
// What bounds it on this card: bytes.  Every code row is streamed once (1 B
// per component) and meets at most B queries: 2B int8 operations per byte,
// far under the H100's ~590 op/byte int8 ridge for every batch the router
// sends here (B = 1 probed, B = 64 full scan).  The f32 score matrix it
// writes (4B bytes per row) is the second largest stream.
//
// What the design does about it: the TPU kernel's sequential depth grid axis
// and its int32 scratch accumulator become a loop over all of D inside the
// block, with the accumulator in registers.  Each block streams a 128-row
// code tile once with 16-byte loads, the next stage's loads issued before
// the current stage's products, and multiplies it against every query of its
// query tile on the int8 tensor cores (WMMA 16x16x16 s8, s32 accumulate).
// Shared tiles are kept in 16-byte depth chunks ([chunk][row][16]) so every
// fragment is one contiguous 256-byte block, aligned as WMMA requires.  The
// affine/norm/mask epilogue is fused and each thread owns one DB column, so
// the row's scale, zero, norm and id are read once and the scores leave the
// block once, coalesced along N.  Ragged B, N and D are masked in the kernel
// (zero-filled operands, which is exact because corr is taken over the real
// D; guarded stores), so nothing is padded.
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 128;           // DB rows per block (4 warps x 32)
constexpr int BK = 128;           // bytes of depth per pipeline stage
constexpr int CH = 16;            // bytes of depth per WMMA product
constexpr int NCH = BK / CH;      // depth chunks per stage
constexpr int THREADS = 128;
constexpr int STAGE_LD = BN + 4;  // int32 staging row for the epilogue

// 16 bytes of `row` at depth [k, k + 16), zero past the ragged edges.
// vec16: D % 16 == 0 and a 16-byte-aligned base, so k + 16 <= D here.
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ base,
                                       int row, int nrows, int k, int D,
                                       int vec16) {
  int4 v = make_int4(0, 0, 0, 0);
  if (row < nrows && k < D) {
    const int8_t* p = base + (size_t)row * D + k;
    if (vec16) {
      v = __ldg(reinterpret_cast<const int4*>(p));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t byte = (k + i < D) ? (uint32_t)(uint8_t)p[i] : 0u;
        w[i / 4] |= byte << (8 * (i % 4));
      }
      v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
  }
  return v;
}

// MF = 16-row query fragments per block (BM = 16 * MF queries).
template <int MF>
__global__ void __launch_bounds__(THREADS)
scan_scores_q8_kernel(const int8_t* __restrict__ qc,
                      const int8_t* __restrict__ codes,
                      const int* __restrict__ ids,
                      const float* __restrict__ scales,
                      const float* __restrict__ zeros,
                      const float* __restrict__ norms,
                      const float* __restrict__ sq,
                      const float* __restrict__ corr,
                      float* __restrict__ out, int B, int N, int D, int l2,
                      int vec16) {
  constexpr int BM = 16 * MF;
  constexpr int TILE_BYTES = (BM + BN) * BK;
  constexpr int STAGE_BYTES = BM * STAGE_LD * 4;
  constexpr int SMEM = TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;
  constexpr int QV = BM * NCH / THREADS;    // query 16-byte loads per thread
  constexpr int DV = BN * NCH / THREADS;    // code 16-byte loads per thread
  static_assert(QV >= 1 && BM * NCH % THREADS == 0, "query tile split");
  static_assert(DV >= 1 && BN * NCH % THREADS == 0, "code tile split");
  static_assert(BN == THREADS, "the epilogue gives each thread one column");

  __shared__ __align__(128) unsigned char smem[SMEM];
  signed char* sQ = reinterpret_cast<signed char*>(smem);  // [NCH][BM][16]
  signed char* sD = sQ + BM * BK;                          // [NCH][BN][16]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  // element e of a tile: row e / NCH, chunk e % NCH (coalesced in global
  // memory: the 8 chunks of a row are 8 neighbouring threads)
  int4 rq[QV], rd[DV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int e = tid + i * THREADS;
      rq[i] = load16(qc, m0 + e / NCH, B, k0 + (e % NCH) * CH, D, vec16);
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int e = tid + i * THREADS;
      rd[i] = load16(codes, n0 + e / NCH, N, k0 + (e % NCH) * CH, D, vec16);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int e = tid + i * THREADS;
      *reinterpret_cast<int4*>(sQ + (e % NCH) * (BM * CH) + (e / NCH) * CH) =
          rq[i];
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int e = tid + i * THREADS;
      *reinterpret_cast<int4*>(sD + (e % NCH) * (BN * CH) + (e / NCH) * CH) =
          rd[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[MF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  fetch(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < D) fetch(k0 + BK);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], sD + c * (BN * CH) + (warp * 32 + j * 16) * CH, CH);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sQ + c * (BM * CH) + i * 16 * CH, CH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: stage the int32 tile in shared memory (reusing the operand
  // space); thread t then owns column n0 + t and walks the query rows
  int* stage = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stage + i * 16 * STAGE_LD + warp * 32 + j * 16,
                              acc[i][j], STAGE_LD, wmma::mem_row_major);
  __syncthreads();
  const int n = n0 + tid;
  if (n >= N) return;
  const float scale = scales[n];
  const float zero = zeros[n];
  const float norm = l2 ? norms[n] : 0.f;
  const bool dead = ids[n] < 0;
  const float mask_val = l2 ? INFINITY : -INFINITY;
  const int rows = min(BM, B - m0);
  for (int r = 0; r < rows; ++r) {
    const int b = m0 + r;
    float s = __fmul_rn(__fmul_rn(__int2float_rn(stage[r * STAGE_LD + tid]),
                                  sq[b]),
                        scale);
    s = __fadd_rn(s, __fmul_rn(corr[b], zero));
    if (l2) s = __fsub_rn(norm, __fmul_rn(2.f, s));
    out[(size_t)b * N + n] = dead ? mask_val : s;
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Launches on `stream` and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int scan_scores_q8_launch(const int8_t* qc, const int8_t* codes,
                                     const int* ids, const float* scales,
                                     const float* zeros, const float* norms,
                                     const float* sq, const float* corr,
                                     float* out, int B, int N, int D, int l2,
                                     int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(THREADS);
  if (B <= 16) {
    dim3 grid((N + BN - 1) / BN, (B + 15) / 16);
    scan_scores_q8_kernel<1><<<grid, block, 0, s>>>(
        qc, codes, ids, scales, zeros, norms, sq, corr, out, B, N, D, l2,
        vec16);
  } else {
    dim3 grid((N + BN - 1) / BN, (B + 63) / 64);
    scan_scores_q8_kernel<4><<<grid, block, 0, s>>>(
        qc, codes, ids, scales, zeros, norms, sq, corr, out, B, N, D, l2,
        vec16);
  }
  return static_cast<int>(cudaGetLastError());
}
