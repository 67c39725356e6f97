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
// A launch takes a lane axis (what the TPU kernel runs under `vmap` for a
// cross-collection fused query): G same-shaped scans, QC [G, B, D] (sq,
// corr [G, B]) against CODES [G, N, D] (ids, scales, zeros, norms [G, N];
// scores [G, B, N]), lane g on blockIdx.z with every operand offset by its
// lane stride and the arithmetic of a G = 1 launch on its operands.
//
// The TPU kernel's sequential depth grid axis and its int32 scratch
// accumulator become a loop over all of D inside the block, with the
// accumulator in registers.  Two variants, chosen by the wrapper from
// shapes and alignment alone:
//
// `stream` (D % 16 == 0, 16-byte-aligned qc and codes, the query tile fits
// in shared memory; scan_stream.cuh): a persistent grid whose blocks keep a
// tile of up to 64 query code rows (and their sq/corr) resident and stream
// 128-row code tiles through a TMA ring of 128-row x 128-byte boxes.  Two
// consumer groups of four warps take the tiles in turn.  A group reads the
// code tile straight from the swizzled stage with ldmatrix (conflict-free:
// the swizzle spreads eight rows' 16-byte units over the banks) and runs
// mma.sync m16n8k32 s8 x s8 -> s32 with the code rows on the M side, so
// B = 1 costs an N = 8 product.  Each thread fetches its four rows'
// scale/zero/norm/id when a tile starts and applies the affine/norm/mask
// epilogue to its own accumulators; the 4B bytes of scores a row (a
// quarter of the code bytes at B = 64) leave while the other group runs
// the next tile's products, each store instruction writing eight
// neighbouring rows of four queries (32-byte segments along N).
//
// `generic` (any shape): each block streams one 128-row code tile with
// 16-byte loads, the next stage's loads issued before the current stage's
// products, on the int8 tensor cores (WMMA 16x16x16 s8, s32 accumulate).
// Shared tiles are kept in 16-byte depth chunks ([chunk][row][16]) so every
// fragment is one contiguous 256-byte block, aligned as WMMA requires.  The
// epilogue stages the int32 tile in shared memory and each thread owns one
// DB column.  Ragged B, N and D are masked in the kernel (zero-filled
// operands, which is exact because corr is taken over the real D; guarded
// stores), so nothing is padded.
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "scan_stream.cuh"

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
  const size_t coll = blockIdx.z;  // the lane
  qc += coll * B * D;
  codes += coll * N * D;
  ids += coll * N;
  scales += coll * N;
  zeros += coll * N;
  if (l2) norms += coll * N;
  sq += coll * B;
  corr += coll * B;
  out += coll * B * N;
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// QT = resident query rows per block (blockIdx.y selects the query tile,
// blockIdx.z the lane).
template <int QT>
__global__ void __launch_bounds__(scan_stream::THREADS, 1)
scan_scores_q8_stream_kernel(const __grid_constant__ CUtensorMap code_map,
                             const int8_t* __restrict__ qc,
                             const int* __restrict__ ids,
                             const float* __restrict__ scales,
                             const float* __restrict__ zeros,
                             const float* __restrict__ norms,
                             const float* __restrict__ sq,
                             const float* __restrict__ corr,
                             float* __restrict__ out, int B, int N, int D,
                             int l2, int stages) {
  using namespace scan_stream;
  constexpr int NB = QT / 8;                // n8 blocks of queries
  const size_t coll = blockIdx.z;  // the lane; its codes come via code_map
  qc += coll * B * D;
  ids += coll * N;
  scales += coll * N;
  zeros += coll * N;
  if (l2) norms += coll * N;
  sq += coll * B;
  corr += coll * B;
  out += coll * B * N;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve_smem(smem_raw, stages);
  float* s_sq = reinterpret_cast<float*>(sm.rest);
  float* s_corr = s_sq + QT;
  uint8_t* s_q = reinterpret_cast<uint8_t*>(s_corr + QT);  // [QT][dpad]

  const int kb_n = (D + BOX_BYTES - 1) / BOX_BYTES;
  const int qstride = kb_n * BOX_BYTES + QPAD;  // bytes per resident query
  const int n_tiles = (N + TILE_ROWS - 1) / TILE_ROWS;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the query code tile, zero past B and D (D % 16 == 0 here), and its
  // per-query scalars
  const int v16 = kb_n * (BOX_BYTES / 16);
  for (int e = tid; e < QT * v16; e += scan_stream::THREADS) {
    const int r = e / v16, k = (e % v16) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (q0 + r < B && k < D)
      v = __ldg(reinterpret_cast<const int4*>(qc + (size_t)(q0 + r) * D + k));
    *reinterpret_cast<int4*>(s_q + r * qstride + k) = v;
  }
  for (int r = tid; r < QT; r += scan_stream::THREADS) {
    s_sq[r] = q0 + r < B ? sq[q0 + r] : 0.f;
    s_corr[r] = q0 + r < B ? corr[q0 + r] : 0.f;
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    produce(&code_map, sm, stages, n_tiles, kb_n, BOX_BYTES);
    return;
  }

  const int wrow = (warp % GROUP_WARPS) * 32;  // this warp's rows in a tile
  const int g = lane >> 2, tg = lane & 3;
  const float mask_val = l2 ? INFINITY : -INFINITY;
  // ldmatrix row addresses of this lane.  A (the code box): matrices 0-3 =
  // rows 0-7 / 8-15 of a 16-row half x 16-byte units 2ks / 2ks + 1, the
  // unit swizzled by the row (lane & 7).  B (the query tile): matrices 0/1
  // = depth units of queries 0-7 of an n8 pair, matrices 2/3 of queries
  // 8-15.
  const int a_row = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_hi = lane >> 4;
  const uint32_t b_lane = smem_u32(s_q) +
                          ((lane & 7) + ((lane >> 4) << 3)) * qstride +
                          (((lane >> 3) & 1) << 4);
  Ring rg(stages);
  Turn turn(sm.turn, warp / GROUP_WARPS);
  int local = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++local) {
    if (!turn.mine(local)) {            // the other group's tile
      rg.advance(kb_n);
      continue;
    }
    const int row0 = t * TILE_ROWS + wrow;
    // this thread's four rows' sidebands, fetched now, used after the loop
    float scl[2][2], zer[2][2], nrm[2][2];
    bool dead[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = row0 + mi * 16 + h * 8 + g;
        const bool in = n < N;
        dead[mi][h] = in && ids[n] < 0;
        scl[mi][h] = in ? scales[n] : 0.f;
        zer[mi][h] = in ? zeros[n] : 0.f;
        nrm[mi][h] = (l2 && in) ? norms[n] : 0.f;
      }
    int acc[2][NB][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][nb][i] = 0;

    turn.acquire();
    for (int kb = 0; kb < kb_n; ++kb) {
      bar_wait(&sm.full[rg.stage], rg.phase);
      const uint32_t st = smem_u32(sm.ring + rg.stage * STAGE_BYTES);
#pragma unroll
      for (int ks = 0; ks < BOX_BYTES / 32; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], st + (a_row + mi * 16) * BOX_BYTES +
                                 (((2 * ks + a_hi) ^ (lane & 7)) << 4));
        const uint32_t b_k = b_lane + kb * BOX_BYTES + ks * 32;
        if constexpr (NB == 1) {
          uint32_t b[2];
          ldmatrix_x2(b, b_k);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][0], a[mi], b[0], b[1]);
        } else {
#pragma unroll
          for (int j = 0; j < NB / 2; ++j) {
            uint32_t b[4];
            ldmatrix_x4(b, b_k + j * 16 * qstride);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_s8(acc[mi][2 * j], a[mi], b[0], b[1]);
              mma_s8(acc[mi][2 * j + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
      bar_arrive(&sm.empty[rg.stage]);
      rg.advance();
    }
    turn.release();

    // epilogue in registers, in the reference's order, overlapping the
    // other group's products: acc[mi][nb][i] is row mi*16 + g (+8 for
    // i >= 2) of this warp's 32, query nb*8 + 2tg (+1 for odd i); each
    // store instruction writes eight neighbouring rows (32 bytes) of each
    // of four queries
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int n = row0 + mi * 16 + h * 8 + g;
          const int r = nb * 8 + 2 * tg + (i & 1);
          if (n < N && q0 + r < B) {
            float s = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[mi][nb][i]), s_sq[r]),
                scl[mi][h]);
            s = __fadd_rn(s, __fmul_rn(s_corr[r], zer[mi][h]));
            if (l2) s = __fsub_rn(nrm[mi][h], __fmul_rn(2.f, s));
            out[(size_t)(q0 + r) * N + n] = dead[mi][h] ? mask_val : s;
          }
        }
  }
}

template <int QT>
int launch_stream(const int8_t* qc, const int8_t* codes, const int* ids,
                  const float* scales, const float* zeros, const float* norms,
                  const float* sq, const float* corr, float* out, int G, int B,
                  int N, int D, int l2, cudaStream_t s) {
  using namespace scan_stream;
  CUtensorMap map;
  int err =
      encode_lanes(&map, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, G, N, D);
  if (err) return err;
  const int qrow = (D + BOX_BYTES - 1) / BOX_BYTES * BOX_BYTES;
  const int side = 2 * QT * 4;
  const int stages = ring_stages(QT, qrow, side);
  if (stages < MIN_STAGES) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(stages, QT, qrow, side);
  const int n_tiles = (N + TILE_ROWS - 1) / TILE_ROWS;
  const int n_qt = (B + QT - 1) / QT;
  const int gx = persistent_blocks(scan_scores_q8_stream_kernel<QT>, smem,
                                   n_tiles, n_qt, G, &err);
  if (err) return err;
  scan_scores_q8_stream_kernel<QT>
      <<<dim3(gx, n_qt, G), scan_stream::THREADS, smem, s>>>(
          map, qc, ids, scales, zeros, norms, sq, corr, out, B, N, D, l2,
          stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded through ctypes): G lanes of [B, D] query
// codes over [N, D] code rows (G = 1: one scan).  variant 1 = stream (the
// caller has checked its shape and alignment rules), 0 = generic.  Launches
// on `stream` and returns cudaGetLastError() (or the setup's error) so the
// caller can raise on a refused launch.
extern "C" int scan_scores_q8_launch(const int8_t* qc, const int8_t* codes,
                                     const int* ids, const float* scales,
                                     const float* zeros, const float* norms,
                                     const float* sq, const float* corr,
                                     float* out, int G, int B, int N, int D,
                                     int l2, int vec16, int variant,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
#define SCAN_Q8_STREAM(QT)                                                 \
  return launch_stream<QT>(qc, codes, ids, scales, zeros, norms, sq, corr, \
                           out, G, B, N, D, l2, s)
    switch (scan_stream::query_tile(B)) {
      case 8: SCAN_Q8_STREAM(8);
      case 16: SCAN_Q8_STREAM(16);
      case 32: SCAN_Q8_STREAM(32);
      default: SCAN_Q8_STREAM(64);
    }
#undef SCAN_Q8_STREAM
  }
  dim3 block(THREADS);
  if (B <= 16) {
    dim3 grid((N + BN - 1) / BN, (B + 15) / 16, G);
    scan_scores_q8_kernel<1><<<grid, block, 0, s>>>(
        qc, codes, ids, scales, zeros, norms, sq, corr, out, B, N, D, l2,
        vec16);
  } else {
    dim3 grid((N + BN - 1) / BN, (B + 63) / 64, G);
    scan_scores_q8_kernel<4><<<grid, block, 0, s>>>(
        qc, codes, ids, scales, zeros, norms, sq, corr, out, B, N, D, l2,
        vec16);
  }
  return static_cast<int>(cudaGetLastError());
}
