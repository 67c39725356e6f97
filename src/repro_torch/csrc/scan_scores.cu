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
// A launch takes a lane axis (what the TPU kernel runs under `vmap` for a
// cross-collection fused query): G same-shaped scans, Q f32[G, B, D] against
// DB f32[G, N, D] (ids, norms [G, N]; scores [G, B, N]), lane g on
// blockIdx.z with every operand offset by its lane stride.  A lane's
// arithmetic is that of a G = 1 launch on its operands, bit for bit: the
// depth order of each output's sum does not depend on the lane, the query
// tile or the grid.
//
// The rows may come in two segments, DB1 f32[(G,) N1, D] and DB2 f32[(G,)
// N2, D], each with its own ids and norms [(G,) N1] and [(G,) N2], scored
// as if concatenated: S[:, n] is row n of DB1 for n < N1 and row n - N1 of
// DB2 after it.  A full scan reads an index's list tier and spill tier, rows
// and ids, where they lie, with no concatenated copy; each row's sum is the
// one-segment launch's, bit for bit.  N2 = 0 is the one-segment launch: the
// same grid and tiles.
//
// Two variants, chosen by the wrapper from shapes and alignment alone:
//
// `stream` (D % 4 == 0, 16-byte-aligned q and segments, the query tile
// fits in shared memory; scan_stream.cuh): a persistent grid whose blocks
// keep a tile of up to 64 queries resident as bf16 and stream 128-row DB
// tiles (each segment through its own tensor map) through a TMA ring of
// 128-row x 32-float boxes.  Two consumer groups of four warps take the
// tiles in turn.  A group reads each f32 box from the swizzled stage,
// converts it to bf16 in registers (the TPU kernel's in-VREG conversion:
// the bf16 copy never exists in device memory) and runs mma.sync
// m16n8k16 with the DB rows on the M side, so B = 1 costs an N = 8
// product.  The accumulator stays in registers over all of D; the
// norm/mask epilogue is applied in registers and its stores (each
// instruction eight neighbouring rows of four queries: 32-byte segments
// along N) overlap the other group's products on the next tile.
//
// `generic` (any shape): each block streams one 128-row tile (a row
// pointer per row, from whichever segment holds it), converting
// f32 -> bf16 on its way to shared memory, WMMA bf16 with the next stage's
// loads issued before the current stage's products, and a staged epilogue
// written coalesced along N.  Ragged B, N and D are masked in the kernel
// (zero-filled operands, guarded stores), so no padding is needed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "scan_stream.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 128;          // DB rows per block (4 warps x 32)
constexpr int BK = 32;           // depth per pipeline stage
constexpr int LDS = BK + 8;      // padded shared row, bf16 elements
constexpr int THREADS = 128;
constexpr int STAGE_LD = BN + 4; // f32 staging row for the epilogue

// Four depth elements k.. of the row at `row` (nullptr: past the rows),
// zero past D.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int k,
                                        int D, int vec4) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row != nullptr) {
    const float* p = row + k;
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

// MF = 16-row query fragments per block (BM = 16 * MF queries).  Score
// column n < N1 is row n of db (ids, norms), n >= N1 row n - N1 of db2
// (ids2, norms2).
template <int MF>
__global__ void __launch_bounds__(THREADS)
scan_scores_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const float* __restrict__ db2, const int* __restrict__ ids,
                   const int* __restrict__ ids2,
                   const float* __restrict__ norms,
                   const float* __restrict__ norms2, float* __restrict__ out,
                   int B, int N1, int N2, int D, int l2, int vec4) {
  constexpr int BM = 16 * MF;
  const int N = N1 + N2;           // score columns
  const size_t coll = blockIdx.z;  // the lane
  q += coll * B * D;
  db += coll * N1 * D;
  db2 += coll * N2 * D;
  ids += coll * N1;
  ids2 += coll * N2;
  if (l2) {
    norms += coll * N1;
    norms2 += coll * N2;
  }
  out += coll * B * N;
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

  auto q_row = [&](int b) -> const float* {
    return b < B ? q + (size_t)b * D : nullptr;
  };
  auto db_row = [&](int n) -> const float* {
    return n >= N ? nullptr
           : n < N1 ? db + (size_t)n * D
                    : db2 + (size_t)(n - N1) * D;
  };
  float4 rq[QV], rd[DV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int e = tid + i * THREADS;
      rq[i] = load4(q_row(m0 + e / V), k0 + (e % V) * 4, D, vec4);
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int e = tid + i * THREADS;
      rd[i] = load4(db_row(n0 + e / V), k0 + (e % V) * 4, D, vec4);
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
      const bool first = n < N1;
      const int row = first ? n : n - N1;   // in its segment
      float s = stage[r * STAGE_LD + c];
      if (l2) s = (first ? norms : norms2)[row] - 2.f * s;
      if ((first ? ids : ids2)[row] < 0) s = mask_val;
      out[(size_t)b * N + n] = s;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// QT = resident queries per block (blockIdx.y selects the query tile,
// blockIdx.z the lane).  The rows are N1 rows through db_map (ids, norms),
// then N2 through db2_map (ids2, norms2; N2 = 0: one segment); score
// column n < N1 is row n of the first, n >= N1 row n - N1 of the second.
template <int QT>
__global__ void __launch_bounds__(scan_stream::THREADS, 1)
scan_scores_stream_kernel(const __grid_constant__ CUtensorMap db_map,
                          const __grid_constant__ CUtensorMap db2_map,
                          const float* __restrict__ q,
                          const int* __restrict__ ids,
                          const int* __restrict__ ids2,
                          const float* __restrict__ norms,
                          const float* __restrict__ norms2,
                          float* __restrict__ out, int B, int N1, int N2,
                          int D, int l2, int stages) {
  using namespace scan_stream;
  constexpr int NB = QT / 8;                // n8 blocks of queries
  constexpr int BOX_K = BOX_BYTES / 4;      // f32 depth per stage
  const int N = N1 + N2;           // score columns
  const size_t coll = blockIdx.z;  // the lane; its rows come through the maps
  q += coll * B * D;
  ids += coll * N1;
  ids2 += coll * N2;
  if (l2) {
    norms += coll * N1;
    norms2 += coll * N2;
  }
  out += coll * B * N;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve_smem(smem_raw, stages);
  uint8_t* s_q = sm.rest;                   // [QT][dpad] bf16 (+ QPAD)

  const int kb_n = (D + BOX_K - 1) / BOX_K;
  const int dpad = kb_n * BOX_K;
  const int qstride = dpad * 2 + QPAD;      // bytes per resident query row
  const int t1 = (N1 + TILE_ROWS - 1) / TILE_ROWS;  // first segment's tiles
  const int n_tiles = t1 + (N2 + TILE_ROWS - 1) / TILE_ROWS;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the query tile, as bf16, zero past B and D (D % 4 == 0 here)
  const int v4 = dpad / 4;
  for (int e = tid; e < QT * v4; e += scan_stream::THREADS) {
    const int r = e / v4, k = (e % v4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < B && k < D)
      v = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * D + k));
    uint32_t* dst = reinterpret_cast<uint32_t*>(s_q + r * qstride + k * 2);
    dst[0] = pack_bf16(make_float2(v.x, v.y));
    dst[1] = pack_bf16(make_float2(v.z, v.w));
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    produce(&db_map, &db2_map, t1, sm, stages, n_tiles, kb_n, BOX_K);
    return;
  }

  const int wrow = (warp % GROUP_WARPS) * 32;  // this warp's rows in a tile
  const int g = lane >> 2, tg = lane & 3;
  const float mask_val = l2 ? INFINITY : -INFINITY;
  // ldmatrix row address of this lane in the query tile: matrices 0/1 are
  // depth halves of queries 0-7 of an n8 pair, matrices 2/3 of queries 8-15
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
    // the tile's segment: its rows, sidebands and first score column
    const bool second = t >= t1;
    const int seg_n = second ? N2 : N1;
    const int* seg_ids = second ? ids2 : ids;
    const float* seg_norms = second ? norms2 : norms;
    const int seg_col = second ? N1 : 0;
    const int row0 = (second ? t - t1 : t) * TILE_ROWS + wrow;
    // this thread's four rows' score columns (-1: past the segment) and
    // sidebands, fetched now, used after the loop
    int col[2][2];
    float nrm[2][2];
    bool dead[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + mi * 16 + h * 8 + g;
        col[mi][h] = r < seg_n ? seg_col + r : -1;
        dead[mi][h] = r < seg_n && seg_ids[r] < 0;
        nrm[mi][h] = (l2 && r < seg_n) ? seg_norms[r] : 0.f;
      }
    float acc[2][NB][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][nb][i] = 0.f;

    turn.acquire();
    for (int kb = 0; kb < kb_n; ++kb) {
      bar_wait(&sm.full[rg.stage], rg.phase);
      const uint8_t* st = sm.ring + rg.stage * STAGE_BYTES;
#pragma unroll
      for (int ks = 0; ks < BOX_K / 16; ++ks) {
        // A: rows g / g + 8 of each 16-row half, depth 2tg (+8), read from
        // the swizzled box (16-byte unit u of row r sits at u ^ (r % 8))
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint8_t* rowp = st + (wrow + mi * 16 + g) * BOX_BYTES;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = ks * 16 + h * 8 + 2 * tg;
            const int off = (((k >> 2) ^ g) << 4) + ((k & 3) << 2);
            a[mi][2 * h] =
                pack_bf16(*reinterpret_cast<const float2*>(rowp + off));
            a[mi][2 * h + 1] = pack_bf16(
                *reinterpret_cast<const float2*>(rowp + 8 * BOX_BYTES + off));
          }
        }
        const uint32_t b_k = b_lane + (kb * BOX_K + ks * 16) * 2;
        if constexpr (NB == 1) {
          uint32_t b[2];
          ldmatrix_x2(b, b_k);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][0], a[mi], b[0], b[1]);
        } else {
#pragma unroll
          for (int j = 0; j < NB / 2; ++j) {
            uint32_t b[4];
            ldmatrix_x4(b, b_k + j * 16 * qstride);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[mi][2 * j], a[mi], b[0], b[1]);
              mma_bf16(acc[mi][2 * j + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
      bar_arrive(&sm.empty[rg.stage]);
      rg.advance();
    }
    turn.release();

    // epilogue in registers, overlapping the other group's products:
    // acc[mi][nb][i] is row mi*16 + g (+8 for i >= 2) of this warp's 32,
    // query nb*8 + 2tg (+1 for odd i); each store instruction writes eight
    // neighbouring rows (32 bytes) of each of four queries
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int n = col[mi][h];
          const int b = q0 + nb * 8 + 2 * tg + (i & 1);
          if (n >= 0 && b < B) {
            float s = acc[mi][nb][i];
            if (l2) s = nrm[mi][h] - 2.f * s;
            out[(size_t)b * N + n] = dead[mi][h] ? mask_val : s;
          }
        }
  }
}

template <int QT>
int launch_stream(const float* q, const float* db, const float* db2,
                  const int* ids, const int* ids2, const float* norms,
                  const float* norms2, float* out, int G, int B, int N1,
                  int N2, int D, int l2, cudaStream_t s) {
  using namespace scan_stream;
  CUtensorMap map, map2;
  int err =
      encode_lanes(&map, db, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, G, N1, D);
  if (err) return err;
  if (N2 > 0) {
    err = encode_lanes(&map2, db2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, G, N2,
                       D);
    if (err) return err;
  } else {
    map2 = map;                    // never read: no tile lies past t1
  }
  const int box_k = BOX_BYTES / 4;
  const int qrow = (D + box_k - 1) / box_k * box_k * 2;
  const int stages = ring_stages(QT, qrow, 0);
  if (stages < MIN_STAGES) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(stages, QT, qrow, 0);
  const int n_tiles =
      (N1 + TILE_ROWS - 1) / TILE_ROWS + (N2 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_qt = (B + QT - 1) / QT;
  const int gx = persistent_blocks(scan_scores_stream_kernel<QT>, smem,
                                   n_tiles, n_qt, G, &err);
  if (err) return err;
  scan_scores_stream_kernel<QT>
      <<<dim3(gx, n_qt, G), scan_stream::THREADS, smem, s>>>(
          map, map2, q, ids, ids2, norms, norms2, out, B, N1, N2, D, l2,
          stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded through ctypes): G lanes of [B, D] queries
// over rows in two segments, [N1, D] at db (ids, norms [N1]) then [N2, D]
// at db2 (ids2, norms2 [N2]; N2 = 0: one segment, db2 and its sidebands
// unused; G = 1: one scan), scores [B, N1 + N2].  variant 1 = stream (the
// caller has checked its shape and alignment rules), 0 = generic.
// Launches on `stream` and returns cudaGetLastError() (or the setup's
// error) so the caller can raise on a refused launch.
extern "C" int scan_scores_launch(const float* q, const float* db,
                                  const float* db2, const int* ids,
                                  const int* ids2, const float* norms,
                                  const float* norms2, float* out, int G,
                                  int B, int N1, int N2, int D, int l2,
                                  int vec4, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N2 == 0) {
    db2 = db;
    ids2 = ids;
    norms2 = norms;
  }
  if (variant == 1) {
    switch (scan_stream::query_tile(B)) {
      case 8:
        return launch_stream<8>(q, db, db2, ids, ids2, norms, norms2, out, G,
                                B, N1, N2, D, l2, s);
      case 16:
        return launch_stream<16>(q, db, db2, ids, ids2, norms, norms2, out, G,
                                 B, N1, N2, D, l2, s);
      case 32:
        return launch_stream<32>(q, db, db2, ids, ids2, norms, norms2, out, G,
                                 B, N1, N2, D, l2, s);
      default:
        return launch_stream<64>(q, db, db2, ids, ids2, norms, norms2, out, G,
                                 B, N1, N2, D, l2, s);
    }
  }
  const int N = N1 + N2;
  dim3 block(THREADS);
  if (B <= 16) {
    dim3 grid((N + BN - 1) / BN, (B + 15) / 16, G);
    scan_scores_kernel<1><<<grid, block, 0, s>>>(
        q, db, db2, ids, ids2, norms, norms2, out, B, N1, N2, D, l2, vec4);
  } else {
    dim3 grid((N + BN - 1) / BN, (B + 63) / 64, G);
    scan_scores_kernel<4><<<grid, block, 0, s>>>(
        q, db, db2, ids, ids2, norms, norms2, out, B, N1, N2, D, l2, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
