// The streaming-scan machinery shared by scan_scores.cu and
// scan_scores_q8.cu (their `stream` variants), for Hopper (sm_90a).
// kmeans_assign.cu's `wgmma` variant uses its tensor-map encoder and its
// barrier and TMA helpers.
//
// Both scans are bound by the bytes of the database rows they stream once.
// The shape that keeps those bytes moving on this card:
//
//  * a persistent grid: about one block per SM, each walking row tiles
//    t = blockIdx.x, t += gridDim.x, so no block pays a cold start or an
//    exposed drain per tile;
//  * a lane axis on blockIdx.z: a launch scans G same-shaped collections
//    ([G, N, D] rows), lane g only its own rows, and every block owns one
//    (lane, query tile) pair for its whole life;
//  * the block's query tile resident in shared memory, loaded (and
//    converted) once before the stream starts;
//  * one producer warp that keeps a ring of up to MAX_STAGES TMA boxes
//    (TILE_ROWS rows x 128 depth bytes, 128-byte swizzle) in flight, with a
//    full/empty mbarrier pair per stage;
//  * GROUPS consumer groups of GROUP_WARPS warps taking the block's tiles
//    in turn (ping-pong): a group runs its tile's tensor-core products on
//    the stages that have arrived, then applies the epilogue and writes its
//    scores while the other group consumes the next tile.  The products run
//    in tile order (a turn barrier passes the ring from group to group), so
//    the stores of one tile overlap the loads and products of the next.
//
// TMA zero-fills boxes past the tensor's edge, so ragged N and a ragged
// depth inside a 16-byte-aligned row stride need no padding.  The rows are
// a 3-D tensor map (depth, N, G) read in one-lane boxes, so the last tile
// of lane g is zero-filled past N instead of reading lane g + 1's rows.
// The rows may lie in two segments with a map each (scan_scores reads an
// index's list tier and spill tier in place): the tile walk covers both
// segments' tiles, the first segment's first, and the same zero fill ends
// each segment's last tile.
//
// The host-side sizes here are mirrored in kernels/scan_stream.py, which
// chooses the variant before a launch.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace scan_stream {

constexpr int GROUP_WARPS = 4;       // 32 rows of a tile each
constexpr int GROUPS = 2;            // consumer groups taking tiles in turn
constexpr int GROUP_THREADS = 32 * GROUP_WARPS;
constexpr int CONSUMER_WARPS = GROUPS * GROUP_WARPS;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);  // + the producer warp
constexpr int TILE_ROWS = 32 * GROUP_WARPS;  // DB rows per tile (M side)
constexpr int BOX_BYTES = 128;       // depth bytes per box: the swizzle span
constexpr int STAGE_BYTES = TILE_ROWS * BOX_BYTES;
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 4;
constexpr int BARRIERS = 2 * MAX_STAGES + 2;  // full, empty, two turns
constexpr int QPAD = 16;             // bytes after each resident query row
constexpr int ALIGN = 1024;          // the 128-byte swizzle repeats every 1 KB
constexpr int SMEM_LIMIT = 232448;   // opt-in shared memory of a block

// Queries per resident tile: the MMA's N side (a multiple of 8).
inline int query_tile(int B) {
  return B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 64;
}

// Dynamic shared memory of a block: alignment slack, the ring, its
// barriers, the resident query rows and the per-query sidebands.
inline int smem_bytes(int stages, int qt, int qrow_bytes, int side_bytes) {
  return ALIGN + stages * STAGE_BYTES + BARRIERS * 8 +
         qt * (qrow_bytes + QPAD) + side_bytes;
}

// Ring depth that fits beside the resident queries (< MIN_STAGES: the
// shape is the generic variant's).
inline int ring_stages(int qt, int qrow_bytes, int side_bytes) {
  const int free = SMEM_LIMIT - smem_bytes(0, qt, qrow_bytes, side_bytes);
  const int s = free / STAGE_BYTES;
  return s > MAX_STAGES ? MAX_STAGES : s;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled refuses to encode on a thread with no current
// context.  A thread whose PyTorch work so far launched nothing (a service
// worker whose first task is a scan over views of the store) has none yet,
// so each encode first binds the primary context of the runtime's current
// device: the device of a context PyTorch bound, or device 0 on a thread
// where it bound none, as PyTorch's own current device is then.  Returns 0
// or a CUDA error code.
inline int bind_current_device() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  return static_cast<int>(e);
}

// A map of the row-major rows [n_rows, d] (elements of elem_bytes, the row
// stride d * elem_bytes a multiple of 16, base 16-byte aligned) in boxes of
// box_rows rows x box_elems elements of depth (box_elems * elem_bytes <=
// 128), 128-byte swizzled, zero-filled past the edges.  Returns 0 or a CUDA
// error code.
inline int encode_2d(CUtensorMap* map, const void* base,
                     CUtensorMapDataType dtype, int elem_bytes,
                     long long n_rows, int d, int box_elems, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (const int err = bind_current_device()) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_elems),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = enc(map, dtype, 2, const_cast<void*>(base), dims, strides,
                         box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The scans' rows [G, n_rows, d] (lane stride n_rows * d elements, a
// multiple of 16 bytes since the row stride is) as a 3-D map in boxes of
// TILE_ROWS rows x BOX_BYTES of depth x one lane, 128-byte swizzled,
// zero-filled past each lane's last row.  Returns 0 or a CUDA error code.
inline int encode_lanes(CUtensorMap* map, const void* base,
                        CUtensorMapDataType dtype, int elem_bytes, int G,
                        long long n_rows, int d) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (const int err = bind_current_device()) return err;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(d) * elem_bytes;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n_rows),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[2] = {row_bytes,
                                 row_bytes * static_cast<cuuint64_t>(n_rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(BOX_BYTES / elem_bytes),
                             static_cast<cuuint32_t>(TILE_ROWS), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = enc(map, dtype, 3, const_cast<void*>(base), dims, strides,
                         box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The persistent grid's width: SMs x resident blocks per SM at `smem`
// bytes, shared by the n_qt query tiles of each of the G lanes, at least
// one and at most one block per row tile.  The residency (which does not
// depend on G or n_qt, so they stay out of the cache key) is computed once
// per (card, kernel, smem) and the kernel's shared-memory limit raised once
// to SMEM_LIMIT (never lowered, so concurrent launches of other shapes stay
// valid): the probed path launches a scan per query, and asking the
// runtime each time would cost more host time than the kernel takes.
// Returns 0 on an error (in *err).
template <typename Kernel>
inline int persistent_blocks(Kernel kernel, int smem, int n_tiles, int n_qt,
                             int G, int* err) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> resident;
  int dev = 0, per_card = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    const auto key =
        std::make_tuple(dev, reinterpret_cast<const void*>(kernel), smem);
    std::lock_guard<std::mutex> lock(mu);
    const auto it = resident.find(key);
    if (it != resident.end()) {
      per_card = it->second;
    } else {
      int sms = 0, occ = 0;
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                          THREADS, smem);
      if (e == cudaSuccess && occ < 1) e = cudaErrorInvalidConfiguration;
      if (e == cudaSuccess) resident[key] = per_card = sms * occ;
    }
  }
  *err = static_cast<int>(e);
  if (e != cudaSuccess) return 0;
  int gx = per_card / (n_qt * G);
  gx = gx < 1 ? 1 : gx;
  return gx < n_tiles ? gx : n_tiles;
}

// ---------------------------------------------------------------------------
// device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box at (depth c0, row c1) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One TMA box of a 3-D map at (depth c0, row c1, lane c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The block's shared memory: the ring (1 KB aligned, as the swizzle needs),
// its barriers, then the kernel's own region (16-byte aligned).
struct Smem {
  uint8_t* ring;
  uint64_t* full;    // [MAX_STAGES] a stage has landed
  uint64_t* empty;   // [MAX_STAGES] a stage has been consumed
  uint64_t* turn;    // [2] group g may run its products
  uint8_t* rest;
};

// Carves the dynamic shared memory; thread 0 initializes the barriers
// (full[s]: the producer's arrival plus the stage's bytes; empty[s]: every
// thread of the consuming group; turn[g]: every thread of the other
// group).  The caller synchronizes the block before any barrier is used.
__device__ __forceinline__ Smem carve_smem(uint8_t* raw, int stages) {
  const uint32_t a = smem_u32(raw);
  Smem s;
  s.ring = raw + ((ALIGN - (a & (ALIGN - 1))) & (ALIGN - 1));
  s.full = reinterpret_cast<uint64_t*>(s.ring + stages * STAGE_BYTES);
  s.empty = s.full + MAX_STAGES;
  s.turn = s.empty + MAX_STAGES;
  s.rest = reinterpret_cast<uint8_t*>(s.turn + 2);
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(&s.full[i], 1);
      bar_init(&s.empty[i], GROUP_THREADS);
    }
    bar_init(&s.turn[0], GROUP_THREADS);
    bar_init(&s.turn[1], GROUP_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return s;
}

// The stage ring as each role walks it: stage index and phase parity.
struct Ring {
  int stages;
  int stage = 0;
  uint32_t phase = 0;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ void advance(int k = 1) {
    for (int i = 0; i < k; ++i) {
      if (++stage == stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
  }
};

// The producer warp's whole life: lane 0 streams every stage of every row
// tile this block owns in its lane (blockIdx.z), in the order the consumer
// groups walk them.  The rows may come in two segments, each its own map:
// tile t < t1 is rows t * TILE_ROWS.. of `map`, tile t >= t1 rows
// (t - t1) * TILE_ROWS.. of `map2`, so a segment's last tile is zero-filled
// past its own end and never reads the other segment's rows.
__device__ __forceinline__ void produce(const CUtensorMap* map,
                                        const CUtensorMap* map2, int t1,
                                        const Smem& sm, int stages,
                                        int n_tiles, int kb_n, int box_elems) {
  if (threadIdx.x % 32 != 0) return;
  Ring r(stages);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const bool second = t >= t1;
    const CUtensorMap* m = second ? map2 : map;
    const int row = (second ? t - t1 : t) * TILE_ROWS;
    for (int kb = 0; kb < kb_n; ++kb) {
      bar_wait(&sm.empty[r.stage], r.phase ^ 1u);
      bar_expect_tx(&sm.full[r.stage], STAGE_BYTES);
      tma_load_3d(sm.ring + r.stage * STAGE_BYTES, m, &sm.full[r.stage],
                  kb * box_elems, row, blockIdx.z);
      r.advance();
    }
  }
}

// One segment: every tile from `map`.
__device__ __forceinline__ void produce(const CUtensorMap* map, const Smem& sm,
                                        int stages, int n_tiles, int kb_n,
                                        int box_elems) {
  produce(map, map, n_tiles, sm, stages, n_tiles, kb_n, box_elems);
}

// A consumer group's place in the ping-pong: group g takes the block's
// tiles g, g + GROUPS, ...; the products of its n-th tile wait until the
// other group has finished the products of the tile before.
struct Turn {
  uint64_t* turn;
  int group;
  uint32_t n = 0;
  __device__ Turn(uint64_t* t, int g) : turn(t), group(g) {}
  __device__ bool mine(int local_tile) const {
    return local_tile % GROUPS == group;
  }
  __device__ void acquire() const {
    if (GROUPS == 1) return;
    if (group == 0) {
      if (n > 0) bar_wait(&turn[0], (n - 1) & 1u);
    } else {
      bar_wait(&turn[1], n & 1u);
    }
  }
  __device__ void release() {
    if (GROUPS > 1) bar_arrive(&turn[1 - group]);
    ++n;
  }
};

}  // namespace scan_stream
