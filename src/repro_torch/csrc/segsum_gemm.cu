// Deterministic segmented sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segsum_gemm.py::segsum_gemm
// (body _segsum_kernel).  For rows x f32[M, D] and assignments a[M]:
//
//   sums[c]   = sum over rows with a[m] == c of bf16(x[m]), in f32
//   counts[c] = number of such rows (exact)
//
// rows with a[m] outside [0, C) are ignored.  On the TPU this is a dense
// one-hot GEMM (an artifact of the matrix unit); here it is the segmented
// sum it computes.
//
// What bounds it on this card: bytes.  Every valid row is read once (4 B per
// component) for one add per component — nothing for the tensor cores.
//
// What the design does about it: the caller groups rows by cluster with a
// stable sort (`order`, `starts`, `counts`), and one block per (cluster,
// 512-column tile) walks its cluster's rows in row order, 16 B per thread
// per row, four rows in flight per thread.  Each output is written once, no
// atomics: one input always gives bit-identical sums.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TD = THREADS * 4;   // columns per block

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 load4(const float* __restrict__ x, int row,
                                        int d, int D, int vec4) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = x + (size_t)row * D + d;
  if (vec4 && d + 3 < D) {
    v = *reinterpret_cast<const float4*>(p);
  } else {
    if (d < D) v.x = p[0];
    if (d + 1 < D) v.y = p[1];
    if (d + 2 < D) v.z = p[2];
    if (d + 3 < D) v.w = p[3];
  }
  return v;
}

__device__ __forceinline__ void add_bf(float4& acc, float4 v) {
  acc.x += bf(v.x);
  acc.y += bf(v.y);
  acc.z += bf(v.z);
  acc.w += bf(v.w);
}

__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ x, const int* __restrict__ order,
              const int* __restrict__ starts, const int* __restrict__ counts,
              float* __restrict__ sums, float* __restrict__ counts_out,
              int D, int vec4) {
  const int c = blockIdx.x;
  const int d = blockIdx.y * TD + threadIdx.x * 4;
  const int start = starts[c];
  const int cnt = counts[c];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (d < D) {
    int i = 0;
    for (; i + 4 <= cnt; i += 4) {
      const float4 v0 = load4(x, order[start + i], d, D, vec4);
      const float4 v1 = load4(x, order[start + i + 1], d, D, vec4);
      const float4 v2 = load4(x, order[start + i + 2], d, D, vec4);
      const float4 v3 = load4(x, order[start + i + 3], d, D, vec4);
      add_bf(acc, v0);   // row order, one row at a time: deterministic
      add_bf(acc, v1);
      add_bf(acc, v2);
      add_bf(acc, v3);
    }
    for (; i < cnt; ++i) add_bf(acc, load4(x, order[start + i], d, D, vec4));
    float* out = sums + (size_t)c * D + d;
    if (vec4 && d + 3 < D) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      out[0] = acc.x;
      if (d + 1 < D) out[1] = acc.y;
      if (d + 2 < D) out[2] = acc.z;
      if (d + 3 < D) out[3] = acc.w;
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) counts_out[c] = (float)cnt;
}

}  // namespace

// Plain C entry point (loaded through ctypes).  `order` lists the valid rows
// grouped by cluster (stable), cluster c owning order[starts[c] ..
// starts[c] + counts[c]).  Launches on `stream`; returns cudaGetLastError().
extern "C" int segsum_gemm_launch(const float* x, const int* order,
                                  const int* starts, const int* counts,
                                  float* sums, float* counts_out, int C,
                                  int D, int vec4, void* stream) {
  dim3 grid(C, (D + TD - 1) / TD);
  segsum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, order, starts, counts, sums, counts_out, D, vec4);
  return static_cast<int>(cudaGetLastError());
}
