// K4: gather + exact fp32 rescore of the bins the prefilter chose.
//
// Replaces the Pallas kernel _kernel of sert_tpu/ops/gather_rescore.py (:31,
// launched by _gather_rescore_one :73 through gather_rescore :51).
//     out[q, j * bw + l] = R[q] . M_binned[bin_idx[q, j], l]      (fp32)
// Each query reads only the rows of its own NB chosen bins; the gathered
// [Q, NB * bw, d] matrix never exists in device memory.
//
// What bounds it on the H100: bytes. At the serving shape (Q = 64,
// NB = 1012, bw = 128, d = 128, fp32 rows) a batch reads 4.2 GB of rows
// (~1.3 ms at 3.35 TB/s) for 1.1 GFLOP, far below the ridge. So the design
// only keeps many 16-byte (fp32) or 8-byte (bf16) loads in flight: one block
// per (query, BINS bins), one warp per row with each lane holding 4 columns,
// ROWS rows per warp in flight before the shuffle reductions. No tensor
// cores. The TPU version's scalar prefetch, SMEM chunking of bin_idx and the
// qb-fold replication of the M operand are not needed here: a block reads
// its own indices.
//
// A bin id outside [0, n_bins) yields NaN scores instead of reading out of
// bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BINS = 4;         // bins per block
constexpr int ROWS = 8;         // rows per warp in flight

__device__ inline float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_rescore_kernel(const float* __restrict__ R, const T* __restrict__ M,
                      const int* __restrict__ bin_idx,
                      float* __restrict__ out, int NB, int n_bins, int bw,
                      int d) {
  extern __shared__ __align__(16) float rs[];
  const int q = blockIdx.y;
  for (int i = threadIdx.x; i < d; i += THREADS) rs[i] = R[size_t(q) * d + i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = blockIdx.x * BINS;
  const int j1 = min(j0 + BINS, NB);
  const int total = (j1 - j0) * bw;             // rows of this block's bins
  const int* idx = bin_idx + size_t(q) * NB;
  float* o = out + size_t(q) * NB * bw + size_t(j0) * bw;

  for (int row0 = warp * ROWS; row0 < total; row0 += WARPS * ROWS) {
    const T* ptr[ROWS];
    bool ok[ROWS];
    float acc[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int row = row0 + u;
      const int b = row < total ? idx[j0 + row / bw] : -1;
      ok[u] = row < total && b >= 0 && b < n_bins;
      ptr[u] = M + (size_t(ok[u] ? b : 0) * bw + row % bw) * d;
      acc[u] = 0.0f;
    }
    for (int c = lane * 4; c < d; c += 128) {
      const float4 r = *reinterpret_cast<const float4*>(rs + c);
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (!ok[u]) continue;
        const float4 m = load4(ptr[u] + c);
        acc[u] = fmaf(r.x, m.x, acc[u]);
        acc[u] = fmaf(r.y, m.y, acc[u]);
        acc[u] = fmaf(r.z, m.z, acc[u]);
        acc[u] = fmaf(r.w, m.w, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int row = row0 + u;
        if (row < total) o[row] = ok[u] ? acc[u] : CUDART_NAN_F;
      }
    }
  }
}

template <typename T>
int launch(const void* R, const void* M, const void* bin_idx, void* out,
           int Q, int NB, int n_bins, int bw, int d, void* stream) {
  const dim3 grid((NB + BINS - 1) / BINS, Q);
  gather_rescore_kernel<T><<<grid, THREADS, size_t(d) * sizeof(float),
                             cudaStream_t(stream)>>>(
      static_cast<const float*>(R), static_cast<const T*>(M),
      static_cast<const int*>(bin_idx), static_cast<float*>(out), NB, n_bins,
      bw, d);
  return int(cudaGetLastError());
}

}  // namespace

// R [Q, d] fp32 (already rounded through M's dtype by the wrapper),
// M_binned [n_bins, bw, d] fp32 or bf16, bin_idx [Q, NB] int32,
// out [Q, NB * bw] fp32. d % 4 == 0 (the Python wrapper checks).
extern "C" int sert_gather_rescore_f32(const void* R, const void* M,
                                       const void* bin_idx, void* out, int Q,
                                       int NB, int n_bins, int bw, int d,
                                       void* stream) {
  return launch<float>(R, M, bin_idx, out, Q, NB, n_bins, bw, d, stream);
}

extern "C" int sert_gather_rescore_bf16(const void* R, const void* M,
                                        const void* bin_idx, void* out, int Q,
                                        int NB, int n_bins, int bw, int d,
                                        void* stream) {
  return launch<__nv_bfloat16>(R, M, bin_idx, out, Q, NB, n_bins, bw, d,
                               stream);
}
