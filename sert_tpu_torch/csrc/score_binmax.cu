// K3: fused score + per-bin max sweep for sm_90a.
//
// Replaces the Pallas kernels _kernel_bias / _kernel_nobias of
// sert_tpu/ops/score_binmax.py (:51 / :57, launched by score_binmax_prepared
// :87). out[q, b] = max over the bw consecutive entities e of bin b of
//     S[q, e] = R[q] . M[e]  (+ alpha[q] * bias[e]),
// with bf16 inputs and fp32 accumulation. The [Q, E] score matrix never
// reaches device memory: each block keeps its [TQ, TE] score tile in shared
// memory and writes only TE / bw maxima per query row.
//
// What bounds it on the H100: at the serving shape (Q = 64, E = 1M, d = 128)
// the sweep reads the 256 MB bf16 entity matrix once (~76 us at 3.35 TB/s)
// and does 16.4 GFLOP (~17 us at the dense bf16 tensor-core rate), so it is
// bound by device-memory bandwidth once the products run on tensor cores.
// This first version uses nvcuda::wmma bf16 fragments (mma.sync underneath)
// and plain 16-byte loads; TMA and wgmma are later work.
//
// Differences from the TPU kernel, on purpose:
//   * entities >= E are masked to -inf here, so the partial tail bin holds
//     the max over valid entities only (the TPU version padded with zero
//     rows, which can inflate that bin);
//   * the output is [Q, n_bins] row-major, not the bins-major transpose
//     Mosaic's (8, 128) block rule needed;
//   * any bw dividing TE is a plain warp max, not a masked 128-lane max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int TQ = 64;          // query rows per block
constexpr int TE = 128;         // entity rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD_H = 8;        // bf16 padding per shared row (16 bytes)
constexpr int LDS = TE + 4;     // fp32 score-tile row stride

__host__ __device__ inline int bf16_ld(int d) { return d + PAD_H; }

inline size_t smem_bytes(int d) {
  const size_t r = size_t(TQ) * bf16_ld(d) * 2;
  const size_t m = size_t(TE) * bf16_ld(d) * 2;
  const size_t s = size_t(TQ) * LDS * 4;
  return r + (m > s ? m : s);   // the score tile reuses the M tile's space
}

__global__ void __launch_bounds__(THREADS)
score_binmax_kernel(const __nv_bfloat16* __restrict__ R,
                    const __nv_bfloat16* __restrict__ M,
                    const float* __restrict__ bias,
                    const float* __restrict__ alpha,
                    float* __restrict__ out,
                    int Q, int E, int d, int bw, int n_bins) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = bf16_ld(d);
  __nv_bfloat16* Rs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ms = Rs + TQ * ld;
  float* Ss = reinterpret_cast<float*>(Ms);

  const int q0 = blockIdx.y * TQ;
  const int e0 = blockIdx.x * TE;
  const int tid = threadIdx.x;
  const int vecs = d / 8;       // 16-byte vectors per row

  // Stage the R and M tiles; rows past Q or E are zero (masked below).
  for (int i = tid; i < TQ * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Q)
      v = *reinterpret_cast<const uint4*>(R + size_t(q0 + r) * d + c);
    *reinterpret_cast<uint4*>(Rs + r * ld + c) = v;
  }
  for (int i = tid; i < TE * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (e0 + r < E)
      v = __ldg(reinterpret_cast<const uint4*>(M + size_t(e0 + r) * d + c));
    *reinterpret_cast<uint4*>(Ms + r * ld + c) = v;
  }
  __syncthreads();

  // 8 warps cover the 64 x 128 tile: warp w owns query rows 16*(w/2) and
  // four 16-wide entity column blocks starting at 64*(w%2).
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2;
  const int wc = (warp % 2) * 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kk = 0; kk < d; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Rs + wr * 16 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // B(k, n) = M[e0 + n][kk + k]: the M tile read column-major.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Ms + (wc + j) * 16 * ld + kk, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
  __syncthreads();              // every warp is done reading Ms
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Ss + wr * 16 * LDS + (wc + j) * 16, acc[j], LDS,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: one warp per (query row, bin) pair of the tile.
  const int bins_per_tile = TE / bw;
  const int b0 = e0 / bw;
  for (int p = warp; p < TQ * bins_per_tile; p += WARPS) {
    const int r = p / bins_per_tile, bi = p % bins_per_tile;
    const int q = q0 + r, bin = b0 + bi;
    if (q >= Q || bin >= n_bins) continue;      // uniform across the warp
    const float a = alpha != nullptr ? alpha[q] : 1.0f;
    float m = -CUDART_INF_F;
    for (int l = lane; l < bw; l += 32) {
      const int c = bi * bw + l, e = e0 + c;
      if (e < E) {
        float s = Ss[r * LDS + c];
        if (bias != nullptr) s += a * bias[e];
        m = fmaxf(m, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) out[size_t(q) * n_bins + bin] = m;
  }
}

}  // namespace

// R [Q, d] bf16, M [>=E, d] bf16, bias [E] fp32 or null, alpha [Q] fp32 or
// null, out [Q, n_bins] fp32. d % 16 == 0 and TE % bw == 0 (the Python
// wrapper checks both). Returns the cudaError_t of the launch.
extern "C" int sert_score_binmax(const void* R, const void* M,
                                 const void* bias, const void* alpha,
                                 void* out, int Q, int E, int d, int bw,
                                 int n_bins, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      score_binmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((E + TE - 1) / TE, (Q + TQ - 1) / TQ);
  score_binmax_kernel<<<grid, THREADS, smem, cudaStream_t(stream)>>>(
      static_cast<const __nv_bfloat16*>(R),
      static_cast<const __nv_bfloat16*>(M), static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<float*>(out), Q, E, d,
      bw, n_bins);
  return int(cudaGetLastError());
}
