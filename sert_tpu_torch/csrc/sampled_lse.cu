// K1 + K2: masked log-sum-exp over batch-shared sampled-softmax candidates,
// forward and backward, for sm_90a.
//
// Replaces the Pallas kernels of sert_tpu/ops/sampled_lse.py: _fwd_kernel
// :78 (launched by _slse_fwd :184) and _bwd_kernel :89 (launched by
// _slse_bwd :220). With z[b, j] = R[b] . C[j] - corr[j], and z = -1e30 where
// j >= k or ids[j] == pos[b] (an accidental hit):
//   K1: per (batch row, candidate chunk) the running (max, sumexp) of z; the
//       caller merges the chunks into lse[b] (as the reference merges its
//       per-tile partials outside the kernel);
//   K2: p = g[b] * exp(z - lse[b]);  dC = p^T R,  dcorr = -sum_b p,
//       dreps = p C,  with p rounded to the compute type before both
//       products (the reference's cast points).
// The [B, k] logits never reach device memory: every block keeps one
// 64 x 64 tile of them in shared memory.
//
// What bounds it on the H100: at the flagship shape (B = 4096, k = 32768,
// d = 128) each product is 2 B k d = 34 GFLOP, and the forward plus the
// two backward sweeps take five of them (z once in K1 and once in each K2
// sweep, then dC and dreps), about 172 GFLOP a step, while the inputs are
// a few MB. So the kernels are bound by arithmetic, and the recompute is
// the price of keeping the 512 MB fp32 logits out of device memory. This
// first version multiplies bf16 tiles with nvcuda::wmma fragments (mma.sync
// into fp32) and fp32 tiles on the CUDA cores; wgmma, TMA and pipelined
// loads are later work.
//
// Design against the card rather than the TPU grid:
//   * occupancy: the candidate axis is split into chunks as well as the
//     batch axis, so the flagship's 64 batch tiles become ~576 blocks;
//   * determinism: no float atomics. The dC / dcorr sweep gives each
//     candidate tile one block that loops over all batch tiles in order;
//     the dreps sweep writes one partial per (chunk, batch row), which the
//     caller sums in a fixed order;
//   * masks: -1e30, not -inf; padded batch rows and masked entries give
//     p = 0 exactly, so an all-masked row (lse ~ -1e30, g = 0) has dreps 0;
//     candidate rows past k and batch rows past B are staged as zeros, never
//     read out of bounds.

#include <math_constants.h>

#include "tile_mm.cuh"

namespace {

// Small per-tile vectors: the candidate tile's corr and ids, the batch
// tile's positive ids, lse and upstream gradient.
struct Vecs {
  float* corr;
  int* ids;
  int* pos;
  float* lse;
  float* g;
  __device__ explicit Vecs(unsigned char* base) {
    corr = reinterpret_cast<float*>(base);
    ids = reinterpret_cast<int*>(corr + TILE);
    pos = ids + TILE;
    lse = reinterpret_cast<float*>(pos + TILE);
    g = lse + TILE;
  }
};

__device__ void stage_cand_vecs(Vecs v, const float* corr, const int* ids,
                                int j0, int k) {
  const int t = threadIdx.x;
  if (t < TILE) {
    const bool in = j0 + t < k;
    v.corr[t] = in ? corr[j0 + t] : 0.0f;
    v.ids[t] = in ? ids[j0 + t] : -1;
  }
}

__device__ void stage_row_vecs(Vecs v, const int* pos, const float* lse,
                               const float* g, int b0, int B) {
  const int t = threadIdx.x;
  if (t < TILE) {
    const bool in = b0 + t < B;
    v.pos[t] = in ? pos[b0 + t] : -1;
    if (lse != nullptr) {
      v.lse[t] = in ? lse[b0 + t] : 0.0f;
      v.g[t] = in ? g[b0 + t] : 0.0f;
    }
  }
}

__device__ inline bool kept(Vecs v, int b0, int B, int j0, int k, int r,
                            int c) {
  return b0 + r < B && j0 + c < k && v.ids[c] != v.pos[r];
}

// Overwrite the logits tile Zs with p = g * exp(z - corr - lse) (0 where
// masked) in fp32 and, for bf16, write p rounded to bf16 into Ps.
template <typename T>
__device__ void probs(float* Zs, bf16* Ps, Vecs v, int b0, int B, int j0,
                      int k) {
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    float p = 0.0f;
    if (kept(v, b0, B, j0, k, r, c))
      p = v.g[r] * expf(Zs[r * LDZ + c] - v.corr[c] - v.lse[r]);
    Zs[r * LDZ + c] = p;
    if constexpr (sizeof(T) == 2) Ps[r * LDP + c] = __float2bfloat16(p);
  }
}

// K1: grid (batch tiles, candidate chunks). Each block keeps the running
// (max, sumexp) of its 64 rows over its chunk's candidate tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
slse_fwd_kernel(const T* __restrict__ R, const T* __restrict__ C,
                const float* __restrict__ corr, const int* __restrict__ ids,
                const int* __restrict__ pos, float* __restrict__ m_out,
                float* __restrict__ s_out, int B, int k, int dp,
                int tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(dp, false);
  T* Rs = reinterpret_cast<T*>(smem + L.r);
  T* Cs = reinterpret_cast<T*>(smem + L.c);
  float* Zs = reinterpret_cast<float*>(smem + L.z);
  Vecs v(smem + L.vec);

  const int b0 = blockIdx.x * TILE;
  const int chunk = blockIdx.y;
  const int n_tiles = (k + TILE - 1) / TILE;
  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, n_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int ROWS = TILE / WARPS;   // rows per warp

  stage(Rs, L.ldt, R, b0, B, dp);
  stage_row_vecs(v, pos, nullptr, nullptr, b0, B);
  float m_run[ROWS], s_run[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_run[i] = -CUDART_INF_F;
    s_run[i] = 0.0f;
  }

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * TILE;
    __syncthreads();              // the previous tile is fully read
    stage(Cs, L.ldt, C, j0, k, dp);
    stage_cand_vecs(v, corr, ids, j0, k);
    __syncthreads();
    block_mm<false, true>(Rs, L.ldt, Cs, L.ldt, Zs, LDZ, TILE, dp, false);
    __syncthreads();
    online_lse(
        Zs, m_run, s_run, [&](int c) { return -v.corr[c]; },
        [&](int r, int c) { return j0 + c < k && v.ids[c] != v.pos[r]; });
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = b0 + warp * ROWS + i;
      if (row < B) {
        m_out[size_t(chunk) * B + row] = m_run[i];
        s_out[size_t(chunk) * B + row] = s_run[i];
      }
    }
  }
}

// K2, first sweep: one block per candidate tile, looping over every batch
// tile in order: dC[tile] = sum_b p^T R and dcorr[tile] = -sum_b p.
template <typename T>
__global__ void __launch_bounds__(THREADS)
slse_bwd_dc_kernel(const T* __restrict__ R, const T* __restrict__ C,
                   const float* __restrict__ corr,
                   const int* __restrict__ ids, const int* __restrict__ pos,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dC, float* __restrict__ dcorr, int B,
                   int k, int dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(dp, true);
  T* Rs = reinterpret_cast<T*>(smem + L.r);
  T* Cs = reinterpret_cast<T*>(smem + L.c);
  float* Zs = reinterpret_cast<float*>(smem + L.z);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Acc = reinterpret_cast<float*>(smem + L.acc);
  Vecs v(smem + L.vec);

  const int j0 = blockIdx.x * TILE;
  const int n_btiles = (B + TILE - 1) / TILE;
  stage(Cs, L.ldt, C, j0, k, dp);
  stage_cand_vecs(v, corr, ids, j0, k);
  float col_sum = 0.0f;                 // thread t < 64: column t of dcorr

  for (int bt = 0; bt < n_btiles; ++bt) {
    const int b0 = bt * TILE;
    __syncthreads();
    stage(Rs, L.ldt, R, b0, B, dp);
    stage_row_vecs(v, pos, lse, g, b0, B);
    __syncthreads();
    block_mm<false, true>(Rs, L.ldt, Cs, L.ldt, Zs, LDZ, TILE, dp, false);
    __syncthreads();
    probs<T>(Zs, Ps, v, b0, B, j0, k);
    __syncthreads();
    if (threadIdx.x < TILE)
      for (int r = 0; r < TILE; ++r) col_sum += Zs[r * LDZ + threadIdx.x];
    block_mm<true, false>(p_tile<T>(Zs, Ps), p_ld<T>(), Rs, L.ldt, Acc,
                          L.lda, dp, TILE, bt > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * dp; i += THREADS) {
    const int r = i / dp, c = i % dp;
    dC[size_t(j0 + r) * dp + c] = Acc[r * L.lda + c];
  }
  if (threadIdx.x < TILE) dcorr[j0 + threadIdx.x] = -col_sum;
}

// K2, second sweep: grid (batch tiles, candidate chunks); each block writes
// its rows' partial dreps = p C over the chunk's candidate tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
slse_bwd_dreps_kernel(const T* __restrict__ R, const T* __restrict__ C,
                      const float* __restrict__ corr,
                      const int* __restrict__ ids,
                      const int* __restrict__ pos,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, float* __restrict__ part,
                      int B, int k, int dp, int tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(dp, true);
  T* Rs = reinterpret_cast<T*>(smem + L.r);
  T* Cs = reinterpret_cast<T*>(smem + L.c);
  float* Zs = reinterpret_cast<float*>(smem + L.z);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Acc = reinterpret_cast<float*>(smem + L.acc);
  Vecs v(smem + L.vec);

  const int b0 = blockIdx.x * TILE;
  const int chunk = blockIdx.y;
  const int n_tiles = (k + TILE - 1) / TILE;
  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, n_tiles);
  stage(Rs, L.ldt, R, b0, B, dp);
  stage_row_vecs(v, pos, lse, g, b0, B);

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * TILE;
    __syncthreads();
    stage(Cs, L.ldt, C, j0, k, dp);     // rows past k are zero
    stage_cand_vecs(v, corr, ids, j0, k);
    __syncthreads();
    block_mm<false, true>(Rs, L.ldt, Cs, L.ldt, Zs, LDZ, TILE, dp, false);
    __syncthreads();
    probs<T>(Zs, Ps, v, b0, B, j0, k);
    __syncthreads();
    block_mm<false, false>(p_tile<T>(Zs, Ps), p_ld<T>(), Cs, L.ldt, Acc,
                           L.lda, dp, TILE, t > t0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * dp; i += THREADS) {
    const int r = i / dp, c = i % dp;
    if (b0 + r < B)
      part[(size_t(chunk) * B + b0 + r) * dp + c] = Acc[r * L.lda + c];
  }
}

template <typename T>
int launch_fwd(const void* R, const void* C, const void* corr,
               const void* ids, const void* pos, void* m_out, void* s_out,
               int B, int k, int dp, int tiles_per_chunk, int n_chunks,
               cudaStream_t stream) {
  const size_t smem = Layout<T>(dp, false).total;
  cudaError_t err = cudaFuncSetAttribute(
      slse_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((B + TILE - 1) / TILE, n_chunks);
  slse_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(R), static_cast<const T*>(C),
      static_cast<const float*>(corr), static_cast<const int*>(ids),
      static_cast<const int*>(pos), static_cast<float*>(m_out),
      static_cast<float*>(s_out), B, k, dp, tiles_per_chunk);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* R, const void* C, const void* corr,
               const void* ids, const void* pos, const void* lse,
               const void* g, void* dC, void* dcorr, void* part, int B, int k,
               int dp, int tiles_per_chunk, int n_chunks,
               cudaStream_t stream) {
  const size_t smem = Layout<T>(dp, true).total;
  cudaError_t err = cudaFuncSetAttribute(
      slse_bwd_dc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(slse_bwd_dreps_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const T* r = static_cast<const T*>(R);
  const T* c = static_cast<const T*>(C);
  const float* co = static_cast<const float*>(corr);
  const int* id = static_cast<const int*>(ids);
  const int* po = static_cast<const int*>(pos);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  slse_bwd_dc_kernel<T><<<(k + TILE - 1) / TILE, THREADS, smem, stream>>>(
      r, c, co, id, po, ls, gg, static_cast<float*>(dC),
      static_cast<float*>(dcorr), B, k, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid((B + TILE - 1) / TILE, n_chunks);
  slse_bwd_dreps_kernel<T><<<grid, THREADS, smem, stream>>>(
      r, c, co, id, po, ls, gg, static_cast<float*>(part), B, k, dp,
      tiles_per_chunk);
  return int(cudaGetLastError());
}

}  // namespace

// R [B, dp] and C [k, dp] in the compute type (bf16 when `use_bf16` is nonzero,
// else fp32), dp % 32 == 0 and <= 256, rows 16-byte aligned; corr [k] fp32,
// ids [k] int32, pos [B] int32. K1 writes m_out / s_out [n_chunks, B];
// chunk c covers candidate tiles [c * tiles_per_chunk, ...) of 64. The
// Python wrapper checks every shape and type. Returns the cudaError_t.
extern "C" int sert_sampled_lse_fwd(const void* R, const void* C,
                                    const void* corr, const void* ids,
                                    const void* pos, void* m_out,
                                    void* s_out, int B, int k, int dp,
                                    int tiles_per_chunk, int n_chunks,
                                    int use_bf16, void* stream) {
  return use_bf16 ? launch_fwd<__nv_bfloat16>(
                    R, C, corr, ids, pos, m_out, s_out, B, k, dp,
                    tiles_per_chunk, n_chunks, cudaStream_t(stream))
              : launch_fwd<float>(R, C, corr, ids, pos, m_out, s_out, B, k,
                                  dp, tiles_per_chunk, n_chunks,
                                  cudaStream_t(stream));
}

// K2: as K1, plus lse [B] and g [B] fp32. Writes dC [ceil(k/64)*64, dp]
// fp32, dcorr [ceil(k/64)*64] fp32 and the dreps partials part
// [n_chunks, B, dp] fp32, which the caller sums over the chunk axis.
extern "C" int sert_sampled_lse_bwd(const void* R, const void* C,
                                    const void* corr, const void* ids,
                                    const void* pos, const void* lse,
                                    const void* g, void* dC, void* dcorr,
                                    void* part, int B, int k, int dp,
                                    int tiles_per_chunk, int n_chunks,
                                    int use_bf16, void* stream) {
  return use_bf16 ? launch_bwd<__nv_bfloat16>(
                    R, C, corr, ids, pos, lse, g, dC, dcorr, part, B, k, dp,
                    tiles_per_chunk, n_chunks, cudaStream_t(stream))
              : launch_bwd<float>(R, C, corr, ids, pos, lse, g, dC, dcorr,
                                  part, B, k, dp, tiles_per_chunk, n_chunks,
                                  cudaStream_t(stream));
}
