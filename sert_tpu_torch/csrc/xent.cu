// K5 + K6: softmax cross-entropy over the whole entity axis, forward and
// backward, for sm_90a.
//
// Replaces the Pallas kernels of sert_tpu/ops/xent.py: _fwd_kernel :152
// (launched by _fwd_partials :270) and _bwd_kernel :219 (launched by
// _bwd_calls :364). With z[b, j] = P[b] . W(j) + bias[j] over entities
// j < E (z = -1e30 past E):
//   K5: per (batch row, entity chunk) the running (max, sumexp) of z; the
//       caller merges the chunks into lse[b] and gathers the gold logit
//       itself (as the reference does outside its kernel);
//   K6: p = exp(z - lse[b]) - onehot(label[b]);  dW(j) = g * sum_b p P[b],
//       db = g * sum_b p,  dpooled partials = p W,  with p rounded to the
//       compute type before both products (the reference's cast points).
//       Rows past B and labels of -1 contribute nothing.
// The [B, E] logits never reach device memory: every block keeps one
// 64 x 64 tile of them in shared memory.
//
// W is read in its storage form, never copied, padded or transposed: its
// layout is "de" ([d, E], the log-linear proj_w: entities contiguous) or
// "ed" ([E, d], the LSE entity_emb: features contiguous), given as the
// strides (sj, sk) of W(j, k) = W[j * sj + k * sk]. Each entity tile is
// staged entity-major into shared memory, cast to the compute type on the
// way (fp32 master weights multiply as bf16 without a bf16 copy), with
// entities past E and features past d staged as zeros, so the tail tile
// needs no padding of W and its zero rows cannot leak 0 * NaN into
// dpooled. dW is written back in W's own layout and shape.
//
// What bounds it on the H100: at lse_full's flagship shape (B = 4096,
// E = 1M, d = 128) each product is 2 B E d = 1.07 TFLOP and a training
// step takes five (z in K5 and in each K6 sweep, then dW and dpooled),
// while W is 0.5 GB of fp32: arithmetic bounds it, and the recompute is the
// price of keeping 16 GB of fp32 logits out of device memory. At the
// log-linear recipes' widths (E of a few thousand, fp32 compute) the work
// is a few GFLOP a step on the CUDA cores. This first version uses the
// tile products of K1/K2 (tile_mm.cuh): wmma bf16 fragments into fp32, or
// fp32 on the CUDA cores; wgmma, TMA and pipelined loads are later work.
//
// Determinism: no float atomics. The dW / db sweep gives each entity tile
// one block that loops over all batch tiles in order; the dpooled sweep
// writes one partial per (entity chunk, batch row), which the caller sums
// in a fixed order.

#include <math_constants.h>

#include "tile_mm.cuh"

namespace {

// Per-tile vectors: the entity tile's bias, the batch tile's labels and
// lse.
struct XVecs {
  float* bias;
  int* lab;
  float* lse;
  __device__ explicit XVecs(unsigned char* base) {
    bias = reinterpret_cast<float*>(base);
    lab = reinterpret_cast<int*>(bias + TILE);
    lse = reinterpret_cast<float*>(lab + TILE);
  }
};

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f32(float x);
template <> __device__ inline float from_f32<float>(float x) { return x; }
template <> __device__ inline bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Stage entities [j0, j0 + TILE) of W as an entity-major [TILE, dp] tile of
// the compute type T (stride ld), and their biases; entities past E and
// features past d are zero. The loop order follows W's contiguous axis.
template <typename T, typename WT>
__device__ void stage_w(T* s, int ld, XVecs v, const WT* __restrict__ W,
                        const float* __restrict__ bias, int j0, int E, int d,
                        int dp, long long sj, long long sk) {
  for (int i = threadIdx.x; i < TILE * dp; i += THREADS) {
    const int r = sk == 1 ? i / dp : i % TILE;
    const int k = sk == 1 ? i % dp : i / TILE;
    float x = 0.0f;
    if (j0 + r < E && k < d) x = to_f32(W[(j0 + r) * sj + k * sk]);
    s[r * ld + k] = from_f32<T>(x);
  }
  if (threadIdx.x < TILE)
    v.bias[threadIdx.x] = j0 + threadIdx.x < E ? bias[j0 + threadIdx.x] : 0.0f;
}

__device__ void stage_rows(XVecs v, const float* __restrict__ lse,
                           const int* __restrict__ lab, int b0, int B) {
  const int t = threadIdx.x;
  if (t < TILE) {
    const bool in = b0 + t < B;
    v.lse[t] = in ? lse[b0 + t] : 0.0f;
    v.lab[t] = in ? lab[b0 + t] : -1;
  }
}

// Overwrite the logits tile Zs with p = exp(z - lse) - onehot (0 for rows
// past B and entities past E) in fp32 and, for bf16, write p rounded to bf16
// into Ps.
template <typename T>
__device__ void xent_probs(float* Zs, bf16* Ps, XVecs v, int b0, int B,
                           int j0, int E) {
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    float p = 0.0f;
    if (b0 + r < B && j0 + c < E) {
      p = expf(Zs[r * LDZ + c] + v.bias[c] - v.lse[r]);
      if (v.lab[r] == j0 + c) p -= 1.0f;
    }
    Zs[r * LDZ + c] = p;
    if constexpr (sizeof(T) == 2) Ps[r * LDP + c] = __float2bfloat16(p);
  }
}

// K5: grid (batch tiles, entity chunks). Each block keeps the running
// (max, sumexp) of its 64 rows over its chunk's entity tiles.
template <typename T, typename WT>
__global__ void __launch_bounds__(THREADS)
xent_fwd_kernel(const T* __restrict__ P, const WT* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ m_out,
                float* __restrict__ s_out, int B, int E, int d, int dp,
                long long sj, long long sk, int tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(dp, false);
  T* Ps_in = reinterpret_cast<T*>(smem + L.r);
  T* Ws = reinterpret_cast<T*>(smem + L.c);
  float* Zs = reinterpret_cast<float*>(smem + L.z);
  XVecs v(smem + L.vec);

  const int b0 = blockIdx.x * TILE;
  const int chunk = blockIdx.y;
  const int n_tiles = (E + TILE - 1) / TILE;
  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, n_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int ROWS = TILE / WARPS;   // rows per warp

  stage(Ps_in, L.ldt, P, b0, B, dp);
  float m_run[ROWS], s_run[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_run[i] = -CUDART_INF_F;
    s_run[i] = 0.0f;
  }

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * TILE;
    __syncthreads();              // the previous tile is fully read
    stage_w(Ws, L.ldt, v, W, bias, j0, E, d, dp, sj, sk);
    __syncthreads();
    block_mm<false, true>(Ps_in, L.ldt, Ws, L.ldt, Zs, LDZ, TILE, dp, false);
    __syncthreads();
    online_lse(
        Zs, m_run, s_run, [&](int c) { return v.bias[c]; },
        [&](int, int c) { return j0 + c < E; });
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

// K6, first sweep: one block per entity tile, looping over every batch tile
// in order: dW(tile) = g * sum_b p^T P and db(tile) = g * sum_b p, written
// in W's layout.
template <typename T, typename WT>
__global__ void __launch_bounds__(THREADS)
xent_bwd_dw_kernel(const T* __restrict__ P, const WT* __restrict__ W,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse, const int* __restrict__ lab,
                   const float* __restrict__ g, float* __restrict__ dW,
                   float* __restrict__ db, int B, int E, int d, int dp,
                   long long sj, long long sk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(dp, true);
  T* Ps_in = reinterpret_cast<T*>(smem + L.r);
  T* Ws = reinterpret_cast<T*>(smem + L.c);
  float* Zs = reinterpret_cast<float*>(smem + L.z);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Acc = reinterpret_cast<float*>(smem + L.acc);
  XVecs v(smem + L.vec);

  const int j0 = blockIdx.x * TILE;
  const int n_btiles = (B + TILE - 1) / TILE;
  stage_w(Ws, L.ldt, v, W, bias, j0, E, d, dp, sj, sk);
  float col_sum = 0.0f;                 // thread t < 64: column t of db

  for (int bt = 0; bt < n_btiles; ++bt) {
    const int b0 = bt * TILE;
    __syncthreads();
    stage(Ps_in, L.ldt, P, b0, B, dp);
    stage_rows(v, lse, lab, b0, B);
    __syncthreads();
    block_mm<false, true>(Ps_in, L.ldt, Ws, L.ldt, Zs, LDZ, TILE, dp, false);
    __syncthreads();
    xent_probs<T>(Zs, Ps, v, b0, B, j0, E);
    __syncthreads();
    if (threadIdx.x < TILE)
      for (int r = 0; r < TILE; ++r) col_sum += Zs[r * LDZ + threadIdx.x];
    block_mm<true, false>(p_tile<T>(Zs, Ps), p_ld<T>(), Ps_in, L.ldt, Acc,
                          L.lda, dp, TILE, bt > 0);
  }
  __syncthreads();
  const float gs = *g;
  for (int i = threadIdx.x; i < TILE * dp; i += THREADS) {
    const int r = sk == 1 ? i / dp : i % TILE;
    const int k = sk == 1 ? i % dp : i / TILE;
    if (j0 + r < E && k < d)
      dW[(j0 + r) * sj + k * sk] = gs * Acc[r * L.lda + k];
  }
  if (threadIdx.x < TILE && j0 + threadIdx.x < E)
    db[j0 + threadIdx.x] = gs * col_sum;
}

// K6, second sweep: grid (batch tiles, entity chunks); each block writes
// its rows' partial dpooled = p W over the chunk's entity tiles (unscaled).
template <typename T, typename WT>
__global__ void __launch_bounds__(THREADS)
xent_bwd_dp_kernel(const T* __restrict__ P, const WT* __restrict__ W,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse, const int* __restrict__ lab,
                   float* __restrict__ part, int B, int E, int d, int dp,
                   long long sj, long long sk, int tiles_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(dp, true);
  T* Ps_in = reinterpret_cast<T*>(smem + L.r);
  T* Ws = reinterpret_cast<T*>(smem + L.c);
  float* Zs = reinterpret_cast<float*>(smem + L.z);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Acc = reinterpret_cast<float*>(smem + L.acc);
  XVecs v(smem + L.vec);

  const int b0 = blockIdx.x * TILE;
  const int chunk = blockIdx.y;
  const int n_tiles = (E + TILE - 1) / TILE;
  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, n_tiles);
  stage(Ps_in, L.ldt, P, b0, B, dp);
  stage_rows(v, lse, lab, b0, B);

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * TILE;
    __syncthreads();
    stage_w(Ws, L.ldt, v, W, bias, j0, E, d, dp, sj, sk);  // zero past E
    __syncthreads();
    block_mm<false, true>(Ps_in, L.ldt, Ws, L.ldt, Zs, LDZ, TILE, dp, false);
    __syncthreads();
    xent_probs<T>(Zs, Ps, v, b0, B, j0, E);
    __syncthreads();
    block_mm<false, false>(p_tile<T>(Zs, Ps), p_ld<T>(), Ws, L.ldt, Acc,
                           L.lda, dp, TILE, t > t0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * dp; i += THREADS) {
    const int r = i / dp, c = i % dp;
    if (b0 + r < B)
      part[(size_t(chunk) * B + b0 + r) * dp + c] = Acc[r * L.lda + c];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, typename WT>
int launch_fwd(const void* P, const void* W, const void* bias, void* m_out,
               void* s_out, int B, int E, int d, int dp, long long sj,
               long long sk, int tiles_per_chunk, int n_chunks,
               cudaStream_t stream) {
  const size_t smem = Layout<T>(dp, false).total;
  cudaError_t err = allow_smem(xent_fwd_kernel<T, WT>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((B + TILE - 1) / TILE, n_chunks);
  xent_fwd_kernel<T, WT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(P), static_cast<const WT*>(W),
      static_cast<const float*>(bias), static_cast<float*>(m_out),
      static_cast<float*>(s_out), B, E, d, dp, sj, sk, tiles_per_chunk);
  return int(cudaGetLastError());
}

template <typename T, typename WT>
int launch_bwd(const void* P, const void* W, const void* bias,
               const void* lse, const void* lab, const void* g, void* dW,
               void* db, void* part, int B, int E, int d, int dp,
               long long sj, long long sk, int tiles_per_chunk, int n_chunks,
               cudaStream_t stream) {
  const size_t smem = Layout<T>(dp, true).total;
  cudaError_t err = allow_smem(xent_bwd_dw_kernel<T, WT>, smem);
  if (err != cudaSuccess) return int(err);
  err = allow_smem(xent_bwd_dp_kernel<T, WT>, smem);
  if (err != cudaSuccess) return int(err);
  const T* p = static_cast<const T*>(P);
  const WT* w = static_cast<const WT*>(W);
  const float* b = static_cast<const float*>(bias);
  const float* ls = static_cast<const float*>(lse);
  const int* lb = static_cast<const int*>(lab);
  xent_bwd_dw_kernel<T, WT><<<(E + TILE - 1) / TILE, THREADS, smem, stream>>>(
      p, w, b, ls, lb, static_cast<const float*>(g), static_cast<float*>(dW),
      static_cast<float*>(db), B, E, d, dp, sj, sk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid((B + TILE - 1) / TILE, n_chunks);
  xent_bwd_dp_kernel<T, WT><<<grid, THREADS, smem, stream>>>(
      p, w, b, ls, lb, static_cast<float*>(part), B, E, d, dp, sj, sk,
      tiles_per_chunk);
  return int(cudaGetLastError());
}

}  // namespace

// P [B, dp] in the compute type (bf16 when `use_bf16` is nonzero, else
// fp32), dp % 32 == 0 and <= 256, rows 16-byte aligned; W in its storage
// type (bf16 when `w_bf16` is nonzero, else fp32) with W(j, k) at
// W[j * sj + k * sk] for entities j < E and features k < d; bias [E] fp32.
// K5 writes m_out / s_out [n_chunks, B]; chunk c covers entity tiles
// [c * tiles_per_chunk, ...) of 64. The Python wrapper checks every shape
// and type. Returns the cudaError_t.
extern "C" int sert_xent_fwd(const void* P, const void* W, const void* bias,
                             void* m_out, void* s_out, int B, int E, int d,
                             int dp, long long sj, long long sk,
                             int tiles_per_chunk, int n_chunks, int use_bf16,
                             int w_bf16, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  if (use_bf16)
    return w_bf16 ? launch_fwd<bf16, bf16>(P, W, bias, m_out, s_out, B, E, d,
                                           dp, sj, sk, tiles_per_chunk,
                                           n_chunks, st)
                  : launch_fwd<bf16, float>(P, W, bias, m_out, s_out, B, E, d,
                                            dp, sj, sk, tiles_per_chunk,
                                            n_chunks, st);
  return w_bf16 ? launch_fwd<float, bf16>(P, W, bias, m_out, s_out, B, E, d,
                                          dp, sj, sk, tiles_per_chunk,
                                          n_chunks, st)
                : launch_fwd<float, float>(P, W, bias, m_out, s_out, B, E, d,
                                           dp, sj, sk, tiles_per_chunk,
                                           n_chunks, st);
}

// K6: as K5, plus lse [B] fp32, labels [B] int32 (-1: no gold entity) and
// g, one fp32 scalar on the device. Writes dW fp32 with W's shape and
// strides, db [E] fp32 (both scaled by g) and the unscaled dpooled partials
// part [n_chunks, B, dp] fp32, which the caller sums over the chunk axis.
extern "C" int sert_xent_bwd(const void* P, const void* W, const void* bias,
                             const void* lse, const void* lab, const void* g,
                             void* dW, void* db, void* part, int B, int E,
                             int d, int dp, long long sj, long long sk,
                             int tiles_per_chunk, int n_chunks, int use_bf16,
                             int w_bf16, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  if (use_bf16)
    return w_bf16 ? launch_bwd<bf16, bf16>(P, W, bias, lse, lab, g, dW, db,
                                           part, B, E, d, dp, sj, sk,
                                           tiles_per_chunk, n_chunks, st)
                  : launch_bwd<bf16, float>(P, W, bias, lse, lab, g, dW, db,
                                            part, B, E, d, dp, sj, sk,
                                            tiles_per_chunk, n_chunks, st);
  return w_bf16 ? launch_bwd<float, bf16>(P, W, bias, lse, lab, g, dW, db,
                                          part, B, E, d, dp, sj, sk,
                                          tiles_per_chunk, n_chunks, st)
                : launch_bwd<float, float>(P, W, bias, lse, lab, g, dW, db,
                                           part, B, E, d, dp, sj, sk,
                                           tiles_per_chunk, n_chunks, st);
}
