// K5 + K6 + K7: softmax cross-entropy over the whole entity axis, forward,
// backward, and backward with the optimizer applied, for sm_90a.
//
// Replaces the Pallas kernels of sert_tpu/ops/xent.py: _fwd_kernel :152
// (launched by _fwd_partials :270), _bwd_kernel :219 (launched by
// _bwd_calls :364) and _bwd_update_kernel :468 (launched by xent_bwd_apply
// :525). With z[b, j] = P[b] . W(j) + bias[j] over entities j < E
// (z = -1e30 past E):
//   K5: per (batch row, entity chunk) the running (max, sumexp) of z; the
//       caller merges the chunks into lse[b] and gathers the gold logit
//       itself (as the reference does outside its kernel);
//   K6: p = exp(z - lse[b]) - onehot(label[b]);  dW(j) = g * sum_b p P[b],
//       db = g * sum_b p,  dpooled partials = p W,  with p rounded to the
//       compute type before both products (the reference's cast points).
//       Rows past B and labels of -1 contribute nothing.
//   K7: K6's sweeps, but where K6 stores dW the update sweep applies adam,
//       adagrad or sgd to its own entity tile of W (and m, v or acc), in
//       place, from G = gscale * dW in fp32, so dW never reaches device
//       memory; it writes db (unscaled) and the tile's partial of
//       sum G^2 for the grad-norm metric.
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
// K7 does K6's three products and moves W, m and v once each way, instead
// of writing dW for a separate optimizer pass to read back beside W, m and
// v. At the reference's fused-step width (B = 1024, E = 500k, d = 256) the
// products are 0.79 TFLOP (0.8 ms at the bf16 peak) and adam's W, m, v in
// and out are 3.1 GB of fp32 (0.92 ms at 3.35 TB/s): the two bounds are
// close, bytes for adam and operations for adagrad and sgd. This first
// version recomputes z in its dpooled sweep as K6 does, and its update is
// elementwise in the epilogue of K6's dW sweep.
//
// Determinism: no float atomics. The dW / db sweep gives each entity tile
// one block that loops over all batch tiles in order; the dpooled sweep
// writes one partial per (entity chunk, batch row), which the caller sums
// in a fixed order. K7's sum of G^2 is one partial per entity tile, summed
// in the block in a fixed order.
//
// K7's order: the dpooled sweep reads W, so it is launched first, on the
// same stream; the update sweep's blocks read their own tile of W (and its
// slots) only, stage it before their batch loop, and write it after.

#include <math_constants.h>

#include "tile_mm.cuh"

namespace {

// Per-tile vectors: the entity tile's bias, the batch tile's labels and
// lse, and WARPS floats of scratch for a block sum.
struct XVecs {
  float* bias;
  int* lab;
  float* lse;
  float* red;
  __device__ explicit XVecs(unsigned char* base) {
    bias = reinterpret_cast<float*>(base);
    lab = reinterpret_cast<int*>(bias + TILE);
    lse = reinterpret_cast<float*>(lab + TILE);
    red = lse + TILE;
  }
};

// K7's optimizers, in the order of ops/xent.py's OPTIMIZERS; their
// constants are baked in as the reference bakes them (xent_bwd_apply :552).
enum Opt : int { ADAM = 0, ADAGRAD = 1, SGD = 2 };
// 1 - b1 and 1 - b2 are taken in double and rounded to fp32 once, as the
// reference's Python floats are (not 1.0f - 0.9f, which is 2.2e-8 off).
constexpr float B1 = 0.9f, B1C = 0.1f, B2 = 0.999f, B2C = 0.001f;
constexpr float ADAM_EPS = 1e-8f, ADAGRAD_EPS = 1e-7f;

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

// The dW sweep of K6 and K7, for the block's entity tile [j0, j0 + TILE):
// stage the tile of W once, then loop over every batch tile in order. On
// return (after a barrier) Acc holds the tile's unscaled sum_b p^T P,
// entity-major, and thread t < TILE has column t's sum_b p. W is not read
// after the staging, so K7 may overwrite the tile afterwards.
template <typename T, typename WT>
__device__ float dw_sweep(unsigned char* smem, const Layout<T>& L,
                          const T* __restrict__ P, const WT* W,
                          const float* __restrict__ bias,
                          const float* __restrict__ lse,
                          const int* __restrict__ lab, int B, int E, int d,
                          int dp, long long sj, long long sk, int j0) {
  T* Ps_in = reinterpret_cast<T*>(smem + L.r);
  T* Ws = reinterpret_cast<T*>(smem + L.c);
  float* Zs = reinterpret_cast<float*>(smem + L.z);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Acc = reinterpret_cast<float*>(smem + L.acc);
  XVecs v(smem + L.vec);

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
  return col_sum;
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
  const int j0 = blockIdx.x * TILE;
  const float col_sum = dw_sweep<T, WT>(smem, L, P, W, bias, lse, lab, B, E,
                                        d, dp, sj, sk, j0);
  const float* Acc = reinterpret_cast<const float*>(smem + L.acc);
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

// K7's update sweep: K6's dW sweep, whose epilogue applies the optimizer to
// the block's entity tile in place, elementwise in fp32 from W's stored
// value, in the reference's order (_bwd_update_kernel :501-522), with
// G = gscale * dW; s1, s2 are (m, v) for adam, (acc, -) for adagrad, unused
// for sgd, each shaped and typed as W. Writes db unscaled and the tile's
// sum of G^2 into gsq[tile].
template <typename T, typename WT>
__global__ void __launch_bounds__(THREADS)
xent_bwd_apply_kernel(const T* __restrict__ P, WT* W,
                      const float* __restrict__ bias,
                      const float* __restrict__ lse,
                      const int* __restrict__ lab, WT* s1, WT* s2,
                      float* __restrict__ db, float* __restrict__ gsq, int B,
                      int E, int d, int dp, long long sj, long long sk,
                      int opt, float lr, float gscale, float bc1, float bc2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(dp, true);
  const int j0 = blockIdx.x * TILE;
  const float col_sum = dw_sweep<T, WT>(smem, L, P, W, bias, lse, lab, B, E,
                                        d, dp, sj, sk, j0);
  const float* Acc = reinterpret_cast<const float*>(smem + L.acc);
  float sq = 0.0f;
  for (int i = threadIdx.x; i < TILE * dp; i += THREADS) {
    const int r = sk == 1 ? i / dp : i % TILE;
    const int k = sk == 1 ? i % dp : i / TILE;
    if (j0 + r >= E || k >= d) continue;
    const long long at = (j0 + r) * sj + k * sk;
    const float g = __fmul_rn(Acc[r * L.lda + k], gscale);
    sq = __fadd_rn(sq, __fmul_rn(g, g));
    float upd;
    if (opt == ADAM) {
      const float m2 = __fadd_rn(__fmul_rn(B1, to_f32(s1[at])),
                                 __fmul_rn(B1C, g));
      const float v2 = __fadd_rn(__fmul_rn(B2, to_f32(s2[at])),
                                 __fmul_rn(__fmul_rn(B2C, g), g));
      upd = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m2, bc1)),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), ADAM_EPS));
      s1[at] = from_f32<WT>(m2);
      s2[at] = from_f32<WT>(v2);
    } else if (opt == ADAGRAD) {
      const float a2 = __fadd_rn(to_f32(s1[at]), __fmul_rn(g, g));
      upd = __fmul_rn(__fmul_rn(lr, g),
                      a2 > 0.0f ? __frsqrt_rn(__fadd_rn(a2, ADAGRAD_EPS))
                                : 0.0f);
      s1[at] = from_f32<WT>(a2);
    } else {
      upd = __fmul_rn(lr, g);
    }
    W[at] = from_f32<WT>(__fsub_rn(to_f32(W[at]), upd));
  }
  // The tile's sum of G^2 in a fixed order: lanes, then warps in turn.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  XVecs v(smem + L.vec);
  if (threadIdx.x % 32 == 0) v.red[threadIdx.x / 32] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += v.red[w];
    gsq[blockIdx.x] = s;
  }
  if (threadIdx.x < TILE && j0 + threadIdx.x < E)
    db[j0 + threadIdx.x] = col_sum;
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

template <typename T, typename WT>
int launch_apply(const void* P, void* W, const void* bias, const void* lse,
                 const void* lab, void* s1, void* s2, void* db, void* part,
                 void* gsq, int B, int E, int d, int dp, long long sj,
                 long long sk, int tiles_per_chunk, int n_chunks, int opt,
                 float lr, float gscale, float bc1, float bc2,
                 cudaStream_t stream) {
  const size_t smem = Layout<T>(dp, true).total;
  cudaError_t err = allow_smem(xent_bwd_dp_kernel<T, WT>, smem);
  if (err != cudaSuccess) return int(err);
  err = allow_smem(xent_bwd_apply_kernel<T, WT>, smem);
  if (err != cudaSuccess) return int(err);
  const T* p = static_cast<const T*>(P);
  const float* b = static_cast<const float*>(bias);
  const float* ls = static_cast<const float*>(lse);
  const int* lb = static_cast<const int*>(lab);
  // The dpooled sweep first: it reads W, which the update sweep overwrites.
  const dim3 grid((B + TILE - 1) / TILE, n_chunks);
  xent_bwd_dp_kernel<T, WT><<<grid, THREADS, smem, stream>>>(
      p, static_cast<const WT*>(W), b, ls, lb, static_cast<float*>(part), B,
      E, d, dp, sj, sk, tiles_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  xent_bwd_apply_kernel<T, WT>
      <<<(E + TILE - 1) / TILE, THREADS, smem, stream>>>(
          p, static_cast<WT*>(W), b, ls, lb, static_cast<WT*>(s1),
          static_cast<WT*>(s2), static_cast<float*>(db),
          static_cast<float*>(gsq), B, E, d, dp, sj, sk, opt, lr, gscale,
          bc1, bc2);
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

// K7: as K6, with W updated in place instead of dW written. `opt` is 0
// adam (s1 = m, s2 = v), 1 adagrad (s1 = acc) or 2 sgd (no slots); the
// slots have W's shape, layout and storage type and are updated in place.
// lr is the constant learning rate, gscale the factor from the sum loss's
// dW to the update's gradient (1 / B for the mean loss), bc1 and bc2 adam's
// bias corrections 1 - 0.9^t and 1 - 0.999^t (fp32, t = count + 1).
// Writes db [E] unscaled, the unscaled dpooled partials part
// [n_chunks, B, dp] (summed by the caller) and gsq [ceil(E / 64)], each
// entity tile's sum of (gscale * dW)^2.
extern "C" int sert_xent_bwd_apply(const void* P, void* W, const void* bias,
                                   const void* lse, const void* lab,
                                   void* s1, void* s2, void* db, void* part,
                                   void* gsq, int B, int E, int d, int dp,
                                   long long sj, long long sk,
                                   int tiles_per_chunk, int n_chunks, int opt,
                                   float lr, float gscale, float bc1,
                                   float bc2, int use_bf16, int w_bf16,
                                   void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  auto go = [&](auto t, auto wt) {
    return launch_apply<decltype(t), decltype(wt)>(
        P, W, bias, lse, lab, s1, s2, db, part, gsq, B, E, d, dp, sj, sk,
        tiles_per_chunk, n_chunks, opt, lr, gscale, bc1, bc2, st);
  };
  if (use_bf16) return w_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.0f);
  return w_bf16 ? go(0.0f, bf16()) : go(0.0f, 0.0f);
}
