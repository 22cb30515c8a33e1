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
// is a few GFLOP a step. K5 and K7 use the tile products of K1/K2
// (tile_mm.cuh): wmma bf16 fragments into fp32, or fp32 on the CUDA cores.
// K6 has its own sweeps (xent6_sweep_kernel below): register accumulators,
// fp32 products on the tensor cores as 3xTF32, and staging that overlaps
// the products. wgmma, TMA and one merged sweep are later work.
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
// Determinism: no float atomics. K7's dW / db sweep gives each entity tile
// one block that loops over all batch tiles in order; K6's splits the batch
// tiles into slices by a plan that depends on the shapes alone
// (ops/xent.py _dw_splits), each block looping over its slice in order,
// and a second kernel sums the slices in slice order. The dpooled sweeps
// write one partial per (entity chunk, batch row), which the caller sums
// in a fixed order. K7's sum of G^2 is one partial per entity tile, summed
// in the block in a fixed order.
//
// K7's order: the dpooled sweep reads W, so it is launched first, on the
// same stream; the update sweep's blocks read their own tile of W (and its
// slots) only, stage it before their batch loop, and write it after.

#include <math_constants.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "mma_sync.cuh"
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

// ---- K6 on the tensor cores ----------------------------------------------
// Both of K6's sweeps are xent6_sweep_kernel. A block keeps a "resident"
// [64, dp] tile X of one operand in shared memory and streams the [64, dp]
// tiles Y of the other through a ring of NST [64, CH] feature chunks, each
// tile's chunks twice:
//   z[x][y] = X[x] . Y[y]               chunk by chunk, in registers;
//   p = exp(z - lse) - onehot           in shared memory (fp32, and bf16);
//   acc[x][:] += sum_y p[x][y] Y[y][:]  chunk by chunk, in registers.
// The dW sweep (DW): X is entity tile t of W (cast on the way in), Y the
// batch tiles of slice s of P, which cp.async streams NST - 1 chunks ahead
// of use, with each tile's lse and labels; acc = sum_b p^T P and
// db = sum_b p. The dpooled sweep: X is a batch tile of P (by cp.async), Y
// the entity tiles of one entity chunk of W, each chunk loaded into
// registers one step ahead (16 bytes a load where W's rows allow) and cast
// while stored (cp.async copies bytes unchanged, and W may be fp32
// multiplied as bf16); acc = sum_e p W.
// fp32 products run on the tensor cores as 3xTF32: x = hi + lo with hi and
// lo TF32, and a.b = lo.hi + hi.lo + hi.hi summed in fp32 (the dropped lo.lo
// term is ~2^-22 of a product), which keeps fp32's accuracy class; bf16
// products take one bf16 pass; both through mma.sync, with fragments read
// from shared memory by plain loads (wmma's tf32 loads went through
// generic addressing). Each warp owns 16 rows of X: four 16 x 8 tiles of z
// and, in every chunk, CH / 16 16 x 8 tiles of acc (64 registers of acc at
// dp = 256).
// What bounds it: at the log-linear widths (cerc: B 1024, E 3500, d 256,
// fp32) the three products are 5.5 GFLOP, 33 us as 3xTF32 at the tensor
// cores' peak; between two barriers a warp does a few fragment products,
// each fp32 operand element split in four integer operations and one
// subtraction, so issue slots, load latency and the barriers, not the
// tensor cores, set its time (PERF.md). At E = 1M bf16 the same holds with
// 256 blocks of ~1.5k steps each, and W is read once for z and once for
// acc by each of the 64 batch tiles.
template <typename T>
constexpr int CHUNK = sizeof(T) == 4 ? 32 : 64;
constexpr int NACC = 256 / 16;       // 16 x 8 acc tiles a warp holds, dp 256
constexpr int NST = 3;               // ring stages
constexpr int AHEAD = NST - 1;       // cp.async chunks in flight ahead of use

// Row strides of the resident tile (always the widest dp the kernels
// take) and of a ring stage, as constants so that every fragment address
// folds into an offset from a per-warp base: 16 bytes of padding keep
// fragment pointers 32-byte aligned and the rows off each other's banks.
template <typename T>
constexpr int LD_X = 256 + 16 / int(sizeof(T));
template <typename T>
constexpr int LD_Y = CHUNK<T> + 16 / int(sizeof(T));

// Byte offsets of a sweep block's shared memory: the resident tile, the
// ring, the fp32 z / p tile, the bf16 p tile (bf16 only) and seven vectors
// of TILE 4-byte entries. fp32: 113 KB, two blocks an SM.
template <typename T>
struct SweepLayout {
  static constexpr size_t stage =
      (size_t(TILE) * LD_Y<T> * sizeof(T) + 127) / 128 * 128;
  static constexpr size_t ring =
      (size_t(TILE) * LD_X<T> * sizeof(T) + 127) / 128 * 128;
  static constexpr size_t z = ring + NST * stage;
  static constexpr size_t p =
      (z + size_t(TILE) * LDZ * sizeof(float) + 127) / 128 * 128;
  static constexpr size_t vec =
      (p + (sizeof(T) == 2 ? size_t(TILE) * LDP * sizeof(bf16) : 0) + 127) /
      128 * 128;
  static constexpr size_t total = vec + 7 * TILE * sizeof(float);
};

// A position in a sweep's stream of Y chunks: ring stage, Y tile of the
// block, chunk, pass (0: z, 1: acc).
struct StreamPos {
  int st = 0, ti = 0, c = 0, pass = 0;
  __device__ void next(int nch) {
    if (++st == NST) st = 0;
    if (++c == nch) {
      c = 0;
      if (++pass == 2) {
        pass = 0;
        ++ti;
      }
    }
  }
};

// One of K6's sweeps (DW: the dW sweep). Grid: DW (entity tiles, slices of
// `per` batch tiles), else (batch tiles, chunks of `per` entity tiles).
// DW writes, with one slice, dW = g * acc in W's layout and db = g * sum p
// into `out` and `db`; with S slices its unscaled partials into slice s of
// `out` ([S, Ep, dp] in W's layout, Ep = entity tiles * 64, then the db
// partials [S, Ep]). The dpooled sweep writes its unscaled partial into
// `out` [chunks, Bp, dp] (Bp = batch tiles * 64).
template <typename T, typename WT, bool DW>
__global__ void __launch_bounds__(THREADS, 2)
xent6_sweep_kernel(const T* __restrict__ P, const WT* __restrict__ W,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse, const int* __restrict__ lab,
                   const float* __restrict__ g, float* __restrict__ out,
                   float* __restrict__ db, int B, int E, int d, int dp,
                   long long sj, long long sk, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = SweepLayout<T>;
  constexpr int LDX = LD_X<T>, LDY = LD_Y<T>;
  T* X = reinterpret_cast<T*>(smem);
  float* Z = reinterpret_cast<float*>(smem + L::z);
  bf16* Pb = reinterpret_cast<bf16*>(smem + L::p);
  float* rv = reinterpret_cast<float*>(smem + L::vec);  // X's bias or lse
  int* rl = reinterpret_cast<int*>(rv + TILE);          // X's labels
  float* sv = rv + 2 * TILE;       // Y's lse or bias, by tile parity
  int* sl = reinterpret_cast<int*>(sv + 2 * TILE);      // Y's labels, same
  float* dbacc = sv + 4 * TILE;    // DW: the entity tile's sum_b p
  auto ring = [&](int st) {
    return reinterpret_cast<T*>(smem + L::ring + st * L::stage);
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp / 2, half = warp % 2;
  const int x0 = blockIdx.x * TILE;
  const int n_y = DW ? (B + TILE - 1) / TILE : (E + TILE - 1) / TILE;
  const int y_first = blockIdx.y * per;
  const int n_tiles = min(per, n_y - y_first);
  constexpr int CH = CHUNK<T>, NCH = 256 / CH, FPC = CH / 32;
  const int nch = dp / CH;

  // The stream is each Y tile's chunks in order for z, then again for acc.
  // fetch() starts the load at its cursor (cp.async into its stage; W:
  // global loads into registers), put() finishes the W load at its own
  // (registers, cast, into its stage), and each step reads the stage at a
  // third, all three in stream order. W is read 16
  // bytes (VW elements) a load along its contiguous axis where that axis
  // is a whole number of such pieces, else an element a load.
  constexpr int WPT = TILE * CH / THREADS;   // W elements a thread loads
  constexpr int VW = 16 / sizeof(WT);
  constexpr int NV = TILE * CH / VW / THREADS;   // 16-byte loads a thread
  const bool wvec = (sk == 1 ? d : E) % VW == 0 &&
                    reinterpret_cast<uintptr_t>(W) % 16 == 0;
  float wreg[WPT];
  uint4* wv = reinterpret_cast<uint4*>(wreg);
  float wbias = 0.0f;
  // The v-th 16-byte piece of a thread: (entity row, feature) of its first
  // element, the next VW elements along W's contiguous axis.
  auto piece = [&](int v, int& r, int& k) {
    const int q = tid + v * THREADS;
    if (sk == 1) {
      r = q / (CH / VW);
      k = (q % (CH / VW)) * VW;
    } else {
      k = q / (TILE / VW);
      r = (q % (TILE / VW)) * VW;
    }
  };
  StreamPos at_fetch, at_put;
  int at_read = 0;                 // the stage the next step reads
  auto fetch = [&]() {
    const bool live = at_fetch.ti < n_tiles;
    const int ti = at_fetch.ti, c = at_fetch.c;
    const bool first = at_fetch.pass == 0 && c == 0;
    const int y0 = (y_first + ti) * TILE;
    T* dst = ring(at_fetch.st);
    at_fetch.next(nch);
    if constexpr (DW) {
      if (live) {
        constexpr int V = 16 / sizeof(T), VPR = CH / V;
        for (int q = tid; q < TILE * VPR; q += THREADS) {
          const int r = q / VPR, col = (q % VPR) * V;
          const bool in = y0 + r < B;
          cp_async16(dst + r * LDY + col,
                     P + size_t(in ? y0 + r : 0) * dp + c * CH + col, in);
        }
        if (first && tid < 2 * TILE) {
          const int r = tid % TILE, buf = (ti & 1) * TILE;
          const bool in = y0 + r < B;
          if (tid < TILE)
            cp_async4(sv + buf + r, lse + (in ? y0 + r : 0), in);
          else
            cp_async4(sl + buf + r, lab + (in ? y0 + r : 0), in);
        }
      }
      cp_commit();               // one group a step, empty past the end
    } else if (live) {
      if (wvec) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          int r, k;
          piece(v, r, k);
          k += c * CH;
          wv[v] = y0 + r < E && k < d
                      ? __ldg(reinterpret_cast<const uint4*>(
                            W + (y0 + r) * sj + k * sk))
                      : make_uint4(0, 0, 0, 0);
        }
      } else {
#pragma unroll
        for (int q = 0; q < WPT; ++q) {
          const int e = tid + q * THREADS;
          const int r = sk == 1 ? e / CH : e % TILE;
          const int k = c * CH + (sk == 1 ? e % CH : e / TILE);
          wreg[q] = y0 + r < E && k < d
                        ? to_f32(W[(y0 + r) * sj + k * sk]) : 0.0f;
        }
      }
      if (first && tid < TILE)
        wbias = y0 + tid < E ? bias[y0 + tid] : 0.0f;
    }
  };
  auto put = [&]() {
    const StreamPos at = at_put;
    at_put.next(nch);
    if (at.ti >= n_tiles) return;
    T* dst = ring(at.st);
    if (wvec) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        int r, k;
        piece(v, r, k);
        const WT* w = reinterpret_cast<const WT*>(&wv[v]);
#pragma unroll
        for (int u = 0; u < VW; ++u)
          dst[(sk == 1 ? r : r + u) * LDY + (sk == 1 ? k + u : k)] =
              from_f32<T>(to_f32(w[u]));
      }
    } else {
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const int e = tid + q * THREADS;
        const int r = sk == 1 ? e / CH : e % TILE;
        const int k = sk == 1 ? e % CH : e / TILE;
        dst[r * LDY + k] = from_f32<T>(wreg[q]);
      }
    }
    if (at.pass == 0 && at.c == 0 && tid < TILE)
      sv[(at.ti & 1) * TILE + tid] = wbias;
  };
  // A step begins once its load is in its stage for every thread; the
  // stage the next load overwrites was last read a step or more before.
  // Returns the stage it reads.
  auto begin = [&]() {
    if constexpr (DW) {
      cp_wait<AHEAD - 1>();
      __syncthreads();
    } else {
      __syncthreads();
    }
    fetch();
    const T* Y = ring(at_read);
    if (++at_read == NST) at_read = 0;
    return Y;
  };
  auto end = [&]() {
    if constexpr (!DW) put();
  };
  // The resident tile and its vectors, staged while the first loads of
  // the stream are in flight: W's tile through registers, RES loads a
  // thread in flight, cast on the way; P's tile by cp.async.
  if constexpr (DW) {
    for (int i = 0; i < AHEAD; ++i) fetch();
    constexpr int RES = 16;
    for (int i0 = tid; i0 < TILE * dp; i0 += RES * THREADS) {
      float v[RES];
#pragma unroll
      for (int u = 0; u < RES; ++u) {
        const int i = i0 + u * THREADS;
        const int r = sk == 1 ? i / dp : i % TILE;
        const int k = sk == 1 ? i % dp : i / TILE;
        v[u] = i < TILE * dp && x0 + r < E && k < d
                   ? to_f32(W[(x0 + r) * sj + k * sk]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < RES; ++u) {
        const int i = i0 + u * THREADS;
        const int r = sk == 1 ? i / dp : i % TILE;
        const int k = sk == 1 ? i % dp : i / TILE;
        if (i < TILE * dp) X[r * LDX + k] = from_f32<T>(v[u]);
      }
    }
    if (tid < TILE) {
      rv[tid] = x0 + tid < E ? bias[x0 + tid] : 0.0f;
      dbacc[tid] = 0.0f;
    }
  } else {
    constexpr int V = 16 / sizeof(T);
    const int vpr = dp / V;
    for (int q = tid; q < TILE * vpr; q += THREADS) {
      const int r = q / vpr, col = (q % vpr) * V;
      const bool in = x0 + r < B;
      cp_async16(X + r * LDX + col, P + size_t(in ? x0 + r : 0) * dp + col,
                 in);
    }
    cp_commit();
    if (tid < TILE) {
      const bool in = x0 + tid < B;
      rv[tid] = in ? lse[x0 + tid] : 0.0f;
      rl[tid] = in ? lab[x0 + tid] : -1;
    }
    fetch();
    put();
    cp_wait<0>();
  }

  constexpr int KS = KSTEP<T>;
  const T* pt = reinterpret_cast<const T*>(
      smem + (sizeof(T) == 2 ? L::p : L::z));
  constexpr int LDPT = sizeof(T) == 2 ? LDP : LDZ;
  // ac[c * 2 FPC + j]: rows 16 mt.., features c CH + 16 FPC half + 8 j..;
  // zc[j]: rows 16 mt.., columns 32 half + 8 j.. of z.
  Acc8 ac[NACC], zc[4];
  auto feature = [&](int a) {     // the first feature of ac[a]
    return a / (2 * FPC) * CH + 16 * FPC * half + 8 * (a % (2 * FPC));
  };
#pragma unroll
  for (int a = 0; a < NACC; ++a) ac[a] = Acc8{{0.0f, 0.0f, 0.0f, 0.0f}};

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int y0 = (y_first + ti) * TILE;
#pragma unroll
    for (int j = 0; j < 4; ++j) zc[j] = Acc8{{0.0f, 0.0f, 0.0f, 0.0f}};
    for (int c = 0; c < nch; ++c) {           // z = X . Y^T
      const T* Y = begin() + 32 * half * LDY;
      const T* xa = X + 16 * mt * LDX + c * CH;
#pragma unroll
      for (int kk = 0; kk < CH; kk += KS) {
        FragA<T> a;
        load_a(a, xa + kk, LDX);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB<T> b;
          load_b_nk(b, Y + 8 * j * LDY + kk, LDY);
          tc_mma(zc[j], a, b);
        }
      }
      end();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_c(Z + 16 * mt * LDZ + 32 * half + 8 * j, LDZ, zc[j]);
    __syncthreads();
    // p = exp(z - lse) - onehot, 0 past B and E; warp w owns rows 8w..8w+7.
    const int buf = (ti & 1) * TILE;
#pragma unroll
    for (int rr = 0; rr < TILE / WARPS; ++rr) {
      const int x = warp * (TILE / WARPS) + rr;
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = lane + 32 * h;
        const int b = DW ? y0 + y : x0 + x, e = DW ? x0 + x : y0 + y;
        float p = 0.0f;
        if (b < B && e < E) {
          p = expf(Z[x * LDZ + y] + (DW ? rv[x] : sv[buf + y]) -
                   (DW ? sv[buf + y] : rv[x]));
          if ((DW ? sl[buf + y] : rl[x]) == e) p -= 1.0f;
        }
        Z[x * LDZ + y] = p;
        if constexpr (sizeof(T) == 2) Pb[x * LDP + y] = __float2bfloat16(p);
        sum += p;
      }
      if constexpr (DW) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) dbacc[x] += sum;
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {           // acc += p . Y
      if (c < nch) {
        const T* Y = begin();                 // its barrier publishes p
#pragma unroll
        for (int kk = 0; kk < TILE; kk += KS) {
          FragA<T> a;
          load_a(a, pt + 16 * mt * LDPT + kk, LDPT);
#pragma unroll
          for (int j = 0; j < 2 * FPC; ++j) {
            FragB<T> b;
            load_b_kn(b, Y + kk * LDY + 16 * FPC * half + 8 * j, LDY);
            tc_mma(ac[2 * FPC * c + j], a, b);
          }
        }
        end();
      }
    }
  }

  if constexpr (DW) {
    const int S = gridDim.y, Ep = gridDim.x * TILE;
    if (S == 1) {               // dW = g * acc in W's layout, through Z
      const float gs = *g;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (c < nch) {
          __syncthreads();
#pragma unroll
          for (int j = 0; j < 2 * FPC; ++j)
            store_c(Z + 16 * mt * LDZ + 16 * FPC * half + 8 * j, LDZ,
                    ac[2 * FPC * c + j]);
          __syncthreads();
          for (int i = tid; i < TILE * CH; i += THREADS) {
            const int r = sk == 1 ? i / CH : i % TILE;
            const int k = sk == 1 ? i % CH : i / TILE;
            if (x0 + r < E && c * CH + k < d)
              out[(x0 + r) * sj + (c * CH + k) * sk] = gs * Z[r * LDZ + k];
          }
        }
      }
      if (tid < TILE && x0 + tid < E) db[x0 + tid] = gs * dbacc[tid];
    } else {                    // slice s's partials, unscaled
      float* part = out + size_t(blockIdx.y) * Ep * dp;
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int f = feature(a);
        if (f < dp) {
          if (sk == 1)
            store_c(part + size_t(x0 + 16 * mt) * dp + f, dp, ac[a]);
          else
            store_c_t(part + size_t(f) * Ep + x0 + 16 * mt, Ep, ac[a]);
        }
      }
      if (tid < TILE)
        out[size_t(S) * Ep * dp + size_t(blockIdx.y) * Ep + x0 + tid] =
            dbacc[tid];
    }
  } else {
    const size_t Bp = size_t(gridDim.x) * TILE;
    float* part = out + (blockIdx.y * Bp + x0 + 16 * mt) * dp;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const int f = feature(a);
      if (f < dp) store_c(part + f, dp, ac[a]);
    }
  }
}

// K6's reduce of S > 1 slices: dW = g * sum_s scratch[s] in W's layout and
// db = g * sum_s (db partial s), each summed in slice order (no atomics, so
// two calls give the same bits). Elementwise along W's contiguous axis.
__global__ void __launch_bounds__(THREADS)
xent6_reduce_kernel(const float* __restrict__ scratch,
                    const float* __restrict__ g, float* __restrict__ dW,
                    float* __restrict__ db, int E, int d, int dp,
                    long long sk, int S) {
  const int Ep = (E + TILE - 1) / TILE * TILE;
  const size_t slice = size_t(Ep) * dp, n = size_t(E) * d;
  const float gs = *g;
  for (size_t i = size_t(blockIdx.x) * THREADS + threadIdx.x; i < n + E;
       i += size_t(gridDim.x) * THREADS) {
    const float* src;
    size_t stride;
    if (i < n) {                      // W's flat index: [E, d] or [d, E]
      const size_t j = sk == 1 ? i / d : i % E;
      const size_t k = sk == 1 ? i % d : i / E;
      src = scratch + (sk == 1 ? j * dp + k : k * Ep + j);
      stride = slice;
    } else {
      src = scratch + S * slice + (i - n);
      stride = Ep;
    }
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += src[s * stride];
    if (i < n) dW[i] = gs * acc;
    else db[i - n] = gs * acc;
  }
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

// K6's launches: the dW sweep, the ordered reduce of its slices (S > 1),
// then the dpooled sweep. Each sweep asks for the shared-memory carveout
// that holds two of its blocks an SM.
template <typename T, typename WT>
int launch_bwd(const void* P, const void* W, const void* bias,
               const void* lse, const void* lab, const void* g, void* dW,
               void* db, void* part, void* scratch, int B, int E, int d,
               int dp, long long sj, long long sk, int tiles_per_chunk,
               int n_chunks, int btiles_per_slice, int n_slices,
               cudaStream_t stream) {
  const size_t smem = SweepLayout<T>::total;
  auto dw_k = xent6_sweep_kernel<T, WT, true>;
  auto dp_k = xent6_sweep_kernel<T, WT, false>;
  for (auto k : {dw_k, dp_k}) {
    cudaError_t err = allow_smem(k, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributePreferredSharedMemoryCarveout,
          int(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return int(err);
  }
  const T* p = static_cast<const T*>(P);
  const WT* w = static_cast<const WT*>(W);
  const float* b = static_cast<const float*>(bias);
  const float* ls = static_cast<const float*>(lse);
  const int* lb = static_cast<const int*>(lab);
  const float* gp = static_cast<const float*>(g);
  const int n_etiles = (E + TILE - 1) / TILE;
  dw_k<<<dim3(n_etiles, n_slices), THREADS, smem, stream>>>(
      p, w, b, ls, lb, gp,
      static_cast<float*>(n_slices > 1 ? scratch : dW),
      static_cast<float*>(db), B, E, d, dp, sj, sk, btiles_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (n_slices > 1) {
    const size_t n = size_t(E) * d + E;
    const int blocks = int(std::min<size_t>((n + THREADS - 1) / THREADS,
                                            size_t(8) * 132));
    xent6_reduce_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(scratch), gp, static_cast<float*>(dW),
        static_cast<float*>(db), E, d, dp, sk, n_slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  dp_k<<<dim3((B + TILE - 1) / TILE, n_chunks), THREADS, smem, stream>>>(
      p, w, b, ls, lb, gp, static_cast<float*>(part), nullptr, B, E, d, dp,
      sj, sk, tiles_per_chunk);
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
// part [n_chunks, Bp, dp] fp32 (Bp = B rounded up to 64), which the caller
// sums over the chunk axis; dp is a multiple of 64 for bf16. The dW sweep
// splits the batch tiles into n_slices slices of btiles_per_slice; with
// more than one, `scratch` holds n_slices * Ep * (dp + 1) floats of
// partials (Ep = E rounded up to 64), else it is unused.
extern "C" int sert_xent_bwd(const void* P, const void* W, const void* bias,
                             const void* lse, const void* lab, const void* g,
                             void* dW, void* db, void* part, void* scratch,
                             int B, int E, int d, int dp, long long sj,
                             long long sk, int tiles_per_chunk, int n_chunks,
                             int btiles_per_slice, int n_slices,
                             int use_bf16, int w_bf16, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  auto go = [&](auto t, auto wt) {
    return launch_bwd<decltype(t), decltype(wt)>(
        P, W, bias, lse, lab, g, dW, db, part, scratch, B, E, d, dp, sj, sk,
        tiles_per_chunk, n_chunks, btiles_per_slice, n_slices, st);
  };
  if (use_bf16) return w_bf16 ? go(bf16(), bf16()) : go(bf16(), 0.0f);
  return w_bf16 ? go(0.0f, bf16()) : go(0.0f, 0.0f);
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
