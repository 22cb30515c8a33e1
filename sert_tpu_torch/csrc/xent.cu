// K5 + K6 + K7: softmax cross-entropy over the whole entity axis, forward,
// backward, and backward with the optimizer applied, for sm_90a.
//
// Replaces the Pallas kernels of sert_tpu/ops/xent.py: _fwd_kernel :152
// (launched by _fwd_partials :270), _bwd_kernel :219 (launched by
// _bwd_calls :364) and _bwd_update_kernel :468 (launched by xent_bwd_apply
// :525). With z[b, j] = P[b] . W(j) + bias[j] over entities j < E:
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
// All three are modes of one sweep kernel (xent_sweep_kernel below), and
// the [B, E] logits never reach device memory: a block holds one 64 x 64
// tile of them, in registers and shared memory. The wrapper (ops/xent.py)
// sends K5, K6 and K7 here in fp32 compute; in bf16 compute they run the
// warp-specialized TMA + wgmma sweep of xent_wgmma.cu, K7's update on its
// dW mode through the same arithmetic (update.cuh).
//
// W is read in its storage form, never copied, padded or transposed: its
// layout is "de" ([d, E], the log-linear proj_w: entities contiguous) or
// "ed" ([E, d], the LSE entity_emb: features contiguous), given as the
// strides (sj, sk) of W(j, k) = W[j * sj + k * sk]. Each entity tile is
// staged entity-major into shared memory, in fp32 (a bf16 W is widened on
// the way, without an fp32 copy), with entities past E and features past d
// staged as zeros, so the tail tile needs no padding of W and its zero rows
// cannot leak 0 * NaN into dpooled. dW is written back in W's own layout
// and shape.
//
// What bounds them on the H100. K5 makes one product of [B, d] by [d, E],
// K6 three (z, then dW and dpooled, with z made again in its second
// sweep), K7 K6's three and the update, each product here three TF32
// products (3xTF32, below). At the log-linear recipes' widths (E of a few
// thousand) a product is a few GFLOP, 11 us at cerc's shape on the tensor
// cores; there the barriers, the fragment loads and the TF32 splits between
// the tensor-core instructions set the time, not the tensor cores. K7's
// update moves W and its slots once each way: at the reference's
// fused-step width (B = 1024, E = 500k, d = 256, fp32 params) adam's W, m, v
// in and out are 3.1 GB (0.92 ms at 3.35 TB/s), against 0.79 TFLOP of
// products, which the TF32 passes triple.
//
// What the design does about it: every mode streams one operand through a
// cp.async / register ring that overlaps the products, keeps its
// accumulators in registers and runs fp32 products on the tensor cores as
// 3xTF32; each sweep splits its loop axis by a plan that fills one round of
// two blocks an SM (ops/xent.py _dw_splits, _dp_chunks). A tensor-core sum
// drifts from the exact one in proportion to its length, so the dpooled
// sweep adds its accumulators into its partial, in fp32, every `flush`
// entity tiles (ops/xent.py DP_MAX_TILES) and starts them again from zero.
// K5 is the z pass alone, with a running (max, sumexp) of each row in
// registers. K7 is K6's dpooled sweep, then K6's dW sweep whose epilogue
// applies the update to the block's own tile of W, so dW is never stored;
// where the entity tiles are too few to fill the card the dW sweep is split
// over the batch too, and the update moves into the kernel that sums the
// slices. An fp32 mode of xent_wgmma.cu's sweep, for K5-K7 in fp32
// compute, is later work.
//
// Determinism: no float atomics. The dW sweeps split the batch tiles into
// slices by a plan that depends on the shapes alone (ops/xent.py
// _dw_splits), each block looping over its slice in order, and a second
// kernel sums the slices in slice order. The dpooled sweeps and K5 write
// one partial per (entity chunk, batch row), which the caller sums or
// merges in a fixed order. K7's sum of G^2 is one partial per entity tile,
// summed in the block in a fixed order.
//
// K7's order: the dpooled sweep reads W, so it is launched first, on the
// same stream; the update sweep's blocks read their own tile of W (and its
// slots) only, stage it before their batch loop, and write it after.

#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "mma_sync.cuh"
#include "tile_mm.cuh"
#include "update.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- The sweep: K5, K6 and K7 on the tensor cores --------------------------
// Every launch of K5, K6 and K7 but the slice sums is xent_sweep_kernel, in
// one of four modes. A block keeps a "resident" [64, dp] tile X of one
// operand in shared memory and streams the [64, dp] tiles Y of the other
// through a ring of NST [64, CH] feature chunks, each tile's chunks once
// (FWD) or twice:
//   z[x][y] = X[x] . Y[y]               chunk by chunk, in registers;
//   FWD: the running (max, sumexp) of each row of z, through shared memory;
//   p = exp(z - lse) - onehot           in shared memory;
//   acc[x][:] += sum_y p[x][y] Y[y][:]  chunk by chunk, in registers.
// FWD (K5) and DPOOL (the dpooled sweep of K6 and K7): X is a batch tile of
// P (by cp.async), Y the entity tiles of one entity chunk of W, each chunk
// loaded into registers one step ahead (16 bytes a load where W's rows
// allow) and widened while stored (cp.async copies bytes unchanged, and W
// may be stored as bf16); DPOOL's acc = sum_e p W. DW (K6's dW sweep)
// and UPDATE (K7's): X is entity tile t of W (widened on the way in), Y the
// batch tiles of slice s of P, which cp.async streams NST - 1 chunks ahead
// of use, with each tile's lse and labels; acc = sum_b p^T P and
// db = sum_b p. With one slice DW stores dW = g * acc and UPDATE applies
// the optimizer to the tile from G = gscale * acc; with more, both write
// their unscaled partials for a second kernel to sum in slice order.
// fp32 products run on the tensor cores as 3xTF32: x = hi + lo with hi and
// lo TF32, and a.b = lo.hi + hi.lo + hi.hi summed in fp32 (the dropped lo.lo
// term is ~2^-22 of a product), which keeps fp32's accuracy class, through
// mma.sync, with fragments read from shared memory by plain loads (wmma's
// tf32 loads went through generic addressing). Each warp owns 16 rows of
// X: four 16 x 8 tiles of z and, in every chunk, CH / 16 16 x 8 tiles of
// acc (64 registers of acc at dp = 256).
// Between two barriers a warp does a few fragment products, each fp32
// operand element split in four integer operations and one subtraction, so
// issue slots, load latency and the barriers, not the tensor cores, set its
// time (PERF.md).
constexpr int CHUNK = 32;            // features of a ring stage
constexpr int NACC = 256 / 16;       // 16 x 8 acc tiles a warp holds, dp 256
constexpr int NST = 3;               // ring stages
constexpr int AHEAD = NST - 1;       // cp.async chunks in flight ahead of use

// Row strides of the resident tile (always the widest dp the kernels
// take) and of a ring stage, as constants so that every fragment address
// folds into an offset from a per-warp base: 16 bytes of padding keep
// fragment pointers 32-byte aligned and the rows off each other's banks.
constexpr int LD_X = 256 + 4;
constexpr int LD_Y = CHUNK + 4;

// Byte offsets of a sweep block's shared memory: the resident tile, the
// ring, the z / p tile and seven vectors of TILE 4-byte entries: 113 KB,
// two blocks an SM.
struct SweepLayout {
  static constexpr size_t stage =
      (size_t(TILE) * LD_Y * sizeof(float) + 127) / 128 * 128;
  static constexpr size_t ring =
      (size_t(TILE) * LD_X * sizeof(float) + 127) / 128 * 128;
  static constexpr size_t z = ring + NST * stage;
  static constexpr size_t vec =
      (z + size_t(TILE) * LDZ * sizeof(float) + 127) / 128 * 128;
  static constexpr size_t total = vec + 7 * TILE * sizeof(float);
};

// The sweep's modes: K5's forward, the dpooled sweep (K6, K7), K6's dW
// sweep and K7's update sweep.
enum Mode : int { FWD = 0, DPOOL = 1, DW = 2, UPDATE = 3 };

// A position in a sweep's stream of Y chunks: ring stage, Y tile of the
// block, chunk, pass (0: z, 1: acc; FWD makes the z pass only).
template <int PASSES>
struct StreamPos {
  int st = 0, ti = 0, c = 0, pass = 0;
  __device__ void next(int nch) {
    if (++st == NST) st = 0;
    if (++c == nch) {
      c = 0;
      if (++pass == PASSES) {
        pass = 0;
        ++ti;
      }
    }
  }
};

// Grid: DW and UPDATE (entity tiles, slices of `per` batch tiles), else
// (batch tiles, chunks of `per` entity tiles). dp is a multiple of CH.
// FWD writes each row's running max and sumexp over the chunk into `out`
// and `out2` [chunks, B]. DPOOL writes its unscaled partial into `out`
// [chunks, Bp, dp] (Bp = batch tiles * 64), adding its accumulators into
// it every `flush` Y tiles and at the end. DW writes, with one slice,
// dW = g * acc in W's layout into `out` and db = g * sum p into `out2`;
// UPDATE, with one slice, updates W and its slots in place (through up.w)
// from G = up.gscale * acc, writes db unscaled into `out2` and the tile's
// sum of G^2 into up.gsq; with S slices both write their unscaled partials
// into slice s of `out` ([S, Ep, dp] in W's layout, Ep = entity tiles * 64,
// then the db partials [S, Ep]).
template <typename WT, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
xent_sweep_kernel(const float* __restrict__ P, const WT* W,
                  const float* __restrict__ bias,
                  const float* __restrict__ lse, const int* __restrict__ lab,
                  const float* __restrict__ g, float* __restrict__ out,
                  float* __restrict__ out2, int B, int E, int d, int dp,
                  long long sj, long long sk, int per, int flush,
                  Update<WT> up) {
  constexpr bool XW = MODE == DW || MODE == UPDATE;   // X is a tile of W
  constexpr int PASSES = MODE == FWD ? 1 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  using L = SweepLayout;
  constexpr int LDX = LD_X, LDY = LD_Y;
  float* X = reinterpret_cast<float*>(smem);
  float* Z = reinterpret_cast<float*>(smem + L::z);
  float* rv = reinterpret_cast<float*>(smem + L::vec);  // X's bias or lse
  int* rl = reinterpret_cast<int*>(rv + TILE);          // X's labels
  float* sv = rv + 2 * TILE;       // Y's lse or bias, by tile parity
  int* sl = reinterpret_cast<int*>(sv + 2 * TILE);      // Y's labels, same
  float* dbacc = sv + 4 * TILE;    // DW, UPDATE: the entity tile's sum_b p
  auto ring = [&](int st) {
    return reinterpret_cast<float*>(smem + L::ring + st * L::stage);
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp / 2, half = warp % 2;
  const int x0 = blockIdx.x * TILE;
  const int n_y = XW ? (B + TILE - 1) / TILE : (E + TILE - 1) / TILE;
  const int y_first = blockIdx.y * per;
  const int n_tiles = min(per, n_y - y_first);
  constexpr int CH = CHUNK, NCH = 256 / CH, FPC = CH / 32;
  const int nch = dp / CH;

  // The stream is each Y tile's chunks in order for z, then again for acc.
  // fetch() starts the load at its cursor (cp.async into its stage; W:
  // global loads into registers), put() finishes the W load at its own
  // (registers, widened, into its stage), and each step reads the stage at a
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
  StreamPos<PASSES> at_fetch, at_put;
  int at_read = 0;                 // the stage the next step reads
  auto fetch = [&]() {
    const bool live = at_fetch.ti < n_tiles;
    const int ti = at_fetch.ti, c = at_fetch.c;
    const bool first = at_fetch.pass == 0 && c == 0;
    const int y0 = (y_first + ti) * TILE;
    float* dst = ring(at_fetch.st);
    at_fetch.next(nch);
    if constexpr (XW) {
      if (live) {
        constexpr int V = 4, VPR = CH / V;
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
    const StreamPos<PASSES> at = at_put;
    at_put.next(nch);
    if (at.ti >= n_tiles) return;
    float* dst = ring(at.st);
    if (wvec) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        int r, k;
        piece(v, r, k);
        const WT* w = reinterpret_cast<const WT*>(&wv[v]);
#pragma unroll
        for (int u = 0; u < VW; ++u)
          dst[(sk == 1 ? r : r + u) * LDY + (sk == 1 ? k + u : k)] =
              to_f32(w[u]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const int e = tid + q * THREADS;
        const int r = sk == 1 ? e / CH : e % TILE;
        const int k = sk == 1 ? e % CH : e / TILE;
        dst[r * LDY + k] = wreg[q];
      }
    }
    if (at.pass == 0 && at.c == 0 && tid < TILE)
      sv[(at.ti & 1) * TILE + tid] = wbias;
  };
  // A step begins once its load is in its stage for every thread; the
  // stage the next load overwrites was last read a step or more before.
  // Returns the stage it reads.
  auto begin = [&]() {
    if constexpr (XW) {
      cp_wait<AHEAD - 1>();
      __syncthreads();
    } else {
      __syncthreads();
    }
    fetch();
    const float* Y = ring(at_read);
    if (++at_read == NST) at_read = 0;
    return Y;
  };
  auto end = [&]() {
    if constexpr (!XW) put();
  };
  // The resident tile and its vectors, staged while the first loads of
  // the stream are in flight: W's tile through registers, RES loads a
  // thread in flight, widened on the way; P's tile by cp.async.
  if constexpr (XW) {
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
        if (i < TILE * dp) X[r * LDX + k] = v[u];
      }
    }
    if (tid < TILE) {
      rv[tid] = x0 + tid < E ? bias[x0 + tid] : 0.0f;
      dbacc[tid] = 0.0f;
    }
  } else {
    constexpr int V = 4;
    const int vpr = dp / V;
    for (int q = tid; q < TILE * vpr; q += THREADS) {
      const int r = q / vpr, col = (q % vpr) * V;
      const bool in = x0 + r < B;
      cp_async16(X + r * LDX + col, P + size_t(in ? x0 + r : 0) * dp + col,
                 in);
    }
    cp_commit();
    if constexpr (MODE == DPOOL) {
      if (tid < TILE) {
        const bool in = x0 + tid < B;
        rv[tid] = in ? lse[x0 + tid] : 0.0f;
        rl[tid] = in ? lab[x0 + tid] : -1;
      }
    }
    fetch();
    put();
    cp_wait<0>();
  }

  // ac[c * 2 FPC + j]: rows 16 mt.., features c CH + 16 FPC half + 8 j..;
  // zc[j]: rows 16 mt.., columns 32 half + 8 j.. of z.
  Acc8 ac[NACC], zc[4];
  auto feature = [&](int a) {     // the first feature of ac[a]
    return a / (2 * FPC) * CH + 16 * FPC * half + 8 * (a % (2 * FPC));
  };
#pragma unroll
  for (int a = 0; a < NACC; ++a) ac[a] = Acc8{{0.0f, 0.0f, 0.0f, 0.0f}};
  // DPOOL: add the accumulators into this warp's rows of the block's
  // partial, each element by the thread that holds it (the first time,
  // store them), and start them again from zero.
  bool flushed = false;
  auto flush_acc = [&]() {
    const size_t Bp = size_t(gridDim.x) * TILE;
    float* part = out + (blockIdx.y * Bp + x0 + 16 * mt) * dp;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const int f = feature(a);
      if (f < dp) {
        if (flushed) add_c(ac[a], part + f, dp);
        store_c(part + f, dp, ac[a]);
      }
      ac[a] = Acc8{{0.0f, 0.0f, 0.0f, 0.0f}};
    }
    flushed = true;
  };
  // FWD: the running (max, sumexp) of rows 8 warp.. of X.
  constexpr int ROWS = TILE / WARPS;
  float m_run[ROWS], s_run[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_run[i] = -CUDART_INF_F;
    s_run[i] = 0.0f;
  }

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int y0 = (y_first + ti) * TILE;
#pragma unroll
    for (int j = 0; j < 4; ++j) zc[j] = Acc8{{0.0f, 0.0f, 0.0f, 0.0f}};
    for (int c = 0; c < nch; ++c) {           // z = X . Y^T
      const float* Y = begin() + 32 * half * LDY;
      const float* xa = X + 16 * mt * LDX + c * CH;
#pragma unroll
      for (int kk = 0; kk < CH; kk += KSTEP) {
        FragA a;
        load_a(a, xa + kk, LDX);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB b;
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
    const int buf = (ti & 1) * TILE;
    if constexpr (MODE == FWD) {
      // The next tile's first barrier orders these reads before Z and this
      // tile's half of sv are rewritten.
      online_lse(
          Z, m_run, s_run, [&](int col) { return sv[buf + col]; },
          [&](int, int col) { return y0 + col < E; });
      continue;
    }
    // p = exp(z - lse) - onehot, 0 past B and E; warp w owns rows 8w..8w+7.
#pragma unroll
    for (int rr = 0; rr < TILE / WARPS; ++rr) {
      const int x = warp * (TILE / WARPS) + rr;
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = lane + 32 * h;
        const int b = XW ? y0 + y : x0 + x, e = XW ? x0 + x : y0 + y;
        float p = 0.0f;
        if (b < B && e < E) {
          p = expf(Z[x * LDZ + y] + (XW ? rv[x] : sv[buf + y]) -
                   (XW ? sv[buf + y] : rv[x]));
          if ((XW ? sl[buf + y] : rl[x]) == e) p -= 1.0f;
        }
        Z[x * LDZ + y] = p;
        sum += p;
      }
      if constexpr (XW) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) dbacc[x] += sum;
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {           // acc += p . Y
      if (c < nch) {
        const float* Y = begin();             // its barrier publishes p
#pragma unroll
        for (int kk = 0; kk < TILE; kk += KSTEP) {
          FragA a;
          load_a(a, Z + 16 * mt * LDZ + kk, LDZ);
#pragma unroll
          for (int j = 0; j < 2 * FPC; ++j) {
            FragB b;
            load_b_kn(b, Y + kk * LDY + 16 * FPC * half + 8 * j, LDY);
            tc_mma(ac[2 * FPC * c + j], a, b);
          }
        }
        end();
      }
    }
    if constexpr (MODE == DPOOL)
      if ((ti + 1) % flush == 0 && ti + 1 < n_tiles) flush_acc();
  }

  if constexpr (MODE == FWD) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = x0 + warp * ROWS + i;
        if (row < B) {
          out[size_t(blockIdx.y) * B + row] = m_run[i];
          out2[size_t(blockIdx.y) * B + row] = s_run[i];
        }
      }
    }
  } else if constexpr (MODE == DPOOL) {
    flush_acc();
  } else {
    const int S = gridDim.y, Ep = gridDim.x * TILE;
    if (S > 1) {                // slice s's partials, unscaled
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
      return;
    }
    // One slice: the tile's gradient, chunk by chunk through Z in W's
    // layout, stored as dW = g * acc (DW) or applied as the update (UPDATE).
    const float gs = MODE == DW ? *g : up.gscale;
    float sq = 0.0f;                  // UPDATE: this thread's sum of G^2
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
          if (x0 + r < E && c * CH + k < d) {
            const long long at = (x0 + r) * sj + (c * CH + k) * sk;
            if constexpr (MODE == DW)
              out[at] = gs * Z[r * LDZ + k];
            else
              sq = store_update(up, at, __fmul_rn(Z[r * LDZ + k], gs),
                                load_elem(up, at), sq);
          }
        }
      }
    }
    if (tid < TILE && x0 + tid < E)
      out2[x0 + tid] = MODE == DW ? gs * dbacc[tid] : dbacc[tid];
    if constexpr (MODE == UPDATE) {
      // rl (X's labels) is unused by the dW sweeps.
      const float total = block_sum<WARPS>(sq, reinterpret_cast<float*>(rl));
      if (tid == 0) up.gsq[blockIdx.x] = total;
    }
  }
}

// K6's sum of S > 1 slices: dW = g * sum_s scratch[s] in W's layout and
// db = g * sum_s (db partial s), each summed in slice order (no atomics, so
// two calls give the same bits). Elementwise along W's contiguous axis.
__global__ void __launch_bounds__(THREADS)
xent_reduce_kernel(const float* __restrict__ scratch,
                   const float* __restrict__ g, float* __restrict__ dW,
                   float* __restrict__ db, int E, int d, int dp, long long sk,
                   int S) {
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

// K7's sum of S > 1 slices, with the update: one block per entity tile sums
// the tile's S partials in slice order, applies the update from
// G = gscale * sum in place (as the one-slice UPDATE epilogue does), and
// writes db unscaled and the tile's sum of G^2. With one block per tile the
// grid is small where S > 1 (18 blocks at w3c's shape), so a block has
// RA_THREADS threads and each keeps U elements' loads in flight before it
// stores any (a store may alias a later element's load, so the compiler
// would not hoist the loads itself).
constexpr int RA_THREADS = 1024;
template <typename WT>
__global__ void __launch_bounds__(RA_THREADS)
xent_reduce_apply_kernel(const float* __restrict__ scratch,
                         float* __restrict__ db, int E, int d, int dp,
                         long long sj, long long sk, int S, Update<WT> up) {
  constexpr int U = 4;
  __shared__ float red[RA_THREADS / 32];
  const int j0 = blockIdx.x * TILE, Ep = gridDim.x * TILE;
  const size_t slice = size_t(Ep) * dp;
  float sq = 0.0f;
  for (int i0 = threadIdx.x; i0 < TILE * dp; i0 += U * RA_THREADS) {
    long long at[U];
    float g[U];
    Elem e[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * RA_THREADS;
      const int r = sk == 1 ? i / dp : i % TILE;
      const int k = sk == 1 ? i % dp : i / TILE;
      at[q] = -1;
      float acc = 0.0f;
      if (i < TILE * dp && j0 + r < E && k < d) {
        const float* src = scratch + (sk == 1 ? size_t(j0 + r) * dp + k
                                              : size_t(k) * Ep + j0 + r);
        for (int s = 0; s < S; ++s) acc += src[s * slice];
        at[q] = (j0 + r) * sj + k * sk;
        e[q] = load_elem(up, at[q]);
      }
      g[q] = __fmul_rn(acc, up.gscale);
    }
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (at[q] >= 0) sq = store_update(up, at[q], g[q], e[q], sq);
  }
  const int t = threadIdx.x;
  if (t < TILE && j0 + t < E) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += scratch[S * slice + s * Ep + j0 + t];
    db[j0 + t] = acc;
  }
  const float total = block_sum<RA_THREADS / 32>(sq, red);
  if (t == 0) up.gsq[blockIdx.x] = total;
}

// The dynamic shared memory of a sweep, and the carveout that holds two of
// its blocks an SM.
template <typename K>
cudaError_t prepare_sweep(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

template <typename WT>
int launch_fwd(const void* P, const void* W, const void* bias, void* m_out,
               void* s_out, int B, int E, int d, int dp, long long sj,
               long long sk, int tiles_per_chunk, int n_chunks,
               cudaStream_t stream) {
  const size_t smem = SweepLayout::total;
  auto k = xent_sweep_kernel<WT, FWD>;
  const cudaError_t err = prepare_sweep(k, smem);
  if (err != cudaSuccess) return int(err);
  k<<<dim3((B + TILE - 1) / TILE, n_chunks), THREADS, smem, stream>>>(
      static_cast<const float*>(P), static_cast<const WT*>(W),
      static_cast<const float*>(bias), nullptr, nullptr, nullptr,
      static_cast<float*>(m_out), static_cast<float*>(s_out), B, E, d, dp,
      sj, sk, tiles_per_chunk, 0, Update<WT>{});
  return int(cudaGetLastError());
}

// The dpooled sweep of K6 and K7.
template <typename WT>
int launch_dpooled(const float* P, const WT* W, const float* bias,
                   const void* lse, const void* lab, void* part, int B,
                   int E, int d, int dp, long long sj, long long sk,
                   int tiles_per_chunk, int n_chunks, int flush,
                   cudaStream_t stream) {
  const size_t smem = SweepLayout::total;
  auto k = xent_sweep_kernel<WT, DPOOL>;
  const cudaError_t err = prepare_sweep(k, smem);
  if (err != cudaSuccess) return int(err);
  k<<<dim3((B + TILE - 1) / TILE, n_chunks), THREADS, smem, stream>>>(
      P, W, bias, static_cast<const float*>(lse),
      static_cast<const int*>(lab), nullptr, static_cast<float*>(part),
      nullptr, B, E, d, dp, sj, sk, tiles_per_chunk, flush, Update<WT>{});
  return int(cudaGetLastError());
}

// K6's launches: the dW sweep, the ordered sum of its slices (S > 1), then
// the dpooled sweep.
template <typename WT>
int launch_bwd(const void* P, const void* W, const void* bias,
               const void* lse, const void* lab, const void* g, void* dW,
               void* db, void* part, void* scratch, int B, int E, int d,
               int dp, long long sj, long long sk, int tiles_per_chunk,
               int n_chunks, int btiles_per_slice, int n_slices, int flush,
               cudaStream_t stream) {
  const size_t smem = SweepLayout::total;
  auto dw_k = xent_sweep_kernel<WT, DW>;
  cudaError_t err = prepare_sweep(dw_k, smem);
  if (err != cudaSuccess) return int(err);
  const float* p = static_cast<const float*>(P);
  const WT* w = static_cast<const WT*>(W);
  const float* b = static_cast<const float*>(bias);
  const float* gp = static_cast<const float*>(g);
  const int n_etiles = (E + TILE - 1) / TILE;
  dw_k<<<dim3(n_etiles, n_slices), THREADS, smem, stream>>>(
      p, w, b, static_cast<const float*>(lse), static_cast<const int*>(lab),
      gp, static_cast<float*>(n_slices > 1 ? scratch : dW),
      static_cast<float*>(db), B, E, d, dp, sj, sk, btiles_per_slice, 0,
      Update<WT>{});
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (n_slices > 1) {
    const size_t n = size_t(E) * d + E;
    const int blocks = int(std::min<size_t>((n + THREADS - 1) / THREADS,
                                            size_t(8) * 132));
    xent_reduce_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(scratch), gp, static_cast<float*>(dW),
        static_cast<float*>(db), E, d, dp, sk, n_slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return launch_dpooled(p, w, b, lse, lab, part, B, E, d, dp, sj, sk,
                        tiles_per_chunk, n_chunks, flush, stream);
}

// K7's launches: the dpooled sweep first (it reads W, which the update
// overwrites), then the update sweep, then, with S > 1 slices, the ordered
// sum of the slices that applies the update.
template <typename WT>
int launch_apply(const void* P, void* W, const void* bias, const void* lse,
                 const void* lab, void* s1, void* s2, void* db, void* part,
                 void* gsq, void* scratch, int B, int E, int d, int dp,
                 long long sj, long long sk, int tiles_per_chunk,
                 int n_chunks, int btiles_per_slice, int n_slices, int flush,
                 int opt, float lr, float gscale, float bc1, float bc2,
                 cudaStream_t stream) {
  const size_t smem = SweepLayout::total;
  auto up_k = xent_sweep_kernel<WT, UPDATE>;
  cudaError_t err = prepare_sweep(up_k, smem);
  if (err != cudaSuccess) return int(err);
  const float* p = static_cast<const float*>(P);
  WT* w = static_cast<WT*>(W);
  const float* b = static_cast<const float*>(bias);
  const Update<WT> u{w, static_cast<WT*>(s1), static_cast<WT*>(s2),
                     static_cast<float*>(gsq), opt, lr, gscale, bc1, bc2};
  err = cudaError_t(launch_dpooled<WT>(p, w, b, lse, lab, part, B, E, d, dp,
                                       sj, sk, tiles_per_chunk, n_chunks,
                                       flush, stream));
  if (err != cudaSuccess) return int(err);
  const int n_etiles = (E + TILE - 1) / TILE;
  up_k<<<dim3(n_etiles, n_slices), THREADS, smem, stream>>>(
      p, w, b, static_cast<const float*>(lse), static_cast<const int*>(lab),
      nullptr, static_cast<float*>(scratch), static_cast<float*>(db), B, E,
      d, dp, sj, sk, btiles_per_slice, 0, u);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return int(err);
  xent_reduce_apply_kernel<WT><<<n_etiles, RA_THREADS, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(db), E, d, dp,
      sj, sk, n_slices, u);
  return int(cudaGetLastError());
}

}  // namespace

// K5 in fp32 compute (bf16 compute runs xent_wgmma.cu's sweep). P [B, dp]
// fp32, dp a multiple of 32 and <= 256, rows 16-byte aligned, zero past d;
// W in its storage type (bf16 when `w_bf16` is nonzero, else fp32) with
// W(j, k) at W[j * sj + k * sk] for entities j < E and features k < d;
// bias [E] fp32. K5 writes m_out / s_out [n_chunks, B]; chunk c covers
// entity tiles [c * tiles_per_chunk, ...) of 64. The Python wrapper checks
// every shape and type. Returns the cudaError_t.
extern "C" int sert_xent_fwd(const void* P, const void* W, const void* bias,
                             void* m_out, void* s_out, int B, int E, int d,
                             int dp, long long sj, long long sk,
                             int tiles_per_chunk, int n_chunks, int w_bf16,
                             void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  auto go = [&](auto wt) {
    return launch_fwd<decltype(wt)>(P, W, bias, m_out, s_out, B, E, d, dp,
                                    sj, sk, tiles_per_chunk, n_chunks, st);
  };
  return w_bf16 ? go(bf16()) : go(0.0f);
}

// K6 in fp32 compute: as K5, plus lse [B] fp32, labels [B] int32 (-1: no
// gold entity) and g, one fp32 scalar on the device. Writes dW fp32 with
// W's shape and strides, db [E] fp32 (both scaled by g) and the unscaled
// dpooled partials part [n_chunks, Bp, dp] fp32 (Bp = B rounded up to
// 64), which the caller sums over the chunk axis; a dpooled block adds its
// accumulators into its partial every `flush` entity tiles. The dW sweep
// splits the batch tiles into n_slices slices of btiles_per_slice; with
// more than one, `scratch` holds n_slices * Ep * (dp + 1) floats of
// partials (Ep = E rounded up to 64), else it is unused.
extern "C" int sert_xent_bwd(const void* P, const void* W, const void* bias,
                             const void* lse, const void* lab, const void* g,
                             void* dW, void* db, void* part, void* scratch,
                             int B, int E, int d, int dp, long long sj,
                             long long sk, int tiles_per_chunk, int n_chunks,
                             int btiles_per_slice, int n_slices, int flush,
                             int w_bf16, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  auto go = [&](auto wt) {
    return launch_bwd<decltype(wt)>(
        P, W, bias, lse, lab, g, dW, db, part, scratch, B, E, d, dp, sj, sk,
        tiles_per_chunk, n_chunks, btiles_per_slice, n_slices, flush, st);
  };
  return w_bf16 ? go(bf16()) : go(0.0f);
}

// K7 in fp32 compute (bf16 compute runs xent_wgmma.cu's
// sert_xent_wgmma_apply): as K6, with W updated in place instead of dW
// written. `opt` is 0 adam (s1 = m, s2 = v), 1 adagrad (s1 = acc) or 2 sgd
// (no slots); the slots have W's shape, layout and storage type and are
// updated in place. lr is the constant learning rate, gscale the factor
// from the sum loss's dW to the update's gradient (1 / B for the mean
// loss), bc1 and bc2 adam's bias corrections 1 - 0.9^t and 1 - 0.999^t
// (fp32, t = count + 1). Writes db [E] unscaled, the unscaled dpooled
// partials part [n_chunks, Bp, dp] (summed by the caller) and gsq
// [ceil(E / 64)], each entity tile's sum of (gscale * dW)^2. The plans,
// `flush` and `scratch` are K6's.
extern "C" int sert_xent_bwd_apply(const void* P, void* W, const void* bias,
                                   const void* lse, const void* lab,
                                   void* s1, void* s2, void* db, void* part,
                                   void* gsq, void* scratch, int B, int E,
                                   int d, int dp, long long sj, long long sk,
                                   int tiles_per_chunk, int n_chunks,
                                   int btiles_per_slice, int n_slices,
                                   int flush, int opt, float lr,
                                   float gscale, float bc1, float bc2,
                                   int w_bf16, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  auto go = [&](auto wt) {
    return launch_apply<decltype(wt)>(
        P, W, bias, lse, lab, s1, s2, db, part, gsq, scratch, B, E, d, dp,
        sj, sk, tiles_per_chunk, n_chunks, btiles_per_slice, n_slices, flush,
        opt, lr, gscale, bc1, bc2, st);
  };
  return w_bf16 ? go(bf16()) : go(0.0f);
}
