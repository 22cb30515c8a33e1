// K5 + K6 + K7 in bf16 compute: the full-softmax forward partials, the
// backward, and the backward with the optimizer applied, as four modes of
// one warp-specialized TMA + wgmma sweep, for sm_90a.
//
// Replaces, for bf16 compute, the Pallas kernels of sert_tpu/ops/xent.py
// _fwd_kernel :152 (launched by _fwd_partials :270), _bwd_kernel :219
// (launched by _bwd_calls :364) and _bwd_update_kernel :468 (launched by
// xent_bwd_apply :525). fp32 compute stays on xent.cu's mma.sync sweep.
// With z[b, j] = P[b] . W(j) + bias[j] over entities j < E:
//   K5: per (batch row, entity chunk) the running (max, sumexp) of z; the
//       caller merges the chunks into lse[b];
//   K6: p = exp(z - lse[b]) - onehot(label[b]) (no onehot for a label of
//       -1), dW(j) = g sum_b p P[b], db = g sum_b p, dpooled = sum_j p W(j)
//       (scaled by g in the wrapper), with p rounded to bf16 before both
//       products and db summed from the unrounded p (the reference's cast
//       points). Rows past B contribute nothing.
//   K7: K6's dpooled, then K6's dW sweep with adam, adagrad or sgd applied
//       to W and its slots in place from G = gscale dW where K6 would store
//       dW, so dW never reaches device memory; db unscaled and one sum of
//       G^2 an entity tile. Its accumulators are K6's, bit for bit (the same
//       plan, tiles, order and products), and its update is xent.cu's
//       (update.cuh), so K6 and K7 give one dW and fp32 and bf16 compute one
//       update.
// The [B, E] logits never reach device memory, nor shared memory: every
// tile of them lives in the accumulator registers of the warpgroup that
// made it.
//
// What bounds it on the H100. At lse_full's flagship (B 4096, E 1M, d 128,
// "ed") one product is 2 B E d = 1.07 TFLOP, 1.09 ms at the bf16 peak, and
// one exponential of every logit is B E = 4.1e9 of them, 0.98 ms at the
// special-function units' 16 a clock an SM: K5 makes one of each (bound
// ~1.1 ms), K6 four products (z in each of its two sweeps, then dW and
// dpooled) and two exponential passes. At the log-linear A/B's width (B
// 1024, E 500k, d 256, "de") a product is 0.26 TFLOP (0.27 ms) and the
// exponentials 0.12 ms. The bytes that must move are small beside them: W in
// bf16 once (256 MB at either shape, 0.08 ms at 3.35 TB/s), dW once in fp32
// (512 MB, 0.15 ms). So the sweep must keep the tensor cores fed while it
// exponentiates, and must not read W from device memory once per batch
// tile: at 128-row batch tiles that is B / 128 = 32 reads of W a pass at the
// flagship, 8.2 GB, 2.4 ms, more than K5's whole bound.
//
// The design: K1/K2's sweep (sampled_lse.cu), its modes here. A block
// keeps a resident tile X of 128 rows in shared memory and streams the tiles
// Y of the other operand through a ring of four stages:
//   FWD (K5)  X = a batch tile of P, Y = the entity tiles of one chunk of W:
//             z = X Y^T + bias and each row's running (max, sumexp);
//   DP (K6)   the same tiles: p from z, acc += p Y (dpooled partials);
//   DW (K6)   X = an entity tile of W, Y = the batch tiles of one slice of P:
//             z^T = X Y^T, p^T from it, acc += p^T Y (dW) and the row sums of
//             p^T (db);
//   APPLY (K7) DW's loop; with one slice its epilogue stages G = gscale acc
//             through the ring's shared memory (free once the loop is done)
//             in W's layout and updates the tile of W and its slots, each
//             feature's run of 128 entities ("de") or each entity's row
//             ("ed") read and written whole; with S > 1 slices it writes
//             DW's partials and a second kernel sums them in slice order
//             and applies the same update.
// One producer warp issues the TMA loads into the ring with full / empty
// mbarriers (128-byte swizzle; TMA zero-fills past B, past E and past d, so
// 0 * NaN never reaches a product) and stages each tile's vectors beside it:
// an entity tile's bias (x log2 e) and index, a batch tile's -lse (x log2 e)
// and label. Two consumer warpgroups each own 64 rows of X. z runs on wgmma
// from shared memory; p is rounded to bf16 in registers (the accumulator
// layout is the A-fragment layout) and fed as wgmma's register operand. The
// softmax works on the accumulator fragments, exp2 of a log2(e)-scaled
// argument, K5's row max reduced across the quad of lanes that share a row.
// W's layout picks each operand's major-ness through the descriptors'
// transpose bits: in "ed" ([E, d], features contiguous) W is K-major for z
// and MN-major for p W; in "de" ([d, E], the log-linear proj_w, entities
// contiguous) the two swap, and W's tiles are boxes of d feature rows by 64
// entities. P is K-major for z^T and MN-major for p^T P.
//
// fp32 W. TMA copies bytes unchanged, so the sweep reads a bf16 copy of W
// that the wrapper makes once a forward (ops/xent.py _w_operand): one read
// of fp32 W and one bf16 write, 0.23 ms and 256 MB at the flagship, kept for
// K6. It rounds as xent.cu's staging cast does, so the numbers are the same.
//
// W's traffic. The grid's x axis is the batch tiles, so the blocks that
// run together are whole chunks: at the flagship the plan (ops/xent.py
// _wgmma_plan, K1/K2's _split) cuts W's 7,813 entity tiles into 33 chunks
// of 237, 32 x 33 = 1,056 blocks in 8 rounds of 132 (one an SM), and in each
// round the 32 blocks of a chunk walk the same entity tiles in the same
// order at about the same pace, so L2 serves all but the first read of
// each tile (a round's window of W is a few MB of L2's 50): W comes from
// device memory about once a sweep, 0.08 ms. DW holds each entity tile
// once and streams P (1 MB in bf16 at the flagship), which stays in L2.
//
// Measured (PERF.md §6): within a block the stream of tiles, the products
// and the softmax follow one another more than they overlap. Two ways of
// overlapping them were slower on the H100: the consumer warpgroups taking
// turns at the tensor cores (named barriers), and each warpgroup issuing
// the next tile's products before folding this tile's (two z arrays, which
// spill). Overlapping them without spilling is the next lever.
//
// K7's update bounds it at the log-linear A/B's width in fp32 storage:
// adam reads and writes W, m and v once, 3.07 GB, 0.92 ms at 3.35 TB/s,
// beside its three products (0.27 ms each). One block runs on each SM, so a
// tile's epilogue does not overlap the next tile's products (PERF.md §6
// gives what it adds); a persistent grid whose producer loads the next
// tile meanwhile is the lever.
//
// K7 updates W in place, and with bf16 storage the sweep's operand is W
// itself (ops/xent.py _w_operand). That is safe because: DP, which reads all
// of W, is launched first on the same stream; with one slice a block writes
// only its own resident entity tile X, which no other block reads; with
// S > 1 the update runs only in the reduce kernel, after every slice block
// has finished.
//
// Determinism: no float atomics. The plan is a function of the shapes
// alone: it splits the entity tiles into chunks (FWD, DP) and the batch
// tiles into slices (DW, where the entity tiles are too few to fill the
// card), each block walks its own in order, and the caller merges or sums
// the chunks and a second kernel the slices, in a fixed order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"
#include "update.cuh"

namespace {

constexpr int XR = 128;            // rows of the resident tile X
constexpr int THREADS_WS = 384;    // a producer and two consumer warpgroups
constexpr float L2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED2 = -1e30f * L2E;

enum Mode : int { FWD = 0, DP = 1, DW = 2, APPLY = 3 };

// One block's geometry at kernel width KW (dp rounded up to 64, 128 or 256):
// the Y tile's rows BN, the ring's stages, and the byte offsets of the
// resident tile, the ring, X's vectors, the stages' vectors and the
// mbarriers. 165 KB at KW 128, 195 KB at 256: one block an SM.
template <int KW>
struct Geom {
  static constexpr int BN = KW <= 128 ? 128 : 64;
  static constexpr int NST = 4;
  static constexpr uint32_t X_BYTES = XR * KW * 2, Y_BYTES = BN * KW * 2;
  static constexpr uint32_t RING = X_BYTES;
  static constexpr uint32_t XVEC = RING + NST * Y_BYTES;
  static constexpr uint32_t YVEC = XVEC + 2 * XR * 4;
  static constexpr uint32_t BARS = YVEC + NST * 2 * BN * 4;
  static constexpr uint32_t TOTAL = BARS + (2 * NST + 1) * 8;
};

// A tile of ROWS rows into shared memory at dst, completing on bar. Row
// form (P, or W in "ed"): rows r0.. of the map, one box of ROWS rows x 64
// columns a sub-tile, ROWS * 128 bytes apart. Column form (W in "de"):
// entities r0.. as columns of the [d, E] map, one box of KW feature rows x
// 64 entities a sub-tile, KW * 128 bytes apart.
template <int KW, int ROWS, bool COLS>
__device__ inline void load_tile(uint32_t dst, const CUtensorMap* map,
                                 uint32_t bar, int r0) {
  if constexpr (COLS) {
#pragma unroll
    for (int s = 0; s < ROWS / 64; ++s)
      tma_load_2d(dst + s * KW * 128, map, bar, r0 + 64 * s, 0);
  } else {
#pragma unroll
    for (int s = 0; s < KW / 64; ++s)
      tma_load_2d(dst + s * ROWS * 128, map, bar, 64 * s, r0);
  }
}

// A tile's vectors, two arrays of n 4-byte entries: a (float) and id. The
// entity side: a = bias * log2(e) (0 past E), id = the entity. The batch
// side: a = -lse * log2(e) (0 in K5 and past B), id = the label (-1 past B
// and in K5). p's onehot fires where a row's id equals a column's.
__device__ void stage_ent(unsigned char* v, int n, const float* bias, int e0,
                          int E, int lane) {
  float* a = reinterpret_cast<float*>(v);
  int* id = reinterpret_cast<int*>(a + n);
  for (int i = lane; i < n; i += 32) {
    a[i] = e0 + i < E ? bias[e0 + i] * L2E : 0.0f;
    id[i] = e0 + i;
  }
}

__device__ void stage_batch(unsigned char* v, int n, const float* lse,
                            const int* lab, int r0, int B, int lane) {
  float* a = reinterpret_cast<float*>(v);
  int* id = reinterpret_cast<int*>(a + n);
  for (int i = lane; i < n; i += 32) {
    const bool in = r0 + i < B;
    a[i] = in && lse != nullptr ? -lse[r0 + i] * L2E : 0.0f;
    id[i] = in && lab != nullptr ? lab[r0 + i] : -1;
  }
}

// z[64 x BN] = X[the warpgroup's 64 rows] . Y^T over KW of depth. xs: the
// warpgroup's rows of X (row form: in its first sub-tile; column form: its
// own sub-tile), ys: the stage. A row-form operand is K-major (16 deep a
// step, 32 bytes on within the row), a column-form one MN-major (2048
// bytes a step, sub-tiles KW * 128 bytes apart).
template <int KW, bool X_COLS, bool Y_COLS>
__device__ inline void z_mma(float (&z)[Geom<KW>::BN / 2], uint32_t xs,
                             uint32_t ys) {
  constexpr int BN = Geom<KW>::BN;
  fence_regs(z);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t a =
        X_COLS ? wgmma_desc(xs + kk * 2048, KW * 128, 1024)
               : wgmma_desc(xs + (kk / 4) * (XR * 128) + off, 16, 1024);
    const uint64_t b =
        Y_COLS ? wgmma_desc(ys + kk * 2048, KW * 128, 1024)
               : wgmma_desc(ys + (kk / 4) * (BN * 128) + off, 16, 1024);
    Wgmma<BN>::template ss<X_COLS, Y_COLS>(z, a, b, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(z);
}

// acc[64 x KW] += p[64 x BN] . Y, p rounded to bf16 in registers (16
// columns a step) and Y read with its depth (the rows of z's columns) as
// K: a row-form Y (P, or W in "ed") is MN-major, 16 rows (2048 bytes) a
// step; a column-form Y (W in "de") K-major, 16 entities (32 bytes) a step
// within its 64-entity sub-tiles.
template <int KW, bool Y_COLS>
__device__ inline void acc_mma(float (&acc)[KW / 2],
                               const float (&p)[Geom<KW>::BN / 2],
                               uint32_t ys) {
  constexpr int BN = Geom<KW>::BN, KS = BN / 16;
  uint32_t pa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(p[8 * s + 2 * q], p[8 * s + 2 * q + 1]);
      pa[s][q] = *reinterpret_cast<const uint32_t*>(&h);
    }
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint64_t b =
        Y_COLS ? wgmma_desc(ys + (s / 4) * (KW * 128) + (s % 4) * 32, 16, 1024)
               : wgmma_desc(ys + s * 2048, BN * 128, 1024);
    Wgmma<KW>::template rs<!Y_COLS>(acc, pa[s], b);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// ---- The softmax on the accumulator fragments --------------------------------
// A thread holds rows xr, xr + 8 of its warpgroup's 64 and, of every
// 8-column block j of the tile, columns 8 j + 2 tq and + 1: z[4 j + e] is
// row e / 2, column e % 2. yv / yi are the stage's column vectors, y0 the
// tile's first column, ny the columns that exist; EDGE: the tile may pass
// ny (else its range test is skipped).

// K5: fold the tile into each row's running (max, sumexp), in log2 units.
template <int BN, bool EDGE>
__device__ inline void fold_lse(float (&z)[BN / 2], const float* yv, int y0,
                                int ny, int tq, float (&m_run)[2],
                                float (&s_run)[2]) {
  float mx[2] = {MASKED2, MASKED2};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 ca = *reinterpret_cast<const float2*>(yv + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool kept = !EDGE || y0 + col + (e & 1) < ny;
      const float s =
          kept ? fmaf(z[4 * j + e], L2E, (e & 1) ? ca.y : ca.x) : MASKED2;
      z[4 * j + e] = s;
      mx[h] = fmaxf(mx[h], s);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {     // the quad of lanes that share the row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m_run[h], mx[h]);
    s_run[h] *= ex2(m_run[h] - mn);
    m_run[h] = mn;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_run[e >> 1] += ex2(z[4 * j + e] - m_run[e >> 1]);
}

// K6: p = exp(z + bias - lse) - onehot into z, 0 past the edge; the row's
// and the column's a sum to (bias - lse) log2(e). SUMS (DW) also sums p
// over the tile's columns into rsum.
template <int BN, bool SUMS, bool EDGE>
__device__ inline void probs(float (&z)[BN / 2], const float* yv,
                             const int* yi, int y0, int ny,
                             const float (&ra)[2], const int (&rid)[2],
                             int tq, float (&rsum)[2]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 ca = *reinterpret_cast<const float2*>(yv + col);
    const int2 cid = *reinterpret_cast<const int2*>(yi + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool kept = !EDGE || y0 + col + (e & 1) < ny;
      const float a = ra[h] + ((e & 1) ? ca.y : ca.x);
      const float hot = ((e & 1) ? cid.y : cid.x) == rid[h] ? 1.0f : 0.0f;
      const float p = kept ? ex2(fmaf(z[4 * j + e], L2E, a)) - hot : 0.0f;
      z[4 * j + e] = p;
      if constexpr (SUMS) rsum[h] += p;
    }
  }
}

// ---- K7's update in the epilogue -----------------------------------------
constexpr int CONSUMERS = 256;     // the two consumer warpgroups' threads

// The consumers' barrier (the producer warpgroup has exited by then).
__device__ inline void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// G's tile in shared memory in W's layout, its row strides padded so that
// the accumulator fragments' stores and the update's reads miss each
// other's banks: "de" [KW features][XR + 4 entities], "ed" [XR entities][KW
// + 8 features].
constexpr int LDE = XR + 4;
template <int KW>
constexpr int LDD = KW + 8;
template <int KW, bool DE>
constexpr uint32_t G_BYTES = (DE ? KW * LDE : XR * LDD<KW>) * 4;

// The update of the block's entity tile (entities x0.., features < d) from
// G in shared memory, by consumer thread t: "de" walks each feature's run
// of XR entities, "ed" each entity's row of features, so that W and its
// slots are read and written in whole runs. U elements' loads are in
// flight before any store (a store may alias a later element's load, so the
// compiler would not hoist the loads itself). Returns t's sum of G^2.
template <int KW, bool DE, typename WT>
__device__ inline float apply_tile(const float* Gs, const Update<WT>& up,
                                   int x0, int E, int d, int t) {
  constexpr int U = 8, N = KW * XR;
  float sq = 0.0f;
  for (int i0 = t; i0 < N; i0 += U * CONSUMERS) {
    long long at[U];
    float gv[U];
    Elem e[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * CONSUMERS;
      const int r = DE ? i % XR : i / KW, k = DE ? i / XR : i % KW;
      at[q] = -1;
      if (k < d && x0 + r < E) {
        at[q] = DE ? (long long)k * E + x0 + r : (long long)(x0 + r) * d + k;
        gv[q] = Gs[DE ? k * LDE + r : r * LDD<KW> + k];
        e[q] = load_elem(up, at[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (at[q] >= 0) sq = store_update(up, at[q], gv[q], e[q], sq);
  }
  return sq;
}

// ---- The sweep ---------------------------------------------------------------
// Grid (X tiles of 128 rows, parts); part y covers Y tiles [y per, (y + 1)
// per) of BN rows. tx / ty: the maps of X and Y (P's boxes of 128 or BN
// rows; W's of 128 or BN entity rows in "ed", of KW feature rows x 64
// entities in "de"). FWD writes out / out2 = running max (natural log
// units) / sumexp [parts, B]; DP the dpooled partials out [parts, B, dp]; DW
// with one slice dW = g acc into out (W's layout, [E, d] or [d, E]) and
// db = g sum p into out2 [E], with S slices the unscaled partials into out
// [S, Ex, dp] (Ex = the entity tiles x 128) and out2 [S, Ex]. APPLY: with
// one slice W and its slots updated in place through up, db unscaled into
// out2 [E] and the tile's sum of G^2 into up.gsq[blockIdx.x]; with S
// slices DW's partials.
template <int KW, int MODE, bool DE, typename WT = float>
__global__ void __launch_bounds__(THREADS_WS, 1)
xent_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap ty,
                  const float* __restrict__ bias,
                  const float* __restrict__ lse, const int* __restrict__ lab,
                  const float* __restrict__ g, float* __restrict__ out,
                  float* __restrict__ out2, int B, int E, int d, int dp,
                  int per, Update<WT> up) {
  using G = Geom<KW>;
  constexpr int BN = G::BN, NST = G::NST;
  constexpr bool XE = MODE == DW || MODE == APPLY;   // X: an entity tile
  static_assert(G_BYTES<KW, DE> <= G::XVEC, "G's tile fits X and the ring");
  constexpr bool X_COLS = XE && DE, Y_COLS = !XE && DE;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int nx = XE ? E : B, ny = XE ? B : E;
  const int x0 = blockIdx.x * XR;
  const int yt0 = blockIdx.y * per;
  const int n_tiles = min(per, (ny + BN - 1) / BN - yt0);
  const uint32_t full = base + G::BARS, empty = full + 8 * NST,
                 xbar = full + 16 * NST;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    if (base & 1023) __trap();     // the swizzled tiles need 1 KB alignment
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 32);     // the producer warp's lanes
      mbar_init(empty + 8 * s, 8);     // the consumer warps
    }
    mbar_init(xbar, 32);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: warp 0 stages X and its vectors, then streams the Y
    // tiles, each into the next stage once the consumers have released it.
    setmaxnreg_dec<40>();
    if (tid >= 32) return;
    const int lane = tid;
    if constexpr (XE)
      stage_ent(smem + G::XVEC, XR, bias, x0, E, lane);
    else
      stage_batch(smem + G::XVEC, XR, lse, lab, x0, B, lane);
    if (lane == 0) {
      mbar_arrive_tx(xbar, G::X_BYTES);
      load_tile<KW, XR, X_COLS>(base, &tx, xbar, x0);
    } else {
      mbar_arrive(xbar);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % NST;
      const uint32_t bar = full + 8 * st;
      mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
      const int y0 = (yt0 + i) * BN;
      unsigned char* v = smem + G::YVEC + st * 2 * BN * 4;
      if constexpr (XE)
        stage_batch(v, BN, lse, lab, y0, B, lane);
      else
        stage_ent(v, BN, bias, y0, E, lane);
      if (lane == 0) {
        mbar_arrive_tx(bar, G::Y_BYTES);
        load_tile<KW, BN, Y_COLS>(base + G::RING + st * G::Y_BYTES, &ty, bar,
                                  y0);
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  // The consumers: warpgroup c owns X rows 64 c ..; this thread rows xr and
  // xr + 8 of them, columns 8 j + 2 tq (+ 1) of each 8-column block j.
  setmaxnreg_inc<232>();
  const int c = wg - 1, w = (tid / 32) % 4, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int xr = 64 * c + 16 * w + gq;
  const uint32_t xs = base + c * (X_COLS ? KW * 128 : 64 * 128);
  mbar_wait(xbar, 0);
  float ra[2];
  int rid[2];
  {
    const float* xv = reinterpret_cast<const float*>(smem + G::XVEC);
    const int* xi = reinterpret_cast<const int*>(xv + XR);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ra[h] = xv[xr + 8 * h];
      rid[h] = xi[xr + 8 * h];
    }
  }
  constexpr int NACC = MODE == FWD ? 2 : KW / 2;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, s_run[2] = {0.0f, 0.0f};
  float rsum[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NST;
    mbar_wait(full + 8 * st, (i / NST) & 1);
    const uint32_t ys = base + G::RING + st * G::Y_BYTES;
    float z[BN / 2];
    z_mma<KW, X_COLS, Y_COLS>(z, xs, ys);

    // The columns' vectors; only a part's last tile can pass the edge.
    const int y0 = (yt0 + i) * BN;
    const float* yv = reinterpret_cast<const float*>(smem + G::YVEC +
                                                     st * 2 * BN * 4);
    const int* yi = reinterpret_cast<const int*>(yv + BN);
    const bool inside = y0 + BN <= ny;
    if constexpr (MODE == FWD) {
      if (inside)
        fold_lse<BN, false>(z, yv, y0, ny, tq, m_run, s_run);
      else
        fold_lse<BN, true>(z, yv, y0, ny, tq, m_run, s_run);
    } else {
      if (inside)
        probs<BN, XE, false>(z, yv, yi, y0, ny, ra, rid, tq, rsum);
      else
        probs<BN, XE, true>(z, yv, yi, y0, ny, ra, rid, tq, rsum);
      acc_mma<KW, Y_COLS>(acc, z, ys);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // The epilogue: this thread's rows x0 + xr (+ 8).
  if constexpr (MODE == FWD) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_run[h] += __shfl_xor_sync(0xffffffffu, s_run[h], 1);
      s_run[h] += __shfl_xor_sync(0xffffffffu, s_run[h], 2);
      const int row = x0 + xr + 8 * h;
      if (tq == 0 && row < nx) {
        out[size_t(blockIdx.y) * nx + row] = m_run[h] * LN2;
        out2[size_t(blockIdx.y) * nx + row] = s_run[h];
      }
    }
  } else if constexpr (MODE == DP) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = x0 + xr + 8 * h;
      if (row >= nx) continue;
      float* o = out + (size_t(blockIdx.y) * nx + row) * dp;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < dp)
          *reinterpret_cast<float2*>(o + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  } else {
    const int S = gridDim.y;
    const size_t Ex = size_t(gridDim.x) * XR;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
    }
    if (S > 1) {                    // slice s's partials, unscaled
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = x0 + xr + 8 * h;
        if (row >= nx) continue;
        float* o = out + (size_t(blockIdx.y) * Ex + row) * dp;
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          if (col < dp)
            *reinterpret_cast<float2*>(o + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
        if (tq == 0) out2[size_t(blockIdx.y) * Ex + row] = rsum[h];
      }
    } else if constexpr (MODE == DW) {
      // One slice: dW = g acc in W's layout, db = g sum p.
      const float gs = *g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = x0 + xr + 8 * h;
        if (row >= nx) continue;
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          const float v0 = gs * acc[4 * j + 2 * h];
          const float v1 = gs * acc[4 * j + 2 * h + 1];
          if constexpr (DE) {
            if (col < d) out[size_t(col) * E + row] = v0;
            if (col + 1 < d) out[size_t(col + 1) * E + row] = v1;
          } else {
            float* o = out + size_t(row) * d + col;
            if ((d & 1) == 0 && col + 1 < d) {
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              if (col < d) o[0] = v0;
              if (col + 1 < d) o[1] = v1;
            }
          }
        }
        if (tq == 0) out2[row] = gs * rsum[h];
      }
    } else {
      // One slice, APPLY: db unscaled; G = gscale acc (rounded as xent.cu
      // rounds it) into shared memory in W's layout, once every product
      // has read the ring and X; then the tile's update and its sum of G^2
      // over the consumer warps in a fixed order.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = x0 + xr + 8 * h;
        if (tq == 0 && row < nx) out2[row] = rsum[h];
      }
      float* Gs = reinterpret_cast<float*>(smem);
      consumers_sync();
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = xr + 8 * h, k = 8 * j + 2 * tq;
          const float v0 = __fmul_rn(acc[4 * j + 2 * h], up.gscale);
          const float v1 = __fmul_rn(acc[4 * j + 2 * h + 1], up.gscale);
          if constexpr (DE) {
            Gs[k * LDE + r] = v0;
            Gs[(k + 1) * LDE + r] = v1;
          } else {
            *reinterpret_cast<float2*>(Gs + r * LDD<KW> + k) =
                make_float2(v0, v1);
          }
        }
      consumers_sync();
      const int t = tid - 128;
      float sq = apply_tile<KW, DE>(Gs, up, x0, E, d, t);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      float* red = reinterpret_cast<float*>(smem + G::YVEC);
      if (lane == 0) red[t / 32] = sq;
      consumers_sync();
      if (t == 0) {
        float total = 0.0f;
        for (int w = 0; w < CONSUMERS / 32; ++w) total += red[w];
        up.gsq[blockIdx.x] = total;
      }
    }
  }
}

// K6's sum of S > 1 dW slices: dW = g sum_s part[s] in W's layout ([E, d]
// "ed", [d, E] "de") and db = g sum_s dbpart[s], each summed in slice order
// (no atomics, so two calls give the same bits).
__global__ void __launch_bounds__(256)
xent_wgmma_reduce_kernel(const float* __restrict__ part,
                         const float* __restrict__ dbpart,
                         const float* __restrict__ g, float* __restrict__ dW,
                         float* __restrict__ db, int E, int d, int dp, int Ex,
                         int S, int de) {
  const size_t n = size_t(E) * d, slice = size_t(Ex) * dp;
  const float gs = *g;
  for (size_t i = size_t(blockIdx.x) * 256 + threadIdx.x; i < n + E;
       i += size_t(gridDim.x) * 256) {
    const float* src;
    size_t stride;
    if (i < n) {
      const size_t j = de ? i % E : i / d, k = de ? i / E : i % d;
      src = part + j * dp + k;
      stride = slice;
    } else {
      src = dbpart + (i - n);
      stride = Ex;
    }
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += src[s * stride];
    if (i < n) dW[i] = gs * acc;
    else db[i - n] = gs * acc;
  }
}

// K7's sum of S > 1 slices, with the update: one block an entity tile of XR
// sums the tile's S partials of each element in slice order, as
// xent_wgmma_reduce_kernel does (so G = gscale sum is K6's dW at g =
// gscale, bit for bit), applies the update from G in place in W's layout,
// and writes db unscaled and the tile's sum of G^2. RA_THREADS threads a
// block, each with U elements' loads in flight before it stores any (as
// apply_tile).
constexpr int RA_THREADS = 1024;
template <typename WT>
__global__ void __launch_bounds__(RA_THREADS)
xent_wgmma_reduce_apply_kernel(const float* __restrict__ part,
                               const float* __restrict__ dbpart,
                               float* __restrict__ db, int E, int d, int dp,
                               int Ex, int S, int de, Update<WT> up) {
  constexpr int U = 4;
  __shared__ float red[RA_THREADS / 32];
  const int j0 = blockIdx.x * XR, n = XR * d;
  const size_t slice = size_t(Ex) * dp;
  float sq = 0.0f;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * RA_THREADS) {
    long long at[U];
    float gv[U];
    Elem e[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * RA_THREADS;
      const int r = de ? i % XR : i / d, k = de ? i / XR : i % d;
      at[q] = -1;
      if (i < n && j0 + r < E) {
        const float* src = part + size_t(j0 + r) * dp + k;
        float acc = 0.0f;
        for (int s = 0; s < S; ++s) acc += src[s * slice];
        at[q] = de ? (long long)k * E + j0 + r : (long long)(j0 + r) * d + k;
        gv[q] = __fmul_rn(acc, up.gscale);
        e[q] = load_elem(up, at[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (at[q] >= 0) sq = store_update(up, at[q], gv[q], e[q], sq);
  }
  const int t = threadIdx.x;
  if (t < XR && j0 + t < E) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += dbpart[size_t(s) * Ex + j0 + t];
    db[j0 + t] = acc;
  }
  const float total = block_sum<RA_THREADS / 32>(sq, red);
  if (t == 0) up.gsq[blockIdx.x] = total;
}

// ---- Host side -----------------------------------------------------------------
// The pointers of one launch: P [B, dp] and W's bf16 operand ("ed" [E, d],
// "de" [d, E], rows ldw elements apart), the vectors, and the mode's
// outputs.
struct Args {
  const void* P;
  const void* W;
  const float* bias;
  const float* lse;
  const int* lab;
  const float* g;
  float* out;
  float* out2;
  int B, E, d, dp;
  long long ldw;
};

template <int KW, int MODE, bool DE, typename WT>
cudaError_t launch(const Args& a, int per, int parts, int ytile,
                   cudaStream_t stream, const Update<WT>& up) {
  using G = Geom<KW>;
  if (ytile != G::BN) return cudaErrorInvalidValue;   // the plan's Y tile
  constexpr bool XE = MODE == DW || MODE == APPLY;
  CUtensorMap tp, tw;
  cudaError_t err = make_map<__nv_bfloat16>(&tp, a.P, a.B, a.dp,
                                            XE ? G::BN : XR);
  if (err != cudaSuccess) return err;
  err = DE ? make_map<__nv_bfloat16>(&tw, a.W, a.d, a.E, KW, a.ldw)
           : make_map<__nv_bfloat16>(&tw, a.W, a.E, a.d, XE ? XR : G::BN,
                                     a.ldw);
  if (err != cudaSuccess) return err;
  auto kernel = xent_wgmma_kernel<KW, MODE, DE, WT>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::TOTAL));
  if (err != cudaSuccess) return err;
  const int nx = XE ? a.E : a.B;
  kernel<<<dim3((nx + XR - 1) / XR, parts), THREADS_WS, G::TOTAL, stream>>>(
      XE ? tw : tp, XE ? tp : tw, a.bias, a.lse, a.lab, a.g, a.out, a.out2,
      a.B, a.E, a.d, a.dp, per, up);
  return cudaGetLastError();
}

// The kernel width for the padded d (64, 128 or 256) and W's layout; `up`
// is APPLY's update (W's storage type WT), unused by the other modes.
template <int MODE, typename WT = float>
cudaError_t launch_mode(const Args& a, bool de, int per, int parts,
                        int ytile, cudaStream_t stream,
                        const Update<WT>& up = Update<WT>{}) {
  if (a.dp <= 64)
    return de ? launch<64, MODE, true>(a, per, parts, ytile, stream, up)
              : launch<64, MODE, false>(a, per, parts, ytile, stream, up);
  if (a.dp <= 128)
    return de ? launch<128, MODE, true>(a, per, parts, ytile, stream, up)
              : launch<128, MODE, false>(a, per, parts, ytile, stream, up);
  return de ? launch<256, MODE, true>(a, per, parts, ytile, stream, up)
            : launch<256, MODE, false>(a, per, parts, ytile, stream, up);
}

// K7's launches after its dpooled: the APPLY sweep and, with S > 1 slices,
// the ordered sum of its partials (a.out) that applies the update.
template <typename WT>
cudaError_t launch_apply(const Args& a, bool de, int per, int n_slices,
                         int ytile, float* db, const Update<WT>& up,
                         cudaStream_t stream) {
  cudaError_t err =
      launch_mode<APPLY, WT>(a, de, per, n_slices, ytile, stream, up);
  if (err != cudaSuccess || n_slices == 1) return err;
  const int Ex = (a.E + XR - 1) / XR * XR;
  xent_wgmma_reduce_apply_kernel<WT><<<Ex / XR, RA_THREADS, 0, stream>>>(
      a.out, a.out2, db, a.E, a.d, a.dp, Ex, n_slices, int(de), up);
  return cudaGetLastError();
}

}  // namespace

// K5 in bf16 compute. P [B, dp] bf16, dp a multiple of 64 and <= 256, rows
// 16-byte aligned, zero past d; W's bf16 operand at a 16-byte-aligned
// address, [E, d] ("ed", de = 0) or [d, E] (de = 1) with rows ldw elements
// apart, ldw a multiple of 8; bias [E] fp32. Writes m_out / s_out
// [n_chunks, B]; chunk c covers entity tiles [c per, ...) of `ytile` rows,
// which must be the kernel's own Y tile for the width (ops/xent.py
// _wgmma_plan). The Python wrapper checks every shape and type. Returns
// the cudaError_t.
extern "C" int sert_xent_wgmma_fwd(const void* P, const void* W,
                                   const void* bias, void* m_out,
                                   void* s_out, int B, int E, int d, int dp,
                                   long long ldw, int de, int per,
                                   int n_chunks, int ytile, void* stream) {
  const Args a{P, W, static_cast<const float*>(bias), nullptr, nullptr,
               nullptr, static_cast<float*>(m_out),
               static_cast<float*>(s_out), B, E, d, dp, ldw};
  return int(launch_mode<FWD>(a, de != 0, per, n_chunks, ytile,
                              cudaStream_t(stream)));
}

// K6 in bf16 compute: as K5, plus lse [B] fp32, labels [B] int32 (-1: no
// gold entity here) and g, one fp32 scalar on the device. The dW sweep
// (entity tiles resident, batch tiles of `ytile` rows in n_slices slices of
// per_dw) writes dW fp32 in W's layout and shape ([E, d] or [d, E], rows d
// or E apart) and db [E], both times g; with n_slices > 1 it writes its
// partials into `scratch` (n_slices * Ex * (dp + 1) floats, Ex = E rounded
// up to 128) and a second kernel sums them. The dpooled sweep (K5's
// chunks) writes the unscaled partials part [n_chunks, B, dp], which the
// caller sums over the chunk axis.
extern "C" int sert_xent_wgmma_bwd(const void* P, const void* W,
                                   const void* bias, const void* lse,
                                   const void* lab, const void* g, void* dW,
                                   void* db, void* part, void* scratch,
                                   int B, int E, int d, int dp,
                                   long long ldw, int de, int per_dp,
                                   int n_chunks, int per_dw, int n_slices,
                                   int ytile, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  const int Ex = (E + XR - 1) / XR * XR;
  float* sp = static_cast<float*>(scratch);
  const bool split = n_slices > 1;
  Args a{P, W, static_cast<const float*>(bias),
         static_cast<const float*>(lse), static_cast<const int*>(lab),
         static_cast<const float*>(g),
         split ? sp : static_cast<float*>(dW),
         split ? sp + size_t(n_slices) * Ex * dp : static_cast<float*>(db),
         B, E, d, dp, ldw};
  cudaError_t err = launch_mode<DW>(a, de != 0, per_dw, n_slices, ytile, st);
  if (err != cudaSuccess) return int(err);
  if (split) {
    const size_t n = size_t(E) * d + E;
    const int blocks = int(std::min<size_t>((n + 255) / 256, size_t(8) * 132));
    xent_wgmma_reduce_kernel<<<blocks, 256, 0, st>>>(
        sp, sp + size_t(n_slices) * Ex * dp, static_cast<const float*>(g),
        static_cast<float*>(dW), static_cast<float*>(db), E, d, dp, Ex,
        n_slices, de);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  a.out = static_cast<float*>(part);
  a.out2 = nullptr;
  return int(launch_mode<DP>(a, de != 0, per_dp, n_chunks, ytile, st));
}

// K6's dpooled sweep alone, as sert_xent_wgmma_bwd runs it: K7's dpooled in
// bf16 compute, launched before sert_xent_wgmma_apply (it reads all of W,
// which the update overwrites), so that K6 and K7 give the same dpooled bit
// for bit.
extern "C" int sert_xent_wgmma_dpooled(const void* P, const void* W,
                                       const void* bias, const void* lse,
                                       const void* lab, void* part, int B,
                                       int E, int d, int dp, long long ldw,
                                       int de, int per, int n_chunks,
                                       int ytile, void* stream) {
  const Args a{P, W, static_cast<const float*>(bias),
               static_cast<const float*>(lse), static_cast<const int*>(lab),
               nullptr, static_cast<float*>(part), nullptr, B, E, d, dp,
               ldw};
  return int(launch_mode<DP>(a, de != 0, per, n_chunks, ytile,
                             cudaStream_t(stream)));
}

// K7 in bf16 compute, after sert_xent_wgmma_dpooled on the same stream: K6's
// dW sweep with adam (opt 0; s1 = m, s2 = v), adagrad (1; s1 = acc) or sgd
// (2; no slots) applied to W in place of the dW store. P, W's bf16 operand
// `Wop`, bias, lse, labels, the plan (per, n_slices, ytile) and `scratch`
// are sert_xent_wgmma_bwd's dW sweep's; `W` is W itself in its storage
// type (bf16 when w_bf16 is nonzero, else fp32; it is Wop where W is a bf16
// operand already), [E, d] ("ed") or [d, E] ("de"), contiguous, and the
// slots have its shape and type. lr is the learning rate, gscale the
// factor from the summed loss's dW to the update's gradient, bc1 and bc2
// adam's bias corrections 1 - 0.9^t and 1 - 0.999^t. Writes db [E]
// unscaled and gsq [Ex / 128], each entity tile's sum of (gscale dW)^2.
extern "C" int sert_xent_wgmma_apply(const void* P, const void* Wop,
                                     void* W, const void* bias,
                                     const void* lse, const void* lab,
                                     void* s1, void* s2, void* db, void* gsq,
                                     void* scratch, int B, int E, int d,
                                     int dp, long long ldw, int de, int per,
                                     int n_slices, int ytile, int opt,
                                     float lr, float gscale, float bc1,
                                     float bc2, int w_bf16, void* stream) {
  const int Ex = (E + XR - 1) / XR * XR;
  float* sp = static_cast<float*>(scratch);
  const bool split = n_slices > 1;
  const Args a{P, Wop, static_cast<const float*>(bias),
               static_cast<const float*>(lse), static_cast<const int*>(lab),
               nullptr, split ? sp : nullptr,
               split ? sp + size_t(n_slices) * Ex * dp
                     : static_cast<float*>(db),
               B, E, d, dp, ldw};
  auto go = [&](auto wt) {
    using WT = decltype(wt);
    const Update<WT> u{static_cast<WT*>(W), static_cast<WT*>(s1),
                       static_cast<WT*>(s2), static_cast<float*>(gsq), opt,
                       lr, gscale, bc1, bc2};
    return int(launch_apply<WT>(a, de != 0, per, n_slices, ytile,
                                static_cast<float*>(db), u,
                                cudaStream_t(stream)));
  };
  return w_bf16 ? go(__nv_bfloat16()) : go(0.0f);
}
