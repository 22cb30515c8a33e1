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
//   K2: p = g[b] * exp(z - lse[b]) (0 where masked);  dC = p^T R,
//       dcorr = -sum_b p,  dreps = p C,  with p rounded to the compute type
//       before both products (the reference's cast points).
// The [B, k] logits never reach device memory, nor shared memory: every
// tile of them lives in the accumulator registers of the warpgroup that
// made it.
//
// What bounds it on the H100. At the flagship shape (B = 4096, k = 32768,
// d = 128, bf16) one product is 2 B k d = 34 GFLOP, 0.035 ms at the bf16
// tensor-core peak. K1 makes one, K2 four (z in each of its two sweeps,
// then dC and dreps), while the inputs are a few MB, so the products bound
// them; the recompute of z is the price of keeping 512 MB of fp32 logits
// out of memory. The exponentials are a second floor: B k = 134M of them a
// sweep, 0.032 ms at the 16 a clock of each SM's special-function units,
// about as long as the sweep's products. So a sweep must keep the tensor
// cores fed while it exponentiates.
//
// The design. One sweep kernel, slse_sweep_kernel, in three modes. A block
// keeps a resident tile X of 128 rows in shared memory and streams the
// tiles Y of the other operand through a ring of stages:
//   FWD (K1)    X = a batch tile of R, Y = the candidate tiles of one chunk
//               of C: z = X Y^T and each row's running (max, sumexp);
//   DREPS (K2)  the same tiles: p from z, acc += p Y (dreps partials);
//   DC (K2)     X = a candidate tile of C, Y = the batch tiles of one slice
//               of R: z = X Y^T is z^T, p^T from it, acc += p^T Y (dC
//               partials) and the row sums of p^T (dcorr partials).
// Each Y tile is loaded once and serves both of its products. Warp
// specialization: one producer warp issues TMA loads of Y's sub-tiles
// (128-byte swizzle, zeros past B and k, so 0 * NaN never reaches a
// product) into the ring with full / empty mbarriers, and stages each
// tile's small vectors (corr and ids; pos, lse and g) beside it; two
// consumer warpgroups each own 64 rows of X. In bf16 both products run on
// wgmma: z from shared memory (X and Y K-major), then p converted to bf16
// in registers (the accumulator layout is the A-fragment layout) and fed
// as wgmma's register operand, with Y read MN-major through the
// descriptor's transpose bit. In fp32 they run as 3xTF32 on mma.sync
// (mma_sync.cuh's fragments, read from the same swizzled stages, x = hi +
// lo split at load), never on the CUDA cores. The softmax works on the
// accumulator fragments: masks from the staged vectors before the
// exponential, exp2 of a log2(e)-scaled argument, K1's row max reduced
// across the quad of lanes that share a row. The consumers ask for most of
// the registers (setmaxnreg: 232 a thread, the producer warpgroup 40), but
// ptxas still allocates the block's 168 a thread: the bf16 modes at d <=
// 128 fit, d = 256 and the fp32 acc modes spill a little (PERF.md). At
// d = 256 the Y tile narrows to 64 rows (bf16) so that the accumulator (128
// registers) fits beside z.
//
// Determinism: no float atomics. A shape-only plan (ops/sampled_lse.py
// _plan) splits the Y tiles into chunks (FWD, DREPS) or slices (DC) so
// that the blocks fill the card; each block walks its own in order, and
// the caller merges or sums the partials in a fixed order. Rows past B and
// candidates past k contribute nothing; an all-masked row has p = 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int XR = 128;            // rows of the resident tile X
constexpr int THREADS_WS = 384;    // a producer and two consumer warpgroups
constexpr float L2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED2 = -1e30f * L2E;   // the reference's -1e30, x log2(e)

enum Mode : int { FWD = 0, DREPS = 1, DC = 2 };

// One block's geometry for compute type T and kernel width KW (the padded
// d rounded up to 64, 128 or 256): sub-tiles of 128 bytes of width, the Y
// tile's rows BN, the ring's stages, and the byte offsets of the resident
// tile, the ring, X's vectors, the stages' vectors and the mbarriers.
// bf16: 160 KB at KW 128, 192 KB at 256; fp32: up to 227 KB. One block an
// SM.
template <typename T, int KW>
struct Geom {
  static constexpr int EL = 128 / int(sizeof(T));   // elements a sub-tile row
  static constexpr int NSUB = KW / EL;
  static constexpr int BN = sizeof(T) == 2 ? (KW <= 128 ? 128 : 64)
                                           : (KW <= 64 ? 128 : KW <= 128 ? 64
                                                                         : 32);
  static constexpr int NST = sizeof(T) == 4 && KW == 256 ? 3 : 4;
  static constexpr uint32_t X_SUB = XR * 128, Y_SUB = BN * 128;
  static constexpr uint32_t X_BYTES = NSUB * X_SUB, Y_BYTES = NSUB * Y_SUB;
  static constexpr uint32_t RING = X_BYTES;
  static constexpr uint32_t XVEC = RING + NST * Y_BYTES;
  static constexpr uint32_t YVEC = XVEC + 3 * XR * 4;
  static constexpr uint32_t BARS = YVEC + NST * 3 * BN * 4;
  static constexpr uint32_t TOTAL = BARS + (2 * NST + 1) * 8;
};

// A tile's vectors, three arrays of n 4-byte entries: a, b (floats) and id.
// The candidate side: a = -corr * log2(e), id = the candidate id. The batch
// side: a = -lse * log2(e) and b = g (K2 only; 0 in K1), id = the positive
// id. Rows past k or B get a = b = 0 and id = -1: their columns are masked
// by range, their rows never stored.
__device__ void stage_cand(unsigned char* v, int n, const float* corr,
                           const int* ids, int r0, int k, int lane) {
  float* a = reinterpret_cast<float*>(v);
  int* id = reinterpret_cast<int*>(a + 2 * n);
  for (int i = lane; i < n; i += 32) {
    const bool in = r0 + i < k;
    a[i] = in ? -corr[r0 + i] * L2E : 0.0f;
    id[i] = in ? ids[r0 + i] : -1;
  }
}

__device__ void stage_batch(unsigned char* v, int n, const int* pos,
                            const float* lse, const float* g, int r0, int B,
                            int lane) {
  float* a = reinterpret_cast<float*>(v);
  float* b = a + n;
  int* id = reinterpret_cast<int*>(a + 2 * n);
  for (int i = lane; i < n; i += 32) {
    const bool in = r0 + i < B;
    id[i] = in ? pos[r0 + i] : -1;
    a[i] = in && lse != nullptr ? -lse[r0 + i] * L2E : 0.0f;
    b[i] = in && g != nullptr ? g[r0 + i] : 0.0f;
  }
}

// ---- The products, bf16: wgmma -------------------------------------------
// z[64 x BN] = X[64 rows of this warpgroup] . Y^T, both K-major: xs is the
// warpgroup's rows in X's first sub-tile, ys the stage's first sub-tile.
template <typename G>
__device__ inline void z_bf16(float (&z)[G::BN / 2], uint32_t xs,
                              uint32_t ys) {
  fence_regs(z);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G::NSUB * 4; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    Wgmma<G::BN>::ss(z,
                     wgmma_desc(xs + (kk / 4) * G::X_SUB + off, 16, 1024),
                     wgmma_desc(ys + (kk / 4) * G::Y_SUB + off, 16, 1024),
                     kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(z);
}

// acc[64 x KW] += p[64 x BN] . Y, p rounded to bf16 in registers (its
// accumulator layout is the A-fragment layout, 16 columns a step) and Y
// MN-major: 16 rows a step, sub-tiles Y_SUB bytes apart.
template <typename G, int KW>
__device__ inline void acc_bf16(float (&acc)[KW / 2],
                                const float (&p)[G::BN / 2], uint32_t ys) {
  constexpr int KS = G::BN / 16;
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
  for (int s = 0; s < KS; ++s)
    Wgmma<KW>::rs(acc, pa[s], wgmma_desc(ys + s * 2048, G::Y_SUB, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// ---- The products, fp32: 3xTF32 on mma.sync --------------------------------
// Element (row r, column c) of a swizzled sub-tile of fp32: byte 128 r +
// 16 ((c / 4) ^ (r % 8)) + 4 (c % 4).
__device__ inline float swz(const unsigned char* sub, int r, int c) {
  return *reinterpret_cast<const float*>(
      sub + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

__device__ inline void mma3(float* c, const FragA& a,
                            const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// z[16 x BN] of this warp: X rows xrow.. (xrow % 8 == 0) against every Y
// row, 8 columns of depth a step.
template <typename G>
__device__ inline void z_fp32(float (&z)[G::BN / 2], const unsigned char* X,
                              const unsigned char* Y, int xrow) {
  const int gq = lane_g(), tq = lane_t();
#pragma unroll
  for (int i = 0; i < G::BN / 2; ++i) z[i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < G::NSUB * 4; ++kk) {
    const unsigned char* xs = X + (kk / 4) * G::X_SUB;
    const unsigned char* ys = Y + (kk / 4) * G::Y_SUB;
    const int c0 = (kk % 4) * 8 + tq;
    FragA a;
    split(swz(xs, xrow + gq, c0), a.hi[0], a.lo[0]);
    split(swz(xs, xrow + gq + 8, c0), a.hi[1], a.lo[1]);
    split(swz(xs, xrow + gq, c0 + 4), a.hi[2], a.lo[2]);
    split(swz(xs, xrow + gq + 8, c0 + 4), a.hi[3], a.lo[3]);
#pragma unroll
    for (int j = 0; j < G::BN / 8; ++j) {
      FragB b;
      split(swz(ys, 8 * j + gq, c0), b.hi[0], b.lo[0]);
      split(swz(ys, 8 * j + gq, c0 + 4), b.hi[1], b.lo[1]);
      mma3(&z[4 * j], a, b);
    }
  }
}

// acc[16 x KW] += p[16 x BN] . Y. The depth order inside each 8-column
// block of p is permuted so that the fragment is the thread's own
// accumulator values: depth t <-> column 2t, depth t + 4 <-> column 2t + 1
// (and Y's rows alike).
template <typename G, int KW>
__device__ inline void acc_fp32(float (&acc)[KW / 2],
                                const float (&p)[G::BN / 2],
                                const unsigned char* Y) {
  const int gq = lane_g(), tq = lane_t();
#pragma unroll
  for (int j = 0; j < G::BN / 8; ++j) {
    FragA a;
    split(p[4 * j], a.hi[0], a.lo[0]);
    split(p[4 * j + 2], a.hi[1], a.lo[1]);
    split(p[4 * j + 1], a.hi[2], a.lo[2]);
    split(p[4 * j + 3], a.hi[3], a.lo[3]);
    const int r0 = 8 * j + 2 * tq;
#pragma unroll
    for (int nb = 0; nb < KW / 8; ++nb) {
      const int f = 8 * nb + gq;
      const unsigned char* ys = Y + (f / 32) * G::Y_SUB;
      FragB b;
      split(swz(ys, r0, f % 32), b.hi[0], b.lo[0]);
      split(swz(ys, r0 + 1, f % 32), b.hi[1], b.lo[1]);
      mma3(&acc[4 * nb], a, b);
    }
  }
}

// ---- The softmax on the accumulator fragments --------------------------------
// A thread holds rows xr, xr + 8 of its warpgroup's 64 and, of every
// 8-column block j of the tile, columns 8 j + 2 tq and + 1: z[4 j + e] is
// row e / 2, column e % 2. yv / yi are the stage's column vectors, y0 the
// tile's first column, ny the columns that exist; EDGE: the tile may pass
// ny (else its range test is skipped: the softmax's instructions, not the
// tensor cores, set a tile's time).

// K1: fold the tile into each row's running (max, sumexp), in log2 units.
template <int BN, bool EDGE>
__device__ inline void fold_lse(float (&z)[BN / 2], const float* yv,
                                const int* yi, int y0, int ny,
                                const int (&rid)[2], int tq,
                                float (&m_run)[2], float (&s_run)[2]) {
  float mx[2] = {MASKED2, MASKED2};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 ca = *reinterpret_cast<const float2*>(yv + col);
    const int2 cid = *reinterpret_cast<const int2*>(yi + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool kept = (!EDGE || y0 + col + (e & 1) < ny) &&
                        ((e & 1) ? cid.y : cid.x) != rid[h];
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

// K2: p = g exp(z - corr - lse) into z, 0 where masked or past the edge;
// g is the row's (XB: X is the batch) or the column's. SUMS (DC) also sums
// p over the tile's columns into rsum.
template <int BN, bool XB, bool SUMS, bool EDGE>
__device__ inline void probs(float (&z)[BN / 2], const float* yv,
                             const int* yi, int y0, int ny,
                             const float (&ra)[2], const float (&rg)[2],
                             const int (&rid)[2], int tq,
                             float (&rsum)[2]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 ca = *reinterpret_cast<const float2*>(yv + col);
    const int2 cid = *reinterpret_cast<const int2*>(yi + col);
    float2 cg = make_float2(0.0f, 0.0f);
    if constexpr (!XB) cg = *reinterpret_cast<const float2*>(yv + BN + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool kept = (!EDGE || y0 + col + (e & 1) < ny) &&
                        ((e & 1) ? cid.y : cid.x) != rid[h];
      const float a = ra[h] + ((e & 1) ? ca.y : ca.x);
      const float gg = XB ? rg[h] : ((e & 1) ? cg.y : cg.x);
      const float p = kept ? gg * ex2(fmaf(z[4 * j + e], L2E, a)) : 0.0f;
      z[4 * j + e] = p;
      if constexpr (SUMS) rsum[h] += p;
    }
  }
}

// ---- The sweep ---------------------------------------------------------------
// Grid (X tiles of 128 rows, parts); part y covers Y tiles [y per, (y + 1)
// per) of BN rows. tx / ty: R's and C's tensor maps with boxes of 128 and BN
// rows (X, Y roles by mode). FWD writes out / out2 = running max (natural
// log units) / sumexp [parts, B]; DREPS the dreps partials out [parts, B,
// dp]; DC the dC partials out [parts, k, dp] and -sum_b p into out2
// [parts, k].
template <typename T, int KW, int MODE>
__global__ void __launch_bounds__(THREADS_WS, 1)
slse_sweep_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap ty,
                  const float* __restrict__ corr,
                  const int* __restrict__ ids, const int* __restrict__ pos,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  float* __restrict__ out, float* __restrict__ out2, int B,
                  int k, int dp, int per) {
  using G = Geom<T, KW>;
  constexpr int BN = G::BN, NST = G::NST;
  constexpr bool XB = MODE != DC;     // X is a batch tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int nx = XB ? B : k, ny = XB ? k : B;
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
    if constexpr (XB)
      stage_batch(smem + G::XVEC, XR, pos, lse, g, x0, B, lane);
    else
      stage_cand(smem + G::XVEC, XR, corr, ids, x0, k, lane);
    if (lane == 0) {
      mbar_arrive_tx(xbar, G::X_BYTES);
      for (int s = 0; s < G::NSUB; ++s)
        tma_load_2d(base + s * G::X_SUB, &tx, xbar, s * G::EL, x0);
    } else {
      mbar_arrive(xbar);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % NST;
      const uint32_t bar = full + 8 * st;
      mbar_wait(empty + 8 * st, ((i / NST) & 1) ^ 1);
      const int y0 = (yt0 + i) * BN;
      unsigned char* v = smem + G::YVEC + st * 3 * BN * 4;
      if constexpr (XB)
        stage_cand(v, BN, corr, ids, y0, k, lane);
      else
        stage_batch(v, BN, pos, lse, g, y0, B, lane);
      if (lane == 0) {
        mbar_arrive_tx(bar, G::Y_BYTES);
        const uint32_t dst = base + G::RING + st * G::Y_BYTES;
        for (int s = 0; s < G::NSUB; ++s)
          tma_load_2d(dst + s * G::Y_SUB, &ty, bar, s * G::EL, y0);
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
  const int xrow = 64 * c + 16 * w;
  const int xr = xrow + gq;
  mbar_wait(xbar, 0);
  float ra[2], rg[2];
  int rid[2];
  {
    const float* xv = reinterpret_cast<const float*>(smem + G::XVEC);
    const int* xi = reinterpret_cast<const int*>(xv + 2 * XR);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ra[h] = xv[xr + 8 * h];
      rg[h] = xv[XR + xr + 8 * h];
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
    if constexpr (sizeof(T) == 2)
      z_bf16<G>(z, base + c * 64 * 128, ys);
    else
      z_fp32<G>(z, smem, smem + G::RING + st * G::Y_BYTES, xrow);

    // The columns' vectors; only a chunk's last tile can pass the edge.
    const int y0 = (yt0 + i) * BN;
    const float* yv = reinterpret_cast<const float*>(smem + G::YVEC +
                                                     st * 3 * BN * 4);
    const int* yi = reinterpret_cast<const int*>(yv + 2 * BN);
    const bool inside = y0 + BN <= ny;
    if constexpr (MODE == FWD) {
      if (inside)
        fold_lse<BN, false>(z, yv, yi, y0, ny, rid, tq, m_run, s_run);
      else
        fold_lse<BN, true>(z, yv, yi, y0, ny, rid, tq, m_run, s_run);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    } else {
      if (inside)
        probs<BN, XB, MODE == DC, false>(z, yv, yi, y0, ny, ra, rg, rid, tq,
                                         rsum);
      else
        probs<BN, XB, MODE == DC, true>(z, yv, yi, y0, ny, ra, rg, rid, tq,
                                        rsum);
      if constexpr (sizeof(T) == 2)
        acc_bf16<G, KW>(acc, z, ys);
      else
        acc_fp32<G, KW>(acc, z, smem + G::RING + st * G::Y_BYTES);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
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
  } else {
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
    if constexpr (MODE == DC) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
        const int row = x0 + xr + 8 * h;
        if (tq == 0 && row < nx) out2[size_t(blockIdx.y) * nx + row] = -rsum[h];
      }
    }
  }
}

// ---- Host side -----------------------------------------------------------------
// The pointers of one launch: R [B, dp], C [k, dp], their vectors, and the
// outputs of the mode.
struct Args {
  const void* R;
  const void* C;
  const float* corr;
  const int* ids;
  const int* pos;
  const float* lse;
  const float* g;
  float* out;
  float* out2;
  int B, k, dp;
};

template <typename T, int KW, int MODE>
cudaError_t launch(const Args& a, int per, int parts, int ytile,
                   cudaStream_t stream) {
  using G = Geom<T, KW>;
  if (ytile != G::BN) return cudaErrorInvalidValue;   // the plan's Y tile
  const bool xb = MODE != DC;
  const int nx = xb ? a.B : a.k, ny = xb ? a.k : a.B;
  CUtensorMap tx, ty;
  cudaError_t err = make_map<T>(&tx, xb ? a.R : a.C, nx, a.dp, XR);
  if (err != cudaSuccess) return err;
  err = make_map<T>(&ty, xb ? a.C : a.R, ny, a.dp, G::BN);
  if (err != cudaSuccess) return err;
  auto kernel = slse_sweep_kernel<T, KW, MODE>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::TOTAL));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((nx + XR - 1) / XR, parts), THREADS_WS, G::TOTAL, stream>>>(
      tx, ty, a.corr, a.ids, a.pos, a.lse, a.g, a.out, a.out2, a.B, a.k,
      a.dp, per);
  return cudaGetLastError();
}

// The kernel width for the padded d: 64, 128 or 256.
template <typename T, int MODE>
cudaError_t launch_width(const Args& a, int per, int parts, int ytile,
                         cudaStream_t stream) {
  if (a.dp <= 64) return launch<T, 64, MODE>(a, per, parts, ytile, stream);
  if (a.dp <= 128) return launch<T, 128, MODE>(a, per, parts, ytile, stream);
  return launch<T, 256, MODE>(a, per, parts, ytile, stream);
}

template <int MODE>
cudaError_t launch_type(const Args& a, int per, int parts, int ytile,
                        bool bf16_, cudaStream_t stream) {
  return bf16_ ? launch_width<__nv_bfloat16, MODE>(a, per, parts, ytile,
                                                   stream)
               : launch_width<float, MODE>(a, per, parts, ytile, stream);
}

}  // namespace

// R [B, dp] and C [k, dp] in the compute type (bf16 when `use_bf16` is
// nonzero, else fp32), dp a multiple of 32 and <= 256, rows 16-byte aligned,
// zero past d; corr [k] fp32, ids [k] int32, pos [B] int32. K1 writes m_out
// / s_out [n_chunks, B]; chunk c covers candidate tiles [c * per, ...) of
// `ytile` rows, which must be the kernel's own Y tile for this dtype and
// width (ops/sampled_lse.py _ytile). The Python wrapper checks every shape
// and type. Returns the cudaError_t.
extern "C" int sert_sampled_lse_fwd(const void* R, const void* C,
                                    const void* corr, const void* ids,
                                    const void* pos, void* m_out,
                                    void* s_out, int B, int k, int dp,
                                    int per, int n_chunks, int ytile,
                                    int use_bf16, void* stream) {
  const Args a{R, C, static_cast<const float*>(corr),
               static_cast<const int*>(ids), static_cast<const int*>(pos),
               nullptr, nullptr, static_cast<float*>(m_out),
               static_cast<float*>(s_out), B, k, dp};
  return int(launch_type<FWD>(a, per, n_chunks, ytile, use_bf16 != 0,
                              cudaStream_t(stream)));
}

// K2: as K1, plus lse [B] and g [B] fp32. The dC sweep (batch tiles of
// `ytile` rows in n_slices slices of per_c) writes the dC partials dC_part
// [n_slices, k, dp] and the dcorr partials dcorr_part [n_slices, k]; the
// dreps sweep (K1's chunks) writes dreps_part [n_chunks, B, dp]. The caller
// sums each over its first axis.
extern "C" int sert_sampled_lse_bwd(const void* R, const void* C,
                                    const void* corr, const void* ids,
                                    const void* pos, const void* lse,
                                    const void* g, void* dC_part,
                                    void* dcorr_part, void* dreps_part,
                                    int B, int k, int dp, int per_r,
                                    int n_chunks, int per_c, int n_slices,
                                    int ytile, int use_bf16, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  Args a{R, C, static_cast<const float*>(corr),
         static_cast<const int*>(ids), static_cast<const int*>(pos),
         static_cast<const float*>(lse), static_cast<const float*>(g),
         static_cast<float*>(dC_part), static_cast<float*>(dcorr_part),
         B, k, dp};
  cudaError_t err = launch_type<DC>(a, per_c, n_slices, ytile, use_bf16 != 0,
                                    st);
  if (err != cudaSuccess) return int(err);
  a.out = static_cast<float*>(dreps_part);
  a.out2 = nullptr;
  return int(launch_type<DREPS>(a, per_r, n_chunks, ytile, use_bf16 != 0,
                                st));
}
