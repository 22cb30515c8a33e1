// K3: fused score + per-bin max sweep for sm_90a.
//
// Replaces the Pallas kernels _kernel_bias / _kernel_nobias of
// sert_tpu/ops/score_binmax.py (:51 / :57, launched by score_binmax_prepared
// :87). out[q, b] = max over the bw consecutive entities e of bin b of
//     S[q, e] = R[q] . M[e]  (+ alpha[q] * bias[e]),
// with bf16 inputs and fp32 accumulation. The [Q, E] score matrix never
// leaves the registers that hold it: only the bin maxima reach memory.
//
// What bounds it on the H100: bytes. At the serving shape (Q = 64, E = 1M,
// d = 128) the sweep reads the 256 MB bf16 entity matrix once (0.077 ms at
// 3.35 TB/s) and does 16.4 GFLOP (0.017 ms at the dense bf16 tensor-core
// rate). So the design keeps device memory busy all the time:
//
//   * persistent blocks, one an SM: block (x, y) holds query tile y (64
//     rows of R, loaded once by TMA, resident) and walks entity tiles x,
//     x + gridDim.x, ... of 128 rows;
//   * two consumer warpgroups take the tiles in turn (one's epilogue
//     overlaps the other's products); each runs wgmma m64n128k16 (fp32
//     accumulators) with R and M both K-major, as K1's z = X Y^T does;
//   * a producer warp streams each tile's 128 x 64-column sub-tiles (TMA,
//     128-byte swizzle, zeros past E and past d) into the ring of the
//     warpgroup that takes the tile: NST / 2 stages each, with full /
//     empty mbarriers, so loads run ahead of the products and epilogues.
//     A ring of its own keeps every phase of a stage's barriers with one
//     warpgroup, which consumes them in order; a consumer frees each
//     sub-tile's stage as soon as its products are done, so a tile of
//     more sub-tiles than the ring holds (d > 256) streams through it;
//   * the epilogue stays in registers: + alpha[q] bias[e], -inf for
//     e >= E, each row's max over its bin from the accumulator fragment (a
//     thread-local max over its columns, then __shfl_xor within the quad of
//     lanes that share the row), and one lane writes out[q, bin].
//
// Differences from the TPU kernel, on purpose:
//   * entities >= E are masked to -inf here, so the partial tail bin holds
//     the max over valid entities only (the TPU version padded with zero
//     rows, which can inflate that bin);
//   * the output is [Q, n_bins] row-major, not the bins-major transpose
//     Mosaic's (8, 128) block rule needed;
//   * any bw dividing 128 is a register max: bw >= 8 a quad reduction, a
//     smaller bw within a thread's column pair (and one shuffle at 4).
//
// The fp32 mode (score_binmax_f32_kernel) takes R and M in fp32, as the
// reference's kernels do when prepare_binmax_matrix staged M in fp32
// (sert_tpu/ops/score_binmax.py:72-81, :111), for a prefilter whose bin
// maxima carry fp32-class rounding: 3xTF32 products (lo.hi, hi.lo, hi.hi a
// depth step, mma_sync.cuh's tc_mma order and split), fp32 sums. What
// bounds it at the serving shape: bytes again, 512 MB of fp32 M (0.153 ms)
// against 3 x 16.4 GFLOP at the dense TF32 rate (0.099 ms). It is the bf16
// sweep on TF32 tensor cores: the same persistent blocks, resident query
// tile, producer warp and 128-byte-swizzled 128 x 32-float sub-tiles
// (TMA, zeros past E and d), the same epilogue; wgmma m64n128k8 TF32.
// What differs is the split, which TMA cannot do. The tensor cores read a
// TF32 operand's word and drop its low 13 bits, so each word they read
// must be the rounded hi or lo that split() makes, or the hi they see is
// not the hi that lo was taken from:
//   * R (wgmma's A) comes from registers: each depth step's fragment is
//     read from the resident raw fp32 tile and split in registers, so one
//     copy of R serves both parts (R_hi and R_lo in shared memory would
//     take 344 KB at d 672);
//   * M (B) is split by its consumer warpgroup once its sub-tile lands:
//     hi written over the stage in place, lo into the warpgroup's own lo
//     buffer of the same layout, then fence.proxy.async and the
//     warpgroup's barrier before its wgmmas read them. The stage goes back
//     to the producer when all four warps have arrived on its empty
//     barrier, each after waiting for its share of the sub-tile's
//     products. The one lo buffer has no such barrier, and a warp's wait
//     covers only its own share of the collective wgmma, so a second
//     warpgroup barrier before the split orders every warp's wait for the
//     products that last read lo before any warp rewrites it (two lo
//     buffers in turn would need no second barrier, but do not fit beside
//     R and two stages past d 512). The other warpgroup's products overlap
//     this one's split;
//   * the resident R takes 64 d 4 bytes (172 KB at d 672), so the ring
//     shrinks with d: ops/score_binmax.py's _plan_f32 gives the consumer
//     warpgroups (two while each keeps two stages, else one) and stages.
//     A stage stays taken until its products are done, so at the widest d
//     (one warpgroup, two stages) one load is in flight a block and its
//     latency, not the bytes, sets the pace.
// Sums run in a fixed order with no atomics: two calls are bit-equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int TQ = 64;             // query rows a block holds (wgmma M)
constexpr int TE = 128;            // entity rows a tile (wgmma N)
constexpr int SUB = 64;            // bf16 columns of a 128-byte sub-tile
constexpr int FSUB = 32;           // fp32 columns of a 128-byte sub-tile
constexpr int NST = 8;             // ring stages, one M sub-tile each
constexpr int HALF = NST / 2;      // a consumer warpgroup's own stages
constexpr int MAX_NSUB = 8;        // d <= 512
constexpr int THREADS = 384;       // a producer and two consumer warpgroups
constexpr uint32_t R_SUB = TQ * 128;
constexpr uint32_t M_SUB = TE * 128;

// Bytes of shared memory for nsub sub-tiles of width: R, the ring, the
// barriers. At most 64 + 128 KB.
inline size_t smem_bytes(int nsub) {
  return size_t(nsub) * R_SUB + NST * M_SUB + (2 * NST + 1) * 8;
}

// ---- The epilogue, both modes --------------------------------------------
// A consumer thread holds rows 16 w + gq (+ 8) of the 64 and, of every
// 8-column block j, columns 8 j + 2 tq (+ 1): acc[4 j + 2 h + i] is row h,
// column i.

// The bias of the thread's columns of the tile at e0 (0 past E), loaded
// while the tile's last products run.
__device__ inline void tile_bias(float (&bv)[32], const float* __restrict__ bias,
                                 int e0, int E, int tq) {
  const bool inside = e0 + TE <= E;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = e0 + 8 * j + 2 * tq + i;
      bv[2 * j + i] = inside || e < E ? __ldg(bias + e) : 0.0f;
    }
}

// The scores of the tile at e0 (+ alpha bias, as the plain version rounds
// it: a product, then a sum; -inf past E), then each row's max over its bin
// into out[q, bin].
__device__ inline void bin_maxima(float (&acc)[64], const float (&bv)[32],
                                  bool with_bias, const float (&al)[2],
                                  const int (&qr)[2], int e0, int E, int Q,
                                  int bw, int n_bins, int tq,
                                  float* __restrict__ out) {
  const bool inside = e0 + TE <= E;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e & 1, h = e >> 1;
      float v = acc[4 * j + e];
      if (with_bias) v = __fadd_rn(v, __fmul_rn(al[h], bv[2 * j + i]));
      if (!inside && e0 + 8 * j + 2 * tq + i >= E) v = -CUDART_INF_F;
      acc[4 * j + e] = v;
    }

  if (bw >= 8) {
    // Each thread's max over its two columns of every 8-column block j,
    // into acc[4 j + 2 h]; then over the blocks of a bin (a tree over j,
    // the bin's first block keeps it); then across the quad.
    const int gmask = bw / 8 - 1;   // (8-column groups a bin) - 1
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        acc[4 * j + 2 * h] = fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
#pragma unroll
    for (int s = 1; s < 16; s <<= 1) {
      if (16 * s > bw) break;
#pragma unroll
      for (int j = 0; j < 16; j += 2 * s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          acc[4 * j + 2 * h] =
              fmaxf(acc[4 * j + 2 * h], acc[4 * (j + s) + 2 * h]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j & gmask) continue;      // uniform: bw is the whole grid's
      const int bin = (e0 + 8 * j) / bw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = acc[4 * j + 2 * h];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (tq == 0 && qr[h] < Q && bin < n_bins)
          out[size_t(qr[h]) * n_bins + bin] = m;
      }
    }
  } else {
    // bw 1, 2 or 4: within the thread's column pair (and, at 4, with the
    // neighbouring lane).
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = e0 + 8 * j + 2 * tq;
        const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
        float* o = out + size_t(qr[h]) * n_bins;
        if (bw == 1) {
          if (qr[h] < Q && e < n_bins) o[e] = a;
          if (qr[h] < Q && e + 1 < n_bins) o[e + 1] = b;
          continue;
        }
        float m = fmaxf(a, b);
        if (bw == 4) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        if ((bw == 2 || (tq & 1) == 0) && qr[h] < Q && e / bw < n_bins)
          o[e / bw] = m;
      }
  }
}

// The consumer thread's query rows and their alpha (1 without one).
__device__ inline void query_rows(int (&qr)[2], float (&al)[2],
                                  const float* __restrict__ alpha, int q0,
                                  int w, int gq, int Q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + 16 * w + gq + 8 * h;
    al[h] = alpha != nullptr && qr[h] < Q ? alpha[qr[h]] : 1.0f;
  }
}

// ---- The bf16 mode -----------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
score_binmax_kernel(const __grid_constant__ CUtensorMap tr,
                    const __grid_constant__ CUtensorMap tm,
                    const float* __restrict__ bias,
                    const float* __restrict__ alpha,
                    float* __restrict__ out, int Q, int E, int nsub, int bw,
                    int n_bins) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t ring = base + nsub * R_SUB;
  const uint32_t full = ring + NST * M_SUB, empty = full + 8 * NST,
                 rbar = empty + 8 * NST;
  const int q0 = blockIdx.y * TQ;
  const int n_et = (E + TE - 1) / TE;
  const int n_tiles = int(blockIdx.x) < n_et
                          ? (n_et - 1 - int(blockIdx.x)) / int(gridDim.x) + 1
                          : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    if (base & 1023) __trap();     // the swizzled tiles need 1 KB alignment
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's arrival + its bytes
      mbar_init(empty + 8 * s, 4);     // the consuming warpgroup's warps
    }
    mbar_init(rbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread loads R's tile, then every sub-tile of this
    // block's entity tiles, each into the next stage of the taking
    // warpgroup's ring once it is free.
    setmaxnreg_dec<40>();
    if (tid != 0) return;
    mbar_arrive_tx(rbar, nsub * R_SUB);
    for (int s = 0; s < nsub; ++s)
      tma_load_2d(base + s * R_SUB, &tr, rbar, s * SUB, q0);
    for (int t = 0; t < n_tiles; ++t) {
      const int e0 = (blockIdx.x + t * gridDim.x) * TE;
      const int half = (t & 1) * HALF;
      for (int s = 0; s < nsub; ++s) {
        const int g = (t >> 1) * nsub + s, st = half + g % HALF;
        mbar_wait(empty + 8 * st, ((g / HALF) & 1) ^ 1);
        mbar_arrive_tx(full + 8 * st, M_SUB);
        tma_load_2d(ring + st * M_SUB, &tm, full + 8 * st, s * SUB, e0);
      }
    }
    return;
  }

  // The consumers: warpgroup c takes tiles c, c + 2, ... of this block,
  // its g-th sub-tile from stage c HALF + g % HALF of the ring.
  setmaxnreg_inc<232>();
  const int c = wg - 1, w = (tid / 32) % 4, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  int qr[2];
  float al[2];
  query_rows(qr, al, alpha, q0, w, gq, Q);
  // This warp's release of the stage of its g-th sub-tile, once the
  // products that read it are done.
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (c * HALF + g % HALF));
  };
  mbar_wait(rbar, 0);

  for (int t = c; t < n_tiles; t += 2) {
    const int g0 = (t >> 1) * nsub;
    float acc[64];
    fence_regs(acc);
    wgmma_fence();
    for (int s = 0; s < nsub; ++s) {
      const int g = g0 + s, st = c * HALF + g % HALF;
      mbar_wait(full + 8 * st, (g / HALF) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<128>::ss(acc,
                       wgmma_desc(base + s * R_SUB + kk * 32, 16, 1024),
                       wgmma_desc(ring + st * M_SUB + kk * 32, 16, 1024),
                       s > 0 || kk > 0);
      wgmma_commit();
      if (s > 0) {                  // sub-tile s - 1's products are done
        wgmma_wait<1>();
        release(g - 1);
      }
    }
    const int e0 = (blockIdx.x + t * gridDim.x) * TE;
    float bv[32];                   // the columns' bias, loaded meanwhile
    if (bias != nullptr) tile_bias(bv, bias, e0, E, tq);
    wgmma_wait_all();
    fence_regs(acc);
    release(g0 + nsub - 1);
    bin_maxima(acc, bv, bias != nullptr, al, qr, e0, E, Q, bw, n_bins, tq,
               out);
  }
}

// ---- The fp32 mode -----------------------------------------------------------
// Bytes of shared memory of the fp32 mode: R's nsub sub-tiles, `stages`
// ring stages and a lo buffer for each of `cons` consumer warpgroups, the
// barriers (ops/score_binmax.py's _plan_f32 computes the same).
inline size_t smem_bytes_f32(int nsub, int cons, int stages) {
  return size_t(nsub) * R_SUB + size_t(cons) * (stages + 1) * M_SUB +
         (2 * cons * stages + 1) * 8;
}

// Element (row r, column c) of a 128-byte-swizzled fp32 sub-tile.
__device__ inline float swz(const unsigned char* sub, int r, int c) {
  return *reinterpret_cast<const float*>(
      sub + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// The landed M sub-tile at `st` as TF32 parts, by thread t of the 128 of a
// consumer warpgroup: hi over it in place, lo at the same offset of `lo`.
// Elementwise, so lo keeps the sub-tile's swizzled layout.
__device__ inline void split_stage(unsigned char* st, unsigned char* lo,
                                   int t) {
  constexpr int N = M_SUB / (16 * 128);   // 16-byte words a thread
  float4 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = *reinterpret_cast<const float4*>(st + 16 * (128 * i + t));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint4 h, l;
    split(v[i].x, h.x, l.x);
    split(v[i].y, h.y, l.y);
    split(v[i].z, h.z, l.z);
    split(v[i].w, h.w, l.w);
    *reinterpret_cast<uint4*>(st + 16 * (128 * i + t)) = h;
    *reinterpret_cast<uint4*>(lo + 16 * (128 * i + t)) = l;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
score_binmax_f32_kernel(const __grid_constant__ CUtensorMap tr,
                        const __grid_constant__ CUtensorMap tm,
                        const float* __restrict__ bias,
                        const float* __restrict__ alpha,
                        float* __restrict__ out, int Q, int E, int nsub,
                        int bw, int n_bins, int cons, int stages) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int nst = cons * stages;
  const uint32_t ring = base + nsub * R_SUB, lobuf = ring + nst * M_SUB;
  const uint32_t full = lobuf + cons * M_SUB, empty = full + 8 * nst,
                 rbar = empty + 8 * nst;
  const int q0 = blockIdx.y * TQ;
  const int n_et = (E + TE - 1) / TE;
  const int n_tiles = int(blockIdx.x) < n_et
                          ? (n_et - 1 - int(blockIdx.x)) / int(gridDim.x) + 1
                          : 0;
  // The role index, warp-uniform (read from lane 0), so that the compiler
  // knows each warp takes one branch: without it ptxas serializes the
  // wgmmas ("program dependence on compiler-inserted WG.AR in divergent
  // path"), which cost a fifth of the time at the serving shape.
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    if (base & 1023) __trap();     // the swizzled tiles need 1 KB alignment
    for (int s = 0; s < nst; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's arrival + its bytes
      mbar_init(empty + 8 * s, 4);     // the consuming warpgroup's warps
    }
    mbar_init(rbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer, as the bf16 mode's: tile t goes to consumer t % cons,
    // its g-th sub-tile to stage g % stages of that consumer's ring.
    setmaxnreg_dec<40>();
    if (tid != 0) return;
    mbar_arrive_tx(rbar, nsub * R_SUB);
    for (int s = 0; s < nsub; ++s)
      tma_load_2d(base + s * R_SUB, &tr, rbar, s * FSUB, q0);
    for (int t = 0; t < n_tiles; ++t) {
      const int e0 = (blockIdx.x + t * gridDim.x) * TE;
      const int first = (t % cons) * stages;
      for (int s = 0; s < nsub; ++s) {
        const int g = (t / cons) * nsub + s, st = first + g % stages;
        mbar_wait(empty + 8 * st, ((g / stages) & 1) ^ 1);
        mbar_arrive_tx(full + 8 * st, M_SUB);
        tma_load_2d(ring + st * M_SUB, &tm, full + 8 * st, s * FSUB, e0);
      }
    }
    return;
  }

  // The consumers: warpgroup c takes tiles c, c + cons, ... of this block.
  setmaxnreg_inc<232>();
  const int c = wg - 1, ct = tid % 128, w = ct / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  int qr[2];
  float al[2];
  query_rows(qr, al, alpha, q0, w, gq, Q);
  const uint32_t lo = lobuf + c * M_SUB;
  auto release = [&](int g) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (c * stages + g % stages));
  };
  mbar_wait(rbar, 0);

  for (int t = c; t < n_tiles; t += cons) {
    const int g0 = (t / cons) * nsub;
    float acc[64];
    for (int s = 0; s < nsub; ++s) {
      const int g = g0 + s, st = c * stages + g % stages;
      if (s > 0) {   // this warp's share of sub-tile s - 1's products is
        wgmma_wait<0>();    // done: its stage and its A registers are free
        fence_regs(acc);
        release(g - 1);
      }
      // A: this warp's 16 rows of R, depth 8 kk.. of sub-tile s, split.
      const unsigned char* rs = smem + s * R_SUB;
      uint32_t ah[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(swz(rs, 16 * w + gq + 8 * (i & 1), 8 * kk + tq + 4 * (i >> 1)),
                ah[kk][i], alo[kk][i]);
      mbar_wait(full + 8 * st, (g / stages) & 1);
      // Every warp of the group has waited for the products that last read
      // lo (sub-tile s - 1's, or the previous tile's last): one warp's wait
      // covers only its own share of the collective wgmma, so no warp
      // writes lo before all four have passed theirs.
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      split_stage(smem + (ring - base) + st * M_SUB, smem + (lo - base), ct);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t hi_d = wgmma_desc(ring + st * M_SUB + kk * 32, 16, 1024);
        const uint64_t lo_d = wgmma_desc(lo + kk * 32, 16, 1024);
        wgmma_tf32_rs(acc, alo[kk], hi_d, s > 0 || kk > 0);
        wgmma_tf32_rs(acc, ah[kk], lo_d, 1);
        wgmma_tf32_rs(acc, ah[kk], hi_d, 1);
      }
      wgmma_commit();
    }
    const int e0 = (blockIdx.x + t * gridDim.x) * TE;
    float bv[32];
    if (bias != nullptr) tile_bias(bv, bias, e0, E, tq);
    wgmma_wait_all();
    fence_regs(acc);
    release(g0 + nsub - 1);
    bin_maxima(acc, bv, bias != nullptr, al, qr, e0, E, Q, bw, n_bins, tq,
               out);
  }
}

// The persistent grid: one block an SM, the SMs shared among the query
// tiles, no more blocks a query tile than entity tiles.
cudaError_t sweep_grid(int Q, int E, dim3* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_qt = (Q + TQ - 1) / TQ, n_et = (E + TE - 1) / TE;
  const int per_qt = sms / n_qt;
  *grid = dim3(per_qt < 1 ? 1 : per_qt < n_et ? per_qt : n_et, n_qt);
  return cudaSuccess;
}

}  // namespace

// R [Q, d] bf16, M [>=E, d] bf16 (rows 16-byte aligned), bias [E] fp32 or
// null, alpha [Q] fp32 or null, out [Q, n_bins] fp32. d % 16 == 0, d <=
// 512 and 128 % bw == 0 (the Python wrapper checks all three). Returns the
// cudaError_t of the launch.
extern "C" int sert_score_binmax(const void* R, const void* M,
                                 const void* bias, const void* alpha,
                                 void* out, int Q, int E, int d, int bw,
                                 int n_bins, void* stream) {
  const int nsub = (d + SUB - 1) / SUB;
  if (nsub > MAX_NSUB || TE % bw != 0) return int(cudaErrorInvalidValue);
  CUtensorMap tr, tm;
  cudaError_t err = make_map<__nv_bfloat16>(&tr, R, Q, d, TQ);
  if (err != cudaSuccess) return int(err);
  err = make_map<__nv_bfloat16>(&tm, M, E, d, TE);
  if (err != cudaSuccess) return int(err);
  const size_t smem = smem_bytes(nsub);
  err = cudaFuncSetAttribute(score_binmax_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid;
  err = sweep_grid(Q, E, &grid);
  if (err != cudaSuccess) return int(err);
  score_binmax_kernel<<<grid, THREADS, smem, cudaStream_t(stream)>>>(
      tr, tm, static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<float*>(out), Q, E, nsub,
      bw, n_bins);
  return int(cudaGetLastError());
}

// The fp32 mode: R [Q, d] fp32 and M [>=E, d] fp32, both contiguous, the
// rest as sert_score_binmax; d % 16 == 0 and 128 % bw == 0. `consumers`
// (1 or 2) warpgroups of `stages` ring stages each in `smem` bytes of
// shared memory: ops/score_binmax.py's _plan_f32 for d, which bounds d by
// the resident R rows (kernel_limits, MAX_DIM_F32). Returns the
// cudaError_t of the launch.
extern "C" int sert_score_binmax_f32(const void* R, const void* M,
                                     const void* bias, const void* alpha,
                                     void* out, int Q, int E, int d, int bw,
                                     int n_bins, int consumers, int stages,
                                     int smem, void* stream) {
  const int nsub = (d + FSUB - 1) / FSUB;
  if (d % 16 != 0 || TE % bw != 0 || consumers < 1 || consumers > 2 ||
      stages < 1 || size_t(smem) < smem_bytes_f32(nsub, consumers, stages))
    return int(cudaErrorInvalidValue);
  CUtensorMap tr, tm;
  cudaError_t err = make_map<float>(&tr, R, Q, d, TQ);
  if (err != cudaSuccess) return int(err);
  err = make_map<float>(&tm, M, E, d, TE);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(score_binmax_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  dim3 grid;
  err = sweep_grid(Q, E, &grid);
  if (err != cudaSuccess) return int(err);
  score_binmax_f32_kernel<<<grid, 128 * (1 + consumers), smem,
                            cudaStream_t(stream)>>>(
      tr, tm, static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<float*>(out), Q, E, nsub,
      bw, n_bins, consumers, stages);
  return int(cudaGetLastError());
}
