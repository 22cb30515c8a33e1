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
// The fp32 mode (score_binmax_f32_kernel, below) takes R and M in fp32, as
// the reference's kernels do when prepare_binmax_matrix staged M in fp32
// (sert_tpu/ops/score_binmax.py:72-81, :111), for a prefilter whose bin
// maxima carry fp32-class rounding. It is a kernel of its own, simple
// first: its products run as 3xTF32 on mma.sync (mma_sync.cuh, as K1/K2 and
// K5-K7 take fp32), fed by cp.async. What bounds it at the serving shape:
// bytes again, 512 MB of fp32 M (0.153 ms at 3.35 TB/s) against 3 x 16.4
// GFLOP at the dense TF32 rate (0.099 ms). Each block keeps its 64 query
// rows resident in shared memory and walks entity tiles of 128 rows x, x +
// gridDim.x, ..., streaming each tile's 32-column chunks through a ring of
// three stages, so the copies of the next chunks overlap the products of
// this one. Its epilogue is the bf16 sweep's: + alpha bias, -inf past E,
// the bin max (over a thread's pair, the quad, then, for bw >= 8, each
// row's 8-column group maxima through shared memory).

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
  // its g-th sub-tile from stage c HALF + g % HALF of the ring. A thread
  // holds rows 16 w + gq (+ 8) of the 64 and, of every 8-column block j,
  // columns 8 j + 2 tq (+ 1): acc[4 j + 2 h + i] is row h, column i.
  setmaxnreg_inc<232>();
  const int c = wg - 1, w = (tid / 32) % 4, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  int qr[2];
  float al[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + 16 * w + gq + 8 * h;
    al[h] = alpha != nullptr && qr[h] < Q ? alpha[qr[h]] : 1.0f;
  }
  const int gmask = bw / 8 - 1;     // (8-column groups a bin) - 1, bw >= 8
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
    const bool inside = e0 + TE <= E;
    float bv[32];                   // the columns' bias, loaded meanwhile
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = e0 + 8 * j + 2 * tq + i;
          bv[2 * j + i] = inside || e < E ? __ldg(bias + e) : 0.0f;
        }
    }
    wgmma_wait_all();
    fence_regs(acc);
    release(g0 + nsub - 1);

    // Scores: + alpha bias (as the plain version rounds it: a product, then
    // a sum), -inf past E.
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 1, h = e >> 1;
        float v = acc[4 * j + e];
        if (bias != nullptr) v = __fadd_rn(v, __fmul_rn(al[h], bv[2 * j + i]));
        if (!inside && e0 + 8 * j + 2 * tq + i >= E) v = -CUDART_INF_F;
        acc[4 * j + e] = v;
      }

    if (bw >= 8) {
      // Each thread's max over its two columns of every 8-column block j,
      // into acc[4 j + 2 h]; then over the blocks of a bin (a tree over j,
      // the bin's first block keeps it); then across the quad.
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
        if (j & gmask) continue;    // uniform: bw is the whole grid's
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
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int n_qt = (Q + TQ - 1) / TQ, n_et = (E + TE - 1) / TE;
  const int per_qt = sms / n_qt;   // blocks a query tile, one an SM
  const int gx = per_qt < 1 ? 1 : per_qt < n_et ? per_qt : n_et;
  score_binmax_kernel<<<dim3(gx, n_qt), THREADS, smem,
                        cudaStream_t(stream)>>>(
      tr, tm, static_cast<const float*>(bias),
      static_cast<const float*>(alpha), static_cast<float*>(out), Q, E, nsub,
      bw, n_bins);
  return int(cudaGetLastError());
}

namespace {

// The fp32 mode: 3xTF32 on mma.sync, cp.async-fed.
constexpr int F_TQ = 64;             // query rows a block holds
constexpr int F_TE = 128;            // entity rows a tile
constexpr int F_KC = 32;             // columns a ring stage holds
constexpr int F_LDM = F_KC + 4;      // a stage row's floats (no bank conflicts)
constexpr int F_NST = 3;             // ring stages
constexpr int F_THREADS = 256;       // 8 warps: 2 (query) x 4 (entity)
constexpr int F_GROUPS = F_TE / 8;   // 8-column groups a tile

// Shared memory of the fp32 mode at a depth of dk columns (d rounded up to
// F_KC): the resident R rows, the ring, each row's group maxima.
inline size_t smem_bytes_f32(int dk) {
  return sizeof(float) * (size_t(F_TQ) * (dk + 4) + F_NST * F_TE * F_LDM +
                          F_TQ * F_GROUPS);
}

__global__ void __launch_bounds__(F_THREADS)
score_binmax_f32_kernel(const float* __restrict__ R,
                        const float* __restrict__ M,
                        const float* __restrict__ bias,
                        const float* __restrict__ alpha,
                        float* __restrict__ out, int Q, int E, int d, int dk,
                        int bw, int n_bins) {
  extern __shared__ __align__(16) float fsm[];
  const int ldr = dk + 4;
  float* Rs = fsm;                                  // [F_TQ][ldr]
  float* ring = Rs + F_TQ * ldr;                    // [F_NST][F_TE][F_LDM]
  float* red = ring + F_NST * F_TE * F_LDM;         // [F_TQ][F_GROUPS]
  const int tid = threadIdx.x, warp = tid / 32;
  const int wq = warp / 4, we = warp % 4;           // rows 32 wq, cols 32 we
  const int g = lane_g(), t = lane_t();
  const int q0 = blockIdx.y * F_TQ;
  const int n_et = (E + F_TE - 1) / F_TE;
  const int n_tiles = int(blockIdx.x) < n_et
                          ? (n_et - 1 - int(blockIdx.x)) / int(gridDim.x) + 1
                          : 0;
  const int n_chunks = dk / F_KC;
  const int total = n_tiles * n_chunks;

  // This block's query rows, zero past Q and past d: resident throughout.
  for (int i = tid; i < F_TQ * dk; i += F_THREADS) {
    const int r = i / dk, c = i % dk;
    Rs[r * ldr + c] = q0 + r < Q && c < d ? R[size_t(q0 + r) * d + c] : 0.0f;
  }

  // Stream position s is chunk s % n_chunks of this block's tile
  // s / n_chunks; its copy goes to stage s % F_NST. Every call commits a
  // group (empty past the end), so that the waits count uniformly.
  auto load_stage = [&](int s) {
    if (s < total) {
      const int e0 = (blockIdx.x + (s / n_chunks) * gridDim.x) * F_TE;
      const int c0 = (s % n_chunks) * F_KC;
      float* dst = ring + (s % F_NST) * F_TE * F_LDM;
      for (int p = tid; p < F_TE * F_KC / 4; p += F_THREADS) {
        const int r = p / (F_KC / 4), c = c0 + 4 * (p % (F_KC / 4));
        const bool ok = e0 + r < E && c < d;
        cp_async16(dst + r * F_LDM + c - c0,
                   ok ? M + size_t(e0 + r) * d + c : M, ok);
      }
    }
    cp_commit();
  };
  for (int s = 0; s < F_NST - 1; ++s) load_stage(s);

  // Thread (g, t) of warp (wq, we) holds rows 32 wq + 16 mi + g (+ 8) and
  // columns 32 we + 8 ni + 2 t (+ 1): acc[mi][ni].c[2 h + i].
  Acc8 acc[2][4];
  for (int s = 0; s < total; ++s) {
    cp_wait<F_NST - 2>();
    __syncthreads();             // stage s landed; stage s - 1 is free
    load_stage(s + F_NST - 1);
    const int chunk = s % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni].c[j] = 0.0f;
    }
    const float* Ms = ring + (s % F_NST) * F_TE * F_LDM;
#pragma unroll
    for (int kk = 0; kk < F_KC; kk += 8) {
      FragA<float> a[2];
      FragB<float> b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a(a[mi], Rs + (32 * wq + 16 * mi) * ldr + chunk * F_KC + kk,
               ldr);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        load_b_nk(b[ni], Ms + (32 * we + 8 * ni) * F_LDM + kk, F_LDM);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) tc_mma(acc[mi][ni], a[mi], b[ni]);
    }
    if (chunk != n_chunks - 1) continue;

    // The epilogue of tile s / n_chunks: + alpha bias (a product, then a
    // sum, as the plain version rounds it), -inf past E, the bin maxima.
    const int e0 = (blockIdx.x + (s / n_chunks) * gridDim.x) * F_TE;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * wq + 16 * mi + g + 8 * h, q = q0 + row;
        const float al = alpha != nullptr && q < Q ? alpha[q] : 1.0f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = 32 * we + 8 * ni + 2 * t, e = e0 + col;
          float v[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            v[i] = acc[mi][ni].c[2 * h + i];
            if (bias != nullptr && e + i < E)
              v[i] = __fadd_rn(v[i], __fmul_rn(al, __ldg(bias + e + i)));
            if (e + i >= E) v[i] = -CUDART_INF_F;
          }
          float* o = out + size_t(q) * n_bins;
          if (bw == 1) {
            if (q < Q && e < n_bins) o[e] = v[0];
            if (q < Q && e + 1 < n_bins) o[e + 1] = v[1];
            continue;
          }
          float m = fmaxf(v[0], v[1]);
          if (bw == 2) {
            if (q < Q && e / 2 < n_bins) o[e / 2] = m;
            continue;
          }
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          if (bw == 4) {
            if ((t & 1) == 0 && q < Q && e / 4 < n_bins) o[e / 4] = m;
            continue;
          }
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (t == 0) red[row * F_GROUPS + 4 * we + ni] = m;
        }
      }
    if (bw >= 8) {               // uniform: bw is the whole grid's
      __syncthreads();
      const int per = F_TE / bw, span = bw / 8;
      for (int i = tid; i < F_TQ * per; i += F_THREADS) {
        const int row = i / per, b = i % per, q = q0 + row;
        const int bin = e0 / bw + b;
        float m = red[row * F_GROUPS + b * span];
        for (int j = 1; j < span; ++j)
          m = fmaxf(m, red[row * F_GROUPS + b * span + j]);
        if (q < Q && bin < n_bins) out[size_t(q) * n_bins + bin] = m;
      }
    }
  }
  cp_wait<0>();
}

}  // namespace

// The fp32 mode: R [Q, d] fp32, M [>=E, d] fp32, both contiguous, the rest
// as sert_score_binmax. d % 16 == 0 and 128 % bw == 0; d is bounded by the
// shared memory the resident R rows take (ops/score_binmax.py's
// kernel_limits, MAX_DIM_F32). Returns the cudaError_t of the launch.
extern "C" int sert_score_binmax_f32(const void* R, const void* M,
                                     const void* bias, const void* alpha,
                                     void* out, int Q, int E, int d, int bw,
                                     int n_bins, void* stream) {
  if (d % 16 != 0 || F_TE % bw != 0) return int(cudaErrorInvalidValue);
  const int dk = (d + F_KC - 1) / F_KC * F_KC;
  const size_t smem = smem_bytes_f32(dk);
  cudaError_t err = cudaFuncSetAttribute(
      score_binmax_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, score_binmax_f32_kernel, F_THREADS, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int n_qt = (Q + F_TQ - 1) / F_TQ, n_et = (E + F_TE - 1) / F_TE;
  const int per_qt = sms * per_sm / n_qt;   // blocks a query tile
  const int gx = per_qt < 1 ? 1 : per_qt < n_et ? per_qt : n_et;
  score_binmax_f32_kernel<<<dim3(gx, n_qt), F_THREADS, smem,
                            cudaStream_t(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(M),
      static_cast<const float*>(bias), static_cast<const float*>(alpha),
      static_cast<float*>(out), Q, E, d, dk, bw, n_bins);
  return int(cudaGetLastError());
}
