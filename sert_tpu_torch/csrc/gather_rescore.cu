// K4: gather + exact fp32 rescore of the bins the prefilter chose.
//
// Replaces the Pallas kernel _kernel of sert_tpu/ops/gather_rescore.py (:31,
// launched by _gather_rescore_one :73 through gather_rescore :51).
//     out[q, j * bw + l] = R[q] . M_binned[bin_idx[q, j], l]      (fp32)
// The gathered [Q, NB * bw, d] matrix never exists in device memory.
//
// What bounds it on the H100: bytes. At the serving shape (Q = 64,
// NB = 1012, bw = 128, d = 128, fp32 rows) the queries choose at most the
// 7,813 bins of 1M entities, 512 MB of rows, and write 33 MB of scores:
// 0.163 ms at 3.35 TB/s, against 1.1 GFLOP of fp32 FMAs (0.032 ms on the
// CUDA cores). A query-major kernel (one block a query's bins, as the TPU
// kernel's grid runs) reads each bin once for every query that chose it,
// 4.2 GB a batch. So this one is turned inside out, bin-major:
//
//   1. An inverse index, built on the device: count_kernel counts the
//      (q, j) pairs of each bin with integer atomics (and writes NaN for a
//      bin id outside [0, n_bins), the only output such a pair gets);
//      scan_kernel takes the exclusive prefix sum of the counts in one
//      block, looping over the bins with a running carry, and lists the
//      non-empty bins with their first pair and count; scatter_kernel
//      drops each pair into its bin's slot range (an integer atomic, so the
//      order within a bin may change from run to run; no output depends on
//      it).
//   2. rescore_kernel: persistent blocks walk the (non-empty bin, row
//      chunk) items. The chunk's rows (one bin of fp32 rows at d = 128) are
//      staged in shared memory by cp.async, double-buffered, so the next
//      item's rows are in flight during this item's products; each bin is
//      read from device memory once a call, whatever the number of queries
//      that chose it. The R rows of the bin's pairs are staged beside them,
//      a pass of up to pairs_per_pass at a time, and thread (pair lane pl,
//      row r) sums R[q] . M[r] for pairs pl, pl + npl, ... of the pass in
//      registers, with fp32 FMAs on the CUDA cores (the contract is 1e-5
//      against the dense fp32 score, so no TF32): a thread's pairs are
//      unrolled by their count, with four partial sums a pair, so that its
//      FMAs run back to back.
//
// Determinism: no float atomics. Every output element is written once, by
// one thread, its d-sum in a fixed order (four partial sums over the
// columns c % 4, then (0 + 1) + (2 + 3)), so two calls are bit-equal. The
// shape-only plan (row chunk, pairs a pass, R resident or not, grid) is
// ops/gather_rescore.py's _plan; the launcher derives the shared memory's
// layout from it, and the wrapper allocates the index's scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "mma_sync.cuh"

namespace {

constexpr int THREADS = 256;       // rescore_kernel
constexpr int PPT = 8;             // pairs a thread carries through a pass
constexpr int PMAX = 256;          // pair ids an item stages with its rows
constexpr int INDEX_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 8;      // bins a scan thread loads a round

// ---- The inverse index -------------------------------------------------------
__global__ void __launch_bounds__(INDEX_THREADS)
count_kernel(const int* __restrict__ bin_idx, int n_pairs, int n_bins, int bw,
             int* __restrict__ count, float* __restrict__ out) {
  const int p = blockIdx.x * INDEX_THREADS + threadIdx.x;
  if (p >= n_pairs) return;
  const int b = bin_idx[p];
  if (b >= 0 && b < n_bins) {
    atomicAdd(count + b, 1);
  } else {
    float* o = out + size_t(p) * bw;
    for (int l = 0; l < bw; ++l) o[l] = CUDART_NAN_F;
  }
}

// count [n_bins] becomes the exclusive prefix sum (each bin's first pair
// slot); the non-empty bins are listed in order as nz[i] (bin),
// nz[n_bins + i] (first slot), nz[2 n_bins + i] (pairs), and *n_nz counts
// them. One block, any n_bins: rounds of SCAN_ITEMS x SCAN_THREADS bins,
// whose counts are all loaded at once (coalesced), then scanned in bin
// order, SCAN_THREADS at a time.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int* __restrict__ count, int n_bins, int* __restrict__ nz,
            int* __restrict__ n_nz) {
  __shared__ int sums[2][32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int carry = 0, carry_nz = 0;
  for (int base = 0; base < n_bins; base += SCAN_THREADS * SCAN_ITEMS) {
    int c[SCAN_ITEMS];
#pragma unroll
    for (int u = 0; u < SCAN_ITEMS; ++u) {
      const int i = base + u * SCAN_THREADS + tid;
      c[u] = i < n_bins ? count[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < SCAN_ITEMS; ++u) {
      const int i = base + u * SCAN_THREADS + tid;
      const int z = c[u] > 0;
      int si = c[u], zi = z;        // inclusive scans within the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, si, o);
        const int y = __shfl_up_sync(0xffffffffu, zi, o);
        if (lane >= o) {
          si += x;
          zi += y;
        }
      }
      if (lane == 31) {
        sums[0][warp] = si;
        sums[1][warp] = zi;
      }
      __syncthreads();
      if (warp == 0) {              // inclusive scan of the warps' sums
        int x = sums[0][lane], y = sums[1][lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int xx = __shfl_up_sync(0xffffffffu, x, o);
          const int yy = __shfl_up_sync(0xffffffffu, y, o);
          if (lane >= o) {
            x += xx;
            y += yy;
          }
        }
        sums[0][lane] = x;
        sums[1][lane] = y;
      }
      __syncthreads();
      const int ps = carry + si - c[u] + (warp > 0 ? sums[0][warp - 1] : 0);
      const int pz = carry_nz + zi - z + (warp > 0 ? sums[1][warp - 1] : 0);
      if (i < n_bins) {
        count[i] = ps;
        if (z) {
          nz[pz] = i;
          nz[n_bins + pz] = ps;
          nz[2 * n_bins + pz] = c[u];
        }
      }
      carry += sums[0][31];
      carry_nz += sums[1][31];
      __syncthreads();              // sums is rewritten next
    }
  }
  if (tid == 0) *n_nz = carry_nz;
}

__global__ void __launch_bounds__(INDEX_THREADS)
scatter_kernel(const int* __restrict__ bin_idx, int n_pairs, int n_bins,
               int* __restrict__ slot, int* __restrict__ pairs) {
  const int p = blockIdx.x * INDEX_THREADS + threadIdx.x;
  if (p >= n_pairs) return;
  const int b = bin_idx[p];
  if (b >= 0 && b < n_bins) pairs[atomicAdd(slot + b, 1)] = p;
}

// ---- The rescore sweep ---------------------------------------------------------
// Four row elements: one 16-byte (fp32) or 8-byte (bf16) copy, one read.
__device__ inline void copy4(float* dst, const float* src) {
  cp_async16(dst, src, true);
}
__device__ inline void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  cp_async8(dst, src);
}
__device__ inline float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float4 read4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One thread's products for n of a pass's pairs against its row: four
// partial sums a pair (columns c % 4), so that the FMAs do not wait on
// each other, added in a fixed order at the end.
template <int N, typename T>
__device__ inline void row_products(const T* mrow, const float* const* rp,
                                    int d, float* acc) {
  float a[N][4];
#pragma unroll
  for (int u = 0; u < N; ++u) a[u][0] = a[u][1] = a[u][2] = a[u][3] = 0.0f;
  for (int c = 0; c < d; c += 4) {
    const float4 m = read4(mrow + c);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const float4 r = read4(rp[u] + c);
      a[u][0] = fmaf(r.x, m.x, a[u][0]);
      a[u][1] = fmaf(r.y, m.y, a[u][1]);
      a[u][2] = fmaf(r.z, m.z, a[u][2]);
      a[u][3] = fmaf(r.w, m.w, a[u][3]);
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u) acc[u] = (a[u][0] + a[u][1]) + (a[u][2] + a[u][3]);
}

template <typename T>
__device__ inline void products_of(int n, const T* mrow,
                                   const float* const* rp, int d,
                                   float* acc) {
  switch (n) {
    case 1: row_products<1>(mrow, rp, d, acc); break;
    case 2: row_products<2>(mrow, rp, d, acc); break;
    case 3: row_products<3>(mrow, rp, d, acc); break;
    case 4: row_products<4>(mrow, rp, d, acc); break;
    case 5: row_products<5>(mrow, rp, d, acc); break;
    case 6: row_products<6>(mrow, rp, d, acc); break;
    case 7: row_products<7>(mrow, rp, d, acc); break;
    case 8: row_products<8>(mrow, rp, d, acc); break;
    default: break;
  }
}

// An item's bin, its first pair slot and its pair count (nz's columns).
struct Item {
  int bin, first, cnt;
};
__device__ inline Item item_at(const int* nz, int n_bins, int li) {
  return Item{nz[li], nz[n_bins + li], nz[2 * n_bins + li]};
}

// Shared memory: two stages, each `rows` rows of M (row stride d + 4
// elements, so that neighbouring rows start in other banks; m_bytes in
// all) and the item's first PMAX pair ids (stage_bytes in all); then the R
// rows: all Q of them, loaded once (`resident`), or pairs_per_pass rows
// staged a pass at a time. Item i is row chunk i % chunks of the non-empty
// bin nz[i / chunks]. The items' (bin, first, cnt) are read two items
// ahead, the rows and pair ids of the next item are in flight during this
// one's products, so an item waits on nothing but its own rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rescore_kernel(const float* __restrict__ R, const T* __restrict__ M,
               const int* __restrict__ nz, const int* __restrict__ n_nz,
               const int* __restrict__ pairs, float* __restrict__ out, int Q,
               int NB, int n_bins, int bw, int d, int rows, int chunks,
               int npl, int pairs_per_pass, int m_bytes, int stage_bytes,
               int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Rs = reinterpret_cast<float*>(smem + 2 * stage_bytes);
  const int ldm = d + 4, units = d / 4;
  const int n_items = *n_nz * chunks;
  const int tid = threadIdx.x, G = gridDim.x;
  const int row = tid % rows, pl = tid / rows;
  // This thread's copies of a stage's rows: the four-element units tid,
  // tid + THREADS, ... as (row, column), stepped without a division.
  const int r_first = tid / units, c_first = (tid % units) * 4;
  const int r_step = THREADS / units, c_step = (THREADS % units) * 4;
  int item = blockIdx.x;
  if (item >= n_items) return;
  if (resident) {
    for (int i = tid; i < Q * units; i += THREADS)
      reinterpret_cast<float4*>(Rs)[i] = reinterpret_cast<const float4*>(R)[i];
  }

  auto load = [&](int it, const Item& m, int stage) {
    const int r0 = (it % chunks) * rows;
    const int nr = min(rows, bw - r0);
    const T* src = M + (size_t(m.bin) * bw + r0) * d;
    unsigned char* st = smem + stage * stage_bytes;
    T* dst = reinterpret_cast<T*>(st);
    for (int r = r_first, c = c_first; r < nr;) {
      copy4(dst + r * ldm + c, src + size_t(r) * d + c);
      r += r_step;
      c += c_step;
      if (c >= d) {
        c -= d;
        ++r;
      }
    }
    int* ps = reinterpret_cast<int*>(st + m_bytes);
    for (int j = tid; j < min(m.cnt, PMAX); j += THREADS)
      cp_async4(ps + j, pairs + m.first + j, true);
  };

  Item cur = item_at(nz, n_bins, item / chunks), nxt = cur, ahead = cur;
  if (item + G < n_items) nxt = item_at(nz, n_bins, (item + G) / chunks);
  load(item, cur, 0);
  cp_commit();
  for (int k = 0; item < n_items; ++k, item += G) {
    if (item + 2 * G < n_items)     // used next round: its latency is hidden
      ahead = item_at(nz, n_bins, (item + 2 * G) / chunks);
    if (item + G < n_items) load(item + G, nxt, (k + 1) & 1);
    cp_commit();
    cp_wait<1>();                   // this item's rows and pair ids landed
    __syncthreads();
    const int r0 = (item % chunks) * rows;
    const unsigned char* st = smem + (k & 1) * stage_bytes;
    const T* mrow = reinterpret_cast<const T*>(st) + row * ldm;
    const int* ps = reinterpret_cast<const int*>(st + m_bytes);
    const bool live = pl < npl && r0 + row < bw;
    for (int p0 = 0; p0 < cur.cnt; p0 += pairs_per_pass) {
      const int np = min(pairs_per_pass, cur.cnt - p0);
      if (!resident) {              // stage this pass's R rows
        __syncthreads();
        for (int i = tid; i < np * units; i += THREADS) {
          const int j = i / units, c = (i - j * units) * 4;
          const int pj = p0 + j;
          const int q = (pj < PMAX ? ps[pj] : pairs[cur.first + pj]) / NB;
          *reinterpret_cast<float4*>(Rs + j * d + c) =
              *reinterpret_cast<const float4*>(R + size_t(q) * d + c);
        }
        __syncthreads();
      }
      if (!live) continue;
      // This thread's pairs of the pass: p0 + pl, + npl, ... (< np).
      const int mine = np > pl ? (np - pl + npl - 1) / npl : 0;
      int pid[PPT];
      const float* rp[PPT];
#pragma unroll
      for (int u = 0; u < PPT; ++u) {
        const int j = pl + u * npl, pj = p0 + j;
        pid[u] = u < mine ? (pj < PMAX ? ps[pj] : pairs[cur.first + pj]) : 0;
        rp[u] = Rs + (resident ? pid[u] / NB : j) * d;
      }
      float acc[PPT];
      products_of(mine, mrow, rp, d, acc);
#pragma unroll
      for (int u = 0; u < PPT; ++u)
        if (u < mine) out[size_t(pid[u]) * bw + r0 + row] = acc[u];
    }
    __syncthreads();                // every thread is done with the stage
    cur = nxt;
    nxt = ahead;
  }
  cp_wait<0>();
}

template <typename T>
int launch(const void* R, const void* M, const void* bin_idx, void* out,
           void* scratch, int Q, int NB, int n_bins, int bw, int d, int rows,
           int pairs_per_pass, int resident, int blocks, void* stream) {
  const cudaStream_t st = cudaStream_t(stream);
  const int n_pairs = Q * NB;
  const int* idx = static_cast<const int*>(bin_idx);
  int* count = static_cast<int*>(scratch);
  int* nz = count + n_bins;
  int* pairs = nz + 3 * size_t(n_bins);
  int* n_nz = pairs + n_pairs;
  float* o = static_cast<float*>(out);
  // The plan's decisions; everything the shared memory's layout follows
  // from is derived here, from this file's THREADS, PPT and PMAX.
  if (rows < 1 || rows > THREADS || rows > bw || pairs_per_pass < 1 ||
      pairs_per_pass > (THREADS / rows) * PPT)
    return int(cudaErrorInvalidValue);
  const int chunks = (bw + rows - 1) / rows, npl = THREADS / rows;
  const size_t row_bytes = size_t(d + 4) * sizeof(T);
  const size_t m_bytes = (rows * row_bytes + 15) / 16 * 16;
  const size_t stage_bytes = m_bytes + 4 * PMAX;
  const size_t smem = 2 * stage_bytes +
                      4 * size_t(d) * (resident ? Q : pairs_per_pass);
  if (smem > size_t(INT_MAX)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(count, 0, size_t(n_bins) * 4, st);
  if (err != cudaSuccess) return int(err);
  const int grid = (n_pairs + INDEX_THREADS - 1) / INDEX_THREADS;
  count_kernel<<<grid, INDEX_THREADS, 0, st>>>(idx, n_pairs, n_bins, bw,
                                                count, o);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(count, n_bins, nz, n_nz);
  scatter_kernel<<<grid, INDEX_THREADS, 0, st>>>(idx, n_pairs, n_bins, count,
                                                  pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 0) return int(err);
  // Fails (rather than overrunning) where the layout passes the card's limit.
  err = cudaFuncSetAttribute(rescore_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  rescore_kernel<T><<<blocks, THREADS, smem, st>>>(
      static_cast<const float*>(R), static_cast<const T*>(M), nz, n_nz, pairs,
      o, Q, NB, n_bins, bw, d, rows, chunks, npl, pairs_per_pass,
      int(m_bytes), int(stage_bytes), resident);
  return int(cudaGetLastError());
}

}  // namespace

// R [Q, d] fp32 (already rounded through M's dtype by the wrapper),
// M_binned [n_bins, bw, d] fp32 or bf16, bin_idx [Q, NB] int32, out
// [Q, NB * bw] fp32, scratch int32 [4 n_bins + Q NB + 1]. d % 4 == 0; rows,
// pairs_per_pass, resident and blocks are the wrapper's plan
// (ops/gather_rescore.py _plan), which checks every shape.
extern "C" int sert_gather_rescore_f32(const void* R, const void* M,
                                       const void* bin_idx, void* out,
                                       void* scratch, int Q, int NB,
                                       int n_bins, int bw, int d, int rows,
                                       int pairs_per_pass, int resident,
                                       int blocks, void* stream) {
  return launch<float>(R, M, bin_idx, out, scratch, Q, NB, n_bins, bw, d,
                       rows, pairs_per_pass, resident, blocks, stream);
}

extern "C" int sert_gather_rescore_bf16(const void* R, const void* M,
                                        const void* bin_idx, void* out,
                                        void* scratch, int Q, int NB,
                                        int n_bins, int bw, int d, int rows,
                                        int pairs_per_pass, int resident,
                                        int blocks, void* stream) {
  return launch<__nv_bfloat16>(R, M, bin_idx, out, scratch, Q, NB, n_bins,
                               bw, d, rows, pairs_per_pass, resident, blocks,
                               stream);
}
