// Shared pieces of the batch-by-column tile kernels K1/K2 (sampled_lse.cu):
// the tile geometry, one block's shared-memory layout, row staging, the
// 64-row tile product on tensor cores (bf16, wmma) or CUDA cores (fp32),
// and the running (max, sumexp) of a logits tile. The sweeps of K5-K7
// (xent.cu) take the tile geometry and the running (max, sumexp) only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;              // batch rows and columns per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDZ = TILE + 4;         // fp32 logits-tile row stride
constexpr int LDP = TILE + 8;         // bf16 probability-tile row stride
constexpr float MASKED = -1e30f;

// Shared-memory row padding of the operand tiles: 16 bytes for the bf16
// wmma tiles, one float for the fp32 tiles (an odd stride keeps the column
// reads of the CUDA-core product free of bank conflicts).
template <typename T> constexpr int pad() { return sizeof(T) == 2 ? 8 : 1; }

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// Byte offsets of one block's shared memory (host and device agree): the
// batch-row tile r, the column tile c, the fp32 logits tile z, the bf16
// probability tile p (bf16 only), the fp32 accumulator (backward only) and
// five per-tile vectors of TILE 4-byte entries.
template <typename T>
struct Layout {
  int ldt, lda;
  size_t r, c, z, p, acc, vec, total;
  __host__ __device__ Layout(int dp, bool with_acc) {
    ldt = dp + pad<T>();
    lda = dp + 4;
    r = 0;
    c = align128(r + size_t(TILE) * ldt * sizeof(T));
    z = align128(c + size_t(TILE) * ldt * sizeof(T));
    p = align128(z + size_t(TILE) * LDZ * sizeof(float));
    // fp32 products read p straight from the logits tile.
    acc = align128(p + (sizeof(T) == 2 ? size_t(TILE) * LDP * sizeof(bf16)
                                       : size_t(0)));
    vec = align128(acc + (with_acc ? size_t(TILE) * lda * sizeof(float)
                                   : size_t(0)));
    total = vec + 5 * TILE * sizeof(float);
  }
};

// Copy rows [row0, row0 + TILE) of a [rows, dp] matrix into a shared tile
// of stride ld; rows at or past `rows` are zero.
template <typename T>
__device__ void stage(T* s, int ld, const T* g, int row0, int rows, int dp) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = dp / V;
  for (int i = threadIdx.x; i < TILE * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * V;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      v = __ldg(reinterpret_cast<const uint4*>(g + size_t(row0 + r) * dp + c));
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(s + r * ld + c) = v;
    } else {
      const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r * ld + c + q] = f[q];
    }
  }
}

// C[64 x N] (+)= A[64 x K] . B[K x N], every operand in shared memory; N and
// K are multiples of 32 and 16. A_COL: A(m, k) = A[k * lda + m], else
// A[m * lda + k]. B_COL: B(k, n) = B[n * ldb + k], else B[k * ldb + n].
// bf16: tensor cores through wmma, warp w owning row tile w / 2 and half of
// the column tiles; fp32: one output per thread at a time on the CUDA cores.
template <bool A_COL, bool B_COL>
__device__ void block_mm(const bf16* A, int lda, const bf16* B, int ldb,
                         float* C, int ldc, int N, int K, bool accumulate) {
  using ALayout = typename std::conditional<A_COL, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<B_COL, wmma::col_major,
                                            wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int mt = warp / 2;
  const int per = N / 32;
  const int nt0 = (warp % 2) * per;
  for (int j = 0; j < per; ++j) {
    const int nt = nt0 + j;
    float* cp = C + mt * 16 * ldc + nt * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wmma::load_matrix_sync(
          a, A_COL ? A + kk * lda + mt * 16 : A + mt * 16 * lda + kk, lda);
      wmma::load_matrix_sync(
          b, B_COL ? B + nt * 16 * ldb + kk : B + kk * ldb + nt * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
}

template <bool A_COL, bool B_COL>
__device__ void block_mm(const float* A, int lda, const float* B, int ldb,
                         float* C, int ldc, int N, int K, bool accumulate) {
  for (int o = threadIdx.x; o < TILE * N; o += THREADS) {
    const int m = o / N, n = o % N;
    float s = accumulate ? C[m * ldc + n] : 0.0f;
    for (int k = 0; k < K; ++k)
      s = fmaf(A_COL ? A[k * lda + m] : A[m * lda + k],
               B_COL ? B[n * ldb + k] : B[k * ldb + n], s);
    C[m * ldc + n] = s;
  }
}

// The probability tile as a product operand: the bf16 copy for bf16
// products, the fp32 logits tile itself for fp32 ones.
template <typename T>
__device__ const T* p_tile(const float* Zs, const bf16* Ps) {
  if constexpr (sizeof(T) == 2) return reinterpret_cast<const T*>(Ps);
  else return reinterpret_cast<const T*>(Zs);
}

template <typename T>
__device__ constexpr int p_ld() { return sizeof(T) == 2 ? LDP : LDZ; }

// Fold one 64-column logits tile into each warp's running (max, sumexp) of
// its TILE / WARPS rows: z(r, c) = Zs[r][c] + add(c), or MASKED where
// keep(r, c) is false.
template <typename Add, typename Keep>
__device__ void online_lse(const float* Zs, float* m_run, float* s_run,
                           Add add, Keep keep) {
  constexpr int ROWS = TILE / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp * ROWS + i;
    float z[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      z[h] = keep(r, c) ? Zs[r * LDZ + c] + add(c) : MASKED;
    }
    float mx = fmaxf(z[0], z[1]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m_run[i], mx);
    float s = expf(z[0] - mn) + expf(z[1] - mn);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    s_run[i] = s_run[i] * expf(m_run[i] - mn) + s;
    m_run[i] = mn;
  }
}

}  // namespace
