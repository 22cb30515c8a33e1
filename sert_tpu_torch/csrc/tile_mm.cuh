// The tile geometry of the full-softmax sweep (K5-K7, xent.cu): 64-row
// batch and entity tiles, eight warps a block, the row stride of its fp32
// logits tile, the masked logit, and the running (max, sumexp) of a logits
// tile that K5 keeps per row.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;              // batch rows and columns per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDZ = TILE + 4;         // fp32 logits-tile row stride
constexpr float MASKED = -1e30f;

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
