// K7's optimizer update of one element of W and its slots, shared by both
// of its sweeps: the mma.sync sweep of xent.cu (fp32 compute) and the
// wgmma sweep of xent_wgmma.cu (bf16 compute), so that the two apply the
// same float operations in the same order to the same gradient.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// K7's optimizers, in the order of ops/xent.py's OPTIMIZERS; their
// constants are baked in as the reference bakes them (xent_bwd_apply :552).
enum Opt : int { ADAM = 0, ADAGRAD = 1, SGD = 2 };
// 1 - b1 and 1 - b2 are taken in double and rounded to fp32 once, as the
// reference's Python floats are (not 1.0f - 0.9f, which is 2.2e-8 off).
constexpr float B1 = 0.9f, B1C = 0.1f, B2 = 0.999f, B2C = 0.001f;
constexpr float ADAM_EPS = 1e-8f, ADAGRAD_EPS = 1e-7f;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ inline T from_f32(float x);
template <> __device__ inline float from_f32<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// K7's update: W itself (written in place), its slots s1, s2 ((m, v) for
// adam, (acc, -) for adagrad, unused for sgd, each shaped and typed as W),
// the per-entity-tile sums of G^2, and the update's constants.
template <typename WT>
struct Update {
  WT* w;
  WT* s1;
  WT* s2;
  float* gsq;
  int opt;
  float lr, gscale, bc1, bc2;
};

// W's element and its slots' (those the optimizer has), in fp32.
struct Elem {
  float w, s1, s2;
};
template <typename WT>
__device__ inline Elem load_elem(const Update<WT>& u, long long at) {
  Elem e{to_f32(u.w[at]), 0.0f, 0.0f};
  if (u.opt != SGD) e.s1 = to_f32(u.s1[at]);
  if (u.opt == ADAM) e.s2 = to_f32(u.s2[at]);
  return e;
}

// The update of W's element `at` (loaded as e) from its gradient g, in
// place, in fp32 from the stored values, in the reference's order
// (_bwd_update_kernel :501-522) with round-to-nearest intrinsics (no
// contraction); results stored in W's type. Returns sq + g^2.
template <typename WT>
__device__ inline float store_update(const Update<WT>& u, long long at,
                                     float g, Elem e, float sq) {
  sq = __fadd_rn(sq, __fmul_rn(g, g));
  float upd;
  if (u.opt == ADAM) {
    const float m2 = __fadd_rn(__fmul_rn(B1, e.s1), __fmul_rn(B1C, g));
    const float v2 = __fadd_rn(__fmul_rn(B2, e.s2),
                               __fmul_rn(__fmul_rn(B2C, g), g));
    upd = __fdiv_rn(__fmul_rn(u.lr, __fdiv_rn(m2, u.bc1)),
                    __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, u.bc2)), ADAM_EPS));
    u.s1[at] = from_f32<WT>(m2);
    u.s2[at] = from_f32<WT>(v2);
  } else if (u.opt == ADAGRAD) {
    const float a2 = __fadd_rn(e.s1, __fmul_rn(g, g));
    upd = __fmul_rn(__fmul_rn(u.lr, g),
                    a2 > 0.0f ? __frsqrt_rn(__fadd_rn(a2, ADAGRAD_EPS))
                              : 0.0f);
    u.s1[at] = from_f32<WT>(a2);
  } else {
    upd = __fmul_rn(u.lr, g);
  }
  u.w[at] = from_f32<WT>(__fsub_rn(e.w, upd));
  return sq;
}

// The sum over a block's NW warps of one value a thread, in a fixed order
// (lanes, then warps in turn), in thread 0; `red` is NW floats of shared
// memory, one a warp.
template <int NW>
__device__ inline float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

}  // namespace
