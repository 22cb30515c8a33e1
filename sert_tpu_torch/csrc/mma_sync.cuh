// Warp-level fp32 tensor-core products (3xTF32) through mma.sync for
// sm_90a, and asynchronous global -> shared copies (cp.async): the pieces of
// the fp32 sweeps (xent.cu, and the fp32 modes of sampled_lse.cu and
// score_binmax.cu) that a block's own tiling does not decide; K4's rescore
// sweep (gather_rescore.cu) takes the copies alone.
//
// Fragments are laid out as the PTX ISA lays out m16n8k8 (tf32): lane l
// holds rows g = l / 4 and g + 8, and columns (k) t = l % 4 (+ 4); a
// 16 x 8 fp32 accumulator tile C holds C[g][2t], C[g][2t + 1], C[g + 8][2t],
// C[g + 8][2t + 1]. Operands are read from shared memory one element a
// load and split into TF32 (hi, lo) parts as they are loaded.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int KSTEP = 8;      // fragment depth

struct Acc8 {                 // one 16 x 8 fp32 accumulator tile
  float c[4];
};
struct FragA {                // a 16 x KSTEP operand as TF32 (hi, lo)
  uint32_t hi[4], lo[4];
};
struct FragB {                // a KSTEP x 8 operand
  uint32_t hi[2], lo[2];
};

__device__ inline int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ inline int lane_t() { return threadIdx.x & 3; }

// x = hi + lo with hi and lo TF32 (10 mantissa bits, rounded half away
// from zero) and x - hi exact: two integer operations each, for finite x.
__device__ inline void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// A(m, k) = S[m * ld + k], row-major.
__device__ inline void load_a(FragA& a, const float* S, int ld) {
  const int g = lane_g(), t = lane_t();
  split(S[g * ld + t], a.hi[0], a.lo[0]);
  split(S[(g + 8) * ld + t], a.hi[1], a.lo[1]);
  split(S[g * ld + t + 4], a.hi[2], a.lo[2]);
  split(S[(g + 8) * ld + t + 4], a.hi[3], a.lo[3]);
}
// B(k, n) = S[n * ld + k]: the z pass's Y rows.
__device__ inline void load_b_nk(FragB& b, const float* S, int ld) {
  const int g = lane_g(), t = lane_t();
  split(S[g * ld + t], b.hi[0], b.lo[0]);
  split(S[g * ld + t + 4], b.hi[1], b.lo[1]);
}
// B(k, n) = S[k * ld + n]: the acc pass's Y rows.
__device__ inline void load_b_kn(FragB& b, const float* S, int ld) {
  const int g = lane_g(), t = lane_t();
  split(S[t * ld + g], b.hi[0], b.lo[0]);
  split(S[(t + 4) * ld + g], b.hi[1], b.lo[1]);
}

__device__ inline void mma_tf32(float* c, const uint32_t* a,
                                const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a . b as 3xTF32, the small terms first.
__device__ inline void tc_mma(Acc8& c, const FragA& a, const FragB& b) {
  mma_tf32(c.c, a.lo, b.hi);
  mma_tf32(c.c, a.hi, b.lo);
  mma_tf32(c.c, a.hi, b.hi);
}

// C(m, n) -> S[m * ld + n] (ld even), or S[n * ld + m] (transposed).
__device__ inline void store_c(float* S, int ld, const Acc8& c) {
  const int g = lane_g(), t = 2 * lane_t();
  *reinterpret_cast<float2*>(S + g * ld + t) = make_float2(c.c[0], c.c[1]);
  *reinterpret_cast<float2*>(S + (g + 8) * ld + t) =
      make_float2(c.c[2], c.c[3]);
}
// c += S[m * ld + n], the elements store_c writes.
__device__ inline void add_c(Acc8& c, const float* S, int ld) {
  const int g = lane_g(), t = 2 * lane_t();
  const float2 u = *reinterpret_cast<const float2*>(S + g * ld + t);
  const float2 v = *reinterpret_cast<const float2*>(S + (g + 8) * ld + t);
  c.c[0] += u.x;
  c.c[1] += u.y;
  c.c[2] += v.x;
  c.c[3] += v.y;
}
__device__ inline void store_c_t(float* S, size_t ld, const Acc8& c) {
  const int g = lane_g(), t = 2 * lane_t();
  S[t * ld + g] = c.c[0];
  S[(t + 1) * ld + g] = c.c[1];
  S[t * ld + g + 8] = c.c[2];
  S[(t + 1) * ld + g + 8] = c.c[3];
}

// Asynchronous global -> shared copies of 16, 8 or 4 bytes; `valid` false
// fills the destination with zeros and reads nothing.
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ inline void cp_async8(void* dst, const void* src) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
