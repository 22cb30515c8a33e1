// Hopper's asynchronous pieces for sm_90a, as inline PTX: mbarriers, TMA
// tile loads into 128-byte-swizzled shared memory, wgmma descriptors and
// the bf16 wgmma instructions, warpgroup register rebalancing. Used by the
// warp-specialized sweeps of K1/K2 (sampled_lse.cu), K3 (score_binmax.cu)
// and K5/K6 in bf16 (xent_wgmma.cu), with the host side's tensor maps.
//
// Layout conventions. A tile of rows x (128 bytes) is loaded by one TMA box
// with CU_TENSOR_MAP_SWIZZLE_128B: row r lands at byte 128 r, and its 16-byte
// chunk c at chunk c ^ (r % 8), so every tile starts on a 1024-byte
// boundary. A wider operand is a row of such tiles ("sub-tiles", one per
// 128 bytes of width). wgmma reads them through descriptors:
//   K-major (the product's depth is the contiguous axis): start address of
//     the rows and 16-element depth step (32 bytes on within the row), stride
//     byte offset 1024 (8 rows); the leading byte offset is unused;
//   MN-major (the output's rows, for A, or columns, for B, are contiguous):
//     leading byte offset = the stride between sub-tiles (64 output rows or
//     columns each), stride byte offset 1024 (the next 8 rows of depth), a
//     16-deep step 2048 bytes on.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ inline uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------
__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// An arrival that also announces `bytes` of TMA traffic to complete the phase.
__device__ inline void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that has
// not ended after ~2^32 clocks (about two seconds) traps, so a protocol
// fault surfaces as a launch error instead of a hung card.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------
// Box (c0 = column in elements, c1 = row) of the tensor map `map` (a
// __grid_constant__ parameter) into shared memory at `dst`, completing
// its bytes on `bar`.
__device__ inline void tma_load_2d(uint32_t dst, const void* map, uint32_t bar,
                                   int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 2^x on the special-function unit alone: flushes a subnormal result to
// zero (a probability below 1e-38), ex2(-inf) = 0.
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- warpgroups -------------------------------------------------------------
template <int N>
__device__ inline void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ inline void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across its issue and its wait.
template <int N>
__device__ inline void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A 128-byte-swizzle wgmma descriptor (layout type 1) for shared address
// `addr`, with leading and stride byte offsets `lbo` and `sbo`.
__device__ inline uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                      uint32_t sbo) {
  return uint64_t((addr & 0x3ffff) >> 4) |
         uint64_t((lbo >> 4) & 0x3fff) << 16 |
         uint64_t((sbo >> 4) & 0x3fff) << 32 | uint64_t(1) << 62;
}

// wgmma.m64nNk16 with fp32 accumulators and bf16 operands: ss() with A and
// B both from shared memory (K-major; N = 64, 128), rs() with A from
// registers and B MN-major (N = 64, 128, 256). Each thread of the warpgroup holds N / 2 accumulators: warp w
// rows 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4) (+ 1) of each 8-column
// block j, as d[4 j .. 4 j + 3] (l the lane).
template <int N>
struct Wgmma;

template <> struct Wgmma<64> {
  // d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory,
  // K-major, or MN-major where TA / TB is 1.
  template <int TA = 0, int TB = 0>
  static __device__ inline void ss(float (&d)[32], uint64_t a, uint64_t b,
                                 int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
  // d[64 x 64] += A[64 x 16] . B[16 x 64], A bf16 pairs in registers (the
  // accumulator layout), B in shared memory, MN-major (TB = 1) or K-major.
  template <int TB = 1>
  static __device__ inline void rs(float (&d)[32], const uint32_t (&a)[4],
                                 uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <> struct Wgmma<128> {
  // d[64 x 128] (+)= A[64 x 16] . B[16 x 128], as Wgmma<64>::ss.
  template <int TA = 0, int TB = 0>
  static __device__ inline void ss(float (&d)[64], uint64_t a, uint64_t b,
                                 int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
  // d[64 x 128] += A[64 x 16] . B[16 x 128], as Wgmma<64>::rs.
  template <int TB = 1>
  static __device__ inline void rs(float (&d)[64], const uint32_t (&a)[4],
                                 uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <> struct Wgmma<256> {
  // d[64 x 256] += A[64 x 16] . B[16 x 256], as Wgmma<64>::rs.
  template <int TB = 1>
  static __device__ inline void rs(float (&d)[128], const uint32_t (&a)[4],
                                 uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

// ---- Host side: tensor maps ----------------------------------------------
// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major [rows, cols] matrix of T at `ptr`, rows
// `ld` elements apart (cols where ld is 0): boxes of box_rows x 128 bytes,
// 128-byte swizzle, zeros past its edges. The encoder checks `ptr` against
// the calling thread's context, which a thread that has made no runtime call
// yet may lack (an autograd worker whose first CUDA work is a kernel here:
// the encoder then refuses a valid address), so the runtime binds one first.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows, long long ld = 0) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cudaError_t bound = cudaFree(nullptr);
  if (bound != cudaSuccess) return bound;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(ld > 0 ? ld : cols) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(128 / sizeof(T)),
                             cuuint32_t(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
