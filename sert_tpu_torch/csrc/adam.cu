// The dense adam update: one pass over each leaf's p, g, m and v.
//
// Replaces no Pallas kernel. It stands in for optax's adam in the JAX
// package (sert_tpu/train/step.py's make_optimizer), which XLA fuses into one
// elementwise pass over each leaf; the port's eager PyTorch ran the update of
// train/step.py's Optimizer as fourteen elementwise passes a leaf instead.
// Its arithmetic is ops/adam.py's adam_plain to the bit: the same float
// operations, in the same order, each rounded where PyTorch rounds it (see
// adam_elem). The gradient may be of a wider dtype than p, m and v (the
// fused step's fp32 bias gradient of bf16 params): what involves p, m or v
// rounds to their dtype, what involves the gradient alone to its own.
//
// What bounds it on the H100: bytes. Each element reads p, g, m and v and
// writes p, m and v: 28 bytes in fp32, 14 in bf16 (16 with an fp32
// gradient), against some 25 float operations (one square root and one
// division among them). At the flagship's four fp32 leaves (250k x 128,
// 1M x 128, 128 x 128, 128: 160.0M elements) that is 4.48 GB, 1.337 ms at
// 3.35 TB/s.
//
// How the design meets that bound:
//   - One launch for all of a dtype's leaves (up to MAX_LEAVES): the leaves'
//     pointers, sizes and the prefix sums of their blocks travel in a table
//     passed by value as a kernel parameter, so there is no copy of a table
//     to the device and no launch beside this one. A block finds its leaf in
//     the prefix sums and its chunk of the leaf from the remainder.
//   - Streaming: 16-byte loads and stores (a float4 of fp32, eight bf16), each
//     thread holding 16 elements of each of the four inputs in flight before
//     it computes (four vectors of fp32, two of bf16; with an fp32 gradient
//     of bf16 params, units of eight elements: one vector of p, m and v, two
//     of g), neighbouring threads on neighbouring units; loads and stores
//     are marked evict-first (__ldcs, __stcs), since nothing reads the data
//     again before it has left the 50 MB L2. On the H100 at the flagship's
//     leaves, 2, 4 and 8 fp32 vectors a thread and 128-512 threads a block
//     ran within 1 % of each other; bf16 ran 3.5 % faster with two vectors
//     than with four (117 registers a thread against 72) and at half the
//     speed with eight.
//   - A leaf whose four tensors all reach a 16-byte boundary at one element
//     runs its elements before it (head) and the last ones past the final
//     whole unit (tail) one by one, in its first block; a leaf whose tensors
//     reach none together runs every element on its own (the scalar body),
//     still one element a thread and coalesced.
//   - Nothing is allocated and nothing synchronises: the kernel runs on the
//     caller's stream. With clipping on, each block reads the global norm
//     from device memory, so the host never waits for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 32;   // ops/adam.py's MAX_LEAVES
// S stores p, m and v, G the gradient. Elements a unit (16 bytes of the
// narrower type); units of each input a thread keeps in flight (16
// elements); units (or elements, in a scalar body) a block.
template <typename S, typename G>
constexpr int VEC = 16 / (sizeof(S) < sizeof(G) ? sizeof(S) : sizeof(G));
template <typename S, typename G> constexpr int UNROLL = 16 / VEC<S, G>;
template <typename S, typename G>
constexpr long long CHUNK = THREADS * UNROLL<S, G>;

// A leaf of the table: its four tensors, each contiguous with n elements; in
// vector mode head elements, then body units, then tail elements; in scalar
// mode (vec 0) body elements.
struct Leaf {
  void* p;
  const void* g;
  void* m;
  void* v;
  long long head, body, tail;
  int vec;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  // Each leaf's first block; first[leaves]: the grid.
  long long first[MAX_LEAVES + 1];
  int leaves;
};

// adam's constants, each a float of the gradient's dtype (the plain
// version's Python floats), but the reciprocals: PyTorch divides a CUDA
// tensor by a Python float as a product with the float's fp32 reciprocal.
struct Consts {
  float b1, c1, b2, c2;          // B1, 1 - B1, B2, 1 - B2
  float inv_bc1, inv_bc2;        // 1 / (1 - B1^t), 1 / (1 - B2^t), in fp32
  float eps, neg_lr, neg_decay;
  float clip_below, clip;        // g is kept where norm < clip_below
  int decay;
  const float* norm;  // the gradients' global norm; null: no clipping
};

// Storage types: fp32 as float, bf16 as its 16 bits.
__device__ inline float f32(float x) { return x; }
__device__ inline float f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}
template <typename T> __device__ inline T store(float x);
template <> __device__ inline float store<float>(float x) { return x; }
template <> __device__ inline unsigned short store<unsigned short>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// x rounded to T: what a PyTorch elementwise op whose result is T returns,
// having computed in fp32.
template <typename T> __device__ inline float rnd(float x) {
  return f32(store<T>(x));
}

// Where the block clips: the norm rounded to the gradient's dtype.
struct Clip {
  bool on;
  float norm;
};

template <typename G>
__device__ inline Clip clip_of(const Consts& k) {
  if (k.norm == nullptr) return {false, 0.0f};
  const float n = *k.norm;
  return {!(n < k.clip_below), rnd<G>(n)};
}

// One element, in place, in adam_plain's order with round-to-nearest
// intrinsics (no contraction); what involves the gradient alone rounds to
// G, the rest to S:
//   g = where(norm < clip_below, g, g / norm * clip)
//   m = m * b1 + g * c1;  v = v * b2 + (g * g) * c2
//   u = ((m * inv_bc1) / (sqrt(v * inv_bc2) + eps)) * neg_lr
//   u = u + p * neg_decay (with decay);  p = p + u
template <typename S, typename G>
__device__ inline void adam_elem(S& ps, G gs, S& ms, S& vs, const Consts& k,
                                 const Clip& c) {
  float g = f32(gs);
  if (c.on) g = rnd<G>(__fmul_rn(rnd<G>(__fdiv_rn(g, c.norm)), k.clip));
  const float m = rnd<S>(__fadd_rn(rnd<S>(__fmul_rn(f32(ms), k.b1)),
                                   rnd<G>(__fmul_rn(g, k.c1))));
  const float v = rnd<S>(__fadd_rn(
      rnd<S>(__fmul_rn(f32(vs), k.b2)),
      rnd<G>(__fmul_rn(rnd<G>(__fmul_rn(g, g)), k.c2))));
  const float den = rnd<S>(__fadd_rn(
      rnd<S>(__fsqrt_rn(rnd<S>(__fmul_rn(v, k.inv_bc2)))), k.eps));
  float u = rnd<S>(__fdiv_rn(rnd<S>(__fmul_rn(m, k.inv_bc1)), den));
  u = rnd<S>(__fmul_rn(u, k.neg_lr));
  const float p = f32(ps);
  if (k.decay) u = rnd<S>(__fadd_rn(u, rnd<S>(__fmul_rn(p, k.neg_decay))));
  ps = store<S>(__fadd_rn(p, u));
  ms = store<S>(m);
  vs = store<S>(v);
}

// V elements of T: one or two 16-byte vectors.
template <typename T, int V> constexpr int WORDS = V * int(sizeof(T)) / 16;
template <typename T, int V>
union Unit {
  uint4 raw[WORDS<T, V>];
  T x[V];
};

template <typename T, int V>
__device__ inline void load(Unit<T, V>& u, const void* base, long long i) {
  const uint4* q = static_cast<const uint4*>(base) + i * WORDS<T, V>;
#pragma unroll
  for (int w = 0; w < WORDS<T, V>; ++w) u.raw[w] = __ldcs(q + w);
}

template <typename T, int V>
__device__ inline void save(const Unit<T, V>& u, void* base, long long i) {
  uint4* q = static_cast<uint4*>(base) + i * WORDS<T, V>;
#pragma unroll
  for (int w = 0; w < WORDS<T, V>; ++w) __stcs(q + w, u.raw[w]);
}

// The block's chunk of a vector body.
template <typename S, typename G>
__device__ inline void vec_chunk(const Leaf& L, long long chunk,
                                 const Consts& k, const Clip& c) {
  constexpr int V = VEC<S, G>, U = UNROLL<S, G>;
  S* pp = static_cast<S*>(L.p) + L.head;
  const G* gp = static_cast<const G*>(L.g) + L.head;
  S* mp = static_cast<S*>(L.m) + L.head;
  S* vp = static_cast<S*>(L.v) + L.head;
  const long long base = chunk * CHUNK<S, G> + threadIdx.x;
  Unit<S, V> p[U], m[U], v[U];
  Unit<G, V> g[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + u * THREADS;
    if (i < L.body) {
      load(p[u], pp, i);
      load(g[u], gp, i);
      load(m[u], mp, i);
      load(v[u], vp, i);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + u * THREADS;
    if (i < L.body) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        adam_elem<S, G>(p[u].x[j], g[u].x[j], m[u].x[j], v[u].x[j], k, c);
      save(p[u], pp, i);
      save(m[u], mp, i);
      save(v[u], vp, i);
    }
  }
}

// Element i of a leaf, on its own.
template <typename S, typename G>
__device__ inline void one(const Leaf& L, long long i, const Consts& k,
                           const Clip& c) {
  S* p = static_cast<S*>(L.p) + i;
  S* m = static_cast<S*>(L.m) + i;
  S* v = static_cast<S*>(L.v) + i;
  S ps = *p, ms = *m, vs = *v;
  adam_elem<S, G>(ps, static_cast<const G*>(L.g)[i], ms, vs, k, c);
  *p = ps;
  *m = ms;
  *v = vs;
}

template <typename S, typename G>
__global__ void __launch_bounds__(THREADS)
    adam_kernel(const __grid_constant__ Table t, const Consts k) {
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.leaves && t.first[l + 1] <= b) ++l;
  const Leaf& L = t.leaf[l];
  const long long chunk = b - t.first[l];
  const Clip c = clip_of<G>(k);
  if (L.vec) {
    vec_chunk<S, G>(L, chunk, k, c);
    // The head and tail, fewer than a unit each, in the leaf's first block.
    const int at = threadIdx.x;
    if (chunk == 0 && at < L.head + L.tail)
      one<S, G>(L, at < L.head ? at : L.body * VEC<S, G> + at, k, c);
  } else {
    const long long base = chunk * CHUNK<S, G> + threadIdx.x;
#pragma unroll
    for (int u = 0; u < UNROLL<S, G>; ++u)
      if (base + u * THREADS < L.body) one<S, G>(L, base + u * THREADS, k, c);
  }
}

// rows: leaves x (p, g, m, v, n, head) as int64, head -1 where the four
// tensors reach a 16-byte boundary at no common element.
template <typename S, typename G>
int launch(const long long* rows, int leaves, const Consts& k, void* stream) {
  constexpr int V = VEC<S, G>;
  if (leaves < 0 || leaves > MAX_LEAVES) return int(cudaErrorInvalidValue);
  Table t{};
  t.leaves = leaves;
  t.first[0] = 0;
  for (int l = 0; l < leaves; ++l) {
    const long long* r = rows + 6 * l;
    Leaf& L = t.leaf[l];
    L.p = reinterpret_cast<void*>(r[0]);
    L.g = reinterpret_cast<const void*>(r[1]);
    L.m = reinterpret_cast<void*>(r[2]);
    L.v = reinterpret_cast<void*>(r[3]);
    const long long n = r[4];
    L.vec = r[5] >= 0;
    L.head = L.vec ? r[5] : 0;
    L.body = L.vec ? (n - L.head) / V : n;
    L.tail = n - L.head - (L.vec ? L.body * V : L.body);
    const long long chunks = (L.body + CHUNK<S, G> - 1) / CHUNK<S, G>;
    t.first[l + 1] = t.first[l] + (chunks > 0 ? chunks : 1);
  }
  const long long blocks = t.first[leaves];
  if (blocks == 0) return int(cudaSuccess);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  adam_kernel<S, G><<<unsigned(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, k);
  return int(cudaGetLastError());
}

Consts consts(float b1, float c1, float b2, float c2, float inv_bc1,
              float inv_bc2, float eps, float neg_lr, float neg_decay,
              int decay, const void* norm, float clip_below, float clip) {
  return Consts{b1, c1, b2, c2, inv_bc1, inv_bc2, eps, neg_lr, neg_decay,
                clip_below, clip, decay, static_cast<const float*>(norm)};
}

}  // namespace

// The entry points: p, m and v in fp32 or bf16, the gradient of their dtype
// or, for bf16 params, fp32.

extern "C" int sert_adam_update_f32(const void* rows, int leaves,
                                    float b1, float c1, float b2, float c2,
                                    float inv_bc1, float inv_bc2, float eps,
                                    float neg_lr, float neg_decay, int decay,
                                    const void* norm, float clip_below,
                                    float clip, void* stream) {
  return launch<float, float>(
      static_cast<const long long*>(rows), leaves,
      consts(b1, c1, b2, c2, inv_bc1, inv_bc2, eps, neg_lr, neg_decay, decay,
             norm, clip_below, clip),
      stream);
}

extern "C" int sert_adam_update_bf16(const void* rows, int leaves,
                                     float b1, float c1, float b2, float c2,
                                     float inv_bc1, float inv_bc2, float eps,
                                     float neg_lr, float neg_decay, int decay,
                                     const void* norm, float clip_below,
                                     float clip, void* stream) {
  return launch<unsigned short, unsigned short>(
      static_cast<const long long*>(rows), leaves,
      consts(b1, c1, b2, c2, inv_bc1, inv_bc2, eps, neg_lr, neg_decay, decay,
             norm, clip_below, clip),
      stream);
}

extern "C" int sert_adam_update_bf16_f32grad(
    const void* rows, int leaves, float b1, float c1, float b2, float c2,
    float inv_bc1, float inv_bc2, float eps, float neg_lr, float neg_decay,
    int decay, const void* norm, float clip_below, float clip, void* stream) {
  return launch<unsigned short, float>(
      static_cast<const long long*>(rows), leaves,
      consts(b1, c1, b2, c2, inv_bc1, inv_bc2, eps, neg_lr, neg_decay, decay,
             norm, clip_below, clip),
      stream);
}
