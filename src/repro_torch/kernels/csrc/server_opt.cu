// Server aggregator step of the objectives layer (FedAvgM / FedAdam) for
// every leaf of the global in ONE launch, elementwise in f32:
//
//   d    = old - avg
//   m'   = kind == 0 ? m : b1*m + (kind == 2 ? 1 - b1 : 1) * d
//   v'   = kind == 2 ? b2*v + ((1 - b2)*d)*d : v
//   step = kind == 2 ? m' / (sqrt(v') + eps) : m'
//   out  = inert ? avg : old - slr*step,
//   inert = kind == 0 | (kind == 1 & b1 == 0 & slr == 1)
//
// outputs (out, m', v') cast to the operands' dtype (f32 or bf16).
//
// Replaces the TPU kernel src/repro/kernels/server_opt.py::server_opt_pallas
// (four leaf-shaped streams in, three out, plus a (1, 5) consts tile; the
// reference maps it over the global's leaves, one call each).
//
// Bound on this card: bytes. Each element reads avg, old, m, v and writes
// out, m', v' — 7 * n * itemsize over all leaves — against at most 13
// flops (FedAdam), far below the card's operations-per-byte line. The
// design, in the style of fused_sgd.cu:
//   * one launch takes up to kMaxLeaves leaves; their seven pointers, n
//     and a prefix of chunk counts travel BY VALUE in the kernel's
//     parameter space (a __grid_constant__ table, ~2.2 KB for 32 leaves),
//     so a merge makes no host-to-device copy and the launch can be
//     captured in a CUDA graph. The five constants are launch arguments:
//     a merge reads no device scalar and syncs nothing;
//   * block b runs chunk b - first[l] of leaf l (a search over at most
//     kMaxLeaves constants). A launch of at least vector_from(dtype)
//     elements streams 16-byte vectors: a thread loads one vector (4 f32
//     or 8 bf16) of each of the four operands before it computes any, 64 B
//     in flight; a leaf whose n is not a multiple of V or whose pointers
//     are not all 16-byte aligned takes the one-element path over the same
//     chunk. A smaller launch takes one element a thread: there the
//     FedAdam law's division and square root (tens of dependent
//     instructions an element) bound a thread, not its bytes: on the
//     H100 one element a thread beat vectors below about 4 M elements in
//     f32 and 0.5 M in bf16, and tied or lost above. The ragged tail is
//     masked (the TPU version zero-pads every operand to its tile first
//     and slices the outputs).
//
// Bit contract with the plain PyTorch version (kernels/ref.py): every
// operation is its own correctly rounded intrinsic (__fsub_rn, __fmul_rn,
// __fadd_rn, __fsqrt_rn, __fdiv_rn) — the build leaves -fmad on, so a
// plain b1*m + s*d would contract to an FMA — in the reference's order and
// association; 1 - b1 and 1 - b2 are formed in f32; and the inert case is
// a select, so avg's bits pass through untouched (old - (old - avg) is not
// an IEEE-754 identity).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

using namespace repro_vec;

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;

// the fewest elements a launch streams as vectors (see above)
long long vector_from(int dtype) { return dtype == 0 ? 1LL << 22 : 1LL << 19; }

struct Leaves {
  const void* avg[kMaxLeaves];
  const void* old[kMaxLeaves];
  const void* m[kMaxLeaves];
  const void* v[kMaxLeaves];
  void* out[kMaxLeaves];
  void* m_out[kMaxLeaves];
  void* v_out[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];   // first chunk of each leaf; [count] = total
  unsigned vec;                // bit l: leaf l takes 16-byte vectors
  int count;
};

// the law's constants and their tests, uniform over the grid
struct Law {
  bool identity, adam, inert;
  float b1, b2, slr, eps, scale1, one_m_b2;
};

__device__ __forceinline__ void step(const Law& c, float a, float o,
                                     float mm, float vv, float& out,
                                     float& nm, float& nv) {
  const float d = __fsub_rn(o, a);
  nm = c.identity ? mm
                  : __fadd_rn(__fmul_rn(c.b1, mm), __fmul_rn(c.scale1, d));
  nv = c.adam ? __fadd_rn(__fmul_rn(c.b2, vv),
                          __fmul_rn(__fmul_rn(c.one_m_b2, d), d))
              : vv;
  const float s =
      c.adam ? __fdiv_rn(nm, __fadd_rn(__fsqrt_rn(nv), c.eps)) : nm;
  out = c.inert ? a : __fsub_rn(o, __fmul_rn(c.slr, s));
}

template <typename T, int V>
__device__ __forceinline__ void chunk(const Leaves& t, int l, long long base,
                                      const Law& c) {
  using C = Cols<T, V>;
  using Raw = typename C::Raw;
  const T* avg = static_cast<const T*>(t.avg[l]);
  const T* old = static_cast<const T*>(t.old[l]);
  const T* m = static_cast<const T*>(t.m[l]);
  const T* v = static_cast<const T*>(t.v[l]);
  const long long n = t.n[l];
  const long long i = base + (long long)threadIdx.x * V;
  if (i >= n) return;
  const Raw ra = C::load(avg + i), ro = C::load(old + i);
  const Raw rm = C::load(m + i), rv = C::load(v + i);
  float a[V], o[V], mm[V], vv[V], x[V], y[V], z[V];
  C::get(ra, a);
  C::get(ro, o);
  C::get(rm, mm);
  C::get(rv, vv);
#pragma unroll
  for (int e = 0; e < V; ++e)
    step(c, a[e], o[e], mm[e], vv[e], x[e], y[e], z[e]);
  C::put(static_cast<T*>(t.out[l]) + i, x);
  C::put(static_cast<T*>(t.m_out[l]) + i, y);
  C::put(static_cast<T*>(t.v_out[l]) + i, z);
}

// V = 16 / sizeof(T): vectors, a leaf without its bit one element at a
// time over the same chunk; V = 1: one element a thread, every leaf
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    server_opt_kernel(const __grid_constant__ Leaves t, float kind, float b1,
                      float b2, float slr, float eps) {
  Law c;
  c.identity = (kind == 0.0f);
  c.adam = (kind == 2.0f);
  c.inert = c.identity || (kind == 1.0f && b1 == 0.0f && slr == 1.0f);
  c.b1 = b1;
  c.b2 = b2;
  c.slr = slr;
  c.eps = eps;
  c.scale1 = c.adam ? __fsub_rn(1.0f, b1) : 1.0f;
  c.one_m_b2 = __fsub_rn(1.0f, b2);
  int l = 0;
  while (l + 1 < t.count && t.first[l + 1] <= (int)blockIdx.x) ++l;
  const long long ch = (long long)blockIdx.x - t.first[l];
  if (V == 1 || (t.vec >> l) & 1u)
    chunk<T, V>(t, l, ch * kThreads * V, c);
  else  // the same chunk of V elements a thread, one at a time
    for (int v = 0; v < V; ++v) chunk<T, 1>(t, l, (ch * V + v) * kThreads, c);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

template <typename T, int V>
int launch(const void* const* avg, const void* const* old,
           const void* const* m, const void* const* v, void* const* out,
           void* const* m_out, void* const* v_out, const long long* n,
           int count, const float* k, cudaStream_t s) {
  constexpr long long kChunk = (long long)kThreads * V;
  Leaves t{};
  t.count = count;
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    if (n[l] < 0) return (int)cudaErrorInvalidValue;
    t.avg[l] = avg[l];
    t.old[l] = old[l];
    t.m[l] = m[l];
    t.v[l] = v[l];
    t.out[l] = out[l];
    t.m_out[l] = m_out[l];
    t.v_out[l] = v_out[l];
    t.n[l] = n[l];
    t.first[l] = (int)total;
    total += (n[l] + kChunk - 1) / kChunk;
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (n[l] % V == 0 && aligned16(avg[l]) && aligned16(old[l]) &&
        aligned16(m[l]) && aligned16(v[l]) && aligned16(out[l]) &&
        aligned16(m_out[l]) && aligned16(v_out[l]))
      t.vec |= 1u << l;
  }
  t.first[count] = (int)total;
  if (total == 0) return 0;
  server_opt_kernel<T, V><<<(unsigned)total, kThreads, 0, s>>>(
      t, k[0], k[1], k[2], k[3], k[4]);
  return (int)cudaGetLastError();
}

}  // namespace

// The most leaves one launch takes; a longer list takes more launches.
extern "C" int repro_server_opt_max_leaves() { return kMaxLeaves; }

// avg, old, m, v, out, m_out, v_out: host arrays of ``count`` device
// pointers (leaf l's seven contiguous buffers of n[l] elements, one
// dtype); consts: five host floats [kind, beta1, beta2, server_lr, eps].
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int repro_server_opt_leaves(
    const void* const* avg, const void* const* old, const void* const* m,
    const void* const* v, void* const* out, void* const* m_out,
    void* const* v_out, const long long* n, int count, const float* consts,
    int dtype, void* stream) {
  if (count < 0 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long total = 0;
  for (int l = 0; l < count; ++l) total += n[l];
  const bool vec = total >= vector_from(dtype);
  using bf = __nv_bfloat16;
  if (dtype == 0)
    return (vec ? launch<float, 4> : launch<float, 1>)(
        avg, old, m, v, out, m_out, v_out, n, count, consts, s);
  if (dtype == 1)
    return (vec ? launch<bf, 8> : launch<bf, 1>)(
        avg, old, m, v, out, m_out, v_out, n, count, consts, s);
  return (int)cudaErrorInvalidValue;
}
