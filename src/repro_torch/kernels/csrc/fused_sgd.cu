// Fused SGD update  p <- cast(float(p) - lr * float(g)),  in place, for
// every leaf of a model in ONE launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_sgd.py::fused_sgd_pallas
// (one read-modify-write pass per parameter leaf per local step).
//
// Bound on this card: bytes. Every element is read twice (p, g) and
// written once (p) with two flops between, so the least time is
// 3 * n * itemsize / memory rate over all leaves. The design, in the style
// of a multi-tensor apply:
//   * one launch takes up to kMaxLeaves leaves (the stacked (U, ...)
//     leaves of the cohort: 4 for the MLP, 6 for the CNN). Their (p, g, n)
//     and a per-leaf prefix of chunk counts travel BY VALUE in the
//     kernel's parameter space (a __grid_constant__ table), so a step
//     makes no host-to-device copy and the launch can be captured in a
//     CUDA graph;
//   * block b runs chunk b - first[l] of leaf l, the leaf whose chunk
//     range holds b (a search over at most kMaxLeaves constants, the same
//     in every thread of the block). A chunk is kThreads x kVecs vectors;
//   * a thread loads its kVecs 16-byte vectors of p and of g (4 f32 or 8
//     bf16 each) before it computes and stores any: 2 x kVecs x 16 B in
//     flight a thread. A leaf whose n is not a multiple of V or whose
//     pointers are not 16-byte aligned takes the one-element path over
//     the same chunk, its loads batched alike. The ragged tail is masked.
// The product and the difference are rounded separately (__fmul_rn /
// __fsub_rn, no FMA contraction), so results are bit-equal to the plain
// PyTorch version in f32 and bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

using namespace repro_vec;

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kVecs = 4;

struct Leaves {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];   // first chunk of each leaf; [count] = total
  unsigned vec;                // bit l: leaf l takes 16-byte vectors
  int count;
};

template <typename T, int V>
__device__ __forceinline__ void step(T* __restrict__ p,
                                     const T* __restrict__ g, long long n,
                                     long long base, float lr) {
  using C = Cols<T, V>;
  using Raw = typename C::Raw;
  Raw rp[kVecs], rg[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long c = base + ((long long)k * kThreads + threadIdx.x) * V;
    if (c < n) {
      rp[k] = *reinterpret_cast<const Raw*>(p + c);
      rg[k] = *reinterpret_cast<const Raw*>(g + c);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long c = base + ((long long)k * kThreads + threadIdx.x) * V;
    if (c < n) {
      float a[V], b[V];
      C::get(rp[k], a);
      C::get(rg[k], b);
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = __fsub_rn(a[e], __fmul_rn(lr, b[e]));
      C::put(p + c, a);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    sgd_leaves_kernel(const __grid_constant__ Leaves t, float lr) {
  int l = 0;
  while (l + 1 < t.count && t.first[l + 1] <= (int)blockIdx.x) ++l;
  T* p = static_cast<T*>(t.p[l]);
  const T* g = static_cast<const T*>(t.g[l]);
  const long long n = t.n[l];
  const long long chunk = (long long)blockIdx.x - t.first[l];
  if ((t.vec >> l) & 1u)
    step<T, V>(p, g, n, chunk * kThreads * kVecs * V, lr);
  else  // the same chunk of V * kVecs elements a thread, one at a time
    for (int v = 0; v < V; ++v)
      step<T, 1>(p, g, n, (chunk * V + v) * kThreads * kVecs, lr);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

template <typename T>
int launch(void* const* p, const void* const* g, const long long* n,
           int count, float lr, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  constexpr long long kChunk = (long long)kThreads * kVecs * V;
  Leaves t{};
  t.count = count;
  long long total = 0;
  for (int l = 0; l < count; ++l) {
    if (n[l] < 0) return (int)cudaErrorInvalidValue;
    t.p[l] = p[l];
    t.g[l] = g[l];
    t.n[l] = n[l];
    t.first[l] = (int)total;
    total += (n[l] + kChunk - 1) / kChunk;
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (n[l] % V == 0 && aligned16(p[l]) && aligned16(g[l]))
      t.vec |= 1u << l;
  }
  t.first[count] = (int)total;
  if (total == 0) return 0;
  sgd_leaves_kernel<T, V><<<(unsigned)total, kThreads, 0, s>>>(t, lr);
  return (int)cudaGetLastError();
}

}  // namespace

// The most leaves one launch takes; a longer list takes more launches.
extern "C" int repro_fused_sgd_max_leaves() { return kMaxLeaves; }

// p, g: host arrays of ``count`` device pointers (each leaf's param and
// grad, contiguous, same dtype); n: host array of their element counts.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int repro_fused_sgd_leaves(void* const* p, const void* const* g,
                                      const long long* n, int count,
                                      float lr, int dtype, void* stream) {
  if (count < 0 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, g, n, count, lr, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, g, n, count, lr, s);
  return (int)cudaErrorInvalidValue;
}
