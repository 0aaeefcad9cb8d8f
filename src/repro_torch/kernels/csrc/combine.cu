// Eq. 1 merges: the gather-K combine, the plain FedAvg combine, and the
// two merges of the channel and fault layers built on the same walk.
//
//   gather_combine:  out = any(w != 0) ? sum_j w_j * stack[idx_j] : glob
//   fedavg_combine:  out = sum_k a_k * stack[k]
//   aircomp_combine: out = (sum_j w_j * stack[idx_j] + noise) * scale
//   robust_combine:  out = sum_k w_k * (s_k == 1 ? x_k : g + s_k (x_k - g))
//
// Replace the TPU kernels src/repro/kernels/gather.py::gather_combine_pallas,
// src/repro/kernels/fedavg.py::fedavg_pallas,
// src/repro/kernels/aircomp.py::aircomp_pallas and
// src/repro/kernels/robust.py::robust_pallas. gather, fedavg and AirComp
// are one kernel (combine_kernel): fedavg is the case "idx is the
// identity, no glob guard", AirComp "no glob guard, a noise plane and a
// scale". Robust (robust_kernel) runs the same row walk with a per-row
// shrink towards the old global.
//
// Bound on this card: bytes — one row of n elements read per NONZERO
// weight, n written, plus glob when every weight is zero (gather), the
// noise plane (AirComp) or the old global (robust); two flops per element
// per row, five for a robust row that is shrunk.
//
// The TPU version walks a (column block, winner) grid with the winner
// axis innermost and accumulates into the resident output tile, steering
// the row DMA with scalar-prefetched indices. Here:
//   * each block first stages the LIVE rows once: the (row, weight[,
//     scale]) of every nonzero weight, compacted in ascending j (a warp
//     ballot prefix over w != 0, 32 weights a step) in shared memory. No thread reads w, idx or
//     the scales from device memory afterwards, a masked row costs nothing
//     per column (FedAvg's 1024-row mask with 2 live rows walks 2 rows),
//     and the index check (an index outside [0, S) traps: a caller's bug,
//     never data) runs once a live row a block;
//   * a thread owns V contiguous columns (16 B of a row: 4 f32 or 8 bf16,
//     one vector load a row; V = 1 where n or an operand's alignment does
//     not allow vectors) and walks the live rows in groups of 16 (4 when
//     at most 8 rows are live): all the group's loads are issued first,
//     then its updates run in delivery order, so 16 x 16 B are in flight a
//     thread where one scalar load a row kept 4 B — what a K = 64 merge
//     needs to keep the HBM busy.
// The contracts the reference pins are kept at the bit level:
//   * delivery order: the sum runs over the live rows in ascending j, each
//     product and each addition rounded on its own (__fmul_rn / __fadd_rn,
//     no FMA contraction), so the result equals the plain version that
//     loops j in order, bit for bit, whatever the grid;
//   * a zero weight contributes EXACT zero: its row is not read at all,
//     so a non-finite loser cannot leak and padding costs no bytes.
//     Skipping equals adding +0.0, which never changes an f32 sum that
//     started from +0.0 — the pad width cannot change the bits;
//   * all-zero weights return glob unchanged (its raw bits are copied);
//   * the result depends on the gathered rows only, not on the stack's
//     length S: S = U with winner ids and S = K with positions agree
//     bit for bit.
// No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

using namespace repro_vec;

constexpr int kThreads = 128;        // 64-512 measured within 4 % (PERF.md)
// rows in flight a thread: 16 when more than kFewRows rows are live, else
// 4 (a short walk pays for every predicated slot; PERF.md)
constexpr int kFewRows = 8;
constexpr unsigned kFull = 0xffffffffu;
// staged per block in shared memory, 4 bytes each per weight: w, the row
// ids and (robust) the scales, compacted in place; K is bounded so that
// they fit a block's 227 KB
constexpr int kMaxK = 16384;

size_t stage_bytes(int K, bool scales) {
  return (size_t)4 * ((scales ? 3 : 2) * (size_t)K + 1);
}

// Stage the live (row, weight[, scale]) triples of the block: every j with
// w[j] != 0, compacted in ascending j into ws / rows / ss. All threads load
// the K triples (idx == nullptr: row j; s == nullptr: no scales), then
// warp 0 compacts them in place, 32 at a time in order: a lane's write
// goes to a position at or below its own j, in this group or an earlier
// one, so it never lands on a value not yet read. Returns the number of
// live rows (the same in every thread); count is one int of shared memory.
__device__ int stage_live(const int* __restrict__ idx,
                          const float* __restrict__ w,
                          const float* __restrict__ s, int S, int K,
                          float* ws, int* rows, float* ss, int* count) {
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    ws[j] = __ldg(w + j);
    rows[j] = (idx != nullptr) ? __ldg(idx + j) : j;
    if (s != nullptr) ss[j] = __ldg(s + j);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int m = 0;
    for (int base = 0; base < K; base += 32) {
      const int j = base + lane;
      const float wj = j < K ? ws[j] : 0.0f;
      const int r = j < K ? rows[j] : 0;
      const float sj = (j < K && s != nullptr) ? ss[j] : 0.0f;
      __syncwarp();                      // every read before any write
      const unsigned live = __ballot_sync(kFull, wj != 0.0f);
      if (wj != 0.0f) {
        if (r < 0 || r >= S) __trap();
        const int pos = m + __popc(live & ((1u << lane) - 1u));
        ws[pos] = wj;
        rows[pos] = r;
        if (s != nullptr) ss[pos] = sj;
      }
      m += __popc(live);
      __syncwarp();
    }
    if (lane == 0) *count = m;
  }
  __syncthreads();
  return *count;
}

// The per-row transforms of the walk: none (gather, FedAvg, AirComp), and
// robust's shrink, where s == 1 takes the row as it is (no arithmetic
// touches it) and any other scale (a NaN too) is applied.
struct Identity {
  __device__ __forceinline__ void apply(int, float*) const {}
};

template <int V>
struct Shrink {
  const float* ss;   // the live rows' scales (shared memory)
  float g[V];        // the old global's V columns
  __device__ __forceinline__ void apply(int i, float* x) const {
    const float sj = ss[i];
    if (sj == 1.0f) return;
#pragma unroll
    for (int e = 0; e < V; ++e)
      x[e] = __fadd_rn(g[e], __fmul_rn(sj, __fsub_rn(x[e], g[e])));
  }
};

// THE row walk: acc[e] += f(row)[e] * w over the m live rows in order, for
// the V columns at c; kU rows' loads in flight before their updates.
template <int kU, typename T, int V, typename F>
__device__ __forceinline__ void walk_rows(const T* __restrict__ stack,
                                          long long n, long long c,
                                          const int* rows, const float* ws,
                                          int m, const F& f, float* acc) {
  using C = Cols<T, V>;
  for (int j0 = 0; j0 < m; j0 += kU) {
    typename C::Raw raw[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (j0 + u < m) raw[u] = C::load(stack + (long long)rows[j0 + u] * n + c);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (j0 + u >= m) break;
      const float wj = ws[j0 + u];
      float x[V];
      C::get(raw[u], x);
      f.apply(j0 + u, x);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], wj));
    }
  }
}

template <typename T, int V, typename F>
__device__ __forceinline__ void walk(const T* __restrict__ stack,
                                     long long n, long long c,
                                     const int* rows, const float* ws, int m,
                                     const F& f, float* acc) {
  if (m > kFewRows)
    walk_rows<16, T, V>(stack, n, c, rows, ws, m, f, acc);
  else
    walk_rows<4, T, V>(stack, n, c, rows, ws, m, f, acc);
}

// gather / FedAvg / AirComp. idx == nullptr: row j of the stack is term j.
// glob == nullptr: no guard. noise == nullptr adds nothing, which gives the
// bits of adding +0.0 (acc is never -0.0: it starts at +0.0 and a
// round-to-nearest sum is -0.0 only when both addends are). scale ==
// nullptr multiplies by nothing; AirComp's scale is read from device
// memory, so the wrapper forms sum(a) / sum(a * c) on the device without a
// host sync, and with noise absent and scale == 1.0 AirComp gives the
// gather sum bit for bit (x * 1.0 == x).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ stack, const int* __restrict__ idx,
                   const float* __restrict__ w, const T* __restrict__ glob,
                   const float* __restrict__ noise,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int S, int K, long long groups) {
  using C = Cols<T, V>;
  extern __shared__ float smem[];
  float* ws = smem;
  int* rows = reinterpret_cast<int*>(smem + K);
  int* count = reinterpret_cast<int*>(smem + 2 * K);
  const float sc = (scale != nullptr) ? *scale : 1.0f;   // beside staging
  const int m = stage_live(idx, w, nullptr, S, K, ws, rows, nullptr, count);
  const long long n = groups * V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long q0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m == 0 && glob != nullptr) {
    for (long long q = q0; q < groups; q += stride)
      C::put_raw(out + q * V, C::load(glob + q * V));
    return;
  }
  for (long long q = q0; q < groups; q += stride) {
    const long long c = q * V;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    walk<T, V>(stack, n, c, rows, ws, m, Identity(), acc);
    if (noise != nullptr) {
      float z[V];
      load_f32<V>(noise + c, z);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], z[e]);
    }
    if (scale != nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(acc[e], sc);
    }
    C::put(out + c, acc);
  }
}

// Robust: each live row is shrunk towards the old global g in delta space
// before the same ordered sum. All-ones scales give gather_combine's sum
// over the same rows bit for bit; a zero weight drops the row at staging,
// so a NaN scale or a NaN row there cannot leak. A NaN row
// with a nonzero weight propagates (the caller's quarantine masks it). g
// is loaded once per column group.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    robust_kernel(const T* __restrict__ stack, const float* __restrict__ w,
                  const float* __restrict__ s, const T* __restrict__ glob,
                  T* __restrict__ out, int K, long long groups) {
  using C = Cols<T, V>;
  extern __shared__ float smem[];
  float* ws = smem;
  int* rows = reinterpret_cast<int*>(smem + K);
  float* ss = smem + 2 * K;
  int* count = reinterpret_cast<int*>(smem + 3 * K);
  const int m = stage_live(nullptr, w, s, K, K, ws, rows, ss, count);
  const long long n = groups * V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < groups; q += stride) {
    const long long c = q * V;
    Shrink<V> shrink{ss, {}};
    C::get(C::load(glob + c), shrink.g);
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    walk<T, V>(stack, n, c, rows, ws, m, shrink, acc);
    C::put(out + c, acc);
  }
}

constexpr long long kMaxBlocks = 132LL * 16;

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

unsigned grid_for(long long groups) {
  long long blocks = (groups + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// Above 48 KB of dynamic shared memory a kernel must opt in, which holds
// for the current device alone: opt in on every such launch.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int V>
int launch_v(const void* stack, const int* idx, const float* w,
             const void* glob, const float* noise, const float* scale,
             void* out, int S, int K, long long groups, cudaStream_t s) {
  const size_t smem = stage_bytes(K, false);
  const int rc = allow_smem(combine_kernel<T, V>, smem);
  if (rc != 0) return rc;
  combine_kernel<T, V><<<grid_for(groups), kThreads, smem, s>>>(
      static_cast<const T*>(stack), idx, w, static_cast<const T*>(glob),
      noise, scale, static_cast<T*>(out), S, K, groups);
  return (int)cudaGetLastError();
}

// Vector columns when every row starts 16 B aligned (n a multiple of V and
// aligned operands, the f32 noise plane included), else one column a
// thread.
template <typename T>
int launch(const void* stack, const int* idx, const float* w,
           const void* glob, const float* noise, const float* scale,
           void* out, int S, int K, long long n, cudaStream_t s) {
  if (n <= 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && aligned16(stack) && aligned16(out) &&
      (glob == nullptr || aligned16(glob)) &&
      (noise == nullptr || aligned16(noise)))
    return launch_v<T, V>(stack, idx, w, glob, noise, scale, out, S, K,
                          n / V, s);
  return launch_v<T, 1>(stack, idx, w, glob, noise, scale, out, S, K, n, s);
}

template <typename T, int V>
int launch_robust_v(const void* stack, const float* w, const float* sc,
                    const void* glob, void* out, int K, long long groups,
                    cudaStream_t s) {
  const size_t smem = stage_bytes(K, true);
  const int rc = allow_smem(robust_kernel<T, V>, smem);
  if (rc != 0) return rc;
  robust_kernel<T, V><<<grid_for(groups), kThreads, smem, s>>>(
      static_cast<const T*>(stack), w, sc, static_cast<const T*>(glob),
      static_cast<T*>(out), K, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_robust(const void* stack, const float* w, const float* sc,
                  const void* glob, void* out, int K, long long n,
                  cudaStream_t s) {
  if (n <= 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && aligned16(stack) && aligned16(glob) && aligned16(out))
    return launch_robust_v<T, V>(stack, w, sc, glob, out, K, n / V, s);
  return launch_robust_v<T, 1>(stack, w, sc, glob, out, K, n, s);
}

int dispatch(const void* stack, const int* idx, const float* w,
             const void* glob, const float* noise, const float* scale,
             void* out, int S, int K, long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(stack, idx, w, glob, noise, scale, out, S, K, n, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(stack, idx, w, glob, noise, scale, out, S,
                                 K, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The largest K (weights a merge) a launch takes: the staged weights must
// fit a block's shared memory. A larger K returns cudaErrorInvalidValue.
extern "C" int repro_combine_max_k() { return kMaxK; }

// stack: (S, n); idx: (K,) int32 device; w: (K,) f32 device; glob, out:
// (n,). dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int repro_gather_combine(const void* stack, const void* idx,
                                    const void* w, const void* glob,
                                    void* out, int S, int K, long long n,
                                    int dtype, void* stream) {
  if (idx == nullptr || glob == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(stack, static_cast<const int*>(idx),
                  static_cast<const float*>(w), glob, nullptr, nullptr, out,
                  S, K, n, dtype, stream);
}

// stack: (K, n); alphas: (K,) f32 device; out: (n,).
extern "C" int repro_fedavg_combine(const void* stack, const void* alphas,
                                    void* out, int K, long long n, int dtype,
                                    void* stream) {
  return dispatch(stack, nullptr, static_cast<const float*>(alphas), nullptr,
                  nullptr, nullptr, out, K, K, n, dtype, stream);
}

// stack: (S, n); idx: (K,) int32 device or nullptr (row j is term j, and
// then S == K); w: (K,) f32 device; noise: (n,) f32 device or nullptr;
// scale: one f32 on the device; out: (n,).
extern "C" int repro_aircomp_combine(const void* stack, const void* idx,
                                     const void* w, const void* noise,
                                     const void* scale, void* out, int S,
                                     int K, long long n, int dtype,
                                     void* stream) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(stack, static_cast<const int*>(idx),
                  static_cast<const float*>(w), nullptr,
                  static_cast<const float*>(noise),
                  static_cast<const float*>(scale), out, S, K, n, dtype,
                  stream);
}

// stack: (K, n); w, scales: (K,) f32 device; glob, out: (n,).
extern "C" int repro_robust_combine(const void* stack, const void* w,
                                    const void* scales, const void* glob,
                                    void* out, int K, long long n, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 0 || glob == nullptr) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scales);
  if (dtype == 0)
    return launch_robust<float>(stack, wf, sf, glob, out, K, n, s);
  if (dtype == 1)
    return launch_robust<__nv_bfloat16>(stack, wf, sf, glob, out, K, n, s);
  return (int)cudaErrorInvalidValue;
}
