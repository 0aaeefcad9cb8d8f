// Eq. 1 merges: the gather-K combine, the plain FedAvg combine, and the
// two merges of the channel and fault layers built on the same loop.
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
// share one device function: fedavg is the case "idx is the identity, no
// glob guard", AirComp "no glob guard, a noise plane and a scale". Robust
// is its own kernel with the same shape.
//
// Bound on this card: bytes — one row of n elements read per NONZERO
// weight, n written, plus glob when every weight is zero (gather), the
// noise plane (AirComp) or the old global (robust); two flops per element
// per row, five for a robust row that is shrunk.
//
// The TPU version walks a (column block, winner) grid with the winner
// axis innermost and accumulates into the resident output tile, steering
// the row DMA with scalar-prefetched indices. Here each thread owns
// output columns (grid-stride), reads idx and w itself (K is the winner
// budget, a handful) and loops j = 0..K-1 with the sum in a register.
// The contracts the reference pins are kept at the bit level:
//   * delivery order: the sum runs j = 0, 1, ... in order, each product
//     and each addition rounded on its own (__fmul_rn / __fadd_rn, no
//     FMA contraction), so the result equals the plain version that
//     loops j in order, bit for bit, whatever the grid;
//   * a zero weight contributes EXACT zero: its row is not read at all,
//     so a non-finite loser cannot leak and padding costs no bytes.
//     Skipping equals adding +0.0, which never changes an f32 sum that
//     started from +0.0 — the pad width cannot change the bits;
//   * all-zero weights return glob unchanged;
//   * the result depends on the gathered rows only, not on the stack's
//     length S: S = U with winner ids and S = K with positions agree
//     bit for bit.
// No atomics. The ragged tail is masked by the loop bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One body for gather, FedAvg and AirComp, so the three round alike by
// construction. idx == nullptr: row j of the stack is term j. glob ==
// nullptr: no guard. noise == nullptr adds nothing, which gives the bits
// of adding +0.0 (acc is never -0.0: it starts at +0.0 and a
// round-to-nearest sum is -0.0 only when both addends are). scale ==
// nullptr multiplies by nothing; AirComp's scale is read from device
// memory, so the wrapper forms sum(a) / sum(a * c) on the device without
// a host sync, and with noise absent and scale == 1.0 AirComp gives the
// gather sum bit for bit (x * 1.0 == x). The reference AirComp kernel has
// no glob guard, and neither has this one when called for it.
// An index outside [0, S) traps: it is a caller's bug, never data.
template <typename T>
__global__ void combine_kernel(const T* __restrict__ stack,
                               const int* __restrict__ idx,
                               const float* __restrict__ w,
                               const T* __restrict__ glob,
                               const float* __restrict__ noise,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int S, int K,
                               long long n) {
  bool any = false;
  if (glob != nullptr)
    for (int j = 0; j < K; ++j) any |= (w[j] != 0.0f);
  const float sc = (scale != nullptr) ? *scale : 1.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += stride) {
    if (glob != nullptr && !any) {
      out[c] = glob[c];
      continue;
    }
    float acc = 0.0f;
    for (int j = 0; j < K; ++j) {
      const float wj = w[j];
      if (wj == 0.0f) continue;
      const int r = (idx != nullptr) ? idx[j] : j;
      if (r < 0 || r >= S) __trap();
      acc = __fadd_rn(acc, __fmul_rn(to_f32(stack[(long long)r * n + c]), wj));
    }
    if (noise != nullptr) acc = __fadd_rn(acc, noise[c]);
    if (scale != nullptr) acc = __fmul_rn(acc, sc);
    from_f32(out + c, acc);
  }
}

// Robust: each row is shrunk towards the old global g in delta space
// before the same ordered masked sum. s == 1 takes the row as it is (no
// arithmetic touches it), so all-ones scales give gather_combine's sum
// over the same rows bit for bit; a zero weight skips the row before its
// scale is read, so a NaN scale or a NaN row there cannot leak. A NaN row
// with a nonzero weight propagates (the caller's quarantine masks it).
//
// Bound: bytes, K rows streamed once. A thread owns V contiguous columns
// (16 B of a row: 4 f32 or 8 bf16, one vector load a row; V = 1 where n
// or the operands' alignment does not allow vectors) and walks the rows
// in groups of kUnroll: all the group's loads are issued first, each
// predicated on its weight (a masked row is still never read), then the
// group's updates run in delivery order. So a thread keeps kUnroll x 16 B
// in flight where one scalar load a row kept 4 B, which is what a K = 64
// merge needs to keep the HBM busy. w and s are staged in shared memory
// once a block; g is loaded once per column group. The arithmetic of a
// column is unchanged: __fmul_rn / __fadd_rn / __fsub_rn, j = 0, 1, ...
template <typename T, int V>
struct Cols;

template <>
struct Cols<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void get(Raw r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ void put(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// eight bf16 as four 32-bit words, the lower address in the low half; a
// bf16 is the high half of its f32, so widening is a shift (exact)
template <>
struct Cols<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void get(Raw r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p,
                                             const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
struct Cols<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void get(Raw r, float* f) {
    f[0] = to_f32(r);
  }
  static __device__ __forceinline__ void put(T* p, const float* f) {
    from_f32(p, f[0]);
  }
};

constexpr int kUnroll = 8;

template <typename T, int V>
__global__ void robust_kernel(const T* __restrict__ stack,
                              const float* __restrict__ w,
                              const float* __restrict__ s,
                              const T* __restrict__ glob,
                              T* __restrict__ out, int K, long long groups) {
  using C = Cols<T, V>;
  extern __shared__ float ws[];         // w[K], then s[K]
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    ws[j] = w[j];
    ws[K + j] = s[j];
  }
  __syncthreads();
  const long long n = groups * V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < groups; q += stride) {
    const long long c = q * V;
    float g[V], acc[V];
    C::get(C::load(glob + c), g);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    for (int j0 = 0; j0 < K; j0 += kUnroll) {
      typename C::Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        if (j < K && ws[j] != 0.0f) raw[u] = C::load(stack + j * n + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        const float wj = j < K ? ws[j] : 0.0f;
        if (wj == 0.0f) continue;
        const float sj = ws[K + j];
        float x[V];
        C::get(raw[u], x);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = (sj == 1.0f)
                              ? x[e]
                              : __fadd_rn(g[e],
                                          __fmul_rn(sj, __fsub_rn(x[e], g[e])));
          acc[e] = __fadd_rn(acc[e], __fmul_rn(v, wj));
        }
      }
    }
    C::put(out + c, acc);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename T>
int launch(const void* stack, const int* idx, const float* w,
           const void* glob, const float* noise, const float* scale,
           void* out, int S, int K, long long n, cudaStream_t s) {
  if (n <= 0) return 0;
  combine_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(stack), idx, w, static_cast<const T*>(glob),
      noise, scale, static_cast<T*>(out), S, K, n);
  return (int)cudaGetLastError();
}

constexpr int kRobustThreads = 128;      // 64-512 measured within 4 % (PERF.md)
constexpr int kRobustMaxK = 232448 / 8;   // w and s in a block's shared memory

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

template <typename T, int V>
int launch_robust_v(const void* stack, const float* w, const float* sc,
                    const void* glob, void* out, int K, long long groups,
                    cudaStream_t s) {
  const size_t smem = (size_t)8 * K;
  if (smem > 48 * 1024) {
    // above 48 KB only after opting in, which holds for the current device
    // alone: opt in on every such launch
    const cudaError_t rc = cudaFuncSetAttribute(
        robust_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  long long blocks = (groups + kRobustThreads - 1) / kRobustThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  robust_kernel<T, V><<<(unsigned)blocks, kRobustThreads, smem, s>>>(
      static_cast<const T*>(stack), w, sc, static_cast<const T*>(glob),
      static_cast<T*>(out), K, groups);
  return (int)cudaGetLastError();
}

// Vector columns when every row starts 16 B aligned (n a multiple of V and
// aligned operands), else one column a thread.
template <typename T>
int launch_robust(const void* stack, const float* w, const float* sc,
                  const void* glob, void* out, int K, long long n,
                  cudaStream_t s) {
  if (n <= 0) return 0;
  if (K > kRobustMaxK) return (int)cudaErrorInvalidValue;
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
