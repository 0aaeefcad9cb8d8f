// Eq. 1 merges: the gather-K combine and the plain FedAvg combine.
//
//   gather_combine:  out = any(w != 0) ? sum_j w_j * stack[idx_j] : glob
//   fedavg_combine:  out = sum_k a_k * stack[k]
//
// Replace the TPU kernels src/repro/kernels/gather.py::gather_combine_pallas
// and src/repro/kernels/fedavg.py::fedavg_pallas. Both share one device
// function; fedavg is the case "idx is the identity, no glob guard".
//
// Bound on this card: bytes — one row of n elements read per NONZERO
// weight, n written, plus glob when every weight is zero; two flops per
// element per row.
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

// idx == nullptr: row j of the stack is term j. glob == nullptr: no guard.
// An index outside [0, S) traps: it is a caller's bug, never data.
template <typename T>
__global__ void combine_kernel(const T* __restrict__ stack,
                               const int* __restrict__ idx,
                               const float* __restrict__ w,
                               const T* __restrict__ glob,
                               T* __restrict__ out, int S, int K,
                               long long n) {
  bool any = false;
  for (int j = 0; j < K; ++j) any |= (w[j] != 0.0f);
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
    from_f32(out + c, acc);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

template <typename T>
int launch(const void* stack, const int* idx, const float* w,
           const void* glob, void* out, int S, int K, long long n,
           cudaStream_t s) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  combine_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(stack), idx, w, static_cast<const T*>(glob),
      static_cast<T*>(out), S, K, n);
  return (int)cudaGetLastError();
}

int dispatch(const void* stack, const int* idx, const float* w,
             const void* glob, void* out, int S, int K, long long n,
             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(stack, idx, w, glob, out, S, K, n, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(stack, idx, w, glob, out, S, K, n, s);
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
                  static_cast<const float*>(w), glob, out, S, K, n, dtype,
                  stream);
}

// stack: (K, n); alphas: (K,) f32 device; out: (n,).
extern "C" int repro_fedavg_combine(const void* stack, const void* alphas,
                                    void* out, int K, long long n, int dtype,
                                    void* stream) {
  return dispatch(stack, nullptr, static_cast<const float*>(alphas), nullptr,
                  out, K, K, n, dtype, stream);
}
