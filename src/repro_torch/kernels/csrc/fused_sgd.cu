// Fused SGD update  p <- cast(float(p) - lr * float(g)),  in place.
//
// Replaces the TPU kernel src/repro/kernels/fused_sgd.py::fused_sgd_pallas
// (one read-modify-write pass per parameter leaf per local step).
//
// Bound on this card: bytes. Every element is read twice (p, g) and
// written once (p) with two flops between, so the least time is
// 3 * n * itemsize / memory rate. The design is the plain streaming
// pass: a grid-stride loop over the flat buffer, neighbouring threads on
// neighbouring addresses, the ragged tail masked by the loop bound
// instead of zero-padding the operands to a tile as the TPU version did
// (which cost an extra copy of p and g on every call). One launch covers
// the whole stacked (U, ...) leaf of the cohort. The product and the
// difference are rounded separately (__fmul_rn / __fsub_rn, no FMA
// contraction), so f32 results are bit-equal to the plain PyTorch
// version.
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

template <typename T>
__global__ void fused_sgd_kernel(T* __restrict__ p, const T* __restrict__ g,
                                 float lr, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = __fsub_rn(to_f32(p[i]), __fmul_rn(lr, to_f32(g[i])));
    from_f32(p + i, v);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 resident blocks per SM

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int repro_fused_sgd(void* p, const void* g, float lr, long long n,
                               int dtype, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fused_sgd_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g), lr, n);
  } else if (dtype == 1) {
    fused_sgd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(g),
        lr, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
