// Server aggregator step of the objectives layer (FedAvgM / FedAdam), one
// leaf of the global per launch, elementwise in f32:
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
// (four leaf-shaped streams in, three out, plus a (1, 5) consts tile).
//
// Bound on this card: bytes. Each element reads avg, old, m, v and writes
// out, m', v' — 7 * n * itemsize — against at most 13 flops (FedAdam), far
// below the card's operations-per-byte line. The design is the plain
// streaming pass: a grid-stride loop over the flat leaf, neighbouring
// threads on neighbouring addresses, no cross-block reduction, the ragged
// tail masked by the loop bound (the TPU version zero-pads every operand to
// its tile first and slices the outputs after). The five constants are
// launch arguments, so a merge reads no device scalar and syncs nothing.
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
__global__ void server_opt_kernel(const T* __restrict__ avg,
                                  const T* __restrict__ old,
                                  const T* __restrict__ m,
                                  const T* __restrict__ v,
                                  T* __restrict__ out, T* __restrict__ m_out,
                                  T* __restrict__ v_out, float kind, float b1,
                                  float b2, float slr, float eps,
                                  long long n) {
  // the constants' tests, uniform over the grid: no divergent branch
  const bool identity = (kind == 0.0f);
  const bool adam = (kind == 2.0f);
  const bool inert =
      identity || (kind == 1.0f && b1 == 0.0f && slr == 1.0f);
  const float scale1 = adam ? __fsub_rn(1.0f, b1) : 1.0f;
  const float one_m_b2 = __fsub_rn(1.0f, b2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = to_f32(avg[i]);
    const float o = to_f32(old[i]);
    const float mm = to_f32(m[i]);
    const float vv = to_f32(v[i]);
    const float d = __fsub_rn(o, a);
    const float nm =
        identity ? mm : __fadd_rn(__fmul_rn(b1, mm), __fmul_rn(scale1, d));
    const float nv =
        adam ? __fadd_rn(__fmul_rn(b2, vv),
                         __fmul_rn(__fmul_rn(one_m_b2, d), d))
             : vv;
    const float step =
        adam ? __fdiv_rn(nm, __fadd_rn(__fsqrt_rn(nv), eps)) : nm;
    from_f32(out + i, inert ? a : __fsub_rn(o, __fmul_rn(slr, step)));
    from_f32(m_out + i, nm);
    from_f32(v_out + i, nv);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 resident blocks per SM

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all seven buffers). Returns
// cudaGetLastError().
extern "C" int repro_server_opt(const void* avg, const void* old,
                                const void* m, const void* v, void* out,
                                void* m_out, void* v_out, float kind,
                                float b1, float b2, float slr, float eps,
                                long long n, int dtype, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    server_opt_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(avg), static_cast<const float*>(old),
        static_cast<const float*>(m), static_cast<const float*>(v),
        static_cast<float*>(out), static_cast<float*>(m_out),
        static_cast<float*>(v_out), kind, b1, b2, slr, eps, n);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    server_opt_kernel<bf><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(avg), static_cast<const bf*>(old),
        static_cast<const bf*>(m), static_cast<const bf*>(v),
        static_cast<bf*>(out), static_cast<bf*>(m_out),
        static_cast<bf*>(v_out), kind, b1, b2, slr, eps, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
