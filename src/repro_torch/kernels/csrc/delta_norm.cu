// Eq. 2 reduction over a stacked cohort, one pass:
//   d2[u] = sum_i (float(stack[u, i]) - float(glob[i]))^2     u = 0..U-1
//   g2    = sum_i float(glob[i])^2
//
// Replaces the TPU kernel src/repro/kernels/delta_norm.py::delta_norm_pallas,
// which the reference vmaps over the (U, ...) stack, one call per leaf.
//
// Bound on this card: bytes — (U + 1) * n * itemsize read, U + 1 floats
// written, three flops per element.
//
// The TPU kernel adds into its two outputs across grid steps, which only
// an in-order grid allows. Here blocks run concurrently, so the
// reduction is two fixed-order passes and uses no atomics:
//   pass 1  grid (B, U): block (b, u) walks columns b*T + t, step B*T,
//           of user u; each thread keeps an f32 sum, a warp reduces by
//           shuffles, the block's warps through shared memory, and the
//           block writes ONE partial to part[u, b]. The blocks of user 0
//           also square glob and write part[U, b]: g2 does not depend on
//           the user, so it is computed once, not U times.
//   pass 2  grid (U + 1): block r sums part[r, 0..B) in a fixed order
//           (thread-strided, then the same tree) into out[r].
// The order of every addition is a function of (n, B) alone, so results
// are bit-identical from run to run. The ragged tail is masked by the
// loop bound; operands are taken as they are, not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kElemsPerBlock = kThreads * 16;
constexpr long long kMaxBlocksX = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum over the block, valid in thread 0. Fixed tree: xor-shuffles within
// each warp, then warp 0 folds the per-warp sums the same way.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kWarps) ? smem[threadIdx.x] : 0.0f;
  if (warp == 0) {
    for (int off = kWarps / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // smem is reused by the caller's next reduction
  return v;
}

template <typename T>
__global__ void delta_norm_partials(const T* __restrict__ stack,
                                    const T* __restrict__ glob,
                                    float* __restrict__ part, long long n) {
  __shared__ float smem[kWarps];
  const int b = blockIdx.x, nb = gridDim.x, u = blockIdx.y, U = gridDim.y;
  const T* row = stack + (long long)u * n;
  const long long stride = (long long)nb * kThreads;
  float d2 = 0.0f, g2 = 0.0f;
  for (long long i = (long long)b * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float wg = to_f32(glob[i]);
    const float d = to_f32(row[i]) - wg;
    d2 += d * d;
    g2 += wg * wg;  // kept by the blocks of user 0 only
  }
  d2 = block_sum(d2, smem);
  if (threadIdx.x == 0) part[(long long)u * nb + b] = d2;
  if (u == 0) {  // uniform over the block: no divergence inside block_sum
    g2 = block_sum(g2, smem);
    if (threadIdx.x == 0) part[(long long)U * nb + b] = g2;
  }
}

__global__ void delta_norm_finish(const float* __restrict__ part,
                                  float* __restrict__ out, int nb) {
  __shared__ float smem[kWarps];
  const float* row = part + (long long)blockIdx.x * nb;
  float v = 0.0f;
  for (int i = threadIdx.x; i < nb; i += kThreads) v += row[i];
  v = block_sum(v, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace

// Number of partials per row that repro_delta_norm writes for n columns:
// the wrapper sizes `part` as (U + 1) * this many floats.
extern "C" int repro_delta_norm_blocks(long long n) {
  long long b = (n + kElemsPerBlock - 1) / kElemsPerBlock;
  if (b < 1) b = 1;
  if (b > kMaxBlocksX) b = kMaxBlocksX;
  return (int)b;
}

// stack: (U, n), glob: (n,), part: (U + 1, blocks) f32 scratch,
// out: (U + 1,) f32 = [d2[0..U), g2]. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int repro_delta_norm(const void* stack, const void* glob,
                                void* part, void* out, int U, long long n,
                                int dtype, void* stream) {
  if (U < 1 || U > 65535) return (int)cudaErrorInvalidValue;
  const int nb = repro_delta_norm_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)nb, (unsigned)U);
  if (dtype == 0) {
    delta_norm_partials<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(stack), static_cast<const float*>(glob),
        static_cast<float*>(part), n);
  } else if (dtype == 1) {
    delta_norm_partials<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(stack),
        static_cast<const __nv_bfloat16*>(glob), static_cast<float*>(part),
        n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  delta_norm_finish<<<(unsigned)(U + 1), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nb);
  return (int)cudaGetLastError();
}
