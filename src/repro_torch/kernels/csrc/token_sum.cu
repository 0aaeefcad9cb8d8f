// Fixed-order token sum  out[r, c] = sum over n of x[r, n, c]  (f32), in
// ONE tree whatever R and C are: the N values of a column are padded with
// zeros to P = the next power of two and added in adjacent pairs, level by
// level (x[2i] + x[2i+1]), as kernels/ref.py::token_sum_ref does it.
//
// Replaces no TPU kernel: the reference leaves these sums to XLA (the loss
// mean, src/repro/models/layers.py:190, and the norm scales' gradients that
// jax.grad takes of layers.py:30). torch's own CUDA sum splits one output's
// additions over blocks by the NUMBER of outputs, so a user's loss or norm
// gradient in a (U, ...) local step came out in other bits at U = 30 (a
// 3-lane sweep) than at U = 10 (the run). Here a row's additions follow its
// N alone, and the bits equal the plain version's on the CPU. The plain
// version's ~log2(N) launches of elementwise adds a sum cost the --arch
// round more than a tenth of its time on the card; this is one launch.
//
// Bound on this card: bytes. Every input element is read once and every
// output written once; there is one add an element. The design:
//   * Q = min(P, kSlices) slices of L = P / Q consecutive tokens a column.
//     Thread (column lane, slice q) sums its slice's L values in order with
//     a binary-counter stack (s[k] holds a finished subtree of 2^k values),
//     which is the adjacent-pair tree of that aligned slice. Its loads go
//     kBatch at a time, ahead of the adds;
//   * a warp is 32 neighbouring columns of one slice, so each load of a
//     warp is one 128-byte line of a token's row;
//   * the Q slice sums of a column meet in shared memory in adjacent pairs
//     (strides 1, 2, 4, ...): the tree's last log2(Q) levels;
//   * a block is 32 columns x Q slices of one row; the grid walks (row,
//     column tile). Padding tokens are zeros that are really added, as in
//     the plain version, so no add is skipped on either side.
// Adds are __fadd_rn (no contraction, nothing to contract anyway).
#include <cuda_runtime.h>

namespace {

constexpr int kSlices = 32;
constexpr int kLanes = 32;
constexpr int kBatch = 8;
constexpr int kDepth = 24;    // stack levels: L <= 2^23

__global__ void __launch_bounds__(kLanes * kSlices)
token_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int C,
                 long long N, long long L, int Q, int tiles) {
  const int r = blockIdx.x / tiles;
  const int c = (blockIdx.x % tiles) * kLanes + threadIdx.x;
  const int q = threadIdx.y;
  const bool live = c < C;
  const float* row = x + (long long)r * N * C;
  const long long first = (long long)q * L;
  const int step = L < kBatch ? (int)L : kBatch;   // both powers of two

  float s[kDepth];
  float v = 0.f;
  for (long long i0 = 0; i0 < L; i0 += step) {
    float buf[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long n = first + i0 + b;
      buf[b] = (b < step && live && n < N) ? __ldg(row + n * C + c) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (b >= step) break;
      const long long i = i0 + b;
      v = buf[b];
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        if (!((i >> k) & 1)) {
          s[k] = v;
          break;
        }
        v = __fadd_rn(s[k], v);
      }
    }
  }
  // v is the last value stored: the whole slice's subtree

  __shared__ float sm[kSlices][kLanes + 1];
  sm[q][threadIdx.x] = v;
  __syncthreads();
  for (int stride = 1; stride < Q; stride <<= 1) {
    if ((q & (2 * stride - 1)) == 0)
      sm[q][threadIdx.x] = __fadd_rn(sm[q][threadIdx.x],
                                     sm[q + stride][threadIdx.x]);
    __syncthreads();
  }
  if (q == 0 && live) out[(long long)r * C + c] = sm[0][threadIdx.x];
}

}  // namespace

extern "C" {

// x: (R, N, C) contiguous f32; out: (R, C) f32. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.
int repro_token_sum(const float* x, float* out, int R, long long N, int C,
                    cudaStream_t stream) {
  if (R < 1 || C < 1 || N < 0) return (int)cudaErrorInvalidValue;
  long long P = 1;
  while (P < N) P <<= 1;
  const int Q = P < kSlices ? (int)P : kSlices;
  const long long L = P / Q;
  const int tiles = (C + kLanes - 1) / kLanes;
  if ((long long)R * tiles > 0x7fffffffLL || L > (1LL << (kDepth - 1)))
    return (int)cudaErrorInvalidValue;
  token_sum_kernel<<<R * tiles, dim3(kLanes, Q), 0, stream>>>(x, out, C, N, L,
                                                              Q, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
