// One slotted-CSMA medium event over B parallel contention rounds, as three
// passes over a (B, N) int32 pool of backoff counters:
//
//   pass 1  step[b]   = min over live lanes of cnt[b, :]        (BIG if none)
//   pass 2  nexp[b]   = |{i : live[b, i] and cnt[b, i] == step[b]}|
//           winner[b] = the smallest such i                      (N if none)
//   pass 3  elementwise: live counters count step[b] down; a lone expiry
//           (nexp == 1) delivers and leaves; on nexp >= 2 every expiring
//           lane redraws clip(rint(rand * win * 2^nd), 1, BIG) with
//           nd = min(dbl + 1, max_doublings) and keeps nd.
//
// Replaces the TPU kernels of src/repro/kernels/contention.py::
// contention_event_pallas: _min_kernel, _expiry_kernel, _transition_kernel.
//
// Bound on this card: bytes. Pass 1 reads 5 bytes a lane (counter + live
// flag), pass 2 the same, pass 3 reads 17 and writes 9; each lane costs a
// few integer operations. At the pool widths the event loop runs (B * N of
// 1e2 .. 1e6 lanes) every pass is far below a microsecond of traffic, so a
// launch costs more than the work: what the design keeps cheap is the
// number of launches, not the bytes.
//
// The Pallas passes walk an in-order grid and carry (1, 1) accumulators
// from one N-block to the next; CUDA blocks run concurrently, so that
// cannot be copied. Here passes 1 and 2 run on a (B, chunks) grid: each
// block reduces its share of a row (warp __reduce_min_sync /
// __reduce_add_sync, then shared memory) and adds ONE integer atomic
// (atomicMin / atomicAdd) into the row's output, which a tiny init kernel
// of the same launcher set first. Integer min and sum are exact and do not
// depend on order, so results are bit-identical from run to run (no float
// atomics anywhere). Pass 3 reads step and nexp per row.
//
// No padding: the Pallas entry pads N up to 2048-lane blocks with dead
// lanes and maps its padded sentinel back to N; here the tail is masked by
// the loop bound and the sentinel is N itself.
//
// The redraw is bit-exact against the plain version: rand * win is one f32
// rounding (__fmul_rn), 2^nd is built from its exponent field (exact for
// nd in [-126, 127]) and the product with it is exact, rintf rounds half to
// even like torch.round. Built without --use_fast_math.
//
// Domain, as the event loop feeds it: counters in [0, BIG], doublings >= 0,
// 0 <= max_doublings <= 30, windows and rand finite.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 29;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = 4;
constexpr int kMaxChunks = 1024;

// Blocks per row of the (B, chunks) grid.
int chunks_for(int N) {
  long long c = ((long long)N + kThreads * kLanesPerThread - 1) /
                (kThreads * kLanesPerThread);
  if (c < 1) c = 1;
  if (c > kMaxChunks) c = kMaxChunks;
  return (int)c;
}

__global__ void fill_kernel(int* __restrict__ a, int va, int* __restrict__ b,
                            int vb, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  a[r] = va;
  if (b != nullptr) b[r] = vb;
}

int fill(int* a, int va, int* b, int vb, int B, cudaStream_t s) {
  fill_kernel<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      a, va, b, vb, B);
  return (int)cudaGetLastError();
}

// Min / sum over the block, valid in thread 0. Every thread of the block
// must call them (they synchronise).
__device__ __forceinline__ int block_min(int v, int* smem) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < kWarps) ? smem[lane] : INT32_MAX;
    v = __reduce_min_sync(0xffffffffu, v);
  }
  __syncthreads();  // smem is reused by the caller's next reduction
  return v;
}

__device__ __forceinline__ int block_sum(int v, int* smem) {
  v = (int)__reduce_add_sync(0xffffffffu, (unsigned)v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < kWarps) ? smem[lane] : 0;
    v = (int)__reduce_add_sync(0xffffffffu, (unsigned)v);
  }
  __syncthreads();
  return v;
}

// grid (B, chunks): block (b, c) walks lanes c*T + t, step chunks*T, of row b
__global__ void min_kernel(const int* __restrict__ cnt,
                           const uint8_t* __restrict__ live,
                           int* __restrict__ step, int N) {
  __shared__ int smem[kWarps];
  const long long row = (long long)blockIdx.x * N;
  int m = kBig;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < N;
       i += gridDim.y * kThreads) {
    if (live[row + i]) m = min(m, cnt[row + i]);
  }
  m = block_min(m, smem);
  if (threadIdx.x == 0 && m < kBig) atomicMin(step + blockIdx.x, m);
}

__global__ void expiry_kernel(const int* __restrict__ cnt,
                              const uint8_t* __restrict__ live,
                              const int* __restrict__ step,
                              int* __restrict__ nexp,
                              int* __restrict__ winner, int N) {
  __shared__ int smem[kWarps];
  const long long row = (long long)blockIdx.x * N;
  const int s = step[blockIdx.x];
  int count = 0, first = N;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < N;
       i += gridDim.y * kThreads) {
    if (live[row + i] && cnt[row + i] == s) {
      ++count;
      first = min(first, i);
    }
  }
  count = block_sum(count, smem);
  first = block_min(first, smem);
  if (threadIdx.x == 0) {
    if (count > 0) atomicAdd(nexp + blockIdx.x, count);
    if (first < N) atomicMin(winner + blockIdx.x, first);
  }
}

__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

__global__ void transition_kernel(
    const int* __restrict__ cnt, const uint8_t* __restrict__ live,
    const int* __restrict__ dbl, const float* __restrict__ win,
    const float* __restrict__ rand, const int* __restrict__ step,
    const int* __restrict__ nexp, int* __restrict__ ncnt,
    int* __restrict__ ndbl, uint8_t* __restrict__ nact, int N,
    int max_doublings) {
  const long long row = (long long)blockIdx.x * N;
  const int s = step[blockIdx.x];
  const int ne = nexp[blockIdx.x];
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < N;
       i += gridDim.y * kThreads) {
    const long long j = row + i;
    const bool lv = live[j] != 0;
    const int c = cnt[j];
    const int d = dbl[j];
    const int c2 = lv ? c - s : c;
    const bool ex = lv && c2 == 0;
    if (ex && ne >= 2) {
      const int nd = min(d + 1, max_doublings);
      float x = __fmul_rn(__fmul_rn(rand[j], win[j]), pow2(nd));
      x = fminf(fmaxf(rintf(x), 1.0f), (float)kBig);
      ncnt[j] = (int)x;
      ndbl[j] = nd;
    } else {
      ncnt[j] = c2;
      ndbl[j] = d;
    }
    nact[j] = (uint8_t)(lv && !(ex && ne == 1));
  }
}

bool bad_shape(int B, int N) { return B < 0 || N < 0; }

}  // namespace

// Pass 1. cnt: (B, N) int32; live: (B, N) uint8 (0 / 1); step: (B,) int32,
// set to BIG here first. Returns cudaGetLastError().
extern "C" int repro_contention_min(const void* cnt, const void* live,
                                    void* step, int B, int N, void* stream) {
  if (bad_shape(B, N)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(step);
  int rc = fill(out, kBig, nullptr, 0, B, s);
  if (rc != 0 || N == 0) return rc;
  min_kernel<<<dim3((unsigned)B, (unsigned)chunks_for(N)), kThreads, 0, s>>>(
      static_cast<const int*>(cnt), static_cast<const uint8_t*>(live), out, N);
  return (int)cudaGetLastError();
}

// Pass 2. step: (B,) from pass 1; nexp, winner: (B,) int32, set to 0 and N
// here first.
extern "C" int repro_contention_expiry(const void* cnt, const void* live,
                                       const void* step, void* nexp,
                                       void* winner, int B, int N,
                                       void* stream) {
  if (bad_shape(B, N)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ne = static_cast<int*>(nexp);
  int* wi = static_cast<int*>(winner);
  int rc = fill(ne, 0, wi, N, B, s);
  if (rc != 0 || N == 0) return rc;
  expiry_kernel<<<dim3((unsigned)B, (unsigned)chunks_for(N)), kThreads, 0,
                  s>>>(static_cast<const int*>(cnt),
                       static_cast<const uint8_t*>(live),
                       static_cast<const int*>(step), ne, wi, N);
  return (int)cudaGetLastError();
}

// Pass 3. dbl: (B, N) int32; win, rand: (B, N) f32; step, nexp: (B,) from
// passes 1 and 2; ncnt, ndbl: (B, N) int32 out; nact: (B, N) uint8 out.
extern "C" int repro_contention_transition(
    const void* cnt, const void* live, const void* dbl, const void* win,
    const void* rand, const void* step, const void* nexp, void* ncnt,
    void* ndbl, void* nact, int B, int N, int max_doublings, void* stream) {
  if (bad_shape(B, N) || max_doublings < 0 || max_doublings > 30)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  transition_kernel<<<dim3((unsigned)B, (unsigned)chunks_for(N)), kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cnt), static_cast<const uint8_t*>(live),
      static_cast<const int*>(dbl), static_cast<const float*>(win),
      static_cast<const float*>(rand), static_cast<const int*>(step),
      static_cast<const int*>(nexp), static_cast<int*>(ncnt),
      static_cast<int*>(ndbl), static_cast<uint8_t*>(nact), N, max_doublings);
  return (int)cudaGetLastError();
}
