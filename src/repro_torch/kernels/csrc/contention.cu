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
//
// ---------------------------------------------------------------------------
// The persistent event loop (repro_contention_loop): passes 1-3 fused, and
// the whole event loop of kernels/contention.py::_contend_device (its plain
// version) run on the card, ONE block per pool row, with no host
// involvement between events. Replaces src/repro/kernels/contention.py::
// contention_event_pallas together with the lax.while_loop of that file's
// _contend_device that drives it. Driving the three passes from the host costs
// three launches, ~30 torch ops and one sync an event (~0.84 ms of host
// time against a few microseconds of device work), so what bounds the loop
// is the latency of one event, not bytes or operations; the design keeps an
// event inside one block:
//
//   * state: the row's lanes live in shared memory (expiry int32, or kDead
//     once a lane has left, doublings int32, window f32: 12 B a lane) when
//     M <= kSharedLanes, else in global scratch the wrapper allocates (the
//     retry ladder's wide attempts, up to M = N). One template, two storage
//     policies; thread i owns lanes i, i + T, i + 2T, ... in both, so lane
//     state needs no synchronisation;
//   * an event is ONE block reduction of (min expiry tau, count of live
//     lanes at tau, smallest pool column at tau): warp __reduce_*_sync, one
//     shared-memory round (double-buffered, so one __syncthreads an event),
//     then every warp reduces the per-warp triples itself, so every thread
//     holds the result and runs the row's bookkeeping (t, idle, wins, cols)
//     in registers, identically; no atomics;
//   * then, exactly as the plain loop orders it: the pool-exhaustion guard
//     tau >= threshold sets invalid; the horizon clamp freezes t at the cap;
//     a lone expiry delivers (its pool column and finish slot written, the
//     lane retired); two or more collide and each expiring lane redraws
//     clip(rint(u * win * 2^nd), 1, BIG) and re-enters at
//     min(tau + redraw, BIG). Other lanes keep their absolute expiry;
//   * redraws come from a counter-based generator: u is the top 24 bits of
//     splitmix64(splitmix64(key ^ ev) ^ (row << 32 | column)) times 2^-24,
//     where key mixes (entropy, call index) on the host and ev is the row's
//     own event count (the plain loop's global event index for as long as
//     the row runs). kernels/contention.py::counter_uniform is the same
//     function in int64 torch arithmetic, so the CPU and the card draw the
//     same numbers;
//   * delivered pool columns map to user ids through pool_idx once, after
//     the loop, so no event waits on a global load.
//
// Output per row, int32: [t, wins, collisions, invalid, events,
// winners[k_max], finish[k_max]] (-1 where nothing was delivered).
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

// ------------------------------------------------ the persistent event loop
constexpr int kDead = INT32_MAX;        // a lane that has left the pool
constexpr int kLoopThreads = 1024;
constexpr int kSharedLanes = 16384;     // 12 B a lane: 192 KB of shared memory
constexpr int kHead = 5;                // t, wins, cols, invalid, events

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// U[0, 1) of lane (row, col) in the event whose key is kev: the top 24
// bits, exact in f32.
__device__ __forceinline__ float counter_uniform(unsigned long long kev,
                                                 int row, int col) {
  const unsigned long long x = splitmix64(
      kev ^ (((unsigned long long)(unsigned)row << 32) | (unsigned)col));
  return (float)(unsigned)(x >> 40) * 0x1p-24f;
}

struct Expiry {
  int tau, nexp, first;
};

// The block's (min m, sum of c where m is the min, min f where m is the
// min), in EVERY thread. blockDim.x is a multiple of 32; red is this
// event's buffer of the double-buffered (3, 32) scratch.
__device__ __forceinline__ Expiry block_expiry(int m, int c, int f,
                                               int (*red)[32]) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int mw = __reduce_min_sync(full, m);
  const int cw = (int)__reduce_add_sync(full, (unsigned)(m == mw ? c : 0));
  const int fw = __reduce_min_sync(full, m == mw ? f : kDead);
  if (lane == 0) {
    red[0][warp] = mw;
    red[1][warp] = cw;
    red[2][warp] = fw;
  }
  __syncthreads();
  m = lane < nw ? red[0][lane] : kDead;
  c = lane < nw ? red[1][lane] : 0;
  f = lane < nw ? red[2][lane] : kDead;
  Expiry e;
  e.tau = __reduce_min_sync(full, m);
  e.nexp = (int)__reduce_add_sync(full, (unsigned)(m == e.tau ? c : 0));
  e.first = __reduce_min_sync(full, m == e.tau ? f : kDead);
  return e;
}

// grid B, one block a row. kShared: lane state in dynamic shared memory
// (key[M], dbl[M], win[M]); else key / dbl in g_key / g_dbl, (B, M) each,
// and the window read from pool_win.
template <bool kShared>
__global__ void __launch_bounds__(kLoopThreads) loop_kernel(
    const int* __restrict__ pool_exp, const float* __restrict__ pool_win,
    const int* __restrict__ pool_idx, const int* __restrict__ threshold,
    const int* __restrict__ k_arr, int* __restrict__ g_key,
    int* __restrict__ g_dbl, int* __restrict__ out, int M, int k_max,
    int tx_slots, int max_doublings, int cap, unsigned long long key) {
  extern __shared__ int lanes[];
  __shared__ int red[2][3][32];
  const int b = blockIdx.x, T = blockDim.x;
  const long long row = (long long)b * M;
  int* lk = kShared ? lanes : g_key + row;
  int* ld = kShared ? lanes + M : g_dbl + row;
  const float* lw =
      kShared ? reinterpret_cast<const float*>(lanes + 2 * M) : pool_win + row;
  int* o = out + (long long)b * (kHead + 2 * k_max);
  int live = 0;
  for (int i = threadIdx.x; i < M; i += T) {
    const int e = pool_exp[row + i];
    lk[i] = e < kBig ? e : kDead;
    ld[i] = 0;
    if (kShared) reinterpret_cast<float*>(lanes + 2 * M)[i] = pool_win[row + i];
    live += e < kBig;
  }
  for (int i = threadIdx.x; i < 2 * k_max; i += T) o[kHead + i] = -1;
  int n_act = block_expiry(0, live, 0, red[1]).nexp;   // orders the -1s too
  const int thr = threshold[b], kb = k_arr[b];
  int t = 0, idle = 0, wins = 0, cols = 0, ev = 0, buf = 0;
  bool invalid = false;
  while (wins < kb && n_act > 0 && t < cap) {
    int m = kDead, c = 0, f = kDead;
    for (int i = threadIdx.x; i < M; i += T) {
      const int v = lk[i];
      if (v < m) {
        m = v;
        c = 1;
        f = i;
      } else if (v == m) {
        ++c;
      }
    }
    const Expiry x = block_expiry(m, c, f, red[buf]);
    buf ^= 1;
    const int e = ev++;
    const int tau = min(x.tau, kBig);
    if (tau >= thr) {                   // an excluded counter could be first
      invalid = true;
      break;
    }
    const int finish_t = t + (tau - idle) + tx_slots;
    if (finish_t > cap) {               // airtime past the horizon: freeze
      t = cap;
      break;
    }
    t = finish_t;
    idle = tau;
    if (x.nexp == 1) {
      if (threadIdx.x == 0) {
        const int slot = min(wins, k_max - 1);
        o[kHead + slot] = x.first;      // a pool column until the loop ends
        o[kHead + k_max + slot] = finish_t;
      }
      if (x.first % T == threadIdx.x) lk[x.first] = kDead;
      ++wins;
      --n_act;
    } else {
      ++cols;
      const unsigned long long kev = splitmix64(key ^ (unsigned long long)e);
      for (int i = threadIdx.x; i < M; i += T) {
        if (lk[i] != tau) continue;
        const int nd = min(ld[i] + 1, max_doublings);
        float r = __fmul_rn(__fmul_rn(counter_uniform(kev, b, i), lw[i]),
                            pow2(nd));
        r = fminf(fmaxf(rintf(r), 1.0f), (float)kBig);
        lk[i] = min(tau + (int)r, kBig);
        ld[i] = nd;
      }
    }
  }
  __syncthreads();                      // thread 0's column writes
  for (int s = threadIdx.x; s < min(wins, k_max); s += T)
    o[kHead + s] = pool_idx[row + o[kHead + s]];
  if (threadIdx.x == 0) {
    o[0] = t;
    o[1] = wins;
    o[2] = cols;
    o[3] = invalid ? 1 : 0;
    o[4] = ev;
  }
}

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

// The lanes a row may hold in shared memory; a wider pool needs the
// global scratch g_key / g_dbl.
extern "C" int repro_contention_loop_shared_lanes() { return kSharedLanes; }

// The persistent event loop over B pool rows of M lanes. pool_exp: (B, M)
// int32 absolute expiries in [0, BIG] (BIG: not in the race); pool_win:
// (B, M) f32; pool_idx: (B, M) int32 user ids; threshold, k_arr: (B,)
// int32; g_key, g_dbl: (B, M) int32 scratch when M > kSharedLanes, else
// unused (may be null); out: (B, 5 + 2 k_max) int32. key: the host's mix of
// (entropy, call index). Returns cudaGetLastError().
extern "C" int repro_contention_loop(
    const void* pool_exp, const void* pool_win, const void* pool_idx,
    const void* threshold, const void* k_arr, void* g_key, void* g_dbl,
    void* out, int B, int M, int k_max, int tx_slots, int max_doublings,
    int max_sim_slots, unsigned long long key, void* stream) {
  if (bad_shape(B, M) || k_max < 1 || max_doublings < 0 ||
      max_doublings > 30 || tx_slots < 1 || tx_slots >= (1 << 20) ||
      max_sim_slots < 0 || max_sim_slots > kBig)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = (M + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kLoopThreads ? kLoopThreads
                                                        : threads);
  const int* pe = static_cast<const int*>(pool_exp);
  const float* pw = static_cast<const float*>(pool_win);
  const int* pi = static_cast<const int*>(pool_idx);
  const int* th = static_cast<const int*>(threshold);
  const int* ka = static_cast<const int*>(k_arr);
  int* o = static_cast<int*>(out);
  if (M <= kSharedLanes) {
    const size_t smem = (size_t)12 * M;
    // the dynamic lanes and the static reduction buffer together: above
    // 48 KB only after opting in, which holds for the current device
    // alone: opt in on every such launch (a 4096-lane pool's 48 KB of
    // lanes alone does not fit without it)
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, loop_kernel<true>);
    if (rc != cudaSuccess) return (int)rc;
    if (smem + attr.sharedSizeBytes > 48 * 1024) {
      rc = cudaFuncSetAttribute(
          loop_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    loop_kernel<true><<<(unsigned)B, threads, smem, s>>>(
        pe, pw, pi, th, ka, nullptr, nullptr, o, M, k_max, tx_slots,
        max_doublings, max_sim_slots, key);
  } else {
    if (g_key == nullptr || g_dbl == nullptr)
      return (int)cudaErrorInvalidValue;
    loop_kernel<false><<<(unsigned)B, threads, 0, s>>>(
        pe, pw, pi, th, ka, static_cast<int*>(g_key),
        static_cast<int*>(g_dbl), o, M, k_max, tx_slots, max_doublings,
        max_sim_slots, key);
  }
  return (int)cudaGetLastError();
}
