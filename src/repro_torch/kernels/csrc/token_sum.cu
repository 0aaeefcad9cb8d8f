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
// N alone, and the bits equal the plain version's on the CPU.
//
// Bound on this card: bytes. Every input element is read once and every
// output written once; there is one add an element. What the design rests
// on: cut the tree over P into aligned chunks of B = 2^b tokens; each
// chunk's own tree, then the adjacent-pair tree over the P / B chunk sums,
// is the same tree for every B. So the launch geometry may follow R, N and
// C to fill the card (kernels/token_sum.py::token_sum_plan picks it) and
// the bits do not move:
//   * a block owns one aligned chunk of B tokens of one row and one column
//     tile; the grid is rows x chunks holding a real token x tiles;
//   * a thread sums V neighbouring columns (a 16- or 8-byte vector where C
//     and the pointers allow) over a run of L consecutive tokens with a
//     binary-counter stack (s[k] holds a finished subtree of 2^k tokens),
//     its loads 8 tokens ahead of the adds, streaming (__ldcs: each input
//     is read once); L <= 16 on every plan but a very long N, and L is a
//     constant of the code it runs (a switch over the five), so the stack
//     stays in registers. Runs of 32 took more registers and were slower
//     at every wide census shape;
//   * a warp is Cw lanes a token (Cw = the column groups rounded up to a
//     power of two, at most 32) x 32 / Cw consecutive runs: at a narrow
//     C only the lanes past C idle, and a batch of a warp's loads covers
//     one contiguous span of the row (one load reads its runs' tokens, L
//     apart); at a wide C one load is 32 vectors of a token. The runs
//     meet by xor-shuffles at lane strides Cw, 2 Cw, ..., 16, the warps'
//     sums in shared memory: the tree's upper levels over the chunk,
//     always the left operand first;
//   * tokens past N inside a chunk are zeros that are really added, as in
//     the plain version (a -0.0 column at N = 3 sums to +0.0); chunks
//     wholly past N are not launched and count as +0.0;
//   * with more than one chunk, the fold runs in the same launch, with no
//     float atomics: each block writes its chunk's partial, and after a
//     __threadfence() takes an INTEGER ticket for its (row, tile) (atomicAdd
//     on an unsigned); the block that draws the last one sums the chunk
//     partials in the same block tree and resets the ticket to zero. The
//     caller zeroes the tickets once, at allocation.
// Adds are __fadd_rn (no contraction, nothing to contract anyway).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocksPerSM = 2;   // <= 128 registers a thread
constexpr int kMaxFixedLg = 4;    // runs of up to 16 tokens unrolled
constexpr int kLongDepth = 19;    // runs of 16 a thread: L <= 2^23

// one launch's geometry (kernels/token_sum.py::token_sum_plan)
struct Geo {
  long long N;     // tokens a row
  int C;           // columns
  int groups;      // column groups of V columns: ceil(C / V)
  int lw;          // log2 Cw, the lanes a token
  int tiles;       // column tiles a row: ceil(groups / Cw)
  int run_lg;      // log2 L, a thread's run of tokens
  int used_lg;     // log2 of the runs a chunk (B = L << used_lg)
  int live;        // chunks holding a real token (>= 1)
  int chunks_lg;   // log2 (P / B)
  int frun_lg;     // the fold's run and runs used
  int fused_lg;
};

template <int V, bool kL2>
__device__ __forceinline__ void load(const float* p, float* f) {
  if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 r = kL2 ? __ldcg(q) : __ldcs(q);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  } else if constexpr (V == 2) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 r = kL2 ? __ldcg(q) : __ldcs(q);
    f[0] = r.x;
    f[1] = r.y;
  } else {
    f[0] = kL2 ? __ldcg(p) : __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* f) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    p[0] = f[0];
  }
}

// Push the i-th value x of a run onto a binary counter: s[k] holds a
// finished subtree of 2^k values, its left half first. The subtree that
// x completes lands in s[k] and in top.
template <int V, int DEPTH>
__device__ __forceinline__ void push(float (*s)[V], const float* x, int i,
                                     float* top) {
  float w[V];
#pragma unroll
  for (int c = 0; c < V; ++c) w[c] = x[c];
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    if (!((i >> k) & 1)) {
#pragma unroll
      for (int c = 0; c < V; ++c) s[k][c] = top[c] = w[c];
      return;
    }
#pragma unroll
    for (int c = 0; c < V; ++c) w[c] = __fadd_rn(s[k][c], w[c]);
  }
}

// The adjacent-pair tree of the 2^LG tokens first, first + 1, ... of a
// row (p: its token 0 at this thread's columns; a token is `stride`
// floats); tokens at or past n_real are zeros, added all the same. LG is
// fixed, so the loop unrolls and the stack stays in registers; the loads
// go 8 tokens at a time ahead of the adds.
template <int V, int LG, bool kL2>
__device__ __forceinline__ void run_fixed(const float* p, long long stride,
                                          long long n_real, long long first,
                                          float* v) {
  constexpr int L = 1 << LG;
  constexpr int kBatch = L < 8 ? L : 8;
  float s[LG + 1][V];
#pragma unroll
  for (int i0 = 0; i0 < L; i0 += kBatch) {
    float buf[kBatch][V];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long n = first + i0 + b;
      if (n < n_real) {
        load<V, kL2>(p + n * stride, buf[b]);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) buf[b][c] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) push<V, LG + 1>(s, buf[b], i0 + b, v);
  }
}

// run_fixed for a run of 2^lg tokens: lg <= 4 as such; a longer run (a
// very long N) as runs of 16 whose sums meet on a counter of their own.
template <int V, bool kL2>
__device__ __forceinline__ void run_tree(const float* p, long long stride,
                                         long long n_real, long long first,
                                         int lg, float* v) {
  switch (lg) {
    case 0: return run_fixed<V, 0, kL2>(p, stride, n_real, first, v);
    case 1: return run_fixed<V, 1, kL2>(p, stride, n_real, first, v);
    case 2: return run_fixed<V, 2, kL2>(p, stride, n_real, first, v);
    case 3: return run_fixed<V, 3, kL2>(p, stride, n_real, first, v);
    case 4: return run_fixed<V, 4, kL2>(p, stride, n_real, first, v);
    default: {
      float s[kLongDepth][V];
      float w[V];
      for (int i = 0; i < (1 << (lg - kMaxFixedLg)); ++i) {
        run_fixed<V, kMaxFixedLg, kL2>(
            p, stride, n_real, first + ((long long)i << kMaxFixedLg), w);
        push<V, kLongDepth>(s, w, i, v);
      }
    }
  }
}

// The tree over the block's 2^used_lg runs (run q at warp q >> (5 - lw),
// lanes (q mod 32 / Cw) * Cw + column): adjacent pairs by xor-shuffles
// inside a warp, then over the warps in shared memory. The chunk's sum
// lands in warp 0, lanes below Cw.
template <int V>
__device__ __forceinline__ void block_tree(float* v, int lw, int used_lg,
                                           float (*red)[32][V]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int in_warp = min(5 - lw, used_lg);
  for (int k = 0; k < in_warp; ++k) {
    const int bit = 1 << (lw + k);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float o = __shfl_xor_sync(0xffffffffu, v[c], bit);
      v[c] = (lane & bit) ? __fadd_rn(o, v[c]) : __fadd_rn(v[c], o);
    }
  }
  const int across = used_lg - in_warp;   // 0 .. 3
  if (across == 0) return;
  const int cw = 1 << lw;
  if (lane < cw) {
#pragma unroll
    for (int c = 0; c < V; ++c) red[warp][lane][c] = v[c];
  }
  __syncthreads();
  if (warp == 0 && lane < cw) {
    float a[kWarps][V];
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
#pragma unroll
      for (int c = 0; c < V; ++c)
        a[w][c] = w < (1 << across) ? red[w][lane][c] : 0.f;
#pragma unroll
    for (int st = 1; st < kWarps; st <<= 1) {
      if (st >= (1 << across)) break;
#pragma unroll
      for (int w = 0; w < kWarps; w += 2 * st)
#pragma unroll
        for (int c = 0; c < V; ++c) a[w][c] = __fadd_rn(a[w][c], a[w + st][c]);
    }
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = a[0][c];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
token_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ part, unsigned* __restrict__ tickets,
                 const Geo g) {
  __shared__ float red[kWarps][32][V];
  __shared__ bool last;
  const int tile = blockIdx.x % g.tiles;
  const long long rj = blockIdx.x / g.tiles;
  const int j = (int)(rj % g.live);
  const long long r = rj / g.live;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane & ((1 << g.lw) - 1);
  const int q = (warp << (5 - g.lw)) | (lane >> g.lw);   // the thread's run
  const int group = (tile << g.lw) + cl;
  const bool col = group < g.groups;
  const bool holder = warp == 0 && lane < (1 << g.lw) && col;
  const long long chunk = 1LL << (g.run_lg + g.used_lg);

  float v[V];
  if (col && q < (1 << g.used_lg)) {
    run_tree<V, false>(x + r * g.N * g.C + (long long)group * V, g.C, g.N,
                       j * chunk + ((long long)q << g.run_lg), g.run_lg, v);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = 0.f;
  }
  block_tree<V>(v, g.lw, g.used_lg, red);
  if (g.chunks_lg == 0) {
    if (holder) store<V>(out + r * g.C + (long long)group * V, v);
    return;
  }

  // the fold: the chunk's partial, then the ticket of (row, tile)
  float* rows = part + r * g.live * g.C + (long long)group * V;
  if (holder) {
    store<V>(rows + (long long)j * g.C, v);
    __threadfence();
  }
  __syncthreads();
  const long long t = r * g.tiles + tile;
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[t], 1u) == (unsigned)(g.live - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (col && q < (1 << g.fused_lg)) {
    run_tree<V, true>(rows, g.C, g.live, (long long)q << g.frun_lg,
                      g.frun_lg, v);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = 0.f;
  }
  block_tree<V>(v, g.lw, g.fused_lg, red);
  if (holder) store<V>(out + r * g.C + (long long)group * V, v);
  if (threadIdx.x == 0) tickets[t] = 0u;
}

template <int V>
int launch(const float* x, float* out, float* part, unsigned* tickets,
           const Geo& g, long long blocks, cudaStream_t s) {
  token_sum_kernel<V>
      <<<(unsigned)blocks, kThreads, 0, s>>>(x, out, part, tickets, g);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<unsigned long long>(p) % bytes) == 0;
}

}  // namespace

extern "C" {

// x: (R, N, C) contiguous f32; out: (R, C) f32; part: at least
// R * live * C floats when chunks_lg > 0; tickets: at least R * tiles
// unsigned, zero. The plan (V, lw, run_lg, used_lg, chunks_lg, frun_lg,
// fused_lg) is token_sum_plan's; it is checked against (R, N, C) here.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape or plan it does not take.
int repro_token_sum(const float* x, float* out, float* part,
                    long long part_cap, unsigned* tickets,
                    long long ticket_cap, int R, long long N, int C, int V,
                    int lw, int run_lg, int used_lg, int chunks_lg,
                    int frun_lg, int fused_lg, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (R < 1 || C < 1 || N < 0 || lw < 0 || lw > 5 || run_lg < 0 ||
      run_lg > kMaxFixedLg + kLongDepth || used_lg < 0 || used_lg > 8 - lw ||
      chunks_lg < 0 || chunks_lg > 62)
    return bad;
  if (!(V == 1 || V == 2 || V == 4) || C % V != 0 ||
      (V > 1 && !(aligned(x, 4 * V) && aligned(out, 4 * V) &&
                  aligned(part, 4 * V))))
    return bad;
  long long P = 1;
  while (P < N) P <<= 1;
  const int B_lg = run_lg + used_lg;
  if (B_lg + chunks_lg > 62 || (1LL << (B_lg + chunks_lg)) != P) return bad;
  Geo g{};
  g.N = N;
  g.C = C;
  g.groups = C / V;
  g.lw = lw;
  g.tiles = (g.groups + (1 << lw) - 1) >> lw;
  g.run_lg = run_lg;
  g.used_lg = used_lg;
  const long long live = N == 0 ? 1 : (N + (1LL << B_lg) - 1) >> B_lg;
  g.live = (int)live;
  g.chunks_lg = chunks_lg;
  g.frun_lg = frun_lg;
  g.fused_lg = fused_lg;
  const long long blocks = (long long)R * live * g.tiles;
  if (live > 0x7fffffffLL || blocks > 0x7fffffffLL ||
      (long long)R * g.tiles > ticket_cap)
    return bad;
  if (chunks_lg > 0 &&
      (frun_lg < 0 || frun_lg > kMaxFixedLg || fused_lg < 0 ||
       fused_lg > 8 - lw || frun_lg + fused_lg != chunks_lg ||
       (long long)R * live * C > part_cap))
    return bad;
  switch (V) {
    case 4:
      return launch<4>(x, out, part, tickets, g, blocks, stream);
    case 2:
      return launch<2>(x, out, part, tickets, g, blocks, stream);
    default:
      return launch<1>(x, out, part, tickets, g, blocks, stream);
  }
}

}  // extern "C"
