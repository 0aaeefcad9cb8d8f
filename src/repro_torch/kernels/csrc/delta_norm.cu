// Eq. 2 reduction for every leaf of a model in ONE launch:
//   d2[l, u] = sum_i (float(stack_l[u, i]) - float(glob_l[i]))^2
//   g2[l]    = sum_i float(glob_l[i])^2
// for leaves l = 0..L-1 (each a stacked (U, n_l) cohort against its
// (n_l,) global), u = 0..U-1.
//
// Replaces the TPU kernel src/repro/kernels/delta_norm.py::delta_norm_pallas,
// which the reference vmaps over the (U, ...) stack, one call per leaf.
//
// Bound on this card: bytes — (U + 1) * n * itemsize read over all leaves,
// (U + 1) * L floats written, three operations an element. The design:
//   * the leaf table travels BY VALUE in the kernel's parameter space (a
//     __grid_constant__ struct, up to kMaxLeaves leaves, in the style of
//     fused_sgd.cu): no host-to-device copy, and the launch can be
//     captured in a CUDA graph;
//   * each leaf has U + 1 rows: the U local rows, and row U, the global
//     alone (a zero row: (0 - g)^2 = g^2 exactly), so g2 is computed by
//     one set of blocks a leaf, not by every user;
//   * a block owns R consecutive rows (R = 1, 2 or 4, a template argument
//     chosen per launch: the most rows that still leave kMinBlocks blocks,
//     so a small cohort keeps one row a block and a large one reads the
//     global once per R rows). R sets only how many rows share a block
//     (or a warp) and its loads of the global, never which elements a
//     thread sums or in what order: a thread loads the same kRowVecs
//     16-byte vectors of the global (4 f32 or 8 bf16 each) whatever R is,
//     holds them in registers across the block's R rows, and loads that
//     many vectors of each row before it accumulates any. So a row's
//     partition into chunks, slots, warps and lanes, and its fold order,
//     follow its leaf's n alone: a row gives the same bits alone, in a
//     256-row chunk or in a 10 000-row stack (the sparse prepass and the
//     fused round must agree bit for bit);
//   * a leaf longer than a warp's span (32 threads' vectors) is cut into
//     chunks of kThreads threads' vectors; the block takes min(chunks,
//     kMaxSlots) "slots" of its rows, walking chunk b, b + slots, ... A
//     shorter leaf packs kWarps x R rows into a block, a warp per R rows;
//   * a leaf whose n is not a multiple of V or whose pointers are not
//     16-byte aligned takes the one-element path over the same chunk, its
//     loads batched alike. The ragged tail is masked;
//   * the fold runs in the same launch, with no float atomics: a row
//     with more than one slot gets one partial per block; after a
//     __threadfence() the block takes an INTEGER ticket for the row
//     (atomicAdd on an unsigned), and the block that draws the last one
//     sums the row's partials in a fixed order and resets the ticket to
//     zero. The tickets are zeroed once by the caller and left zeroed. A
//     fold through a thread-block cluster's distributed shared memory (8
//     blocks a row, no tickets) was no faster on the H100 at 10 users, and
//     a launch has one cluster size for leaves of 10 to 819 200 elements.
// The order of every addition into a row's sum is a function of (its
// leaf's n, dtype, alignment) alone: two runs give the same bits, and so
// do a row alone and the same row inside a wider stack.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

using namespace repro_vec;

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowVecs = 8;   // a thread's vectors of a chunk, whatever R is
constexpr int kMaxRows = 4;
constexpr int kMaxSlots = 256;         // partials a row; a warp folds them
constexpr long long kMinBlocks = 2048;  // ~ 2 waves of the card's 132 SMs
constexpr int kMinBlocksPerSM = 2;      // resident blocks (<= 128 registers)

struct Leaves {
  const void* stack[kMaxLeaves];
  const void* glob[kMaxLeaves];
  long long n[kMaxLeaves];
  long long part[kMaxLeaves];   // first partial of the leaf (slots > 1)
  int first[kMaxLeaves + 1];    // first block of each leaf; [count] = total
  int slots[kMaxLeaves];        // blocks a row group (chunked leaves)
  unsigned vec;                 // bit l: leaf l takes 16-byte vectors
  unsigned packed;              // bit l: leaf l takes a warp per R rows
  int count;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Adds to acc[i] the squared distances of row r0 + i (i < rows) over the
// share of thread `lane` of W cooperating threads in [base, base +
// W * kRowVecs * V): the global's vectors are loaded once, then each
// row's, the same columns in the same order for every R. The call's
// kRowVecs * V squares are summed apart and added to acc[i] once: on a
// leaf of 2e9 elements a row a thread walks ~2 000 chunks, and tens of
// thousands of squares added one by one to an f32 that grows to ~6e4
// lose the smallest ones (their density peaks at zero), a bias that
// grows with the row. Row U is the global alone (its row reads as zero).
template <typename T, int V, int W, int R>
__device__ __forceinline__ void accumulate(const T* __restrict__ stack,
                                           const T* __restrict__ glob,
                                           long long n, long long base,
                                           int lane, int r0, int rows, int U,
                                           float (&acc)[R]) {
  using C = Cols<T, V>;
  using Raw = typename C::Raw;
  constexpr int kVecs = kRowVecs;
  Raw g[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long c = base + ((long long)k * W + lane) * V;
    if (c < n) g[k] = C::load(glob + c);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i >= rows) break;
    const int r = r0 + i;
    const bool local = r < U;
    const T* row = stack + (long long)r * n;
    Raw x[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long c = base + ((long long)k * W + lane) * V;
      if (local && c < n) x[k] = C::load(row + c);
    }
    float part = 0.0f;   // this call's squares, then one add into acc
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long c = base + ((long long)k * W + lane) * V;
      if (c < n) {
        float a[V], b[V];
        C::get(g[k], b);
        if (local) {
          C::get(x[k], a);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) a[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = a[e] - b[e];
          part = fmaf(d, d, part);
        }
      }
    }
    acc[i] += part;
  }
}

// d2 of (l, r) at l * U + r; g2 of leaf l (row U) after all L * U of them
__device__ __forceinline__ long long out_index(int l, int r, int U, int L) {
  return r < U ? (long long)l * U + r : (long long)L * U + l;
}

// A warp per R rows of a leaf no longer than a warp's span: no block
// synchronisation, one write a row.
template <typename T, int V, int R>
__device__ void packed_rows(const Leaves& t, int l, int lb, int U,
                            float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (lb * kWarps + warp) * R;
  if (r0 > U) return;
  const int rows = min(R, U + 1 - r0);
  const T* stack = static_cast<const T*>(t.stack[l]);
  const T* glob = static_cast<const T*>(t.glob[l]);
  const long long n = t.n[l];
  float acc[R] = {};
  if ((t.vec >> l) & 1u) {
    accumulate<T, V, 32, R>(stack, glob, n, 0, lane, r0, rows, U, acc);
  } else {
    for (int v = 0; v < V; ++v)
      accumulate<T, 1, 32, R>(stack, glob, n,
                              (long long)v * 32 * kRowVecs, lane, r0,
                              rows, U, acc);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i >= rows) break;
    const float s = warp_sum(acc[i]);
    if (lane == 0) out[out_index(l, r0 + i, U, t.count)] = s;
  }
}

// Block (group of R rows, slot b) of a chunked leaf: its chunks, the
// block's sum of each row, then the ticket fold when the row has more
// than one slot.
template <typename T, int V, int R>
__device__ void chunk_rows(const Leaves& t, int l, int lb, int U,
                           float* __restrict__ out, float* __restrict__ part,
                           unsigned* __restrict__ tickets) {
  __shared__ float red[R][kWarps];
  __shared__ int last[R];
  constexpr long long kChunk = (long long)kThreads * kRowVecs * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = t.slots[l];
  const int gi = lb / nb, b = lb - gi * nb;
  const int r0 = gi * R;
  const int rows = min(R, U + 1 - r0);
  const T* stack = static_cast<const T*>(t.stack[l]);
  const T* glob = static_cast<const T*>(t.glob[l]);
  const long long n = t.n[l];
  const long long chunks = (n + kChunk - 1) / kChunk;
  const bool vec = (t.vec >> l) & 1u;
  float acc[R] = {};
  for (long long c = b; c < chunks; c += nb) {
    if (vec) {
      accumulate<T, V, kThreads, R>(stack, glob, n, c * kChunk, threadIdx.x,
                                    r0, rows, U, acc);
    } else {
      for (int v = 0; v < V; ++v)
        accumulate<T, 1, kThreads, R>(stack, glob, n,
                                      (c * V + v) * (kChunk / V),
                                      threadIdx.x, r0, rows, U, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i >= rows) break;
    const float s = warp_sum(acc[i]);
    if (lane == 0) red[i][warp] = s;
  }
  __syncthreads();
  const long long trow = (long long)l * (U + 1) + r0;   // ticket index
  if (threadIdx.x < rows) {
    const int i = threadIdx.x;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[i][w];
    if (nb == 1) {
      out[out_index(l, r0 + i, U, t.count)] = s;
    } else {
      part[t.part[l] + (long long)(r0 + i) * nb + b] = s;
      __threadfence();
      last[i] = atomicAdd(&tickets[trow + i], 1u) == (unsigned)(nb - 1);
    }
  }
  if (nb == 1) return;
  __syncthreads();
  if (warp < rows && last[warp]) {
    __threadfence();
    const float* p = part + t.part[l] + (long long)(r0 + warp) * nb;
    float s = 0.0f;
    for (int j = lane; j < nb; j += 32) s += __ldcg(p + j);
    s = warp_sum(s);
    if (lane == 0) {
      out[out_index(l, r0 + warp, U, t.count)] = s;
      tickets[trow + warp] = 0u;
    }
  }
}

// R rows a block (chunked leaves) or a warp (packed leaves): a template
// argument, so the one-row kernel of a small cohort holds one row's
// registers. At most 128 registers a thread, so two blocks share an SM:
// unbounded, the R = 4 kernel took more and ran one block an SM, short
// of the loads in flight that the 1024-user rate needs
template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    delta_norm_kernel(const __grid_constant__ Leaves t, int U,
                      float* __restrict__ out, float* __restrict__ part,
                      unsigned* __restrict__ tickets) {
  int l = 0;
  while (l + 1 < t.count && t.first[l + 1] <= (int)blockIdx.x) ++l;
  const int lb = (int)blockIdx.x - t.first[l];
  if ((t.packed >> l) & 1u)
    packed_rows<T, V, R>(t, l, lb, U, out);
  else
    chunk_rows<T, V, R>(t, l, lb, U, out, part, tickets);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// blocks of leaf l with R rows a block (or a warp)
template <typename T, int R>
long long leaf_blocks(long long n, long long rows, int* slots) {
  constexpr int V = 16 / sizeof(T);
  constexpr long long kChunk = (long long)kThreads * kRowVecs * V;
  constexpr long long kSpan = 32LL * kRowVecs * V;
  if (n <= kSpan) {
    *slots = 0;                           // packed: a warp per R rows
    return ceil_div(rows, (long long)kWarps * R);
  }
  const long long c = ceil_div(n, kChunk);
  *slots = (int)(c > kMaxSlots ? kMaxSlots : c);
  return ceil_div(rows, R) * *slots;
}

template <typename T, int R>
int launch(const void* const* stack, const void* const* glob,
           const long long* n, int count, int U, float* out, float* part,
           long long part_cap, unsigned* tickets, long long ticket_cap,
           cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long rows = (long long)U + 1;
  Leaves t{};
  t.count = count;
  long long total = 0, parts = 0;
  for (int l = 0; l < count; ++l) {
    t.stack[l] = stack[l];
    t.glob[l] = glob[l];
    t.n[l] = n[l];
    t.first[l] = (int)total;
    total += leaf_blocks<T, R>(n[l], rows, &t.slots[l]);
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (t.slots[l] == 0) {
      t.packed |= 1u << l;
    } else if (t.slots[l] > 1) {
      t.part[l] = parts;
      parts += rows * t.slots[l];
    }
    if (n[l] % V == 0 && aligned16(stack[l]) && aligned16(glob[l]))
      t.vec |= 1u << l;
  }
  t.first[count] = (int)total;
  if (rows * count > ticket_cap || parts > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (parts > part_cap) return -(int)parts;   // nothing launched
  if (total == 0) return 0;
  delta_norm_kernel<T, V, R><<<(unsigned)total, kThreads, 0, s>>>(
      t, U, out, part, tickets);
  return (int)cudaGetLastError();
}

// R: the most rows a block (1, 2 or 4) that still leaves the grid
// kMinBlocks blocks, so small cohorts keep one row a block. R changes the
// grid, never a row's sum
template <typename T>
int launch_rows(const void* const* stack, const void* const* glob,
                const long long* n, int count, int U, float* out,
                float* part, long long part_cap, unsigned* tickets,
                long long ticket_cap, cudaStream_t s) {
  long long b2 = 0, b4 = 0;
  int slots;
  for (int l = 0; l < count; ++l) {
    if (n[l] < 0) return (int)cudaErrorInvalidValue;
    b2 += leaf_blocks<T, 2>(n[l], (long long)U + 1, &slots);
    b4 += leaf_blocks<T, 4>(n[l], (long long)U + 1, &slots);
  }
  auto go = b4 >= kMinBlocks ? launch<T, 4>
            : b2 >= kMinBlocks ? launch<T, 2> : launch<T, 1>;
  return go(stack, glob, n, count, U, out, part, part_cap, tickets,
            ticket_cap, s);
}

}  // namespace

// The most leaves one launch takes; a longer list takes more launches.
extern "C" int repro_delta_norm_max_leaves() { return kMaxLeaves; }

// stack, glob: host arrays of ``count`` device pointers (leaf l's
// contiguous (U, n[l]) stack and (n[l],) global, one dtype); out: (count
// * U + count) f32 = [d2 (count, U) row-major, g2 (count,)]; part: f32
// scratch of part_cap floats; tickets: ticket_cap unsigned, at least
// count * (U + 1), all zero (the kernel leaves them zero). dtype: 0 =
// float32, 1 = bfloat16. Returns 0, a CUDA error code, or -k when the
// fold needs k floats of `part` and part_cap is smaller (then nothing
// was launched).
extern "C" int repro_delta_norm_leaves(const void* const* stack,
                                       const void* const* glob,
                                       const long long* n, int count, int U,
                                       void* out, void* part,
                                       long long part_cap, void* tickets,
                                       long long ticket_cap, int dtype,
                                       void* stream) {
  if (count < 0 || count > kMaxLeaves || U < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (dtype == 0)
    return launch_rows<float>(stack, glob, n, count, U, o, p, part_cap, tk,
                              ticket_cap, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(stack, glob, n, count, U, o, p,
                                      part_cap, tk, ticket_cap, s);
  return (int)cudaErrorInvalidValue;
}
