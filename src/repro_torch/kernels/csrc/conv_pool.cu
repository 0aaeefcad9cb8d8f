// The paper CNN's first block over a stacked cohort, forward and weight
// gradient, in two kernels:
//   out[b, r, o, i, j] = max over the 2x2 window (2i + dy, 2j + dx) of
//                        relu(conv5x5_same(x[r, b], w[r])[o] + bias[r, o])
//   dw[r], db[r]       = the vjp of that block, for a cotangent of out
// x: (R, B, H, W, C) NHWC f32 (each row contiguous, rows a stride apart);
// w: (R, 5, 5, C, O) HWIO; bias: (R, O); out: (B, R, O, H/2, W/2), the
// layout conv2's grouped call reads under vmap without a copy (the users
// next to the channels); dw: (R, 5, 5, C, O), db: (R, O), contiguous.
//
// Replaces no TPU kernel: the reference leaves this block to XLA
// (src/repro/models/paper_models.py::apply_cnn, conv -> relu -> pool).
// It was added because under vmap the port's conv1, with one input
// channel a user, is a depthwise grouped convolution, which ATen serves
// with its own f32 fallback kernels (conv_depthwise2d_forward and
// _grad_weight), not cuDNN; and the block wrote and read its 28 x 28 x 128
// activation, the bias-add, the ReLU and the pool's int64 indices, about
// 1.5 GB a local step of the paper's cell (10 users x 32 examples).
//
// Bound on this card at that cell (U = 10, B = 32, 28 x 28 x 1 -> 128):
// the forward is operations, 1.606 GFLOP (every tap of every conv output,
// as f32 FMAs outside the tensor cores) against 33 MB, 24 us at 67
// TFLOP/s; the backward 0.40 GFLOP (the winner's 25 taps a pooled output)
// against 41 MB, 12 us at 3.35 TB/s. The design:
//   * forward, conv_pool_kernel: a block owns one image (r, b) and a tile
//     of 64 output channels. It stages the image zero-padded (2 a side)
//     and the tile's weights in shared memory; a thread takes a pooled
//     position and 8 channels at a time, holds the 6 x 6 input patch of
//     its 2x2 window in registers and the 8 x 4 conv outputs as FMA
//     accumulators (taps in (c, kh, kw) order, 8 weights a 32-byte
//     broadcast load a tap), adds the bias, takes the ReLU and the max,
//     all in registers. It writes the pooled value and a one-byte winner
//     code: the window position (dy * 2 + dx) of the first maximum in
//     row-major order, as max_pool2d takes it (NaN wins, as there), or 4
//     ("none") where the maximum is <= 0, since relu'(0) = 0. Nothing of
//     the 28 x 28 activation reaches device memory;
//   * backward, conv_pool_grad_kernel<CG>: a block owns one user r, a tile
//     of 32 output channels (a lane each), CG input channels (3 where C
//     is a multiple of 3, as the CIFAR variant's, else 1) and a chunk of
//     images. Per image it stages the padded input planes, then the
//     tile's cotangents in slabs of up to 256 positions (a warp four
//     channel rows, its lanes along the positions), each paired with the
//     shared-memory offset of its winner (a "none" pair carries a zero
//     cotangent); a warp walks every 8th position of a slab and each lane
//     adds g * x at the winner's 25 x CG taps, and g into db. The padded
//     row stride keeps the four possible winner offsets of a warp's load
//     in four banks. The 8 warps' sums then fold in a fixed tree;
//   * the image chunk is a function of (H, W) alone (512 pooled positions
//     a chunk); with more than one chunk the fold runs in the same launch,
//     with no float atomics: each block writes its partial, takes an
//     INTEGER ticket for its (r, tile, channel group) after a
//     __threadfence(), and the block that draws the last one adds the
//     chunk partials in chunk order and resets the ticket to zero (the
//     caller zeroes the tickets once, at allocation).
// So every output of user r is a function of user r's operands and of
// (B, H, W, C) alone, in a fixed order: the same bits alone, in a cohort
// of 10 or in a sweep's E x U stack. f32 throughout; FMAs in the conv
// sums, the bias and the gradient folds __fadd_rn.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 5;               // the kernel side
constexpr int kPad = kK / 2;        // "SAME"
constexpr int kTaps = kK * kK;
constexpr int kFwdTile = 64;        // output channels a forward block
constexpr int kOct = 8;             // output channels a forward thread
constexpr int kGradTile = 32;       // output channels a backward block
constexpr unsigned char kNone = 4;

// one launch's shape (kernels/conv_pool.py::conv_pool_plan)
struct Geo {
  int R, B, H, W, C, O;
  int W2, P;            // pooled columns, pooled positions (H/2 * W/2)
  long long sx;         // elements between x's stack rows
  int rs;               // padded row stride in shared memory
  int plane;            // floats of one padded channel plane
  int xs_floats;        // the staged planes, rounded up to 4 floats
  int tiles;            // output-channel tiles
  int groups;           // input-channel groups (backward)
  int chunk;            // images a chunk (backward)
  int chunks;
  int slab;             // positions a staged slab (backward)
  int ps;               // padded slab stride, odd
};

__device__ __forceinline__ void stage_planes(const float* __restrict__ xi,
                                             float* xs, const Geo& g,
                                             int c0, int cn) {
  // xi: one image, NHWC; planes cn channels from c0, interior only
  const int n = g.H * g.W * cn;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int cc = i % cn, pix = i / cn;
    const int h = pix / g.W, w = pix - h * g.W;
    xs[cc * g.plane + (h + kPad) * g.rs + w + kPad] =
        xi[(long long)pix * g.C + c0 + cc];
  }
}

__global__ void __launch_bounds__(kThreads)
conv_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 unsigned char* __restrict__ codes, const Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x % g.tiles;
  const long long img = blockIdx.x / g.tiles;
  const int b = (int)(img % g.B);
  const int r = (int)(img / g.B);
  const int o0 = tile * kFwdTile;
  const int ot = min(kFwdTile, g.O - o0);      // a multiple of kOct
  float* xs = smem;                            // C planes
  float* ws = xs + g.xs_floats;                // [tap][c][kFwdTile]
  float* bs = ws + kTaps * g.C * kFwdTile;     // [kFwdTile]

  for (int i = threadIdx.x; i < g.xs_floats; i += kThreads) xs[i] = 0.f;
  const float* wr = w + (long long)r * kTaps * g.C * g.O + o0;
#pragma unroll 4
  for (int i = threadIdx.x; i < kTaps * g.C * kFwdTile; i += kThreads) {
    const int o = i % kFwdTile, tc = i / kFwdTile;
    ws[i] = o < ot ? wr[(long long)tc * g.O + o] : 0.f;
  }
  if (threadIdx.x < kFwdTile)
    bs[threadIdx.x] =
        threadIdx.x < ot ? bias[(long long)r * g.O + o0 + threadIdx.x] : 0.f;
  __syncthreads();
  stage_planes(x + r * g.sx + (long long)b * g.H * g.W * g.C, xs, g, 0, g.C);
  __syncthreads();

  const int items = g.P * (ot / kOct);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int q = it / g.P, p = it - q * g.P;  // channel octet, position
    const int ph = p / g.W2, pw = p - ph * g.W2;
    float acc[kOct][4];
#pragma unroll
    for (int k = 0; k < kOct; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
    for (int c = 0; c < g.C; ++c) {
      const float* xp = xs + c * g.plane + 2 * ph * g.rs + 2 * pw;
      float patch[kK + 1][kK + 1];
#pragma unroll
      for (int i = 0; i <= kK; ++i)
#pragma unroll
        for (int j = 0; j <= kK; ++j) patch[i][j] = xp[i * g.rs + j];
      const float* wc = ws + c * kFwdTile + q * kOct;
#pragma unroll
      for (int kh = 0; kh < kK; ++kh) {
#pragma unroll
        for (int kw = 0; kw < kK; ++kw) {
          const float* wt = wc + (kh * kK + kw) * g.C * kFwdTile;
          const float4 wa = *reinterpret_cast<const float4*>(wt);
          const float4 wb = *reinterpret_cast<const float4*>(wt + 4);
          const float wv[kOct] = {wa.x, wa.y, wa.z, wa.w,
                                  wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int k = 0; k < kOct; ++k) {
            acc[k][0] = fmaf(patch[kh][kw], wv[k], acc[k][0]);
            acc[k][1] = fmaf(patch[kh][kw + 1], wv[k], acc[k][1]);
            acc[k][2] = fmaf(patch[kh + 1][kw], wv[k], acc[k][2]);
            acc[k][3] = fmaf(patch[kh + 1][kw + 1], wv[k], acc[k][3]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kOct; ++k) {
      const float bb = bs[q * kOct + k];
      float m = 0.f;
      int win = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = __fadd_rn(acc[k][j], bb);
        v = v < 0.f ? 0.f : v;                 // ReLU; NaN stays NaN
        if (j == 0 || v > m || isnan(v)) {
          m = v;
          win = j;
        }
      }
      const long long at =
          (((long long)b * g.R + r) * g.O + o0 + q * kOct + k) * g.P + p;
      out[at] = m;
      codes[at] = m <= 0.f ? kNone : (unsigned char)win;
    }
  }
}

template <int CG>
__global__ void __launch_bounds__(kThreads)
conv_pool_grad_kernel(const float* __restrict__ gout,
                      const float* __restrict__ x,
                      const unsigned char* __restrict__ codes,
                      float* __restrict__ dw, float* __restrict__ db,
                      float* __restrict__ part, unsigned* __restrict__ tickets,
                      const Geo g) {
  constexpr int J = kTaps * CG + 1;            // dw's taps x channels, db
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ bool last;
  long long id = blockIdx.x;
  const int chunk = (int)(id % g.chunks);
  id /= g.chunks;
  const int grp = (int)(id % g.groups);
  id /= g.groups;
  const int tile = (int)(id % g.tiles);
  const int r = (int)(id / g.tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = tile * kGradTile + lane;
  const int c0 = grp * CG;
  float* xs = smem;                            // CG planes
  float2* gs = reinterpret_cast<float2*>(smem + g.xs_floats);  // [32][ps]
  int* base = reinterpret_cast<int*>(gs + kGradTile * g.ps);   // [P]

  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  for (int i = threadIdx.x; i < g.xs_floats; i += kThreads) xs[i] = 0.f;
  // each pooled position's window corner in the padded planes
  for (int p = threadIdx.x; p < g.P; p += kThreads) {
    const int ph = p / g.W2;
    base[p] = 2 * ph * g.rs + 2 * (p - ph * g.W2);
  }

  const int b_end = min(g.B, (chunk + 1) * g.chunk);
  for (int b = chunk * g.chunk; b < b_end; ++b) {
    __syncthreads();                           // the last image is read
    stage_planes(x + r * g.sx + (long long)b * g.H * g.W * g.C, xs, g, c0,
                 CG);
    for (int p0 = 0; p0 < g.P; p0 += g.slab) {
      const int n = min(g.slab, g.P - p0);
      if (p0 > 0) __syncthreads();             // the last slab is read
      // a warp the channel rows warp + 8 k, its lanes along the positions;
      // a lane's loads of its four rows go out together
      for (int pp = lane; pp < n; pp += 32) {
        float gv[kGradTile / kWarps];
        int code[kGradTile / kWarps];
#pragma unroll
        for (int k = 0; k < kGradTile / kWarps; ++k) {
          const int oo = tile * kGradTile + warp + k * kWarps;
          gv[k] = 0.f;
          code[k] = kNone;
          if (oo < g.O) {
            const long long at =
                (((long long)b * g.R + r) * g.O + oo) * g.P + p0 + pp;
            gv[k] = gout[at];
            code[k] = codes[at];
          }
        }
        const int corner = base[p0 + pp];
#pragma unroll
        for (int k = 0; k < kGradTile / kWarps; ++k) {
          if (code[k] == kNone) {               // no gradient: a zero pair
            gv[k] = 0.f;
            code[k] = 0;
          }
          gs[(warp + k * kWarps) * g.ps + pp] = make_float2(
              gv[k], __int_as_float(corner + (code[k] >> 1) * g.rs +
                                    (code[k] & 1)));
        }
      }
      __syncthreads();
      for (int pp = warp; pp < n; pp += kWarps) {
        const float2 e = gs[lane * g.ps + pp];
        const float* xp = xs + __float_as_int(e.y);
#pragma unroll
        for (int kh = 0; kh < kK; ++kh)
#pragma unroll
          for (int kw = 0; kw < kK; ++kw)
#pragma unroll
            for (int cc = 0; cc < CG; ++cc) {
              const int j = (kh * kK + kw) * CG + cc;
              acc[j] = fmaf(e.x, xp[cc * g.plane + kh * g.rs + kw], acc[j]);
            }
        acc[J - 1] = __fadd_rn(acc[J - 1], e.x);
      }
    }
  }

  // the 8 warps' sums, in one fixed tree
  __syncthreads();
  float* red = smem;                           // [kWarps][J][32]
#pragma unroll
  for (int j = 0; j < J; ++j) red[(warp * J + j) * 32 + lane] = acc[j];
  __syncthreads();
  float sums[(J + kWarps - 1) / kWarps];
#pragma unroll
  for (int t = 0; t < (J + kWarps - 1) / kWarps; ++t) {
    const int j = warp + t * kWarps;
    float v[kWarps];
#pragma unroll
    for (int k = 0; k < kWarps; ++k)
      v[k] = j < J ? red[(k * J + j) * 32 + lane] : 0.f;
#pragma unroll
    for (int s = 1; s < kWarps; s <<= 1)
#pragma unroll
      for (int k = 0; k < kWarps; k += 2 * s) v[k] = __fadd_rn(v[k], v[k + s]);
    sums[t] = v[0];
  }

  // output j of this thread: dw[r, tap, c0 + cc, o] or db[r, o]
  const int CJ = kTaps * g.C + 1;              // a chunk partial's rows
  auto row = [&](int j) {
    return j == J - 1 ? kTaps * g.C
                      : (j / CG) * g.C + c0 + j % CG;
  };
  auto store = [&](int j, float v) {
    if (j == J - 1) {
      db[(long long)r * g.O + o] = v;
    } else {
      dw[((long long)r * kTaps * g.C + row(j)) * g.O + o] = v;
    }
  };
  // db is every group's same sum: group 0 keeps it
  auto mine_j = [&](int j) { return j < J && o < g.O && (j < J - 1 || grp == 0); };
  if (g.chunks == 1) {
#pragma unroll
    for (int t = 0; t < (J + kWarps - 1) / kWarps; ++t) {
      const int j = warp + t * kWarps;
      if (mine_j(j)) store(j, sums[t]);
    }
    return;
  }
  float* mine = part + ((long long)r * g.chunks + chunk) * CJ * g.O;
#pragma unroll
  for (int t = 0; t < (J + kWarps - 1) / kWarps; ++t) {
    const int j = warp + t * kWarps;
    if (mine_j(j)) mine[(long long)row(j) * g.O + o] = sums[t];
  }
  __threadfence();
  __syncthreads();
  const long long ticket = ((long long)r * g.tiles + tile) * g.groups + grp;
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[ticket], 1u) == (unsigned)(g.chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = part + (long long)r * g.chunks * CJ * g.O;
#pragma unroll
  for (int t = 0; t < (J + kWarps - 1) / kWarps; ++t) {
    const int j = warp + t * kWarps;
    if (mine_j(j)) {
      const long long at = (long long)row(j) * g.O + o;
      float v = __ldcg(all + at);
      for (int k = 1; k < g.chunks; ++k)
        v = __fadd_rn(v, __ldcg(all + (long long)k * CJ * g.O + at));
      store(j, v);
    }
  }
  if (threadIdx.x == 0) tickets[ticket] = 0u;
}

// The large shared-memory opt-in belongs to the current device's copy of
// the kernel, so it is set at every launch (a call on another card needs
// its own), as combine.cu's allow_smem does.
int allow_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int CG>
int launch_grad(const float* gout, const float* x, const unsigned char* codes,
                float* dw, float* db, float* part, unsigned* tickets,
                const Geo& g, int smem, cudaStream_t s) {
  const int rc = allow_smem((const void*)conv_pool_grad_kernel<CG>, smem);
  if (rc != 0) return rc;
  const long long blocks =
      (long long)g.R * g.tiles * g.groups * g.chunks;
  conv_pool_grad_kernel<CG><<<(unsigned)blocks, kThreads, smem, s>>>(
      gout, x, codes, dw, db, part, tickets, g);
  return (int)cudaGetLastError();
}

bool fill(Geo& g, int R, int B, int H, int W, int C, int O, long long sx,
          int rs, int cg, int chunk, int slab, int ps) {
  if (R < 1 || B < 1 || H < 2 || W < 2 || C < 1 || O < kOct ||
      O % kOct != 0 || sx < 0 || rs < W + 2 * kPad || cg < 1 ||
      (cg != 1 && cg != 3) || C % cg != 0 || chunk < 1 || slab < 1 || ps < slab)
    return false;
  g.R = R;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.O = O;
  g.W2 = W / 2;
  g.P = (H / 2) * g.W2;
  g.sx = sx;
  g.rs = rs;
  g.plane = (H + 2 * kPad) * rs;
  g.tiles = (O + kGradTile - 1) / kGradTile;
  g.groups = C / cg;
  g.chunk = chunk;
  g.chunks = (B + chunk - 1) / chunk;
  g.slab = slab;
  g.ps = ps;
  return true;
}

}  // namespace

extern "C" {

// Forward: x (R, B, H, W, C) f32, row r at x + r * sx (each row
// contiguous); w (R, 5, 5, C, O), bias (R, O) contiguous; out (B, R, O,
// H/2, W/2) f32 and codes (the same, one byte) written. O a multiple of 8.
// smem: the dynamic shared memory bytes kernels/conv_pool.py planned.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape it does not take.
int repro_conv_pool(const float* x, const float* w, const float* bias,
                    float* out, unsigned char* codes, int R, int B, int H,
                    int W, int C, int O, long long sx, int rs, int smem,
                    cudaStream_t stream) {
  Geo g{};
  if (!fill(g, R, B, H, W, C, O, sx, rs, 1, 1, 1, 1))
    return (int)cudaErrorInvalidValue;
  g.tiles = (O + kFwdTile - 1) / kFwdTile;
  g.xs_floats = (C * g.plane + 3) / 4 * 4;
  const long long need =
      4LL * (g.xs_floats + kTaps * C * kFwdTile + kFwdTile);
  const long long blocks = (long long)R * B * g.tiles;
  if (smem < need || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int rc = allow_smem((const void*)conv_pool_kernel, smem);
  if (rc != 0) return rc;
  conv_pool_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, bias, out, codes, g);
  return (int)cudaGetLastError();
}

// Backward: gout and codes (B, R, O, H/2, W/2) contiguous, x as the
// forward's; dw (R, 5, 5, C, O) and db (R, O) written. The plan (rs, cg
// input channels a block, chunk images a chunk, slab positions a staged
// slab and its padded stride ps) is kernels/conv_pool.py's. part: at
// least R * chunks * (25 C + 1) * O floats when chunks > 1; tickets: at
// least R * tiles * (C / cg) unsigned, zero.
int repro_conv_pool_grad(const float* gout, const float* x,
                         const unsigned char* codes, float* dw, float* db,
                         float* part, long long part_cap, unsigned* tickets,
                         long long ticket_cap, int R, int B, int H, int W,
                         int C, int O, long long sx, int rs, int cg,
                         int chunk, int slab, int ps, int smem,
                         cudaStream_t stream) {
  Geo g{};
  if (!fill(g, R, B, H, W, C, O, sx, rs, cg, chunk, slab, ps) || g.P < 1)
    return (int)cudaErrorInvalidValue;
  g.xs_floats = (cg * g.plane + 3) / 4 * 4;
  const long long stage = g.xs_floats + 2LL * kGradTile * ps + g.P;
  const long long red = (long long)kWarps * (kTaps * cg + 1) * 32;
  const long long blocks = (long long)R * g.tiles * g.groups * g.chunks;
  if (smem < 4 * (stage > red ? stage : red) || blocks > 0x7fffffffLL ||
      (long long)R * g.tiles * g.groups > ticket_cap ||
      (g.chunks > 1 &&
       (long long)R * g.chunks * (kTaps * C + 1) * O > part_cap))
    return (int)cudaErrorInvalidValue;
  return cg == 3 ? launch_grad<3>(gout, x, codes, dw, db, part, tickets, g,
                                  smem, stream)
                 : launch_grad<1>(gout, x, codes, dw, db, part, tickets, g,
                                  smem, stream);
}

}  // extern "C"
