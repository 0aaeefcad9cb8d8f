// Shared by the kernels that stream f32 / bf16 arrays (combine.cu,
// fused_sgd.cu): widening to f32 and narrowing back (round to nearest
// even), and V contiguous elements moved as one 16-byte vector (4 f32 or
// 8 bf16; V = 1 is the scalar case). Header-only; build.py hashes it into
// every library, so an edit here rebuilds them all.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_vec {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// V contiguous columns of one row: load the raw vector, widen it to f32,
// narrow f32 back and store, store raw bits.
template <typename T, int V>
struct Cols;

template <>
struct Cols<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void get(Raw r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ void put(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ void put_raw(float* p, Raw r) {
    *reinterpret_cast<float4*>(p) = r;
  }
};

// eight bf16 as four 32-bit words, the lower address in the low half; a
// bf16 is the high half of its f32, so widening is a shift (exact)
template <>
struct Cols<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void get(Raw r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p,
                                             const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void put_raw(__nv_bfloat16* p, Raw r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <typename T>
struct Cols<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void get(Raw r, float* f) {
    f[0] = to_f32(r);
  }
  static __device__ __forceinline__ void put(T* p, const float* f) {
    from_f32(p, f[0]);
  }
  static __device__ __forceinline__ void put_raw(T* p, Raw r) { *p = r; }
};

// V f32 values at p (16-byte aligned when V > 1)
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* f) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = r.x;
      f[4 * i + 1] = r.y;
      f[4 * i + 2] = r.z;
      f[4 * i + 3] = r.w;
    }
  }
}

}  // namespace repro_vec
