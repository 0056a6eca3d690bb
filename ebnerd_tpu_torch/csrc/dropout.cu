// Seed-recompute inverted dropout for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_apply_kernel` of
// ebnerd_tpu/ops/dropout.py: y = x * mask / keep over a tensor of any
// shape, the mask drawn from a counter-based generator keyed by the step's
// seed, so the backward (the same kernel on dy) regenerates it and nothing
// is stored between the two.
//
// Element n of the flattened tensor has the global index g = offset + n and
// takes word g % 4 of Philox4x32-10((g/4 low 32 bits, g/4 high 32 bits,
// stream, DROPOUT_TAG), (seed_lo, seed_hi)) (philox.cuh). It is kept iff
// (bits >> 8) < thr, thr = floor(keep * 2^24), the TPU kernel's 24-bit
// threshold. Every element has its own counter, so any split of a tensor
// into launches (an element offset per chunk) regenerates the same mask.
// The value is multiplied in fp32 by 1/keep or 0 and rounded once to the
// input dtype, as the TPU kernel does. The plain version is
// ebnerd_tpu_torch/ops/dropout.py.
//
// What bounds it on the card: reading x and writing y once (2 * 2 bytes
// per bf16 element, 3.35 TB/s), and ten Philox rounds (about 40 integer
// instructions, multiplies among them) per four elements, which is close to
// the memory time at bf16. Each thread takes 8 contiguous elements at a
// time, one 16-byte load and store in bf16 (two in fp32) and two Philox
// calls, in a grid-stride loop; the tail and unaligned calls go element by
// element.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

struct Params {
  long long n;                 // elements
  unsigned long long offset;   // global index of element 0
  philox::Key key;
  uint32_t stream, thr;
  float inv;                   // 1 / keep in fp32
};

__device__ __forceinline__ uint4 words(const Params& p, unsigned long long c) {
  return philox::philox4x32_10(
      make_uint4(uint32_t(c), uint32_t(c >> 32), p.stream, philox::DROPOUT_TAG), p.key);
}

__device__ __forceinline__ uint32_t word(const uint4& b, int i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

__device__ __forceinline__ float scale(const Params& p, uint32_t bits) {
  return (bits >> 8) < p.thr ? p.inv : 0.f;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load8(const float* src, float v[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float v[8]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
}

// One element, its own Philox call (tail and unaligned launches).
template <typename T>
__device__ __forceinline__ void one(const T* __restrict__ x, T* __restrict__ y, const Params& p,
                                    long long e) {
  const unsigned long long g = p.offset + (unsigned long long)e;
  const float m = scale(p, word(words(p, g >> 2), int(g & 3)));
  y[e] = from_f<T>(to_f(x[e]) * m);
}

// vec: offset % 4 == 0 and x, y 16-byte aligned, so each group of 8
// elements covers exactly two counters and loads as whole vectors.
template <typename T>
__global__ void __launch_bounds__(256) dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                      Params p, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = p.n >> 3;
    const unsigned long long c0 = p.offset >> 2;
    for (long long i = tid; i < groups; i += stride) {
      const uint4 a = words(p, c0 + 2ull * i), b = words(p, c0 + 2ull * i + 1);
      const uint32_t bits[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float v[8];
      load8(x + 8 * i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] * scale(p, bits[j]);
      store8(y + 8 * i, v);
    }
    done = groups << 3;
  }
  for (long long e = done + tid; e < p.n; e += stride) one(x, y, p, e);
}

}  // namespace

extern "C" {

// x, y: n elements of fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1), y written
// in full; offset: global index of x[0]. Returns a cudaError_t code.
int dropout_apply(const void* x, void* y, long long n, unsigned long long offset,
                  unsigned seed_lo, unsigned seed_hi, unsigned stream, unsigned thr, float inv,
                  int is_bf16, void* cuda_stream) {
  if (n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Params p{n, offset, philox::Key{seed_lo, seed_hi}, stream, thr, inv};
  const int vec = offset % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int threads = 256;
  const long long work = vec ? (n + 7) / 8 : n;
  const long long blocks = (work + threads - 1) / threads;
  const unsigned grid = unsigned(blocks < 8192 ? blocks : 8192);
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (is_bf16) {
    dropout_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), p, vec);
  } else {
    dropout_kernel<float><<<grid, threads, 0, s>>>(static_cast<const float*>(x),
                                                   static_cast<float*>(y), p, vec);
  }
  return int(cudaGetLastError());
}

const char* dropout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
