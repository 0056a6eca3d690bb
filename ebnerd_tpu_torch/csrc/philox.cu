// Dropout-mask dump for Hopper (sm_90a).
//
// Replaces the TPU probe `dump_masks` (scripts/check_rng_dropout.py), a
// Pallas kernel that writes the fused encoder's stream-0 and stream-1
// masks so the on-chip-PRNG path can be checked against the external-mask
// path. Here it writes masks [rows, width] fp32 (0 or 1/keep) through
// philox::mask4, the device function the forward and backward kernels
// apply, so a bit-for-bit comparison with the plain version
// (ops/philox.py) checks the kernels' masks.
//
// What bounds it on the card: writing rows * width * 4 bytes, and ten
// Philox rounds (about 40 integer instructions) per four values. One
// thread computes one group of four columns and writes it as one 16-byte
// store when the row is 16-byte aligned.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__global__ void dump_kernel(float* __restrict__ out, int rows, int width, int groups,
                            uint32_t stream, philox::Key key, uint32_t thr, float inv) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)rows * groups) return;
  const int row = int(i / groups), g = int(i % groups);
  const float4 m = philox::mask4(key, row, g, stream, thr, inv);
  float* dst = out + (long long)row * width + 4 * g;
  if (width % 4 == 0) {
    *reinterpret_cast<float4*>(dst) = m;
  } else {
    for (int j = 0; j < 4 && 4 * g + j < width; ++j) dst[j] = philox::pick(m, j);
  }
}

}  // namespace

extern "C" {

// out [rows, width] fp32, 16-byte aligned. Returns a cudaError_t code.
int philox_dump_masks(void* out, int rows, int width, int stream, unsigned seed_lo,
                      unsigned seed_hi, unsigned thr, float keep, void* cuda_stream) {
  if (rows < 0 || width < 1 || stream < 0) return int(cudaErrorInvalidValue);
  const int groups = (width + 3) / 4;
  const long long n = (long long)rows * groups;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  dump_kernel<<<unsigned(blocks), threads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<float*>(out), rows, width, groups, unsigned(stream),
      philox::Key{seed_lo, seed_hi}, thr, 1.0f / keep);
  return int(cudaGetLastError());
}

const char* philox_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
