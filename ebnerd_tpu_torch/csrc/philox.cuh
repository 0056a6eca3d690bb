// Philox4x32-10 counter-based generator and the fused news encoder's
// dropout masks, shared by the forward (news_encoder.cu), the backward
// (news_encoder_bwd.cu) and the mask dump (philox.cu).
//
// Replaces the TPU kernel's on-chip PRNG masks `_prng_mask`
// (ebnerd_tpu/ops/news_encoder.py). Element (row, col) of stream s takes
// word col % 4 of Philox((row, col / 4, s, 0), (seed_lo, seed_hi)), where
// row is the global row article * T + t; it is kept iff
// (bits >> 8) < thr, thr = floor(keep * 2^24), and then scaled by 1/keep.
// Each element has its own counter, so masks do not depend on how rows
// are split into blocks. The plain version is ebnerd_tpu_torch/ops/philox.py.
//
// The standalone dropout kernel (dropout.cu) draws from the same generator
// with counters (index low word, index high word, stream, DROPOUT_TAG); the
// encoder's counters carry 0 in that word, so the two never share one.
#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t DROPOUT_TAG = 0x4B330001u;

struct Key {
  uint32_t lo, hi;
};

// The key of a 64-bit seed: its low word, its high word.
__host__ __device__ __forceinline__ Key key_of(unsigned long long s) {
  return Key{uint32_t(s), uint32_t(s >> 32)};
}

// A launch's key: read from device memory when `dev` is given (the seed is
// a device tensor, so a captured CUDA graph draws each replay's own seed),
// else the key the launch passed by value.
__device__ __forceinline__ Key key_at(Key k, const unsigned long long* dev) {
  return dev != nullptr ? key_of(*dev) : k;
}

// Dropout parameters of one launch: stream 0 (embedding, on x) and
// stream 1 (attention output, on o). A stream with thr == 0 is off.
struct Dropout {
  Key key;
  uint32_t thr_emb, thr_att;
  float inv_emb, inv_att;  // 1 / keep of each stream
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, Key k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
  uint32_t k0 = k.lo, k1 = k.hi;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t lo0 = M0 * c.x, hi0 = __umulhi(M0, c.x);
    const uint32_t lo1 = M1 * c.z, hi1 = __umulhi(M1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four mask values of columns [4 * g, 4 * g + 4) of global row `row`
// (0 or inv each).
__device__ __forceinline__ float4 mask4(Key k, uint32_t row, uint32_t g, uint32_t stream,
                                        uint32_t thr, float inv) {
  const uint4 b = philox4x32_10(make_uint4(row, g, stream, 0u), k);
  return make_float4((b.x >> 8) < thr ? inv : 0.f, (b.y >> 8) < thr ? inv : 0.f,
                     (b.z >> 8) < thr ? inv : 0.f, (b.w >> 8) < thr ? inv : 0.f);
}

__device__ __forceinline__ float pick(const float4& m, int i) {
  return i == 0 ? m.x : i == 1 ? m.y : i == 2 ? m.z : m.w;
}

// One mask value (for the rare scattered element; tiles use mask4).
__device__ __forceinline__ float mask1(Key k, uint32_t row, uint32_t col, uint32_t stream,
                                       uint32_t thr, float inv) {
  return pick(mask4(k, row, col >> 2, stream, thr, inv), col & 3);
}

}  // namespace philox
