// Fused NRMS news encoder, the tiled route, for Hopper (sm_90a).
//
// Replaces, beside news_encoder.cu and news_encoder_bwd.cu, the Pallas TPU
// kernels `fused_news_encoder` / `_kernel` and `_news_encoder_bwd` /
// `_bwd_kernel` (ebnerd_tpu/ops/news_encoder.py) at the shapes that those
// files' two instances do not take: T past 64, a head width past 64, a
// padded attention width past 512, or a block layout past the card's
// shared memory (a wide D with a wide A in fp32). The TPU kernel holds a
// whole article in VMEM; an SM's 227 KB do not, so this route keeps the
// intermediates in device memory and works on them in tiles, any T, any
// head width, any A:
//   T1 tiled_qkv_kernel: Q|K|V = round(x * emb mask) @ Wqkv, 64 rows a
//      block, 256 packed columns a panel, written in the compute dtype. bf16
//      runs the TMA-fed wgmma QKV stage of news_encoder_common.cuh (x comes
//      masked, as for K1), fp32 its cp.async/FMA stage, drawing the stream-0
//      mask. The forward and the backward's recompute both launch it.
//   T2 tiled_attention_kernel: one block per (article, head, 64-row query
//      tile), a warp per 16 query rows. Pass 1 over 64-key tiles takes the
//      softmax's row max and sum; pass 2 recomputes the logits and takes
//      O = round(P) V with P normalised, so the probabilities are rounded
//      where the plain version rounds them (no online rescale of O). Then
//      the stream-1 mask (or the external one), keyed by (global row,
//      column) as K1 keys it, and o in fp32 (the forward's weighted sum) or
//      round(o) in the compute dtype (the backward's dW operand); the row
//      max and sum go to device memory for T4.
//   T3 tiled_pool_kernel: one block per article, over any T in 64-row tiles
//      and W_att in 256-column chunks (the wide instance's pooling device
//      functions). Forward: z, the logits, the softmax over the article's T
//      rows and the weighted sum of the fp32 o. Backward: the same
//      recompute from round(o), datt, round(dz) to device memory, the
//      per-article db and dq partials, and do = round((w g + round(dz)
//      round(W)^T) * mask).
//   T4 tiled_attention_bwd_kernel: one block per (article, head). A pass
//      over the 16-row query tiles gives P (from T2's statistics), dP, the
//      row sums of P dP, dS and dQ; a pass over the 16-row key tiles gives
//      dV = round(P)^T dO and dK = dS^T Q. dQ|dK|dV go to T1's layout.
// After T4 the backward's GEMMs and reductions (news_encoder_bwd.cu) make
// dx, dWqkv, dW, db and dq, as after the per-block kernel.
//
// The attention products run per warp on 16-row fragments: bf16 on
// mma.sync m16n8k16 with fp32 accumulators, fp32 by FMA with the same
// fragment ownership, so one code path serves both dtypes. Fragments are
// gathered element by element from device memory (through L1), zero past
// the article's T rows and the head's columns, so no tile needs padding,
// any head width takes the same code, and no block holds more than one
// 64 x 64 tile of registers; wide heads run in 64-column chunks of the
// output, recomputing the logits once per chunk.
//
// What bounds it on the card: at the history-100 user tower ([16,384, 100,
// 400], 20 heads of 20, A 200, bf16) T1 is bound by tensor-core operations
// (1.7 TFLOP a call); T2 and T4 move Q|K|V (4.2 GB) and o, dO and
// dQ|dK|dV and do 0.26 and 0.66 TFLOP of attention products; T3 is bound
// by the 0.26 TFLOP of its z product (twice in the backward, with the do
// product beside it). What is left: the fragments' scattered loads, and
// every intermediate's round trip through device memory.
//
// Interface: plain C, bound from Python with ctypes
// (ebnerd_tpu_torch/ops/news_encoder.py); each entry point launches on the
// caller's stream and returns cudaGetLastError(). n_valid and the dropout
// seed may be read from device memory (nv_dev, seed_dev), as a replayed
// CUDA graph needs.

#include <string.h>

#include <algorithm>

#include "news_encoder_common.cuh"

namespace {

using namespace ne;

constexpr int kAttThreads = 128;  // T2 and T4: 4 warps of 16 rows
constexpr int kTile = 64;         // query or key rows per tile of T2 and T4

// A matrix of rows x cols at p (row stride ld) in the compute dtype, read
// as its logical (i, j) = stored (i, j), or stored (j, i) when tr; zero
// outside it.
template <typename T>
struct View {
  const T* p;
  int ld, rows, cols;
  bool tr;
  __device__ __forceinline__ float at(int i, int j) const {
    const int r = tr ? j : i, c = tr ? i : j;
    return r < rows && c < cols ? to_f<T>(p[size_t(r) * ld + c]) : 0.f;
  }
  __device__ __forceinline__ uint32_t raw(int i, int j) const {
    const int r = tr ? j : i, c = tr ? i : j;
    return r < rows && c < cols ? uint32_t(__bfloat16_as_ushort(p[size_t(r) * ld + c])) : 0u;
  }
  __device__ __forceinline__ uint32_t two(int i, int j, int di, int dj) const {
    return raw(i, j) | raw(i + di, j + dj) << 16;
  }
};

__device__ __forceinline__ void zero_frag(float (&f)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
}

// acc [16 x 64] += A[m0 .. m0 + 16, 0 .. k_len) B[0 .. k_len, n0 .. n0 + 64)
// over the first nn column tiles of 8. Fragment layout as mma.m16n8k16's
// C: lane 4 g + c holds (g, 8 j + 2 c + {0, 1}) in acc[j][0..1] and row
// g + 8 in acc[j][2..3].
template <typename T>
__device__ __forceinline__ void mm_acc(float (&acc)[8][4], const View<T>& a, int m0,
                                       const View<T>& b, int n0, int k_len, int nn) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  if constexpr (std::is_same<T, bf16>::value) {
    for (int k0 = 0; k0 < k_len; k0 += 16) {
      uint32_t fa[4];
      fa[0] = a.two(m0 + g, k0 + 2 * c, 0, 1);
      fa[1] = a.two(m0 + g + 8, k0 + 2 * c, 0, 1);
      fa[2] = a.two(m0 + g, k0 + 2 * c + 8, 0, 1);
      fa[3] = a.two(m0 + g + 8, k0 + 2 * c + 8, 0, 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nn) {
          uint32_t fb[2];
          fb[0] = b.two(k0 + 2 * c, n0 + 8 * j + g, 1, 0);
          fb[1] = b.two(k0 + 2 * c + 8, n0 + 8 * j + g, 1, 0);
          mma_16816(acc[j], fa, fb);
        }
      }
    }
  } else {
    for (int k = 0; k < k_len; ++k) {
      const float a0 = a.at(m0 + g, k), a1 = a.at(m0 + g + 8, k);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nn) {
          const float b0 = b.at(k, n0 + 8 * j + 2 * c), b1 = b.at(k, n0 + 8 * j + 2 * c + 1);
          acc[j][0] += a0 * b0;
          acc[j][1] += a0 * b1;
          acc[j][2] += a1 * b0;
          acc[j][3] += a1 * b1;
        }
      }
    }
  }
}

// acc [16 x 64] += F B[k0 .. k0 + 16 nks, n0 .. n0 + 64), F [16 x 64] held
// as C fragments (rounded to the compute dtype on the way: bf16 packs them,
// fp32 is exact), over nks k-steps of 16 and nn column tiles of 8.
template <typename T>
__device__ __forceinline__ void mm_frag(float (&acc)[8][4], const float (&f)[8][4],
                                        const View<T>& b, int k0, int nks, int n0, int nn) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= nks) break;
      uint32_t fa[4];
      c_to_a(f, kk, fa);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nn) {
          uint32_t fb[2];
          fb[0] = b.two(k0 + 16 * kk + 2 * c, n0 + 8 * j + g, 1, 0);
          fb[1] = b.two(k0 + 16 * kk + 2 * c + 8, n0 + 8 * j + g, 1, 0);
          mma_16816(acc[j], fa, fb);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= nks) break;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        // column kc of F sits in lane 4 g + (kc % 8) / 2, tile kc / 8, slot kc % 2
        const int kc = 16 * kk + q, src = 4 * g + (kc % 8) / 2;
        const float a0 = __shfl_sync(0xffffffffu, f[kc / 8][kc % 2], src);
        const float a1 = __shfl_sync(0xffffffffu, f[kc / 8][2 + kc % 2], src);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nn) {
            const float b0 = b.at(k0 + kc, n0 + 8 * j + 2 * c);
            const float b1 = b.at(k0 + kc, n0 + 8 * j + 2 * c + 1);
            acc[j][0] += a0 * b0;
            acc[j][1] += a0 * b1;
            acc[j][2] += a1 * b0;
            acc[j][3] += a1 * b1;
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Live column tiles of 8 (at most 8) and k-steps of 16 (at most 4) of a
// 64-wide tile with `left` columns or rows left.
__device__ __forceinline__ int tiles8(int left) { return max(0, min(8, (left + 7) / 8)); }
__device__ __forceinline__ int steps16(int left) { return max(0, min(4, (left + 15) / 16)); }

// The logits of 16 query rows against keys [k0, k0 + 64) as base-2
// exponents: s * scale * log2 e, -inf past the article's t keys.
__device__ __forceinline__ void log2_logits(float (&s)[8][4], int k0, int t, float sl) {
  const int c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = k0 + 8 * j + 2 * c + e < t;
      s[j][e] = in ? s[j][e] * sl : -INFINITY;
      s[j][2 + e] = in ? s[j][2 + e] * sl : -INFINITY;
    }
}

// The stream-1 (attention output) mask of global row `row`, column `col`,
// or the external mask times 1/keep, or 1.
__device__ __forceinline__ float att_mask(const philox::Dropout& dr, const float* ext,
                                          float inv_ext, size_t row, int col, int d) {
  if (dr.thr_att) return philox::mask1(dr.key, uint32_t(row), uint32_t(col), 1u, dr.thr_att, dr.inv_att);
  if (ext != nullptr) return ext[row * d + col] * inv_ext;
  return 1.f;
}

// ---- T1: the QKV projection ----

struct QkvArgs {
  const void* x;     // fp32: [rows, din]; bf16: read through the tensor map
  const void* wqkv;  // [din, P]
  void* qkv;         // [>= rows, P]
  int rows, n, t, din, P, stages, cluster;
  size_t bars;       // bf16: offset of the ring's barriers
  philox::Key key;
  uint32_t thr_emb;
  float inv_emb;
  const int* nv_dev;
  const unsigned long long* seed_dev;
};

template <typename T, int kCta>
__global__ void __launch_bounds__(kCta, 1)
    tiled_qkv_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, QkvArgs p) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = kBf ? align_smem(smem_raw) : smem_raw;
  const Layout L = make_layout(kRows, 16, sizeof(T), p.stages, false);
  const int tid = threadIdx.x;
  const int valid = p.nv_dev != nullptr ? valid_at(0, p.nv_dev, p.n) * p.t : p.rows;
  const int row0 = blockIdx.x * kRows;
  const int rows = max(0, min(kRows, min(valid, p.rows) - row0));
  const int n_pan = p.P / kPanel;
  T* out = static_cast<T*>(p.qkv) + size_t(row0) * p.P;
  auto keep_panel = [&](int g) {
    const T* panel = reinterpret_cast<const T*>(smem);
    for (int i = tid; i < rows * (kPanel / VE); i += kThreads) {
      const int r = i / (kPanel / VE), c = (i % (kPanel / VE)) * VE;
      *reinterpret_cast<uint4*>(out + size_t(r) * p.P + g * kPanel + c) =
          *reinterpret_cast<const uint4*>(panel + r * L.ldw + c);
    }
  };
  if constexpr (kBf) {
    const int nk = (p.din + kQkvBK - 1) / kQkvBK;
    // the cluster's CTAs run the QKV stage together when its first block is valid
    const bool run = int(blockIdx.x) / p.cluster * p.cluster * kRows < valid;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bars);
    const QkvRing q{smem, bars, bars + kQkvMaxStages, p.stages, p.cluster};
    if (tid == 0) qkv_ring_init(q);
    hop::cluster_sync();
    if (tid >= kThreads) {  // the producer warpgroup
      hop::regs_dec<40>();
      if (tid == kThreads && run) qkv_produce(q, &xmap, &wmap, row0, n_pan, nk);
      return;
    }
    hop::regs_inc<232>();
    if (!run) return;
    int it = 0;
    for (int g = 0; g < n_pan; ++g) {
      qkv_panel_wgmma(q, it, nk, reinterpret_cast<bf16*>(smem), L.ldw);
      csync();
      keep_panel(g);
      qkv_panel_done(q, it);  // the ring is free to refill
    }
  } else {
    if (rows == 0) return;
    const float* xb = static_cast<const float*>(p.x) + size_t(row0) * p.din;
    const EmbDrop ed{philox::key_at(p.key, p.seed_dev), p.thr_emb, p.inv_emb, row0};
    for (int g = 0; g < n_pan; ++g) {
      qkv_panel_fp32(xb, rows, p.din, static_cast<const float*>(p.wqkv) + g * kPanel, p.P, L, smem,
                     ed);
      csync();
      keep_panel(g);
      csync();  // the panel is copied out before the next one's stages overwrite it
    }
  }
}

// ---- T2: the attention forward ----

struct AttArgs {
  const void* qkv;  // [n * t, P]
  void* o;          // [n * t, ldo], fp32 or the compute dtype
  float* stats;     // null, or [2][n * t][heads]: the rows' max and sum
  const float* ext;
  float inv_ext;
  int n, t, d, heads, gh, pw, P, ldo, n_valid;
  float scale;
  philox::Dropout dr;
  const int* nv_dev;
  const unsigned long long* seed_dev;
};

template <typename T, typename O>
__global__ void __launch_bounds__(kAttThreads) tiled_attention_kernel(AttArgs p) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const int t = p.t, hd = p.d / p.heads, nq = (t + kTile - 1) / kTile;
  const int qt = blockIdx.x % nq, h = blockIdx.x / nq % p.heads, an = blockIdx.x / (nq * p.heads);
  const int m0 = qt * kTile + 16 * warp;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n) || m0 >= t) return;
  const size_t row0 = size_t(an) * t;
  const T* base = static_cast<const T*>(p.qkv) + row0 * p.P + (h / p.gh) * p.pw + (h % p.gh) * hd;
  const int kq = p.gh * hd;  // Q to K, K to V
  const View<T> q{base, p.P, t, hd, false}, kt{base + kq, p.P, t, hd, true},
      v{base + 2 * kq, p.P, t, hd, false};
  const float sl = p.scale * kLog2e;
  // pass 1: each row's max and sum of exp2 over the key tiles
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < t; k0 += kTile) {
    float s[8][4];
    zero_frag(s);
    mm_acc<T>(s, q, m0, kt, k0, hd, tiles8(t - k0));
    log2_logits(s, k0, t, sl);
    float r[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        r[0] = fmaxf(r[0], s[j][e]);
        r[1] = fmaxf(r[1], s[j][2 + e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(mx[i], quad_max(r[i]));  // finite: key k0 is below t
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) a += exp2f(s[j][2 * i] - mn) + exp2f(s[j][2 * i + 1] - mn);
      l[i] = l[i] * exp2f(mx[i] - mn) + quad_sum(a);
      mx[i] = mn;
    }
  }
  const float il[2] = {1.f / l[0], 1.f / l[1]};
  // pass 2: O = round(P) V with P normalised, by 64-column chunks of the head
  philox::Dropout dr = p.dr;
  dr.key = philox::key_at(dr.key, p.seed_dev);
  O* o = static_cast<O*>(p.o);
  for (int c0 = 0; c0 < hd; c0 += 64) {
    float acc[8][4];
    zero_frag(acc);
    for (int k0 = 0; k0 < t; k0 += kTile) {
      float s[8][4];
      zero_frag(s);
      mm_acc<T>(s, q, m0, kt, k0, hd, tiles8(t - k0));
      log2_logits(s, k0, t, sl);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - mx[e / 2]) * il[e / 2];
      mm_frag<T>(acc, s, v, k0, steps16(t - k0), c0, tiles8(hd - c0));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g + 8 * (e / 2), col = c0 + 8 * j + 2 * c + e % 2;
        if (row >= t || col >= hd) continue;
        const int gcol = h * hd + col;
        const float val = acc[j][e] * att_mask(dr, p.ext, p.inv_ext, row0 + row, gcol, p.d);
        o[(row0 + row) * p.ldo + gcol] = from_f<O>(val);
      }
  }
  if (p.stats != nullptr && c == 0) {
    const size_t plane = size_t(p.n) * t * p.heads;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + g + 8 * i;
      if (row < t) {
        p.stats[(row0 + row) * p.heads + h] = mx[i];
        p.stats[plane + (row0 + row) * p.heads + h] = l[i];
      }
    }
  }
}

// ---- T3: the pooling, forward and backward ----

struct PoolArgs {
  const void* src;  // forward: o [n * t, lds] fp32; backward: round(o) in the compute dtype
  int lds;
  const void* w_att;  // [d, a_pad] compute dtype
  const float* b_att;
  const float* q_att;
  const float* g;     // backward: [n, d] fp32
  float* out;         // forward: [n, d]
  float* att;         // [n * t] scratch: the logits, then (backward) dvals and datt
  float* wts;         // [n * t] scratch: the pooling weights
  void* dz_c;         // backward: [n * t, a_pad] compute dtype
  void* do_c;         // backward: [n * t, d] compute dtype
  float* db_part;     // backward: [n, a_pad]
  float* dq_part;
  const float* ext;
  float inv_ext;
  int n, t, d, a, a_pad, n_valid;
  philox::Dropout dr;
  const int* nv_dev;
  const unsigned long long* seed_dev;
};

// Shared memory of T3: the wide instance's pooling staging or z.
__host__ __device__ inline size_t pool_smem(const Layout& L, int a_pad, int elem) {
  const int ac = a_pad < kAttChunk ? a_pad : kAttChunk;
  const size_t stage = elem == 2 ? kPoolStages * L.pool_stage : size_t(kPoolRows) * ac * elem;
  return align128(smax(stage, size_t(kRows) * L.ldz * 4));
}

template <typename T, typename S, bool kBwd>
__global__ void __launch_bounds__(kThreads, 1) tiled_pool_kernel(PoolArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float inner;
  const Layout L = make_layout(p.d, p.a_pad, sizeof(T), 1, true);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int an = blockIdx.x, t = p.t, d = p.d, a = p.a, a_pad = p.a_pad;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n)) {  // zeros out, or zero partials
    for (int i = tid; i < (kBwd ? 0 : d); i += kThreads) p.out[size_t(an) * d + i] = 0.f;
    for (int j = tid; j < (kBwd ? a_pad : 0); j += kThreads) {
      p.db_part[size_t(an) * a_pad + j] = 0.f;
      p.dq_part[size_t(an) * a_pad + j] = 0.f;
    }
    return;
  }
  const size_t row0 = size_t(an) * t;
  const S* src = static_cast<const S*>(p.src) + row0 * p.lds;
  const T* w_att = static_cast<const T*>(p.w_att);
  float* att = p.att + row0;
  float* wts = p.wts + row0;
  const float* z = reinterpret_cast<const float*>(smem);
  // the logits of every row, 64 rows and 256 columns of W_att at a time; the weights
  for (int rt = 0; rt < t; rt += kRows) {
    const int r = min(kRows, t - rt);
    for (int c0 = 0; c0 < a; c0 += kAttChunk) {
      pooling_logits_chunk<T, S>(src + size_t(rt) * p.lds, p.lds, r, d, w_att, a_pad, c0, L, smem);
      csync();
      pooling_att_chunk<T>(z, L.ldz, p.b_att, p.q_att, a, c0, r, att + rt);
      csync();  // z is spent before the next chunk's product
    }
  }
  pooling_softmax(att, 1, t, wts);
  csync();
  if constexpr (!kBwd) {  // the weighted sum of the fp32 o over t
    for (int c = tid; c < d; c += kThreads) {
      float v = 0.f;
      for (int tt = 0; tt < t; ++tt) v += to_f<S>(src[size_t(tt) * p.lds + c]) * wts[tt];
      p.out[size_t(an) * d + c] = v;
    }
  } else {
    // dvals[r] = round(o[r]) . round(g), over the spent logits; datt = w (dvals - sum w dvals)
    const float* gv = p.g + size_t(an) * d;
    for (int r = warp; r < t; r += kWarps) {
      float v = 0.f;
      for (int c = lane; c < d; c += 32) v += to_f<S>(src[size_t(r) * p.lds + c]) * rnd<T>(gv[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) att[r] = v;
    }
    csync();
    if (warp == 0) {
      float v = 0.f;
      for (int r = lane; r < t; r += 32) v += wts[r] * att[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) inner = v;
    }
    csync();
    for (int r = tid; r < t; r += kThreads) att[r] = wts[r] * (att[r] - inner);
    csync();
    // per column j: dq += round(tanh) round(datt); dz = round(datt) round(q) (1 - tanh^2);
    // db += dz; round(dz) to device memory (z recomputed by chunks)
    T* dz_c = static_cast<T*>(p.dz_c) + row0 * a_pad;
    for (int c0 = 0; c0 < a_pad; c0 += kAttChunk) {
      const int ac = min(kAttChunk, a_pad - c0), j = c0 + tid;
      const float qj = j < a ? rnd<T>(p.q_att[j]) : 0.f, bj = j < a ? p.b_att[j] : 0.f;
      float dq = 0.f, db = 0.f;
      for (int rt = 0; rt < t; rt += kRows) {
        const int r = min(kRows, t - rt);
        pooling_logits_chunk<T, S>(src + size_t(rt) * p.lds, p.lds, r, d, w_att, a_pad, c0, L,
                                   smem);
        csync();
        if (tid < ac)
          for (int rr = 0; rr < r; ++rr) {
            const float hv = j < a ? tanhf(z[rr * L.ldz + tid] + bj) : 0.f;
            const float dr = rnd<T>(att[rt + rr]);
            dq += rnd<T>(hv) * dr;
            const float dz = j < a ? dr * qj * (1.f - hv * hv) : 0.f;
            db += dz;
            dz_c[size_t(rt + rr) * a_pad + j] = from_f<T>(dz);
          }
        csync();  // z is spent before the next tile's product
      }
      if (tid < ac) {
        p.db_part[size_t(an) * a_pad + j] = db;
        p.dq_part[size_t(an) * a_pad + j] = j < a ? dq : 0.f;
      }
    }
    csync();  // round(dz) is written before the do product reads it
    // do = (w g + round(dz) round(W)^T) * mask, a warp per 16 rows x 64 columns
    philox::Dropout dr = p.dr;
    dr.key = philox::key_at(dr.key, p.seed_dev);
    T* doc = static_cast<T*>(p.do_c) + row0 * d;
    const View<T> dzv{dz_c, a_pad, t, a_pad, false}, wt{w_att, a_pad, d, a_pad, true};
    const int g = lane / 4, c = lane % 4, nrt = (t + 15) / 16, nct = (d + 63) / 64;
    for (int u = warp; u < nrt * nct; u += kWarps) {
      const int m0 = 16 * (u % nrt), n0 = 64 * (u / nrt);
      float acc[8][4];
      zero_frag(acc);
      mm_acc<T>(acc, dzv, m0, wt, n0, a_pad, tiles8(d - n0));
#pragma unroll
      for (int jt = 0; jt < 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + g + 8 * (e / 2), col = n0 + 8 * jt + 2 * c + e % 2;
          if (row >= t || col >= d) continue;
          const float m = att_mask(dr, p.ext, p.inv_ext, row0 + row, col, d);
          doc[size_t(row) * d + col] = from_f<T>((wts[row] * gv[col] + acc[jt][e]) * m);
        }
    }
  }
}

// ---- T4: the attention backward ----

struct AttBwdArgs {
  const void* qkv;     // [n * t, P]
  const void* do_c;    // [n * t, d]
  const float* stats;  // [2][n * t][heads] from T2
  float* delta;        // [n * t][heads] scratch: the rows' sums of P dP
  void* dqkv;          // [n * t, P], T1's layout
  int n, t, d, heads, gh, pw, P, n_valid;
  float scale;
  const int* nv_dev;
};

template <typename T>
__global__ void __launch_bounds__(kAttThreads) tiled_attention_bwd_kernel(AttBwdArgs p) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const int t = p.t, hd = p.d / p.heads, h = blockIdx.x % p.heads, an = blockIdx.x / p.heads;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n)) return;
  const size_t row0 = size_t(an) * t;
  const size_t off = row0 * p.P + (h / p.gh) * p.pw + (h % p.gh) * hd;
  const int kq = p.gh * hd;
  const T* base = static_cast<const T*>(p.qkv) + off;
  T* dbase = static_cast<T*>(p.dqkv) + off;
  const T* dob = static_cast<const T*>(p.do_c) + row0 * p.d + h * hd;
  const View<T> q{base, p.P, t, hd, false}, qtr{base, p.P, t, hd, true};
  const View<T> k{base + kq, p.P, t, hd, false}, ktr{base + kq, p.P, t, hd, true};
  const View<T> v{base + 2 * kq, p.P, t, hd, false}, vtr{base + 2 * kq, p.P, t, hd, true};
  const View<T> dov{dob, p.d, t, hd, false}, dotr{dob, p.d, t, hd, true};
  const float* smx = p.stats + row0 * p.heads + h;
  const float* ssum = smx + size_t(p.n) * t * p.heads;
  float* dl = p.delta + row0 * p.heads + h;
  const float sl = p.scale * kLog2e;
  const int nt16 = (t + 15) / 16;
  // P of 16 rows x 64 keys from the logits, by the rows' statistics
  auto probs = [&](float (&s)[8][4], int k0, const float (&mr)[2], const float (&il)[2]) {
    log2_logits(s, k0, t, sl);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - mr[e / 2]) * il[e / 2];
  };
  auto store = [&](const float (&f)[8][4], T* dst, int m0, int c0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g + 8 * (e / 2), col = c0 + 8 * j + 2 * c + e % 2;
        if (row < t && col < hd) dst[size_t(row) * p.P + col] = from_f<T>(f[j][e]);
      }
  };
  // 1. query tiles: delta = rowsum(P dP), then dS = round(P (dP - delta) scale) and dQ = dS K
  for (int qi = warp; qi < nt16; qi += kAttThreads / 32) {
    const int m0 = 16 * qi;
    float mr[2], il[2], ds[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + g + 8 * i;
      mr[i] = row < t ? smx[size_t(row) * p.heads] : 0.f;
      il[i] = row < t ? 1.f / ssum[size_t(row) * p.heads] : 0.f;
    }
    for (int k0 = 0; k0 < t; k0 += kTile) {
      float s[8][4], dp[8][4];
      zero_frag(s);
      zero_frag(dp);
      mm_acc<T>(s, q, m0, ktr, k0, hd, tiles8(t - k0));
      probs(s, k0, mr, il);
      mm_acc<T>(dp, dov, m0, vtr, k0, hd, tiles8(t - k0));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e / 2] += s[j][e] * dp[j][e];
    }
    ds[0] = quad_sum(ds[0]);
    ds[1] = quad_sum(ds[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (c == 0 && m0 + g + 8 * i < t) dl[size_t(m0 + g + 8 * i) * p.heads] = ds[i];
    for (int c0 = 0; c0 < hd; c0 += 64) {
      float acc[8][4];
      zero_frag(acc);
      for (int k0 = 0; k0 < t; k0 += kTile) {
        float s[8][4], dp[8][4];
        zero_frag(s);
        zero_frag(dp);
        mm_acc<T>(s, q, m0, ktr, k0, hd, tiles8(t - k0));
        probs(s, k0, mr, il);
        mm_acc<T>(dp, dov, m0, vtr, k0, hd, tiles8(t - k0));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = rnd<T>(s[j][e] * (dp[j][e] - ds[e / 2]) * p.scale);
        mm_frag<T>(acc, dp, k, k0, steps16(t - k0), c0, tiles8(hd - c0));
      }
      store(acc, dbase, m0, c0);
    }
  }
  __syncthreads();  // every row's delta is written
  // 2. key tiles: P^T and dS^T of 16 keys x 64 queries; dV = round(P)^T dO, dK = dS^T Q
  for (int ki = warp; ki < nt16; ki += kAttThreads / 32) {
    const int j0 = 16 * ki;
    for (int c0 = 0; c0 < hd; c0 += 64) {
      float av[8][4], ak[8][4];
      zero_frag(av);
      zero_frag(ak);
      for (int q0 = 0; q0 < t; q0 += kTile) {
        float st[8][4], dpt[8][4];
        zero_frag(st);
        zero_frag(dpt);
        mm_acc<T>(st, k, j0, qtr, q0, hd, tiles8(t - q0));
        mm_acc<T>(dpt, v, j0, dotr, q0, hd, tiles8(t - q0));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qq = q0 + 8 * j + 2 * c + e;
            const bool in = qq < t;
            const float mq = in ? smx[size_t(qq) * p.heads] : 0.f;
            const float iq = in ? 1.f / ssum[size_t(qq) * p.heads] : 0.f;
            const float dq = in ? dl[size_t(qq) * p.heads] : 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float pr = in ? exp2f(st[j][2 * i + e] * sl - mq) * iq : 0.f;
              st[j][2 * i + e] = pr;
              dpt[j][2 * i + e] = rnd<T>(pr * (dpt[j][2 * i + e] - dq) * p.scale);
            }
          }
        mm_frag<T>(av, st, dov, q0, steps16(t - q0), c0, tiles8(hd - c0));
        mm_frag<T>(ak, dpt, q, q0, steps16(t - q0), c0, tiles8(hd - c0));
      }
      store(av, dbase + 2 * kq, j0, c0);
      store(ak, dbase + kq, j0, c0);
    }
  }
}

// ---- launchers ----

template <typename T>
int launch_qkv(QkvArgs p, int x_rows, cudaStream_t stream) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  if (p.rows < 0 || p.din < 1 || p.P < kPanel || p.P % kPanel || p.din % (16 / int(sizeof(T))) ||
      (p.thr_emb && (kBf || p.din % 4)))
    return int(cudaErrorInvalidValue);
  const int blocks = (p.rows + kRows - 1) / kRows;
  if (blocks == 0) return 0;
  const int nk = (p.din + kQkvBK - 1) / kQkvBK;
  p.stages = kBf ? std::min(kQkvMaxStages, nk) : 1;
  // clusters of 2 CTAs share each weight k-tile, as in K1 (PERF.md)
  p.cluster = kBf && blocks >= 2 ? 2 : 1;
  const Layout L = make_layout(kRows, 16, sizeof(T), p.stages, false);
  size_t smem;
  if (kBf) {
    p.bars = align1024(smax(size_t(p.stages) * kQkvStage, L.panel));
    smem = p.bars + align128(2 * kQkvMaxStages * 8) + 1024;
  } else {
    smem = smax(kStages * L.stage, L.panel);
  }
  constexpr int kCta = kBf ? kQkvThreads : kThreads;
  auto kern = tiled_qkv_kernel<T, kCta>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  // bf16: x [x_rows, din] (rows past it arrive as zeros), wqkv [din, P]
  if (kBf && x_rows > 0 &&
      !(hop::bf16_map(&xmap, p.x, p.din, x_rows, p.din, kQkvBK, kRows) &&
        hop::bf16_map(&wmap, p.wqkv, p.P, p.din, p.P, 64, kQkvBK)))
    return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(unsigned((blocks + p.cluster - 1) / p.cluster * p.cluster));
  cfg.blockDim = dim3(kCta);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, xmap, wmap, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

bool heads_ok(int d, int heads, int gh, int pw, int P) {
  const int hd = heads > 0 ? d / heads : 0;
  return heads >= 1 && d % heads == 0 && gh >= 1 && 3 * gh * hd <= pw &&
         (long long)((heads + gh - 1) / gh) * pw <= P;
}

template <typename T, typename O>
int launch_attention(const AttArgs& p, cudaStream_t stream) {
  if (p.t < 1 || !heads_ok(p.d, p.heads, p.gh, p.pw, p.P) || p.ldo < p.d)
    return int(cudaErrorInvalidValue);
  const long long blocks = (long long)p.n * p.heads * ((p.t + kTile - 1) / kTile);
  if (blocks > (1LL << 31) - 1) return int(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  tiled_attention_kernel<T, O><<<unsigned(blocks), kAttThreads, 0, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, typename S, bool kBwd>
int launch_pool(const PoolArgs& p, cudaStream_t stream) {
  if (p.t < 1 || p.d < 1 || p.a < 1 || p.a > p.a_pad || p.a_pad % 16 || p.lds < p.d)
    return int(cudaErrorInvalidValue);
  if (p.n == 0) return 0;
  const Layout L = make_layout(p.d, p.a_pad, sizeof(T), 1, true);
  const size_t smem = pool_smem(L, p.a_pad, sizeof(T));
  auto kern = tiled_pool_kernel<T, S, kBwd>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<unsigned(p.n), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int launch_attention_bwd(const AttBwdArgs& p, cudaStream_t stream) {
  if (p.t < 1 || !heads_ok(p.d, p.heads, p.gh, p.pw, p.P)) return int(cudaErrorInvalidValue);
  const long long blocks = (long long)p.n * p.heads;
  if (blocks > (1LL << 31) - 1) return int(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  tiled_attention_bwd_kernel<T><<<unsigned(blocks), kAttThreads, 0, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// T1. x [x_rows, din] in the compute dtype (bf16: masked already, rows past
// x_rows read as zeros; fp32: all `rows` rows, the stream-0 mask drawn here
// when thr_emb), wqkv [din, P] (P a multiple of 256), qkv [rows, P]: rows
// [0, rows) of x @ wqkv, rounded to the compute dtype. With nv_dev (an
// int32 article count in device memory, n articles of t rows) only the rows
// of the first *nv_dev articles are computed.
int tiled_qkv(const void* x, int x_rows, const void* wqkv, void* qkv, int rows, int n, int t,
              int din, int P, const void* nv_dev, int is_bf16, unsigned seed_lo, unsigned seed_hi,
              const void* seed_dev, unsigned thr_emb, float inv_emb, void* stream) {
  const QkvArgs p{x,  wqkv, qkv, rows, n, t, din, P, 1, 1, 0, philox::Key{seed_lo, seed_hi},
                  thr_emb, inv_emb, static_cast<const int*>(nv_dev),
                  static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_qkv<bf16>(p, x_rows, s) : launch_qkv<float>(p, x_rows, s);
}

// T2. qkv [n * t, P] (head h: Q at (h / gh) * pw + (h % gh) * hd, K gh * hd
// further, V 2 gh hd further); o [n * t, ldo] fp32 (o_f32) or in the
// compute dtype: o after the stream-1 mask (thr_att, inv_att under the
// seed) or ext [n * t, d] times inv_ext; stats (may be null) [2][n * t]
// [heads] fp32: each row's max of the base-2 logits and its sum of exp2.
// Articles at or past n_valid (or *nv_dev) are left unwritten.
int tiled_attention(const void* qkv, void* o, int ldo, int o_f32, void* stats, int n, int t, int d,
                    int heads, int gh, int pw, int P, int n_valid, const void* nv_dev, float scale,
                    int is_bf16, unsigned seed_lo, unsigned seed_hi, const void* seed_dev,
                    unsigned thr_att, float inv_att, const void* ext, float inv_ext, void* stream) {
  const AttArgs p{qkv, o, static_cast<float*>(stats), static_cast<const float*>(ext), inv_ext, n, t,
                  d, heads, gh, pw, P, ldo, n_valid, scale,
                  philox::Dropout{{seed_lo, seed_hi}, 0u, thr_att, 1.f, inv_att},
                  static_cast<const int*>(nv_dev), static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return o_f32 ? launch_attention<bf16, float>(p, s) : launch_attention<bf16, bf16>(p, s);
  return launch_attention<float, float>(p, s);
}

// T3. Forward (is_bwd 0): src = o [n * t, lds] fp32 -> out [n, d] fp32
// (zeros at or past n_valid). Backward: src = round(o) [n * t, lds] in the
// compute dtype, g [n, d] fp32 -> dz_c [n * t, a_pad], do_c [n * t, d] in
// the compute dtype, db_part and dq_part [n, a_pad] fp32 (zeros at or past
// n_valid). att and wts: [n * t] fp32 scratch. w_att [d, a_pad] in the
// compute dtype, b_att and q_att [a] fp32.
int tiled_pool(const void* src, int lds, const void* w_att, const void* b_att, const void* q_att,
               const void* g, void* out, void* att, void* wts, void* dz_c, void* do_c,
               void* db_part, void* dq_part, int n, int t, int d, int a, int a_pad, int n_valid,
               const void* nv_dev, int is_bf16, int is_bwd, unsigned seed_lo, unsigned seed_hi,
               const void* seed_dev, unsigned thr_att, float inv_att, const void* ext,
               float inv_ext, void* stream) {
  const PoolArgs p{src, lds, w_att, static_cast<const float*>(b_att),
                   static_cast<const float*>(q_att), static_cast<const float*>(g),
                   static_cast<float*>(out), static_cast<float*>(att), static_cast<float*>(wts),
                   dz_c, do_c, static_cast<float*>(db_part), static_cast<float*>(dq_part),
                   static_cast<const float*>(ext), inv_ext, n, t, d, a, a_pad, n_valid,
                   philox::Dropout{{seed_lo, seed_hi}, 0u, thr_att, 1.f, inv_att},
                   static_cast<const int*>(nv_dev), static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return is_bwd ? launch_pool<bf16, bf16, true>(p, s) : launch_pool<bf16, float, false>(p, s);
  return is_bwd ? launch_pool<float, float, true>(p, s) : launch_pool<float, float, false>(p, s);
}

// T4. qkv [n * t, P] as T2's, do_c [n * t, d], stats from T2, delta
// [n * t, heads] fp32 scratch -> dqkv [n * t, P] (dQ|dK|dV where T1 puts
// Q|K|V; other columns and rows untouched).
int tiled_attention_bwd(const void* qkv, const void* do_c, const void* stats, void* delta,
                        void* dqkv, int n, int t, int d, int heads, int gh, int pw, int P,
                        int n_valid, const void* nv_dev, float scale, int is_bf16, void* stream) {
  const AttBwdArgs p{qkv,   do_c, static_cast<const float*>(stats), static_cast<float*>(delta),
                     dqkv,  n,    t,  d, heads, gh, pw, P, n_valid, scale,
                     static_cast<const int*>(nv_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_attention_bwd<bf16>(p, s) : launch_attention_bwd<float>(p, s);
}

const char* tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
