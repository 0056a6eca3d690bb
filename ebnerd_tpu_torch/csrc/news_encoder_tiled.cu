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
//   T1 tiled_qkv_tma_kernel / tiled_qkv_kernel: Q|K|V = round(x * emb mask)
//      @ Wqkv, written in the compute dtype; the forward and the backward's
//      recompute both launch it. bf16 ("tma", below; x comes masked, as for
//      K1): persistent 128-row blocks, x's row block held in shared memory
//      for all of P, the weight's k-tiles through a TMA ring, m64n128k16
//      wgmma, each 128-column output tile stored by TMA from a buffer of
//      its own. fp32 ("tf32x3", below; tiled_qkv_tf32x3_kernel): the
//      3xTF32 GEMM core of news_encoder_common.cuh, x masked by stream 0
//      in shared memory, persistent 128 x 256 output tiles. The first kernel
//      ("panel", fp32 or bf16 when asked, for timing): 64 rows a block,
//      256 packed columns a panel on the QKV stage of
//      news_encoder_common.cuh (fp32: cp.async/FMA, drawing the mask).
//   T2 tiled_attention_staged_kernel / tiled_attention_streamed_kernel /
//      tiled_attention_kernel: the
//      attention forward, O = round(P) V with P normalised, so the
//      probabilities are rounded where the plain version rounds them (no
//      online rescale of O). Then the stream-1 mask (or the external one),
//      keyed by (global row, column) as K1 keys it, and o in fp32 (the
//      forward's weighted sum) or round(o) in the compute dtype (the
//      backward's dW operand); the rows' max and sum go to device memory,
//      [2][n * t][heads], for T4.
//   T3 tiled_pool_resident_kernel / tiled_pool_streamed_kernel /
//      tiled_pool_kernel, and in fp32 the "tf32x3" kernels (below: the two
//      products across articles on the 3xTF32 GEMM core, a per-article pass
//      between them): forward, z = round(o) round(W_att), the logits,
//      the softmax over the article's T rows and the weighted sum of the
//      fp32 o; backward, the same from round(o), datt, round(dz) to device
//      memory, the per-article db and dq partials, and do = round((w g +
//      round(dz) round(W)^T) * mask). Where T rounded up to 16 is at most
//      128, a_pad at most 256 and W_att fits ("resident", below): a
//      persistent block an SM holds W_att in shared memory and takes z once
//      on mma.sync from shared memory. Past that, for a_pad at most 256
//      where its layout fits ("streamed", below): the same block walks each
//      article in rounds of 128 rows. Elsewhere ("chunked", the route's
//      first T3 kernel): a block an article, 64-row tiles, W_att streamed in
//      256-column chunks (the wide instance's pooling device functions).
//   T4 tiled_attention_bwd_staged_kernel / tiled_attention_bwd_streamed_kernel
//      / tiled_attention_bwd_kernel: the attention backward per (article,
//      head): P from T2's statistics,
//      delta = rowsum(P dP) over the unrounded P, dS = round(P (dP - delta)
//      scale), dQ = dS K, dV = round(P)^T dO, dK = dS^T Q, to T1's layout.
// After T4 the backward's GEMMs and reductions (news_encoder_bwd.cu) make
// dx, dWqkv, dW, db and dq, as after the per-block kernel.
//
// T1, T2, T3 and T4 have three kernels each; the wrappers pick one
// before the launch (ops/news_encoder.py `qkv_variant`, `attention_variant`,
// `pool_variant`) and pass the choice, which the launchers refuse where the
// kernel does not take the shape. T2 and T4 (`variant`: 1 staged, 2
// streamed, 0 gathering):
//   - staged, where T rounded up to 16 (T16) is at most 128 and an
//     (article, head) pair's tiles fit a block (at T 128, head widths up to
//     288 for T2 and 144 for T4 in bf16, 144 and 32 in fp32; in bf16 an
//     even width, for cp.async's 4-byte pieces): a block per pair, a warp
//     per 16-row tile, so the warps split the tiles evenly. Q, K and V (T4:
//     and dO and the rows' statistics) are copied once by cp.async into
//     tiles of T16 rows in shared memory, rows padded to an odd number of
//     16-byte pieces, and read by ldmatrix. T2 holds each row's logits in
//     registers (8 to 64 fp32 a thread) and computes them once. T4's query
//     pass takes S and dP once, delta by quad sums, dS and dQ, and leaves
//     round(P) and dS in shared memory; its key pass reads them by
//     ldmatrix.trans for dV and dK and recomputes no logit.
//   - streamed, past the staged kernels (any T; head widths while a
//     round's rows and two slots of 16-row tiles fit: T2 896 in bf16, 448
//     in fp32; T4 576 and 288 at T 200): a block per pair, four warps,
//     each a 16-row tile of a round (T2: two tiles at once where the head
//     is at most 64 wide, each B fragment feeding both), the rounds
//     covering T16. The staged design without the row of logits in
//     registers, which are taken 32 keys at a time: the operands in
//     shared memory by cp.async (plain loads where an odd bf16 width leaves
//     a row 2-byte aligned), read by ldmatrix; where the pair's matrices
//     fit a block ("resident": T2 Q, K and V; T4 also dO) they are loaded
//     once, else each round's rows are loaded and the swept pair streams in
//     tiles of 64, 32 or 16 rows through two slots shared by the warps (the
//     next tile loads while the current one is used). T2 keeps two passes
//     (P must be normalised before it is rounded): the rows' max and sum
//     over the key tiles, then, per 64- (two tiles: 32-) column chunk of
//     the head, the logits again from shared memory and round(P) V. T4
//     keeps each row's max + log2(sum) and delta in shared memory; its
//     query pass takes S and dP for delta, then per 32-column chunk S, dP,
//     dS and dQ; its key pass, per chunk, the logits and dP transposed, dV
//     and dK.
//   - gathering, everywhere else (any T and head width): fragments
//     gathered element by element from device memory (through L1), zero
//     past the article's T rows and the head's columns, so no tile needs
//     padding, and no block holds more than one 64 x 64 tile of registers.
//     T2: a block per (article, head, 64-row query tile); pass 1 over
//     64-key tiles takes the rows' max and sum, pass 2 the logits again
//     and normalised round(P) V, by 64-column chunks of the head. T4: a
//     block per (article, head); a pass over the 16-row query tiles gives
//     dP, delta (to device memory), dS and dQ, a pass over the key tiles
//     dV and dK, the logits taken three times.
// All three run bf16 on mma.sync m16n8k16 with fp32 accumulators. In fp32
// the staged and streamed kernels take every product (Q K^T, P V, dO V^T,
// dS K, P^T dO, dS^T Q) in 3xTF32 on mma.sync m16n8k8 (the split of
// news_encoder_common.cuh: each operand a TF32 high part and remainder, lo
// hi + hi lo + hi hi, within 1e-4 of scale), in k-steps of 8 over the
// head's width rounded up to 8 (20: 3 k-steps, not 32 padded columns) and
// over the keys below t, P and dS as A operands straight from their C
// fragments (paired k-steps, no shuffle), every fragment read from shared
// memory free of bank conflicts (att_mm); the gathering kernels, on no
// configured shape, keep FMA with the bf16 fragments' ownership. No
// atomics: every output element is written by one warp of one block and
// every sum runs in a fixed order, so two launches are bit-equal. (delta
// needs a whole row of P dP before its dS exists: the staged query pass
// has the row in registers, the streamed and gathering ones sweep it
// twice.)
//
// What bounds them on the card: at the history-100 user tower ([16,384,
// 100, 400], 20 heads of 20, A 200, bf16) T1 is bound by tensor-core
// operations (1.6 TFLOP a call) and nearly as much by bytes (x and the
// 4.2 GB of Q|K|V); T2, T3 and T4 by bytes (Q|K|V, o, dO and dQ|dK|dV: 6.5
// and 9.4 GB for T2 and T4; o, round(o), round(dz) and do: 2.6 and 3.3 GB
// for T3), their products being small. The staged T2 and T4 read each
// byte once and take 4.2x and 5.6x their bound there (PERF.md). The rest
// is not traced; the candidates are each pair's copy latency at the few
// blocks an SM holds (T2 three, by registers; T4 two, by its 90 KB of
// shared memory at T 100) and its short mma.sync chains. The gathering
// ones take 16x and 52x: their scattered loads. At the history-200 user
// tower (bounds 3.9 and 5.6 ms) the streamed T2 and T4 take about 8x and
// 14x (PERF.md). In trial builds (not committed) neither the
// special-function unit nor latency alone bounded them: exp2 left out
// barely moved them, two row tiles a warp (more independent work) helped
// T2 a little and T4 not at all, and a block fewer an SM slowed both. What
// is left is the instruction stream itself: the logits twice (T2) and
// three times (T4), over k-steps that are partly the head's zero padding
// at 20 columns (T2 takes the last 8 by an m16n8k8 step), and the
// elementwise work on each of them. In fp32 (3xTF32, PERF.md) the staged
// T2 and T4 take 4.0x and 4.8x their bytes bounds at the history-50 user
// tower, the streamed ones 14.6x and 17.4x their operations bounds at
// history 200: latency, with one or two warps a scheduler (T4's resident
// fp32 pair leaves one block an SM), which mma3_group's order and T4's
// eight warps there shorten. For T1 "tma" and T3 "resident" and
// "streamed" see their notes below.
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

template <int N>
__device__ __forceinline__ void zero_frag(float (&f)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
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

// The logits of 16 query rows against keys [k0, k0 + 8 N) as base-2
// exponents: s * scale * log2 e, -inf past the article's t keys.
template <int N>
__device__ __forceinline__ void log2_logits(float (&s)[N][4], int k0, int t, float sl) {
  const int c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < N; ++j)
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

// T1 in fp32 on the tensor cores ("tf32x3"): Q|K|V = (x * stream-0 mask)
// Wqkv on the GEMM core of news_encoder_common.cuh (tf32x3_gemm: a TMA ring
// of fp32 k-tiles, x masked in place, split into TF32 hi and lo once per
// CTA, m64n256k8 wgmma lo hi + hi lo + hi hi; persistent 128 x 256 output
// tiles, the rows past the valid count unwritten).
__global__ void __launch_bounds__(kTfThreads, 1)
    tiled_qkv_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap, TfArgs p) {
  extern __shared__ __align__(1024) unsigned char tsm_raw[];
  tf32x3_gemm<kTfQkv>(&xmap, &wmap, p, align_smem(tsm_raw));
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

// T3 "tf32x3" (fp32, any T and a_pad where TMA takes o's and W_att's
// rows): the pooling across articles instead of a block per article. The
// chunked kernel restaged W_att through shared memory for every 64 rows
// of every article and took z and do by FMA, loading each o element from
// device memory for every product (284.5 and 450.2 ms at the history-50
// user tower [16,384, 50, 400], 150-280x its bound: PERF.md). Here both
// products are plain matrix products over all N T rows on the 3xTF32 GEMM
// core of news_encoder_common.cuh (persistent 128 x 256 tiles; a tile holds
// every attention column of 128 rows where a_pad <= 256, else several
// column tiles add partials); only the softmax needs an article whole, a
// small pass over [N T] floats:
//   forward: pool_logits_tf32x3_kernel (z = o W_att, never stored: the
//     epilogue reduces tanh(z + b) q to each row's logit), then
//     pool_article_kernel<false> (the softmax per article, max subtracted,
//     +1e-8 in the denominator, and the weighted sum of the fp32 o by
//     16-byte loads, t in order);
//   backward: pool_logits_tf32x3_kernel again, storing tanh(z + b) too
//     ([N T, a_pad] fp32 scratch), pool_article_kernel<true> (the weights,
//     dvals = o g by a warp a row, datt = w (dvals - sum w dvals), dz =
//     datt q (1 - tanh^2) to device memory with the per-article db and dq
//     partials, a thread a column), then pool_do_tf32x3_kernel (do = (w g
//     + dz W_att^T) mask on the core, its epilogue adding w g and drawing
//     the stream-1 mask, or taking the external one).
// Bound by tensor-core operations (z, and in the backward z and dz W^T:
// 3 TF32 products each) and, close behind, the bytes of o, read twice (the
// product and the per-article pass). One writer per output and every sum
// in a fixed order: two launches are bit-equal, whatever the CTA count.
constexpr int kPoolArtThreads = 128;  // pool_article_kernel: 4 warps an article

// The scratch of T3 "tf32x3" (att), fp32: the logits' partials [column
// tiles][n t] (the backward reuses the first for dvals and datt), then in
// the backward, from the next 16-byte boundary (its rows are stored by
// pairs), tanh(z + b) [n t][a_pad] (ops/news_encoder.py
// pool_tf32x3_scratch); wts: the weights [n t].
__host__ __device__ inline int pool_tf_tiles(int a_pad) { return (a_pad + kTfBN - 1) / kTfBN; }
__host__ __device__ inline size_t pool_tf_h_offset(size_t rows, int a_pad) {
  return (rows * pool_tf_tiles(a_pad) + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kTfThreads, 1)
    pool_logits_tf32x3_kernel(const __grid_constant__ CUtensorMap omap,
                              const __grid_constant__ CUtensorMap wmap, TfArgs p) {
  extern __shared__ __align__(1024) unsigned char tsm_raw[];
  tf32x3_gemm<kTfPool>(&omap, &wmap, p, align_smem(tsm_raw));
}

__global__ void __launch_bounds__(kTfThreads, 1)
    pool_do_tf32x3_kernel(const __grid_constant__ CUtensorMap dzmap,
                          const __grid_constant__ CUtensorMap wmap, TfArgs p) {
  extern __shared__ __align__(1024) unsigned char tsm_raw[];
  tf32x3_gemm<kTfPoolDo>(&dzmap, &wmap, p, align_smem(tsm_raw));
}

// A block's max (kMax) or sum of v, every thread getting it: each warp by
// fixed shuffles, then the warps in order.
template <bool kMax>
__device__ __forceinline__ float art_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kPoolArtThreads / 32; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();  // red is read before it is written again
  return v;
}

// T3 "tf32x3"'s per-article pass: a block per article (at or past the valid
// count: zeros out, or zero partials). The logits are the column tiles'
// partials added in order; weights, dvals and datt go through [n t]
// scratch in device memory (any T).
template <bool kBwd>
__global__ void __launch_bounds__(kPoolArtThreads) pool_article_kernel(PoolArgs p, int ct) {
  __shared__ float red[kPoolArtThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int an = blockIdx.x, t = p.t, d = p.d, a = p.a, a_pad = p.a_pad, d4 = p.d / 4;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n)) {
    for (int i = tid; i < (kBwd ? 0 : d); i += kPoolArtThreads) p.out[size_t(an) * d + i] = 0.f;
    for (int j = tid; j < (kBwd ? a_pad : 0); j += kPoolArtThreads) {
      p.db_part[size_t(an) * a_pad + j] = 0.f;
      p.dq_part[size_t(an) * a_pad + j] = 0.f;
    }
    return;
  }
  const size_t rows = size_t(p.n) * t, row0 = size_t(an) * t;
  const float* src = static_cast<const float*>(p.src) + row0 * p.lds;
  float* part = p.att + row0;  // slot 0; slot c at c * rows further
  float* wts = p.wts + row0;
  // the logits and their max; then exp(l - max), their sum, the weights
  float mx = -INFINITY;
  for (int r = tid; r < t; r += kPoolArtThreads) {
    float l = part[r];
    for (int c = 1; c < ct; ++c) l += part[size_t(c) * rows + r];
    wts[r] = l;
    mx = fmaxf(mx, l);
  }
  mx = art_reduce<true>(mx, red);
  float sum = 0.f;
  for (int r = tid; r < t; r += kPoolArtThreads) {
    const float e = expf(wts[r] - mx);
    wts[r] = e;
    sum += e;
  }
  sum = art_reduce<false>(sum, red) + 1e-8f;
  for (int r = tid; r < t; r += kPoolArtThreads) wts[r] /= sum;
  __syncthreads();  // every weight is written before any thread reads another's
  if constexpr (!kBwd) {  // the weighted sum of the fp32 o over t, 4 columns a thread
    for (int c = tid; c < d4; c += kPoolArtThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int tt = 0; tt < t; ++tt) {
        const float4 o = *reinterpret_cast<const float4*>(src + size_t(tt) * p.lds + 4 * c);
        const float w = wts[tt];
        v.x += o.x * w;
        v.y += o.y * w;
        v.z += o.z * w;
        v.w += o.w * w;
      }
      *reinterpret_cast<float4*>(p.out + size_t(an) * d + 4 * c) = v;
    }
  } else {
    // dvals[r] = o[r] . g, a warp a row (the lanes' 4-column pieces in order, then shuffles),
    // into slot 0 of the spent logits
    const float* gv = p.g + size_t(an) * d;
    for (int r = warp; r < t; r += kPoolArtThreads / 32) {
      float v = 0.f;
      for (int c = lane; c < d4; c += 32) {
        const float4 o = *reinterpret_cast<const float4*>(src + size_t(r) * p.lds + 4 * c);
        const float4 g = *reinterpret_cast<const float4*>(gv + 4 * c);
        v += o.x * g.x + o.y * g.y + o.z * g.z + o.w * g.w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) part[r] = v;
    }
    __syncthreads();
    float inner = 0.f;
    for (int r = tid; r < t; r += kPoolArtThreads) inner += wts[r] * part[r];
    inner = art_reduce<false>(inner, red);
    for (int r = tid; r < t; r += kPoolArtThreads) part[r] = wts[r] * (part[r] - inner);
    __syncthreads();  // datt is whole
    // per column j: dz = datt q (1 - tanh^2) to device memory, db += dz, dq += tanh datt
    const float* hz = p.att + pool_tf_h_offset(rows, a_pad) + row0 * a_pad;
    float* dz_c = static_cast<float*>(p.dz_c) + row0 * a_pad;
    for (int j = tid; j < a_pad; j += kPoolArtThreads) {
      const float qj = j < a ? p.q_att[j] : 0.f;
      float db = 0.f, dq = 0.f;
#pragma unroll 4
      for (int r = 0; r < t; ++r) {
        const float hv = hz[size_t(r) * a_pad + j], dr = part[r];
        const float dz = dr * qj * (1.f - hv * hv);
        db += dz;
        dq += hv * dr;
        dz_c[size_t(r) * a_pad + j] = dz;
      }
      p.db_part[size_t(an) * a_pad + j] = db;
      p.dq_part[size_t(an) * a_pad + j] = j < a ? dq : 0.f;
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

// ---- T2 and T4, staged: one (article, head) pair in shared memory ----
// (the top of this file; the launchers only check that a request fits)

constexpr int kStagedT = 128;  // T rounded up to 16 at most this: a row of logits in registers
constexpr int kOutCols = 32;   // head columns of an output chunk

__host__ __device__ constexpr int r16(int v) { return (v + 15) / 16 * 16; }
// A tile's row stride in elements: its width (a multiple of 16) and 16
// bytes, an odd number of 16-byte pieces, so that ldmatrix reads each
// 8 x 8 matrix without bank conflicts.
__host__ __device__ constexpr int pad_ld(int w, int elem) { return w + 16 / elem; }

// Shared memory of the staged T2 (Q, K, V) or T4 (bwd: also dO, round(P)
// and dS [T16 x T16] and the rows' max and sum).
__host__ __device__ inline size_t staged_smem(int t, int hd, int elem, bool bwd) {
  const size_t t16 = r16(t), ld = pad_ld(r16(hd), elem);
  return t16 * ld * elem * (bwd ? 4 : 3) +
         (bwd ? 2 * t16 * pad_ld(int(t16), elem) * elem + 2 * t16 * 4 : 0);
}

// Whether a staged request fits what its launch allocates: T16 within
// kStagedT, the tiles within a block's shared memory, and the head's
// columns in whole 4-byte pieces (cp.async's smallest).
inline bool staged_fits(int t, int hd, int elem, bool bwd) {
  return r16(t) <= kStagedT && hd * elem % 4 == 0 &&
         staged_smem(t, hd, elem, bwd) <= size_t(kSmemLimit);
}

// Blocks an SM holds at once that the registers are held to
// (__launch_bounds__) up to T 112: the kernels wait on each pair's loads
// and short chains of mma.sync, so blocks in flight count for more than a
// few spilled registers. fp32 (elem 4): T2 four up to T 64 (T 50: 6.29
// ms against 7.21 at three on an H100), fewer past it, where its 3xTF32
// fragments (hi and lo) spilled 0.3-1.8 KB a thread at bf16's counts (T2 at
// NK 10-16, T4 at NK 14; -Xptxas -v). T2 at NK 14 still spills 436 bytes
// at two, and took 21.0 ms at T 100 against 26.2 at one (PERF.md).
__host__ __device__ constexpr int t2_min_blocks(int nk, int elem) {
  return elem == 4 ? (nk <= 8 ? 4 : nk <= 14 ? 2 : 1) : nk <= 14 ? 3 : 2;
}
__host__ __device__ constexpr int t4_min_blocks(int nk, int elem) {
  return nk <= (elem == 4 ? 12 : 14) ? 2 : 1;
}

// cp.async of `bytes` (16, 8 or 4) with `valid` of them read and the rest
// zero-filled.
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int bytes, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid));
}

// Rows [0, rows) and columns [0, cols) of the matrix at src (row stride
// lds elements) into the shared tile dst (row stride ldd) of rows_pad x
// cols_pad, zeros elsewhere, by all the block's threads in cp.async pieces
// of the widest of 16, 8 and 4 bytes that src's alignment allows. The
// caller commits and waits.
template <typename T>
__device__ void stage(T* dst, int ldd, const T* src, size_t lds, int rows, int rows_pad, int cols,
                      int cols_pad) {
  constexpr int E = sizeof(T);
  const size_t al = reinterpret_cast<size_t>(src) | (lds * E);
  const int w = al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : 4;
  const int per = cols_pad * E / w, n = rows_pad * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per, c = (i % per) * w / E;
    const int valid = r < rows ? max(0, min(w, (cols - c) * E)) : 0;
    cp_async_n(dst + r * ldd + c, valid ? src + r * lds + c : src, w, valid);
  }
}

// Column `col` of rows [0, rows) at src (stride lds floats) into dst[0,
// rows_pad), zeros past rows: the rows' statistics at stride `heads`.
__device__ void stage_col(float* dst, const float* src, size_t lds, int rows, int rows_pad) {
  for (int r = threadIdx.x; r < rows_pad; r += blockDim.x)
    cp_async_n(dst + r, r < rows ? src + r * lds : src, 4, r < rows ? 4 : 0);
}

__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
  mma_16816(d0, a, b0);
  mma_16816(d1, a, b1);
}

// acc[j] (column tiles n0 + 8 j, j < nn, nn even) += A[m0 .. m0 + 16,
// 0 .. 16 ks) B[0 .. 16 ks, n0 + 8 j ..], both in shared memory: A
// row-major (a[m][k]) or, with ATR, stored transposed (a[k][m]); B stored
// by columns (b[n][k], as K for Q K^T) or, with BKN, row-major (b[k][n]).
template <typename T, int NN, bool ATR, bool BKN>
__device__ __forceinline__ void smm(float (&acc)[NN][4], const T* a, int lda, int m0, const T* b,
                                    int ldb, int n0, int ks, int nn) {
  if constexpr (std::is_same<T, bf16>::value) {
    for (int kk = 0; kk < ks; ++kk) {
      uint32_t fa[4];
      if constexpr (ATR)
        lda_tr(fa, a, lda, m0, 16 * kk);
      else
        lda_rm(fa, a, lda, m0, 16 * kk);
#pragma unroll
      for (int j = 0; j < NN; j += 2) {
        if (j < nn) {
          uint32_t fb[4];
          if constexpr (BKN)
            ldb_kn(fb, b, ldb, 16 * kk, n0 + 8 * j);
          else
            ldb_nk(fb, b, ldb, 16 * kk, n0 + 8 * j);
          mma_pair(acc[j], acc[j + 1], fa, fb);
        }
      }
    }
  } else {
    const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
    for (int k = 0; k < 16 * ks; ++k) {
      const float a0 = ATR ? a[k * lda + m0 + g] : a[(m0 + g) * lda + k];
      const float a1 = ATR ? a[k * lda + m0 + g + 8] : a[(m0 + g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        if (j < nn) {
          const int n = n0 + 8 * j + 2 * c;
          const float b0 = BKN ? b[k * ldb + n] : b[n * ldb + k];
          const float b1 = BKN ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
          acc[j][0] += a0 * b0;
          acc[j][1] += a0 * b1;
          acc[j][2] += a1 * b0;
          acc[j][3] += a1 * b1;
        }
      }
    }
  }
}

// The fp32 products below take their B fragments by groups of kTcG column
// tiles: mma3_group then issues one of the three TF32 products of a k-step
// for every (row tile, column tile) of the group before the next, so that
// consecutive mma.sync write different accumulators: one accumulator's three
// products in a row each wait on the one before (mma_3xtf32), and with a
// warp or two on a scheduler (T4 streamed in fp32 holds one block an SM at
// T 200) nothing hides that wait.
constexpr int kTcG = 4;

// acc[r][j0 + u] += a[r] b[u] in 3xTF32 (lo hi, hi lo, hi hi, as
// mma_3xtf32) for r < R and u < G where j0 + u is below NN and n.
template <int R, int NN, int G>
__device__ __forceinline__ void mma3_group(float (&acc)[R][NN][4], const FragA (&a)[R],
                                           const FragB (&b)[G], int j0, int n) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j0 + u < NN && j0 + u < n)
          mma_1688(acc[r][j0 + u], p == 0 ? a[r].lo : a[r].hi, p == 1 ? b[u].lo : b[u].hi);
}

// Two products of one shape at once (T4: S and dP, dV and dK): acc0 += a0
// b0 and acc1 += a1 b1 over the group, as mma3_group.
template <int NN, int G>
__device__ __forceinline__ void mma3_group2(float (&acc0)[NN][4], const FragA& a0,
                                            const FragB (&b0)[G], float (&acc1)[NN][4],
                                            const FragA& a1, const FragB (&b1)[G], int j0, int n) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (j0 + u < NN && j0 + u < n) {
        mma_1688(acc0[j0 + u], p == 0 ? a0.lo : a0.hi, p == 1 ? b0[u].lo : b0[u].hi);
        mma_1688(acc1[j0 + u], p == 0 ? a1.lo : a1.hi, p == 1 ? b1[u].lo : b1[u].hi);
      }
}

// att_mm's fp32 fragments of the k-step whose slots are k, split: A's 16
// rows from m0, B's column tile of 8 from n0.
template <bool TR>
__device__ __forceinline__ void att_a(FragA& fa, const float* a, int lda, int m0, int2 k) {
  const int g = threadIdx.x % 32 / 4;
  const float v[4] = {TR ? a[k.x * lda + m0 + g] : a[(m0 + g) * lda + k.x],
                      TR ? a[k.x * lda + m0 + g + 8] : a[(m0 + g + 8) * lda + k.x],
                      TR ? a[k.y * lda + m0 + g] : a[(m0 + g) * lda + k.y],
                      TR ? a[k.y * lda + m0 + g + 8] : a[(m0 + g + 8) * lda + k.y]};
  split_tf32(v, fa);
}
template <bool TR>
__device__ __forceinline__ void att_b(FragB& fb, const float* b, int ldb, int n0, int2 k) {
  const int n = n0 + threadIdx.x % 32 / 4;
  const float v[2] = {TR ? b[k.x * ldb + n] : b[n * ldb + k.x],
                      TR ? b[k.y * ldb + n] : b[n * ldb + k.y]};
  split_tf32(v, fb);
}

// acc[j] (column tiles n0 + 8 j, j < nn) += A [16 x kd] B [kd x ..] for T2
// and T4, both in shared memory, as smm takes them: A row-major and B by
// columns (Q K^T, dO V^T), or with TR A stored transposed and B row-major
// (P^T dO, dS^T Q). bf16: smm's k-steps of 16 (kd a multiple of 16, nn
// even). fp32: 3xTF32 on mma.sync m16n8k8 in k-steps of 8 (kd a multiple of
// 8: the head's width rounded up to 8, or the keys below t), A's fragment
// split once a k-step for the nn tiles, the B fragments by groups of kTcG
// (mma3_group). The k order keeps the fragment reads free of bank conflicts
// at a row stride of 4 mod 16 words (pad_ld): single-word slots (c, c + 4)
// along the rows (a lane's g picks the row, 4 g + c the bank), paired slots
// (2c, 2c + 1) down the columns (2c picks the row, 8 c + g the bank).
template <typename T, int NN, bool TR>
__device__ __forceinline__ void att_mm(float (&acc)[NN][4], const T* a, int lda, int m0, const T* b,
                                       int ldb, int n0, int kd, int nn) {
  if constexpr (std::is_same<T, bf16>::value) {
    smm<T, NN, TR, TR>(acc, a, lda, m0, b, ldb, n0, kd / 16, nn);
  } else {
    auto& acc1 = reinterpret_cast<float(&)[1][NN][4]>(acc);
    for (int k0 = 0; k0 < kd; k0 += 8) {
      const int2 k = k_slots<TR>(k0);
      FragA fa[1];
      att_a<TR>(fa[0], a, lda, m0, k);
#pragma unroll
      for (int j0 = 0; j0 < NN; j0 += kTcG) {
        if (j0 >= nn) break;
        FragB fb[kTcG];
#pragma unroll
        for (int u = 0; u < kTcG; ++u)
          if (j0 + u < NN && j0 + u < nn) att_b<TR>(fb[u], b, ldb, n0 + 8 * (j0 + u), k);
        mma3_group(acc1, fa, fb, j0, nn);
      }
    }
  }
}

// T4 staged's two products of one shape, as att_mm takes them: S and dP
// (the query pass), dV and dK (TR, the key pass): acc0 += A0 B0 and acc1 +=
// A1 B1. fp32 takes them in one loop (mma3_group2), twice the independent
// accumulators.
template <typename T, int NN, bool TR>
__device__ __forceinline__ void att_mm2(float (&acc0)[NN][4], const T* a0, const T* b0,
                                        float (&acc1)[NN][4], const T* a1, const T* b1, int lda,
                                        int m0, int ldb, int n0, int kd, int nn) {
  if constexpr (std::is_same<T, bf16>::value) {
    att_mm<T, NN, TR>(acc0, a0, lda, m0, b0, ldb, n0, kd, nn);
    att_mm<T, NN, TR>(acc1, a1, lda, m0, b1, ldb, n0, kd, nn);
  } else {
    for (int k0 = 0; k0 < kd; k0 += 8) {
      const int2 k = k_slots<TR>(k0);
      FragA f0, f1;
      att_a<TR>(f0, a0, lda, m0, k);
      att_a<TR>(f1, a1, lda, m0, k);
#pragma unroll
      for (int j0 = 0; j0 < NN; j0 += kTcG) {
        if (j0 >= nn) break;
        FragB g0[kTcG], g1[kTcG];
#pragma unroll
        for (int u = 0; u < kTcG; ++u)
          if (j0 + u < NN && j0 + u < nn) {
            att_b<TR>(g0[u], b0, ldb, n0 + 8 * (j0 + u), k);
            att_b<TR>(g1[u], b1, ldb, n0 + 8 * (j0 + u), k);
          }
        mma3_group2(acc0, f0, g0, acc1, f1, g1, j0, nn);
      }
    }
  }
}

// The A fragment of k-step kk (8 contraction columns) from C fragments, by
// paired k-steps (as warp_mma_tf32_c takes them): no shuffle.
template <int N>
__device__ __forceinline__ void c_to_tf32(const float (&f)[N][4], int kk, FragA& fa) {
  const float v[4] = {f[kk][0], f[kk][2], f[kk][1], f[kk][3]};
  split_tf32(v, fa);
}

// The paired B fragment of rows [k0, k0 + 8) and column n of B row-major in
// shared memory (row stride ld), split.
__device__ __forceinline__ void ldb_paired(FragB& fb, const float* b, int ld, int k0, int n) {
  const float* q = b + (k0 + 2 * (threadIdx.x % 4)) * ld + n;
  const float v[2] = {q[0], q[ld]};
  split_tf32(v, fb);
}

// acc[j] (j < nn) += F B[.., n0 + 8 j ..], F [16 x 8 NK] held as C fragments
// whose columns are the contraction, B row-major in shared memory. bf16:
// F rounded as the A operand, k-steps of 16 over all NK tiles (nn even).
// fp32: 3xTF32 by paired k-steps over F's first nk tiles (the keys below t:
// P and dS are zero past them).
template <typename T, int NK, int NN>
__device__ __forceinline__ void smm_frag(float (&acc)[NN][4], const float (&f)[NK][4], const T* b,
                                         int ldb, int n0, int nn, int nk) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t fa[4];
      c_to_a(f, kk, fa);
#pragma unroll
      for (int j = 0; j < NN; j += 2) {
        if (j < nn) {
          uint32_t fb[4];
          ldb_kn(fb, b, ldb, 16 * kk, n0 + 8 * j);
          mma_pair(acc[j], acc[j + 1], fa, fb);
        }
      }
    }
  } else {
    const int g = threadIdx.x % 32 / 4;
    auto& acc1 = reinterpret_cast<float(&)[1][NN][4]>(acc);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk >= nk) break;
      FragA fa[1];
      c_to_tf32(f, kk, fa[0]);
#pragma unroll
      for (int j0 = 0; j0 < NN; j0 += kTcG) {
        if (j0 >= nn) break;
        FragB fb[kTcG];
#pragma unroll
        for (int u = 0; u < kTcG; ++u)
          if (j0 + u < NN && j0 + u < nn) ldb_paired(fb[u], b, ldb, 8 * kk, n0 + 8 * (j0 + u) + g);
        mma3_group(acc1, fa, fb, j0, nn);
      }
    }
  }
}

// C fragments (16 rows from m0, 8 N columns) into a shared tile in the
// compute dtype.
template <typename T, int N>
__device__ __forceinline__ void put_frag(const float (&f)[N][4], T* dst, int ld, int m0) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T* q = dst + (m0 + g + 8 * i) * ld + 8 * j + 2 * c;
      if constexpr (std::is_same<T, bf16>::value)
        *reinterpret_cast<uint32_t*>(q) = pack_bf16(f[j][2 * i], f[j][2 * i + 1]);
      else
        *reinterpret_cast<float2*>(q) = make_float2(f[j][2 * i], f[j][2 * i + 1]);
    }
}

// The pair of values at q (columns col, col + 1 of `cols`), as one 4- or
// 8-byte store where both are inside and q is aligned for it.
template <typename T>
__device__ __forceinline__ void put2(T* q, int col, int cols, float a, float b) {
  if (col + 1 < cols && reinterpret_cast<size_t>(q) % (2 * sizeof(T)) == 0) {
    if constexpr (std::is_same<T, bf16>::value)
      *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(a, b);
    else
      *reinterpret_cast<float2*>(q) = make_float2(a, b);
    return;
  }
  q[0] = from_f<T>(a);
  if (col + 1 < cols) q[1] = from_f<T>(b);
}

// C fragments of 16 rows from m0 and 8 NN columns from c0 into device
// memory (row stride ld), rows below `rows` and columns below `cols`.
template <typename T, int NN>
__device__ __forceinline__ void put_rows(const float (&f)[NN][4], T* dst, size_t ld, int m0, int c0,
                                         int rows, int cols) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + g + 8 * i, col = c0 + 8 * j + 2 * c;
      if (row < rows && col < cols)
        put2(dst + size_t(row) * ld + col, col, cols, f[j][2 * i], f[j][2 * i + 1]);
    }
}

// o of the warp's 16 rows from m0 and the head's columns [c0, c0 + 8 NN):
// the stream-1 mask (or the external one) keyed by (global row, column),
// then fp32 or the compute dtype.
template <typename T, int NN>
__device__ __forceinline__ void put_o(const AttArgs& p, bool o_f32, const philox::Dropout& dr,
                                      const float (&acc)[NN][4], size_t row0, int m0, int c0,
                                      int h, int hd) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + g + 8 * i, col = c0 + 8 * j + 2 * c;
      if (row >= p.t || col >= hd) continue;
      const size_t grow = row0 + row;
      const int gcol = h * hd + col;
      const float v0 = acc[j][2 * i] * att_mask(dr, p.ext, p.inv_ext, grow, gcol, p.d);
      const float v1 =
          col + 1 < hd ? acc[j][2 * i + 1] * att_mask(dr, p.ext, p.inv_ext, grow, gcol + 1, p.d) : 0.f;
      if (o_f32)
        put2(static_cast<float*>(p.o) + grow * p.ldo + gcol, col, hd, v0, v1);
      else
        put2(static_cast<T*>(p.o) + grow * p.ldo + gcol, col, hd, v0, v1);
    }
}

// T2 staged: NK / 2 warps (T16 = 8 NK). Each warp takes S of its 16 rows
// over all keys once into registers, the exact row max and sum, P
// normalised, then o = round(P) V from the registers by 32-column chunks of
// the head. V lands while S and P are taken.
template <typename T, int NK>
__global__ void __launch_bounds__(16 * NK, t2_min_blocks(NK, sizeof(T)))
    tiled_attention_staged_kernel(AttArgs p, bool o_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kT16 = 8 * NK;
  const int t = p.t, hd = p.d / p.heads, w16 = r16(hd), ld = pad_ld(w16, sizeof(T));
  const int h = blockIdx.x % p.heads, an = blockIdx.x / p.heads;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n)) return;
  const size_t row0 = size_t(an) * t;
  const T* base = static_cast<const T*>(p.qkv) + row0 * p.P + (h / p.gh) * p.pw + (h % p.gh) * hd;
  const int kq = p.gh * hd;  // Q to K, K to V
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kT16 * ld;
  T* vs = ks + kT16 * ld;
  stage(qs, ld, base, p.P, t, kT16, hd, w16);
  stage(ks, ld, base + kq, p.P, t, kT16, hd, w16);
  cp_async_commit();
  stage(vs, ld, base + 2 * kq, p.P, t, kT16, hd, w16);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const int m0 = 16 * (threadIdx.x / 32);
  // the products' depth over the head (kw) and key tiles (nkt): bf16 the padded head and all
  // T16 keys; fp32 the head's width rounded up to 8 and the keys below t (the logits of the
  // rest stay 0, then -inf: P 0)
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int kw = kF32 ? (hd + 7) / 8 * 8 : w16, nkt = kF32 ? (t + 7) / 8 : NK;
  float s[NK][4];
  zero_frag(s);
  att_mm<T, NK, false>(s, qs, ld, m0, ks, ld, 0, kw, nkt);
  log2_logits(s, 0, t, p.scale * kLog2e);
  float mx[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float r = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j) r = fmaxf(r, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx[i] = quad_max(r);  // finite: key 0 is below t
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][2 * i + e] = exp2f(s[j][2 * i + e] - mx[i]);
        a += s[j][2 * i + e];
      }
    l[i] = quad_sum(a);
    const float il = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][2 * i] *= il;
      s[j][2 * i + 1] *= il;
    }
  }
  philox::Dropout dr = p.dr;
  dr.key = philox::key_at(dr.key, p.seed_dev);
  cp_async_wait<0>();
  __syncthreads();  // V has landed
  for (int c0 = 0; c0 < hd; c0 += kOutCols) {
    float acc[kOutCols / 8][4];
    zero_frag(acc);
    smm_frag<T>(acc, s, vs, ld, c0, min(kOutCols, kw - c0) / 8, nkt);
    put_o<T>(p, o_f32, dr, acc, row0, m0, c0, h, hd);
  }
  if (p.stats != nullptr && threadIdx.x % 4 == 0) {
    const size_t plane = size_t(p.n) * t * p.heads;
    const int g = threadIdx.x % 32 / 4;
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

// T4 staged: NK / 2 warps. Q, K, V, dO and the rows' statistics are staged
// once. Query pass: each warp takes S and dP of its 16 rows over all keys
// into registers, P from T2's statistics, delta = rowsum(P dP) over the
// unrounded P by quad sums, dS = round(P (dP - delta) scale), dQ = dS K,
// and leaves round(P) and dS in shared memory. Key pass, after one
// barrier: dV = round(P)^T dO and dK = dS^T Q of the warp's 16 keys from
// those tiles (bf16 by ldmatrix.trans, fp32 by paired k-steps); no logit is
// recomputed. fp32 takes S and dP, and dV and dK, two at a time (att_mm2).
// Every output element is written by one warp: no atomics.
template <typename T, int NK>
__global__ void __launch_bounds__(16 * NK, t4_min_blocks(NK, sizeof(T)))
    tiled_attention_bwd_staged_kernel(AttBwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kT16 = 8 * NK;
  const int g = threadIdx.x % 32 / 4;
  const int t = p.t, hd = p.d / p.heads, w16 = r16(hd), ld = pad_ld(w16, sizeof(T));
  const int ldt = pad_ld(kT16, sizeof(T));
  const int h = blockIdx.x % p.heads, an = blockIdx.x / p.heads;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n)) return;
  const size_t row0 = size_t(an) * t;
  const size_t off = row0 * p.P + (h / p.gh) * p.pw + (h % p.gh) * hd;
  const int kq = p.gh * hd;
  const T* base = static_cast<const T*>(p.qkv) + off;
  T* dbase = static_cast<T*>(p.dqkv) + off;
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kT16 * ld;
  T* vs = ks + kT16 * ld;
  T* dos = vs + kT16 * ld;
  T* ps = dos + kT16 * ld;
  T* dss = ps + kT16 * ldt;
  float* smx = reinterpret_cast<float*>(dss + kT16 * ldt);
  float* ssum = smx + kT16;
  const float* st = p.stats + row0 * p.heads + h;
  stage(qs, ld, base, p.P, t, kT16, hd, w16);
  stage(ks, ld, base + kq, p.P, t, kT16, hd, w16);
  stage_col(smx, st, p.heads, t, kT16);
  stage_col(ssum, st + size_t(p.n) * t * p.heads, p.heads, t, kT16);
  cp_async_commit();
  // V and dO land while S and P are taken
  stage(vs, ld, base + 2 * kq, p.P, t, kT16, hd, w16);
  stage(dos, ld, static_cast<const T*>(p.do_c) + row0 * p.d + h * hd, p.d, t, kT16, hd, w16);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const int m0 = 16 * (threadIdx.x / 32);
  constexpr bool kF32 = std::is_same<T, float>::value;  // kw and nkt as T2's
  const int kw = kF32 ? (hd + 7) / 8 * 8 : w16, nkt = kF32 ? (t + 7) / 8 : NK;
  {  // the query pass
    float mr[2], il[2], ds[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + g + 8 * i;
      mr[i] = smx[row];
      il[i] = row < t ? 1.f / ssum[row] : 0.f;
    }
    float s[NK][4], dp[NK][4];
    zero_frag(s);
    if constexpr (kF32) {  // S and dP in one loop (att_mm2), once V and dO have landed
      zero_frag(dp);
      cp_async_wait<0>();
      __syncthreads();
      att_mm2<T, NK, false>(s, qs, ks, dp, dos, vs, ld, m0, ld, 0, kw, nkt);
    } else {
      att_mm<T, NK, false>(s, qs, ld, m0, ks, ld, 0, kw, nkt);
    }
    log2_logits(s, 0, t, p.scale * kLog2e);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - mr[e / 2]) * il[e / 2];
    if constexpr (!kF32) {
      cp_async_wait<0>();
      __syncthreads();  // V and dO have landed
      zero_frag(dp);
      att_mm<T, NK, false>(dp, dos, ld, m0, vs, ld, 0, kw, nkt);
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e / 2] += s[j][e] * dp[j][e];
    ds[0] = quad_sum(ds[0]);
    ds[1] = quad_sum(ds[1]);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = rnd<T>(s[j][e] * (dp[j][e] - ds[e / 2]) * p.scale);
    put_frag(s, ps, ldt, m0);  // round(P)
    put_frag(dp, dss, ldt, m0);
    for (int c0 = 0; c0 < hd; c0 += kOutCols) {
      float acc[kOutCols / 8][4];
      zero_frag(acc);
      smm_frag<T>(acc, dp, ks, ld, c0, min(kOutCols, kw - c0) / 8, nkt);
      put_rows(acc, dbase, p.P, m0, c0, t, hd);
    }
  }
  __syncthreads();  // every row's round(P) and dS are in shared memory
  // the key pass: the warp's 16 keys from m0
  for (int c0 = 0; c0 < hd; c0 += kOutCols) {
    const int nn = min(kOutCols, kw - c0) / 8;
    float av[kOutCols / 8][4], ak[kOutCols / 8][4];
    zero_frag(av);
    zero_frag(ak);
    att_mm2<T, kOutCols / 8, true>(av, ps, dos, ak, dss, qs, ldt, m0, ld, c0, 8 * nkt, nn);
    put_rows(av, dbase + 2 * kq, p.P, m0, c0, t, hd);
    put_rows(ak, dbase + kq, p.P, m0, c0, t, hd);
  }
}

// ---- T2 and T4, streamed: any T, the operands in shared memory ----
// (the top of this file; the launchers only check that a request fits)

constexpr int kStrWarps = kAttThreads / 32;  // warps a block
constexpr int kStrWarpsT4F32 = 8;  // warps of an fp32 T4 block whose pair is resident
constexpr int kStrNarrow = 64;  // head widths (rounded up to 16) up to this: two row tiles a warp
constexpr int kStrKeys = 32;    // keys (T4's key pass: queries) of a logits tile in registers
constexpr int kStrKeys1 = 32;   // T2's pass 1 (no o accumulators): keys of a logits tile

// Shared memory of a streamed T2 (bwd false) or T4. Each warp takes rt
// 16-row tiles at once (T2: 2 where the head is narrow, so that each B
// fragment feeds two products; else 1: T4 at its registers' limit gained
// nothing from 2), a round being the block's 16 rt rows a warp (4 warps;
// fp32 T4 with its pair resident 8). The matrices' tiles are zero-padded to
// r16(hd) columns in rows of ld elements. "resident": Q, K and V (T4: and
// dO) whole, T16 rows each, loaded once. Otherwise a round's rows of Q (T4: two matrices) and two
// slots of the swept pair (K and V; T4's key pass: Q and dO) in tiles of kr
// rows, the largest of 64, 32 and 16 that fits. T4 adds each row's max,
// 1/sum and delta (a float4 a row, T16 rows) after them.
struct StreamPlan {
  bool resident;
  int t16, ld, kr, rt, warps, round;
  size_t mat, stats, total;  // bytes: a whole matrix; where the statistics start; all
};
__host__ __device__ inline StreamPlan streamed_plan(int t, int hd, int elem, bool bwd) {
  StreamPlan L;
  L.t16 = r16(t);
  L.ld = pad_ld(r16(hd), elem);
  L.rt = !bwd && r16(hd) <= kStrNarrow ? 2 : 1;
  L.warps = kStrWarps;
  L.round = 16 * L.warps * L.rt;
  const size_t row = size_t(L.ld) * elem, stats = bwd ? size_t(L.t16) * 16 : 0;
  const int mats = bwd ? 4 : 3, side = bwd ? 2 : 1;
  L.mat = size_t(L.t16) * row;
  L.resident = mats * L.mat + stats <= size_t(kSmemLimit);
  L.kr = kTile;
  L.stats = mats * L.mat;
  while (!L.resident) {
    L.stats = (size_t(side) * L.round + 4 * size_t(L.kr)) * row;
    if (L.stats + stats <= size_t(kSmemLimit) || L.kr == 16) break;
    L.kr /= 2;
  }
  L.total = L.stats + stats;
  if (L.resident && bwd && elem == 4) {
    // fp32 T4's resident pair takes more than half an SM's shared memory
    // from T 196 at heads 20 wide (one block an SM): twice the warps share
    // its rounds, which the plan's bytes do not depend on
    L.warps = kStrWarpsT4F32;
    L.round = 16 * L.warps * L.rt;
  }
  return L;
}

// Whether a streamed request fits what its launch allocates.
inline bool streamed_fits(int t, int hd, int elem, bool bwd) {
  return streamed_plan(t, hd, elem, bwd).total <= size_t(kSmemLimit);
}

// stage, or where src is not 4-byte aligned (an odd bf16 head width or D)
// plain loads and stores: cp.async's smallest piece is 4 bytes.
template <typename T>
__device__ void stage_rows(T* dst, int ldd, const T* src, size_t lds, int rows, int rows_pad,
                           int cols, int cols_pad) {
  if ((reinterpret_cast<size_t>(src) | (lds * sizeof(T))) % 4 == 0) {
    stage(dst, ldd, src, lds, rows, rows_pad, cols, cols_pad);
    return;
  }
  for (int i = threadIdx.x; i < rows_pad * cols_pad; i += blockDim.x) {
    const int r = i / cols_pad, c = i % cols_pad;
    dst[r * ldd + c] = r < rows && c < cols ? src[size_t(r) * lds + c] : from_f<T>(0.f);
  }
}

// Two 8 x 8 matrices by ldmatrix (.x2: lanes 0-15 give the rows) and an
// m16n8k8 product: T2's logits take a head's last 8 columns by them where
// its width is 8 past a multiple of 16 (20: 16 + 8), not by a k-step of 16
// that is half zeros. (T4 in bf16, at its registers' limit, spills with
// them and runs slower: it keeps k-steps of 16. fp32 takes every product in
// k-steps of 8.)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hop::smem_u32(p)));
}
__device__ __forceinline__ void mma_16808(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

template <int R, int N>
__device__ __forceinline__ void zero_rows(float (&f)[R][N][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) zero_frag(f[r]);
}

// acc[r][j] += d[r][j] for the column tiles below n.
template <int R, int N>
__device__ __forceinline__ void add_rows(float (&acc)[R][N][4], const float (&d)[R][N][4], int n) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] += d[r][j][e];
}

// fp32 fragments of the k-step at k0 by single-word slots, split: A's 16
// rows of a row-major tile at a; B's column tile of 8 rows from n of a tile
// stored by columns (b[n][k]).
__device__ __forceinline__ void lda_rows(FragA& fa, const float* a, int ld, int k0) {
  const int g = threadIdx.x % 32 / 4;
  const int2 k = k_slots<false>(k0);
  const float v[4] = {a[g * ld + k.x], a[(g + 8) * ld + k.x], a[g * ld + k.y],
                      a[(g + 8) * ld + k.y]};
  split_tf32(v, fa);
}
__device__ __forceinline__ void ldb_cols(FragB& fb, const float* b, int ld, int k0, int n) {
  const int2 k = k_slots<false>(k0);
  const float* q = b + (n + threadIdx.x % 32 / 4) * ld;
  const float v[2] = {q[k.x], q[k.y]};
  split_tf32(v, fb);
}

// acc[r][j] (r < R; j < nn) += A_r[16 x kd] B[kd x 8 nn]: each row tile's
// A row-major at a[r], B stored by columns (b[n][k], as K for Q K^T), all
// in shared memory (row stride ld); each B fragment is loaded once for the
// R tiles. bf16: kd a multiple of 16, or with K8 of 8 (a last k-step of 8),
// nn even. fp32: 3xTF32 in k-steps of 8 (kd a multiple of 8) by single-word
// slots (as att_mm), each A fragment split once for the nn tiles and each B
// fragment once for the R tiles, by groups (mma3_group).
template <typename T, int R, int NN, bool K8 = false>
__device__ __forceinline__ void smm_rows(float (&acc)[R][NN][4], const T* (&a)[R], const T* b,
                                         int ld, int kd, int nn) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int ks = kd / 16;
    for (int kk = 0; kk < ks; ++kk) {
      uint32_t fa[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) lda_rm(fa[r], a[r], ld, 0, 16 * kk);
#pragma unroll
      for (int j = 0; j < NN; j += 2) {
        if (j < nn) {
          uint32_t fb[4];
          ldb_nk(fb, b, ld, 16 * kk, 8 * j);
#pragma unroll
          for (int r = 0; r < R; ++r) mma_pair(acc[r][j], acc[r][j + 1], fa[r], fb);
        }
      }
    }
    if (K8 && kd % 16) {  // columns 16 ks .. 16 ks + 8
      const int l = threadIdx.x % 16;
      uint32_t fa[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) ldsm_x2(fa[r], a[r] + l * ld + 16 * ks);
#pragma unroll
      for (int j = 0; j < NN; j += 2) {
        if (j < nn) {
          uint32_t fb[2];  // column tiles j and j + 1
          ldsm_x2(fb, b + (8 * j + l) * ld + 16 * ks);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            mma_16808(acc[r][j], fa[r], fb[0]);
            mma_16808(acc[r][j + 1], fa[r], fb[1]);
          }
        }
      }
    }
  } else {
    for (int k0 = 0; k0 < kd; k0 += 8) {
      FragA fa[R];
#pragma unroll
      for (int r = 0; r < R; ++r) lda_rows(fa[r], a[r], ld, k0);
#pragma unroll
      for (int j0 = 0; j0 < NN; j0 += kTcG) {
        if (j0 >= nn) break;
        FragB fb[kTcG];
#pragma unroll
        for (int u = 0; u < kTcG; ++u)
          if (j0 + u < NN && j0 + u < nn) ldb_cols(fb[u], b, ld, k0, 8 * (j0 + u));
        mma3_group(acc, fa, fb, j0, nn);
      }
    }
  }
}

// fp32 (T4): two products of smm_rows' shape (R 1) at once, s += A_s B_s and
// dp += A_d B_d, each A row-major and B by columns.
template <int NN>
__device__ __forceinline__ void smm_rows2(float (&s)[1][NN][4], const float* as, const float* bs,
                                          float (&dp)[1][NN][4], const float* ad, const float* bd,
                                          int ld, int kd, int nn) {
  for (int k0 = 0; k0 < kd; k0 += 8) {
    FragA fs, fd;
    lda_rows(fs, as, ld, k0);
    lda_rows(fd, ad, ld, k0);
#pragma unroll
    for (int j0 = 0; j0 < NN; j0 += kTcG) {
      if (j0 >= nn) break;
      FragB bs_[kTcG], bd_[kTcG];
#pragma unroll
      for (int u = 0; u < kTcG; ++u)
        if (j0 + u < NN && j0 + u < nn) {
          ldb_cols(bs_[u], bs, ld, k0, 8 * (j0 + u));
          ldb_cols(bd_[u], bd, ld, k0, 8 * (j0 + u));
        }
      mma3_group2(s[0], fs, bs_, dp[0], fd, bd_, j0, nn);
    }
  }
}

// acc[r][j] (j < no) += F_r[16 x 8 nk] B[8 nk x .., c0 + 8 j ..]: F_r held
// as C fragments of up to 8 NK columns, B row-major in shared memory (row
// stride ld); each B fragment is loaded once for the R tiles. bf16: F
// rounded as the A operand, k-steps of 16 (nk and no even). fp32: 3xTF32 by
// paired k-steps of 8 (as smm_frag, by groups), the call's products into
// zeroed fragments that are then added to acc: these products sum over all
// T keys (or queries) of a sweep, a call's at most 32, and the tensor
// cores' fp32 accumulation truncates each sum, which over T 12,800 (3 x
// 1,600 sums into acc) moved o by 1.3e-4 of its scale on an H100 (PERF.md);
// an fp32 add rounds.
template <typename T, int R, int NK, int NN>
__device__ __forceinline__ void smm_frag_rows(float (&acc)[R][NN][4], const float (&f)[R][NK][4],
                                              const T* b, int ld, int c0, int no, int nk) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      if (kk >= nk / 2) break;
      uint32_t fa[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) c_to_a(f[r], kk, fa[r]);
#pragma unroll
      for (int j = 0; j < NN; j += 2) {
        if (j < no) {
          uint32_t fb[4];
          ldb_kn(fb, b, ld, 16 * kk, c0 + 8 * j);
#pragma unroll
          for (int r = 0; r < R; ++r) mma_pair(acc[r][j], acc[r][j + 1], fa[r], fb);
        }
      }
    }
  } else {
    const int g = threadIdx.x % 32 / 4;
    float d[R][NN][4];
    zero_rows(d);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk >= nk) break;
      FragA fa[R];
#pragma unroll
      for (int r = 0; r < R; ++r) c_to_tf32(f[r], kk, fa[r]);
#pragma unroll
      for (int j0 = 0; j0 < NN; j0 += kTcG) {
        if (j0 >= no) break;
        FragB fb[kTcG];
#pragma unroll
        for (int u = 0; u < kTcG; ++u)
          if (j0 + u < NN && j0 + u < no) ldb_paired(fb[u], b, ld, 8 * kk, c0 + 8 * (j0 + u) + g);
        mma3_group(d, fa, fb, j0, no);
      }
    }
    add_rows(acc, d, no);
  }
}

// fp32 (T4's key pass): two products of smm_frag_rows' shape (R 1) at once,
// av += F_s B_v and ak += F_d B_k.
template <int NK, int NN>
__device__ __forceinline__ void smm_frag_rows2(float (&av)[1][NN][4], const float (&fs)[1][NK][4],
                                               const float* bv, float (&ak)[1][NN][4],
                                               const float (&fd)[1][NK][4], const float* bk,
                                               int ld, int c0, int no, int nk) {
  const int g = threadIdx.x % 32 / 4;
  float dv[1][NN][4], dk[1][NN][4];
  zero_rows(dv);
  zero_rows(dk);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk >= nk) break;
    FragA as, ad;
    c_to_tf32(fs[0], kk, as);
    c_to_tf32(fd[0], kk, ad);
#pragma unroll
    for (int j0 = 0; j0 < NN; j0 += kTcG) {
      if (j0 >= no) break;
      FragB bv_[kTcG], bk_[kTcG];
#pragma unroll
      for (int u = 0; u < kTcG; ++u)
        if (j0 + u < NN && j0 + u < no) {
          ldb_paired(bv_[u], bv, ld, 8 * kk, c0 + 8 * (j0 + u) + g);
          ldb_paired(bk_[u], bk, ld, 8 * kk, c0 + 8 * (j0 + u) + g);
        }
      mma3_group2(dv[0], as, bv_, dk[0], ad, bk_, j0, no);
    }
  }
  add_rows(av, dv, no);
  add_rows(ak, dk, no);
}


// The swept pair of a streamed kernel: two matrices of t rows (in device
// memory at src, row strides lds) taken tile by tile, kr rows a tile, by
// the block's warps in step. Resident: whole in shared memory at whole[i]
// (loaded by load_whole). Else through two slots at `slots` (slot s,
// matrix i at (2 s + i) kr ld): each step waits for its tile, then, after
// a barrier (every warp is past the step before, so the other slot is
// free), loads the phase's next tile into the other slot.
template <typename T>
struct Sweep {
  const T* src[2];
  size_t lds[2];
  T* whole[2];
  T* slots;
  int t, hd, w16, ld, kr, t16, nt;
  bool resident;
  int seq, left;  // streamed: steps taken, and steps left in the phase

  __device__ void load_whole() const {
    for (int i = 0; i < 2; ++i) stage_rows(whole[i], ld, src[i], lds[i], t, t16, hd, w16);
  }
  __device__ void load_tile(int j, int s) const {
    for (int i = 0; i < 2; ++i)
      stage_rows(slots + size_t(2 * s + i) * kr * ld, ld, src[i] + size_t(j) * kr * lds[i], lds[i],
                 min(kr, t - j * kr), kr, hd, w16);
  }
  // A phase of `steps` steps: whole sweeps over the tiles 0 .. nt - 1.
  __device__ void begin(int steps) {
    left = steps;
    if (!resident && steps > 0) {
      load_tile(0, seq & 1);
      cp_async_commit();
    }
  }
  // Tile j of the phase's next step: matrix i at m[i]. Every warp of the
  // block calls it, in the same order.
  __device__ void step(int j, const T* (&m)[2]) {
    if (resident) {
      m[0] = whole[0] + size_t(j) * kr * ld;
      m[1] = whole[1] + size_t(j) * kr * ld;
      return;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (--left > 0) load_tile(j + 1 < nt ? j + 1 : 0, (seq + 1) & 1);
    cp_async_commit();
    m[0] = slots + size_t(2 * (seq & 1)) * kr * ld;
    m[1] = m[0] + size_t(kr) * ld;
    ++seq;
  }
};

template <typename T>
__device__ Sweep<T> make_sweep(const StreamPlan& L, int t, int hd, T* slots) {
  Sweep<T> s;
  s.slots = slots;
  s.t = t;
  s.hd = hd;
  s.w16 = r16(hd);
  s.ld = L.ld;
  s.kr = L.kr;
  s.t16 = L.t16;
  s.nt = (L.t16 + L.kr - 1) / L.kr;
  s.resident = L.resident;
  s.seq = s.left = 0;
  return s;
}

// 2^x on the special-function unit, subnormal results flushed to zero (a
// probability below 2^-126 rounds to nothing the products can see).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -inf for the logits of the keys at or past t: the thread's columns 8 jj
// + {0, 1} (jj < nn) from `left` = t - (the tile's first key + 2 c) on.
template <int R, int NK>
__device__ __forceinline__ void mask_keys(float (&s)[R][NK][4], int left, int nn) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NK; ++jj)
      if (jj < nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * jj + e % 2 >= left) s[i][jj][e] = -INFINITY;
}

// P = 2^(s sl - ml) in place, each row's ml its max + log2(sum) (+inf for
// a row past t: P 0), over the column tiles below nn.
template <int R, int NK>
__device__ __forceinline__ void probs_of(float (&s)[R][NK][4], const float (&ml)[R][2], float sl,
                                         int nn) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NK; ++jj)
      if (jj < nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][jj][e] = ex2(fmaf(s[i][jj][e], sl, -ml[i][e / 2]));
}

// A warp's R row tiles in round r: first rows m0[i] (16 apart), which are
// live below t, and where their rows lie in shared memory: resident, in the
// whole matrix at base (a tile past T16 reads the last one's, its results
// dropped); else in the round's buffer.
template <typename T, int R>
__device__ __forceinline__ void round_rows(const StreamPlan& L, int r, int t, const T* base,
                                           int (&m0)[R], bool (&live)[R], const T* (&rows)[R]) {
  const int first = (r * L.warps + int(threadIdx.x / 32)) * 16 * R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m0[i] = first + 16 * i;
    live[i] = m0[i] < t;
    rows[i] = base + size_t(L.resident ? min(m0[i], L.t16 - 16) : m0[i] - r * L.round) * L.ld;
  }
}

// T2 streamed: a block per (article, head), four warps, each R 16-row query
// tiles of a round (the rounds cover T16). Pass 1 sweeps the key tiles for
// each row's max and sum of exp2, each thread over its own columns (no
// shuffle until the pass ends); pass 2, per 64 / R-column chunk of the
// head, sweeps them again, the logits recomputed from shared memory, for o
// = round(P) V with P normalised. The logits are taken kStrKeys keys at a
// time; column tiles past a tile's T16 rows are skipped. Resident: Q, K
// and V loaded once; else Q by rounds, K and V by tiles through the slots.
// Registers for four blocks an SM, two in fp32 (the two-tile instance's
// 3xTF32 fragments and grouped products spilled at four; at T 200 the
// resident fp32 pair's 90 KB leave room for two blocks anyway).
template <typename T, int R>
__global__ void __launch_bounds__(kAttThreads, sizeof(T) == 4 ? 2 : 4)
    tiled_attention_streamed_kernel(AttArgs p, bool o_f32) {
  constexpr int NK = kStrKeys / 8, NK1 = kStrKeys1 / 8, NO = 8 / R;  // column tiles
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const int t = p.t, hd = p.d / p.heads, w16 = r16(hd), w8 = (hd + 7) / 8 * 8;
  const int wo = kF32 ? w8 : w16;  // o's columns taken: fp32 in column tiles of 8
  const StreamPlan L = streamed_plan(t, hd, sizeof(T), false);
  const int h = blockIdx.x % p.heads, an = blockIdx.x / p.heads;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n)) return;
  const size_t row0 = size_t(an) * t;
  const T* base = static_cast<const T*>(p.qkv) + row0 * p.P + (h / p.gh) * p.pw + (h % p.gh) * hd;
  const int kq = p.gh * hd, ld = L.ld;
  T* qs = reinterpret_cast<T*>(smem);
  Sweep<T> sw = make_sweep<T>(L, t, hd, qs + size_t(L.round) * ld);
  sw.src[0] = base + kq;
  sw.src[1] = base + 2 * kq;
  sw.lds[0] = sw.lds[1] = p.P;
  sw.whole[0] = qs + size_t(L.t16) * ld;
  sw.whole[1] = sw.whole[0] + size_t(L.t16) * ld;
  if (L.resident) {  // Q and K, then V, which lands while pass 1 runs
    stage_rows(qs, ld, base, p.P, t, L.t16, hd, w16);
    stage_rows(sw.whole[0], ld, sw.src[0], p.P, t, L.t16, hd, w16);
    cp_async_commit();
    stage_rows(sw.whole[1], ld, sw.src[1], p.P, t, L.t16, hd, w16);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
  }
  philox::Dropout dr = p.dr;
  dr.key = philox::key_at(dr.key, p.seed_dev);
  const float sl = p.scale * kLog2e;
  const int nch = (wo + 8 * NO - 1) / (8 * NO);
  const int rounds = (L.t16 + L.round - 1) / L.round;
  // the key tiles of 8 below t of a logits tile from key k0 (fp32; bf16 all nn, an even count)
  auto below = [&](int k0, int nn) { return kF32 ? min(nn, (t - k0 + 7) / 8) : nn; };
  for (int r = 0; r < rounds; ++r) {
    int m0[R];
    bool live[R];
    const T* qrow[R];
    round_rows<T, R>(L, r, t, qs, m0, live, qrow);
    if (!L.resident) {
      __syncthreads();  // the last round's Q rows are spent
      stage_rows(qs, ld, base + size_t(r) * L.round * p.P, p.P, min(L.round, t - r * L.round),
                 L.round, hd, w16);
      cp_async_commit();
    }
    sw.begin((1 + nch) * sw.nt);
    // pass 1: each row's max and sum of exp2, first over the thread's own columns
    float mx[R][2], l[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) mx[i][0] = mx[i][1] = -INFINITY, l[i][0] = l[i][1] = 0.f;
    for (int j = 0; j < sw.nt; ++j) {
      const T* m[2];
      sw.step(j, m);
      if (!live[0]) continue;
      const int rows = min(L.kr, L.t16 - j * L.kr);
      for (int h0 = 0; h0 < rows; h0 += kStrKeys1) {
        const int k0 = j * L.kr + h0, nn = min(kStrKeys1, rows - h0) / 8;
        float s[R][NK1][4];
        zero_rows(s);
        smm_rows<T, R, NK1, true>(s, qrow, m[0] + size_t(h0) * ld, ld, w8, below(k0, nn));
        if (k0 + 8 * nn > t) mask_keys(s, t - k0 - 2 * c, nn);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // the max of the raw logits: scale > 0
            float rm = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < NK1; ++jj)
              if (jj < nn) rm = fmaxf(rm, fmaxf(s[i][jj][2 * e], s[i][jj][2 * e + 1]));
            const float mn = fmaxf(mx[i][e], rm * sl), b = mn == -INFINITY ? 0.f : mn;
            float a = 0.f;
#pragma unroll
            for (int jj = 0; jj < NK1; ++jj)
              if (jj < nn)
                a += ex2(fmaf(s[i][jj][2 * e], sl, -b)) + ex2(fmaf(s[i][jj][2 * e + 1], sl, -b));
            l[i][e] = l[i][e] * ex2(mx[i][e] - b) + a;
            mx[i][e] = mn;
          }
      }
    }
    if (L.resident && r == 0) {
      cp_async_wait<0>();
      __syncthreads();  // V has landed
    }
    float ml[R][2];  // max + log2(sum): P = 2^(s scale log2 e - ml)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // the quad's columns together: finite, key 0 is below t
        const float mn = quad_max(mx[i][e]);
        l[i][e] = quad_sum(l[i][e] * ex2(mx[i][e] - mn));
        mx[i][e] = mn;
        ml[i][e] = mn + __log2f(l[i][e]);
      }
    // pass 2: o = round(P) V, P normalised, by 8 NO-column chunks of the head
    for (int c0 = 0; c0 < wo; c0 += 8 * NO) {
      const int no = min(8 * NO, wo - c0) / 8;
      float acc[R][NO][4];
      zero_rows(acc);
      for (int j = 0; j < sw.nt; ++j) {
        const T* m[2];
        sw.step(j, m);
        if (!live[0]) continue;
        const int rows = min(L.kr, L.t16 - j * L.kr);
        for (int h0 = 0; h0 < rows; h0 += kStrKeys) {
          const int k0 = j * L.kr + h0, nn = min(kStrKeys, rows - h0) / 8;
          float s[R][NK][4];
          zero_rows(s);
          const int nb = below(k0, nn);
          smm_rows<T, R, NK, true>(s, qrow, m[0] + size_t(h0) * ld, ld, w8, nb);
          if (k0 + 8 * nn > t) mask_keys(s, t - k0 - 2 * c, nn);
          probs_of(s, ml, sl, nn);
          smm_frag_rows<T, R>(acc, s, m[1] + size_t(h0) * ld, ld, c0, no, nb);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (live[i]) put_o<T>(p, o_f32, dr, acc[i], row0, m0[i], c0, h, hd);
    }
    if (p.stats != nullptr && c == 0) {
      const size_t plane = size_t(p.n) * t * p.heads;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0[i] + g + 8 * e;
          if (live[i] && row < t) {
            p.stats[(row0 + row) * p.heads + h] = mx[i][e];
            p.stats[plane + (row0 + row) * p.heads + h] = l[i][e];
          }
        }
    }
  }
}

// T4 streamed: a block per (article, head), four warps, each a 16-row tile
// of a round; each row's max, 1/sum and delta stay in shared memory, side
// by side (a float4 a row). Query pass (rows of Q and dO; K and V swept): S
// and dP for delta = rowsum(P dP) over the unrounded P, then, per 32-column
// chunk of the head, S and dP again for dS = round(P (dP - delta) scale)
// and dQ = dS K. Key pass (rows of K and V; Q and dO swept), per chunk: the
// logits and dP transposed, dV = round(P)^T dO, dK = dS^T Q. The logits are
// taken kStrKeys at a time; column tiles past a tile's T16 rows are
// skipped. Resident: Q, K, V and dO loaded once; else each pass's rows by
// rounds and the swept pair by tiles. fp32 takes S and dP (and dV and dK)
// as two products in one loop (smm_rows2, smm_frag_rows2), and eight warps
// where the pair is resident (its 123 KB at T 200 leave room for one block
// an SM: four warps left each scheduler one warp to hide every latency).
template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 32 * kStrWarpsT4F32 : kAttThreads,
                                  sizeof(T) == 4 ? 1 : 3)
    tiled_attention_bwd_streamed_kernel(AttBwdArgs p) {
  constexpr int R = 1, NK = kStrKeys / 8, NO = kOutCols / 8;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const int t = p.t, hd = p.d / p.heads, w16 = r16(hd);
  const int kw = kF32 ? (hd + 7) / 8 * 8 : w16;  // the head's columns taken, as T4 staged's
  const StreamPlan L = streamed_plan(t, hd, sizeof(T), true);
  const int h = blockIdx.x % p.heads, an = blockIdx.x / p.heads;
  if (an >= valid_at(p.n_valid, p.nv_dev, p.n)) return;
  const size_t row0 = size_t(an) * t;
  const size_t off = row0 * p.P + (h / p.gh) * p.pw + (h % p.gh) * hd;
  const int kq = p.gh * hd, ld = L.ld;
  const T* base = static_cast<const T*>(p.qkv) + off;
  T* dbase = static_cast<T*>(p.dqkv) + off;
  const T* dob = static_cast<const T*>(p.do_c) + row0 * p.d + h * hd;
  // resident: Q | K | V | dO whole; else the round's two matrices | the slots
  T* r0 = reinterpret_cast<T*>(smem);
  T* r1 = r0 + size_t(L.resident ? L.t16 : L.round) * ld;
  T* whole[4];  // Q, K, V, dO
  for (int i = 0; i < 4; ++i) whole[i] = r0 + size_t(i) * L.t16 * ld;
  float4* rs = reinterpret_cast<float4*>(smem + L.stats);  // a row's max + log2(sum), -, delta
  Sweep<T> sw = make_sweep<T>(L, t, hd, r0 + size_t(2 * L.round) * ld);
  const float* st = p.stats + row0 * p.heads + h;
  const size_t plane = size_t(p.n) * t * p.heads;
  for (int i = threadIdx.x; i < 2 * L.t16; i += blockDim.x) {  // max and sum, zeros past t
    const int row = i >> 1, k = i & 1;
    float* dst = reinterpret_cast<float*>(rs + row) + k;
    cp_async_n(dst, row < t ? st + k * plane + size_t(row) * p.heads : st, 4, row < t ? 4 : 0);
  }
  if (L.resident) {
    stage_rows(whole[0], ld, base, p.P, t, L.t16, hd, w16);
    stage_rows(whole[1], ld, base + kq, p.P, t, L.t16, hd, w16);
    stage_rows(whole[2], ld, base + 2 * kq, p.P, t, L.t16, hd, w16);
    stage_rows(whole[3], ld, dob, p.d, t, L.t16, hd, w16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < L.t16; i += blockDim.x) {  // P = 2^(s sl - ml), 0 past t
    rs[i].x = i < t ? rs[i].x + __log2f(rs[i].y) : INFINITY;
    rs[i].y = rs[i].z = rs[i].w = 0.f;
  }
  __syncthreads();
  const float sl = p.scale * kLog2e;
  const int rounds = (L.t16 + L.round - 1) / L.round;
  const int nch = (kw + kOutCols - 1) / kOutCols;
  // the row tiles of 8 below t of a logits tile from row k0 (fp32; bf16 all nn, an even count)
  auto below = [&](int k0, int nn) { return kF32 ? min(nn, (t - k0 + 7) / 8) : nn; };
  // the round's rows of two matrices: resident, where they lie; else loaded into r0 and r1
  auto rows_of = [&](int r, const T* a, const T* b, size_t ldb, int ia, int ib, int (&m0)[R],
                     bool (&live)[R], const T* (&ra)[R], const T* (&rb)[R]) {
    round_rows<T, R>(L, r, t, L.resident ? whole[ia] : r0, m0, live, ra);
    round_rows<T, R>(L, r, t, L.resident ? whole[ib] : r1, m0, live, rb);
    if (L.resident) return;
    __syncthreads();  // the last round's rows are spent
    const int rr = r * L.round, n = min(L.round, t - rr);
    stage_rows(r0, ld, a + size_t(rr) * p.P, p.P, n, L.round, hd, w16);
    stage_rows(r1, ld, b + size_t(rr) * ldb, ldb, n, L.round, hd, w16);
    cp_async_commit();
  };
  // 1. the query pass: K and V swept
  sw.src[0] = base + kq;
  sw.src[1] = base + 2 * kq;
  sw.lds[0] = sw.lds[1] = p.P;
  sw.whole[0] = whole[1];
  sw.whole[1] = whole[2];
  for (int r = 0; r < rounds; ++r) {
    int m0[R];
    bool live[R];
    const T *qr[R], *dor[R];
    rows_of(r, base, dob, p.d, 0, 3, m0, live, qr, dor);
    sw.begin((1 + nch) * sw.nt);
    float ml[R][2], ds[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ml[i][e] = rs[min(m0[i] + g + 8 * e, L.t16 - 1)].x;
        ds[i][e] = 0.f;
      }
    // P (unrounded, zero past the tile's keys) and dP of the warp's rows against keys k0 ..
    auto probs = [&](float (&s)[R][NK][4], float (&dp)[R][NK][4], const T* kt, const T* vt,
                     int k0, int nn) {
      zero_rows(s);
      zero_rows(dp);
      if constexpr (kF32) {
        smm_rows2(s, qr[0], kt, dp, dor[0], vt, ld, kw, below(k0, nn));
      } else {
        smm_rows<T, R, NK>(s, qr, kt, ld, kw, nn);
        smm_rows<T, R, NK>(dp, dor, vt, ld, kw, nn);
      }
      if (k0 + 8 * nn > t) mask_keys(s, t - k0 - 2 * c, nn);
      probs_of(s, ml, sl, nn);
    };
    for (int j = 0; j < sw.nt; ++j) {  // delta
      const T* m[2];
      sw.step(j, m);
      if (!live[0]) continue;
      const int rows = min(L.kr, L.t16 - j * L.kr);
      for (int h0 = 0; h0 < rows; h0 += kStrKeys) {
        const int nn = min(kStrKeys, rows - h0) / 8;
        float s[R][NK][4], dp[R][NK][4];
        probs(s, dp, m[0] + size_t(h0) * ld, m[1] + size_t(h0) * ld, j * L.kr + h0, nn);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int jj = 0; jj < NK; ++jj)
            if (jj < nn)
#pragma unroll
              for (int e = 0; e < 4; ++e) ds[i][e / 2] += s[i][jj][e] * dp[i][jj][e];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ds[i][e] = quad_sum(ds[i][e]);
        if (live[i] && c == 0) rs[m0[i] + g + 8 * e].z = ds[i][e];
      }
    for (int c0 = 0; c0 < kw; c0 += kOutCols) {  // dQ
      const int no = min(kOutCols, kw - c0) / 8;
      float acc[R][NO][4];
      zero_rows(acc);
      for (int j = 0; j < sw.nt; ++j) {
        const T* m[2];
        sw.step(j, m);
        if (!live[0]) continue;
        const int rows = min(L.kr, L.t16 - j * L.kr);
        for (int h0 = 0; h0 < rows; h0 += kStrKeys) {
          const int nn = min(kStrKeys, rows - h0) / 8;
          float s[R][NK][4], dp[R][NK][4];
          probs(s, dp, m[0] + size_t(h0) * ld, m[1] + size_t(h0) * ld, j * L.kr + h0, nn);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int jj = 0; jj < NK; ++jj)
              if (jj < nn)
#pragma unroll
                for (int e = 0; e < 4; ++e)  // dS, rounded by the product (as A)
                  dp[i][jj][e] = s[i][jj][e] * (dp[i][jj][e] - ds[i][e / 2]) * p.scale;
          smm_frag_rows<T, R>(acc, dp, m[0] + size_t(h0) * ld, ld, c0, no,
                              below(j * L.kr + h0, nn));
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (live[i]) put_rows(acc[i], dbase, p.P, m0[i], c0, t, hd);
    }
  }
  __syncthreads();  // every row's delta is in shared memory
  // 2. the key pass: Q and dO swept
  sw.src[0] = base;
  sw.src[1] = dob;
  sw.lds[0] = p.P;
  sw.lds[1] = p.d;
  sw.whole[0] = whole[0];
  sw.whole[1] = whole[3];
  for (int r = 0; r < rounds; ++r) {
    int j0[R];
    bool live[R];
    const T *kr_[R], *vr[R];
    rows_of(r, base + kq, base + 2 * kq, p.P, 1, 2, j0, live, kr_, vr);
    sw.begin(nch * sw.nt);
    for (int c0 = 0; c0 < kw; c0 += kOutCols) {
      const int no = min(kOutCols, kw - c0) / 8;
      float av[R][NO][4], ak[R][NO][4];
      zero_rows(av);
      zero_rows(ak);
      for (int j = 0; j < sw.nt; ++j) {
        const T* m[2];  // Q, dO
        sw.step(j, m);
        if (!live[0]) continue;
        const int rows = min(L.kr, L.t16 - j * L.kr);
        for (int h0 = 0; h0 < rows; h0 += kStrKeys) {
          const int q0 = j * L.kr + h0, nn = min(kStrKeys, rows - h0) / 8, nb = below(q0, nn);
          const T* qt = m[0] + size_t(h0) * ld;
          const T* dot = m[1] + size_t(h0) * ld;
          float s[R][NK][4], dp[R][NK][4];  // S^T and dP^T: 16 keys x the tile's queries
          zero_rows(s);
          zero_rows(dp);
          if constexpr (kF32) {
            smm_rows2(s, kr_[0], qt, dp, vr[0], dot, ld, kw, nb);
          } else {
            smm_rows<T, R, NK>(s, kr_, qt, ld, kw, nb);
            smm_rows<T, R, NK>(dp, vr, dot, ld, kw, nb);
          }
          // P^T and dS^T (rounded by the products, as A); a query row past t has ml +inf: P 0
#pragma unroll
          for (int jj = 0; jj < NK; ++jj)
            if (jj < nn)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float4 q = rs[q0 + 8 * jj + 2 * c + e];
#pragma unroll
                for (int i = 0; i < R; ++i)
#pragma unroll
                  for (int u = 0; u < 2; ++u) {
                    const float pr = ex2(fmaf(s[i][jj][2 * u + e], sl, -q.x));
                    s[i][jj][2 * u + e] = pr;
                    dp[i][jj][2 * u + e] = pr * (dp[i][jj][2 * u + e] - q.z) * p.scale;
                  }
              }
          if constexpr (kF32) {
            smm_frag_rows2(av, s, dot, ak, dp, qt, ld, c0, no, nb);
          } else {
            smm_frag_rows<T, R>(av, s, dot, ld, c0, no, nb);
            smm_frag_rows<T, R>(ak, dp, qt, ld, c0, no, nb);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (live[i]) {
          put_rows(av[i], dbase + 2 * kq, p.P, j0[i], c0, t, hd);
          put_rows(ak[i], dbase + kq, p.P, j0[i], c0, t, hd);
        }
    }
  }
}

// ---- T1 "tma" (bf16): persistent 128-row blocks, x held once, the epilogue off the ring ----

constexpr int kT1Rows = 128;                   // rows a block: 64 a compute warpgroup
constexpr int kT1Cols = 128;                   // columns of an output tile (m64n128 each)
constexpr int kT1MaxStages = 8;                // the weight ring: as deep as fits, at most this
constexpr int kT1XBox = kT1Rows * kQkvBK * 2;  // x box [128 rows][64 k]: 16,384 B
constexpr int kT1WBox = kQkvBK * 64 * 2;       // weight box [64 k][64 n]: 8,192 B
constexpr int kT1WStage = 2 * kT1WBox;         // one k-tile of a tile's 128 columns
constexpr int kT1Out = kT1Rows * kT1Cols * 2;  // the output tile: [64 rows][64 n] boxes
constexpr int kT1MaxResident = 8;              // k-tiles of x held once: Din up to 512
static_assert(kT1Cols == 2 * 64 && kT1Rows == 2 * 64, "two warpgroups of m64n128");

// Shared memory of T1 "tma" (offsets from the 1,024-byte aligned base): x's
// k-tiles (where they are held once), the ring (each stage a weight k-tile
// and, where x is streamed, its x box; as many stages as fit, up to 8),
// the output tile, the barriers (full and empty a stage, then full and
// empty an x k-tile).
struct T1Plan {
  bool resident;
  int nk, stage, stages;
  size_t ring, out, bars, total;
};
__host__ __device__ inline T1Plan t1_plan(int din) {
  T1Plan L;
  L.nk = (din + kQkvBK - 1) / kQkvBK;
  L.resident = L.nk <= kT1MaxResident;
  L.stage = kT1WStage + (L.resident ? 0 : kT1XBox);
  L.ring = L.resident ? size_t(L.nk) * kT1XBox : 0;
  const size_t bar_bytes = 8 * (2 * kT1MaxStages + 2 * kT1MaxResident) + 1024;  // + alignment
  const size_t fits = (size_t(kSmemLimit) - L.ring - kT1Out - bar_bytes) / L.stage;
  L.stages = int(fits < size_t(kT1MaxStages) ? fits : size_t(kT1MaxStages));
  L.out = L.ring + size_t(L.stages) * L.stage;
  L.bars = L.out + kT1Out;
  L.total = L.bars + bar_bytes;
  return L;
}

// Barrier among the 128 threads of compute warpgroup cw (ids 2 and 3; csync is 1).
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
}

// T1 in bf16 (the fp32 one is tiled_qkv_kernel). Persistent CTAs, one an
// SM: CTA b takes the 128-row blocks b, b + CTAs, ...: warpgroups 0 and 1
// compute 64 rows each, warpgroup 2 produces (one thread issuing TMA). x's
// row block is loaded once for all P / 128 output tiles where its k-tiles
// fit (Din up to 512; each k-tile on its own barrier, reloaded for the next
// row block as soon as the last tile's products have read it, in step with
// the first tile's weight k-tiles; else its box rides each ring stage). The
// weight's k-tiles stream through a ring as deep as shared memory allows
// (5 stages at Din 400). Each warpgroup runs m64n128k16 wgmma and hands each
// stage back as soon as its products are done, so the next tile's k-tiles
// load while the epilogue runs: the accumulators go to bf16 in an output
// tile of its own (128-byte swizzled boxes), stored by TMA; a warpgroup
// whose rows straddle the valid count copies its rows below it by 16-byte
// stores. (Clusters of 2 multicasting the weight, as K1 does, and a second
// output tile in place of ring stages were slower in trial builds.)
__global__ void __launch_bounds__(kQkvThreads, 1)
    tiled_qkv_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap omap, QkvArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const T1Plan L = t1_plan(p.din);
  const int tid = threadIdx.x, nk = L.nk, S = L.stages, n_tiles = p.P / kT1Cols;
  const int valid = p.nv_dev != nullptr ? valid_at(0, p.nv_dev, p.n) * p.t : p.rows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* xfull = bars + 2 * S;
  uint64_t* xempty = xfull + kT1MaxResident;
  const QkvRing q{smem + L.ring, bars, bars + S, S, 1};
  if (tid == 0) {
    for (int k = 0; k < kT1MaxResident; ++k) {
      hop::mbar_init(&xfull[k], 1);
      hop::mbar_init(&xempty[k], kWarps);
    }
    qkv_ring_init(q);
  }
  __syncthreads();
  if (tid >= kThreads) {  // the producer warpgroup
    hop::regs_dec<40>();
    if (tid != kThreads) return;
    hop::tma_prefetch_map(&xmap);
    hop::tma_prefetch_map(&wmap);
    int it = 0, xi = 0;
    for (int rb = blockIdx.x; (long long)rb * kT1Rows < valid; rb += gridDim.x, ++xi) {
      const int row0 = rb * kT1Rows;
      for (int ct = 0; ct < n_tiles; ++ct)
        for (int kt = 0; kt < nk; ++kt, ++it) {
          if (L.resident && ct == 0) {  // x's k-tile, once the last row block's products read it
            hop::mbar_wait(&xempty[kt], (xi & 1) ^ 1);
            hop::mbar_expect_tx(&xfull[kt], kT1XBox);
            hop::tma_load_2d(smem + size_t(kt) * kT1XBox, &xmap, &xfull[kt], kt * kQkvBK, row0);
          }
          const int s = it % S;
          hop::mbar_wait(&q.empty[s], ((it / S) & 1) ^ 1);
          hop::mbar_expect_tx(&q.full[s], L.stage);
          unsigned char* st = q.ring + size_t(s) * L.stage;
          for (int j = 0; j < 2; ++j)
            hop::tma_load_2d(st + kT1WBox * j, &wmap, &q.full[s], ct * kT1Cols + 64 * j,
                             kt * kQkvBK);
          if (!L.resident) hop::tma_load_2d(st + kT1WStage, &xmap, &q.full[s], kt * kQkvBK, row0);
        }
    }
    return;
  }
  hop::regs_inc<232>();
  const int cw = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, wtid = tid % 128;
  unsigned char* out_s = smem + L.out + size_t(cw) * (kT1Out / 2);  // two boxes [64][64]
  bf16* out = static_cast<bf16*>(p.qkv);
  auto x_release = [&](int kt) {
    if (lane == 0) hop::mbar_arrive(&xempty[kt]);
  };
  int it = 0, xi = 0;
  for (int rb = blockIdx.x; (long long)rb * kT1Rows < valid; rb += gridDim.x, ++xi) {
    const int wrow0 = rb * kT1Rows + 64 * cw;  // the warpgroup's first row
    const bool by_tma = wrow0 + 64 <= valid || valid >= p.rows;
    for (int ct = 0; ct < n_tiles; ++ct) {
      const bool last = ct == n_tiles - 1;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        hop::mbar_wait(&q.full[s], (it / S) & 1);
        if (L.resident && ct == 0) hop::mbar_wait(&xfull[kt], xi & 1);
        const unsigned char* st = q.ring + size_t(s) * L.stage;
        const unsigned char* xa =
            (L.resident ? smem + size_t(kt) * kT1XBox : st + kT1WStage) + cw * (kT1XBox / 2);
        hop::wgmma_fence();
        // all four k-steps of every k-tile (TMA fills zeros past Din): a wgmma under a branch
        // costs the kernel's products a warpgroup wait each
#pragma unroll
        for (int kk = 0; kk < kQkvBK / 16; ++kk)
          hop::wgmma_m64n128k16<0, 1>(acc, hop::smem_desc(xa + kk * 32, 16, 1024),
                                      hop::smem_desc(st + kk * 2048, kT1WBox, 1024));
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // k-tile it - 1 is consumed
        if (kt > 0) {
          qkv_release(q, (it - 1) % S);
          if (L.resident && last) x_release(kt - 1);
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      qkv_release(q, (it - 1) % S);
      if (L.resident && last) x_release(nk - 1);
      // the epilogue: the output tile is free once the last tile's store has read it
      if (wtid == 0) hop::bulk_wait_read<0>();
      wg_sync(cw);
      // thread (warp, lane) holds rows r, r + 8 and columns 8 j + 2 (lane % 4) + {0, 1}; in a
      // 128-byte swizzled box, 16-byte chunk k of row r sits at chunk k ^ (r % 8)
      const int r = warp * 16 + lane / 4, sw = lane / 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        unsigned char* box =
            out_s + (j / 8) * (kT1Out / 4) + (((j % 8) ^ sw) * 16) + 4 * (lane % 4);
        *reinterpret_cast<uint32_t*>(box + r * 128) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(box + (r + 8) * 128) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hop::fence_proxy_async();  // the stores above come before the TMA store's reads
      wg_sync(cw);
      if (by_tma) {
        if (wtid == 0) {
          hop::tma_store_2d(&omap, out_s, ct * kT1Cols, wrow0);
          hop::tma_store_2d(&omap, out_s + kT1Out / 4, ct * kT1Cols + 64, wrow0);
          hop::bulk_commit();
        }
      } else {  // rows below the valid count only
        const int live = max(0, min(64, valid - wrow0));
        for (int i = wtid; i < live * 16; i += 128) {
          const int rr = i / 16, ch = i % 16;
          const uint4 v = *reinterpret_cast<const uint4*>(out_s + (ch / 8) * (kT1Out / 4) +
                                                          rr * 128 + (((ch % 8) ^ (rr % 8)) * 16));
          *reinterpret_cast<uint4*>(out + size_t(wrow0 + rr) * p.P + ct * kT1Cols + ch * 8) = v;
        }
      }
    }
  }
  if (wtid == 0) hop::bulk_wait<0>();
}

// ---- T3 "resident": W_att held in shared memory by a persistent block ----

constexpr int kPoolChunk = 64;  // columns of o (the z product's depth) a chunk
constexpr int kPoolMaxT = 128;  // T rounded up to 16 at most this (dvals: a row per two threads)
constexpr int kPoolMaxA = 256;  // padded attention width at most this
constexpr int kPoolMG = 2;      // warps: m-tile groups (m-tiles mg, mg + 2, ...)
constexpr int kPoolNG = 4;      // x column groups (16-column pairs split evenly)
constexpr int kPoolMT = kPoolMaxT / 16 / kPoolMG;  // m-tiles a warp at most
constexpr int kPoolNT = kPoolMaxA / 8 / kPoolNG;   // 8-column tiles a warp at most
static_assert(kPoolMG * kPoolNG == kWarps && 2 * kPoolMaxT == kThreads, "T3 resident warp map");

// Shared memory of T3 "resident" (byte offsets): W_att [d16][ldw] (rows
// past D zero), region R (the chunks of round(o) [t16][lda], 2 or 3; then the
// forward's weighted-sum partials [8][256] fp32, or the backward's
// round(dz) [t16][ldz]), then fp32 arrays: b_att, round(q_att), the
// logits (the backward's datt after the softmax), the weights, the
// backward's dvals and g, a scratch of the logits' partials [4][t16] or
// the backward's db and dq column partials [2][2][a_pad], and the
// backward's stream-1 mask bits of each warp's do unit [8][32 rows][2].
struct PoolPlan {
  int t16, d16, ldw, lda;
  size_t r, b, q, att, wts, dv, g, scr, mb, total;
};
__host__ __device__ inline PoolPlan pool_plan(int t, int d, int a_pad, int elem, bool bwd) {
  PoolPlan L;
  L.t16 = r16(t);
  L.d16 = r16(d);
  L.ldw = pad_ld(a_pad, elem);
  L.lda = pad_ld(kPoolChunk, elem);
  L.r = align128(size_t(L.d16) * L.ldw * elem);
  // chunk buffers: 2 where the forward rounds fp32 o through registers (bf16), else 3 (cp.async)
  const int bufs = bwd || elem == 4 ? 3 : 2;
  size_t r = smax(bufs * size_t(L.t16) * L.lda * elem, size_t(kWarps) * 256 * 4);
  if (bwd) r = smax(r, size_t(L.t16) * L.ldw * elem);
  L.b = L.r + align128(r);
  L.q = L.b + size_t(a_pad) * 4;
  L.att = L.q + size_t(a_pad) * 4;
  L.wts = L.att + size_t(L.t16) * 4;
  L.dv = L.wts + size_t(L.t16) * 4;
  L.g = L.dv + (bwd ? size_t(L.t16) * 4 : 0);
  L.scr = L.g + (bwd ? size_t(d) * 4 : 0);
  L.mb = L.scr + smax(size_t(kPoolNG) * L.t16, size_t(2 * kPoolMG) * a_pad) * 4;
  L.total = L.mb + (bwd ? size_t(kWarps) * 64 * 4 : 0);
  return L;
}

// Whether a "resident" request fits: T16 and a_pad within the warp map, the
// layout within a block's shared memory.
inline bool pool_fits(int t, int d, int a_pad, int elem, bool bwd) {
  return r16(t) <= kPoolMaxT && a_pad <= kPoolMaxA &&
         pool_plan(t, d, a_pad, elem, bwd).total <= size_t(kSmemLimit);
}

// Element j of a 16-byte piece of the compute dtype, as fp32.
template <typename T>
__device__ __forceinline__ float piece_at(const uint4& u, int j) {
  const int i = std::is_same<T, bf16>::value ? j / 2 : j;  // the 32-bit word
  const uint32_t w = i < 2 ? (i < 1 ? u.x : u.y) : (i < 3 ? u.z : u.w);
  if (std::is_same<T, bf16>::value) return __uint_as_float(j % 2 ? w & 0xffff0000u : w << 16);
  return __uint_as_float(w);
}

// tanh(x) = sign(x) (1 - 2 / (exp(2 |x|) + 1)) on the special-function unit (ex2 and rcp):
// within about 1e-7 of tanhf, and a few instructions where tanhf inlines tens (the logits
// call it 128 times a thread, unrolled).
__device__ __forceinline__ float tanh_fast(float x) {
  return copysignf(1.f - __fdividef(2.f, __expf(2.f * fabsf(x)) + 1.f), x);
}

// T3, resident: a persistent block per SM loads W_att (and b_att, round(q))
// once by cp.async and walks articles an = blockIdx.x, + gridDim.x, ...
// For each, z = round(o) round(W_att) runs once, on tensor cores from
// shared memory (bf16: mma.sync m16n8k16 with ldmatrix; fp32: FMA with the
// same fragment ownership), over 64-column chunks of o: the backward's
// round(o) by cp.async into three buffers (two chunks in flight), the
// forward's fp32 o read once by float4 and rounded on its way into one of
// two buffers (one chunk in flight, in registers). The article's rows are
// whole m16 tiles (T 100 is 7); warp (mg, ng) keeps z of m-tiles mg, mg +
// 2, ... and its column group's tiles in registers (4 x 8 x 4 floats; all
// of them are computed, without a branch between the products, and the
// ones past the article or the group are dropped). Then tanh(z + b) in
// place, the logits (quad sums, then the 4 groups' partials in a fixed
// order), the softmax. Forward: the weighted sum of the fp32 o (again, from
// L2), a warp's rows of 256 columns loaded together, the 8 warps' partials
// summed in a fixed order. Backward: dvals = round(o) round(g) taken from
// the chunks as they pass, datt, then dz = round(datt) round(q) (1 -
// tanh^2) from the registers; the db and dq column sums (shuffles over the
// rows, the two m-groups in order), round(dz) into a shared tile, to device
// memory by 16-byte stores, and do = (w g + round(dz) round(W)^T) * mask
// from the tile and W_att (ldmatrix) by 32-row x 64-column units. Every
// output has one writer; no atomics. It runs at several times its bytes
// bound (PERF.md); not traced by a committed tool, the likely cause is the
// eight warps an SM, each phase waiting on its own loads and shared-memory
// fragments, with the serial steps between phases.
template <typename T, typename S, bool kBwd>
__global__ void __launch_bounds__(kThreads, 1) tiled_pool_resident_kernel(PoolArgs p) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int E = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const PoolPlan L = pool_plan(p.t, p.d, p.a_pad, E, kBwd);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int t = p.t, d = p.d, a = p.a, a_pad = p.a_pad;
  const int mt16 = L.t16 / 16, nk = (d + kPoolChunk - 1) / kPoolChunk;
  const int mg = warp % kPoolMG, ng = warp / kPoolMG;
  // the warp's columns: 16-column pairs [p0, p1) of the a_pad / 16, split evenly over the groups
  const int np = a_pad / 16, p0 = ng * np / kPoolNG, p1 = (ng + 1) * np / kPoolNG;
  const int n0 = 16 * p0, nt = 2 * (p1 - p0);  // first column, 8-column tiles
  T* ws = reinterpret_cast<T*>(smem);
  T* abuf = reinterpret_cast<T*>(smem + L.r);
  float* bs = reinterpret_cast<float*>(smem + L.b);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* att = reinterpret_cast<float*>(smem + L.att);
  float* wts = reinterpret_cast<float*>(smem + L.wts);
  float* dvs = reinterpret_cast<float*>(smem + L.dv);
  float* gs = reinterpret_cast<float*>(smem + L.g);
  float* scr = reinterpret_cast<float*>(smem + L.scr);
  const int valid = valid_at(p.n_valid, p.nv_dev, p.n);
  stage(ws, L.ldw, static_cast<const T*>(p.w_att), size_t(a_pad), d, L.d16, a_pad, a_pad);
  cp_async_commit();
  for (int j = tid; j < a_pad; j += kThreads) {
    bs[j] = j < a ? p.b_att[j] : 0.f;
    qs[j] = j < a ? rnd<T>(p.q_att[j]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  philox::Dropout dr = p.dr;
  dr.key = philox::key_at(dr.key, p.seed_dev);
  for (int an = blockIdx.x; an < p.n; an += gridDim.x) {
    if (an >= valid) {  // zeros out, or zero partials
      for (int i = tid; i < (kBwd ? 0 : d); i += kThreads) p.out[size_t(an) * d + i] = 0.f;
      for (int j = tid; j < (kBwd ? a_pad : 0); j += kThreads) {
        p.db_part[size_t(an) * a_pad + j] = 0.f;
        p.dq_part[size_t(an) * a_pad + j] = 0.f;
      }
      continue;
    }
    const size_t row0 = size_t(an) * t;
    const S* src = static_cast<const S*>(p.src) + row0 * p.lds;
    if constexpr (kBwd)
      for (int i = tid; i < d; i += kThreads) gs[i] = p.g[size_t(an) * d + i];
    // the A chunks: cp.async where o comes in the compute dtype, else fp32 loads held in
    // registers across the products and rounded into the buffer after them
    constexpr bool kCopy = std::is_same<T, S>::value;
    constexpr int kBufs = kCopy ? 3 : 2, kAhead = kBufs - 1;
    constexpr int kPf = kCopy ? 1 : kPoolMaxT * kPoolChunk / 4 / kThreads;
    float4 pf[kPf];
    const bool v4 = p.lds % 4 == 0;
    auto buf = [&](int kc) { return abuf + (kc % kBufs) * L.t16 * L.lda; };
    auto issue = [&](int kc) {
      const int k0 = kc * kPoolChunk;
      if constexpr (kCopy) {
        stage(buf(kc), L.lda, src + k0, p.lds, t, L.t16, min(kPoolChunk, d - k0), kPoolChunk);
        cp_async_commit();
      } else {
#pragma unroll
        for (int i = 0; i < kPf; ++i) {
          const int e = tid + kThreads * i, r = e / (kPoolChunk / 4), col = k0 + e % (kPoolChunk / 4) * 4;
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (r < t) {
            const S* s = src + size_t(r) * p.lds + col;
            if (v4 && col + 3 < d) {
              const float4 u = *reinterpret_cast<const float4*>(s);
              v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) v[k] = col + k < d ? to_f<S>(s[k]) : 0.f;
            }
          }
          pf[i] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    };
    auto land = [&](int kc) {
      if constexpr (!kCopy) {
        T* dst = buf(kc);
#pragma unroll
        for (int i = 0; i < kPf; ++i) {
          const int e = tid + kThreads * i, r = e / (kPoolChunk / 4), c4 = e % (kPoolChunk / 4) * 4;
          if (r < L.t16)
            *reinterpret_cast<uint2*>(dst + r * L.lda + c4) =
                make_uint2(pack_bf16(pf[i].x, pf[i].y), pack_bf16(pf[i].z, pf[i].w));
        }
      }
    };
    float acc[kPoolMT][kPoolNT][4];
#pragma unroll
    for (int u = 0; u < kPoolMT; ++u) zero_frag(acc[u]);
    float dv = 0.f;  // the backward's dvals: row tid / 2, half tid % 2 of each chunk's columns
    issue(0);
    land(0);
    if (kAhead > 1 && nk > 1) issue(1);
    for (int kc = 0; kc < nk; ++kc) {
      const int k0 = kc * kPoolChunk, ks = min(kPoolChunk / 16, (d - k0 + 15) / 16);
      if (kAhead > 1 && kc + 1 < nk)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // chunk kc is in; chunk kc - 1's buffer is spent
      if (kc + kAhead < nk) issue(kc + kAhead);
      const T* A = buf(kc);
      if constexpr (kBf) {
        // every warp runs all 4 x 8 tiles' products, without a branch between them (a
        // predicated mma.sync costs a warp sync): the tiles past the article's m-tiles or
        // past the warp's columns read clamped, valid rows and columns, and their sums are
        // never read
        for (int kk = 0; kk < ks; ++kk) {
          uint32_t fb[kPoolNT / 2][4];
#pragma unroll
          for (int jp = 0; jp < kPoolNT / 2; ++jp)
            ldb_kn(fb[jp], ws, L.ldw, k0 + 16 * kk, min(n0 + 16 * jp, a_pad - 16));
#pragma unroll
          for (int u = 0; u < kPoolMT; ++u) {
            uint32_t fa[4];
            lda_rm(fa, A, L.lda, 16 * min(mg + kPoolMG * u, mt16 - 1), 16 * kk);
#pragma unroll
            for (int jp = 0; jp < kPoolNT / 2; ++jp)
              mma_pair(acc[u][2 * jp], acc[u][2 * jp + 1], fa, fb[jp]);
          }
        }
      } else {
        for (int k = 0; k < 16 * ks; ++k) {
          const T* wr = ws + size_t(k0 + k) * L.ldw + n0 + 2 * c;
#pragma unroll
          for (int u = 0; u < kPoolMT; ++u) {
            const int i = mg + kPoolMG * u;
            if (i < mt16) {
              const float a0 = A[(16 * i + g) * L.lda + k], a1 = A[(16 * i + g + 8) * L.lda + k];
#pragma unroll
              for (int j = 0; j < kPoolNT; ++j)
                if (j < nt) {
                  const float b0 = wr[8 * j], b1 = wr[8 * j + 1];
                  acc[u][j][0] += a0 * b0;
                  acc[u][j][1] += a0 * b1;
                  acc[u][j][2] += a1 * b0;
                  acc[u][j][3] += a1 * b1;
                }
            }
          }
        }
      }
      if constexpr (kBwd) {  // 32 columns a thread, 16 bytes at a time
        constexpr int kV = 16 / E;
        const int r = tid / 2, c0 = 32 * (tid % 2), kv = min(kPoolChunk, d - k0);
        if (r < t)
#pragma unroll
          for (int k8 = 0; k8 < 32; k8 += kV)
            if (c0 + k8 < kv) {
              const uint4 u = *reinterpret_cast<const uint4*>(A + r * L.lda + c0 + k8);
#pragma unroll
              for (int j = 0; j < kV; ++j)
                if (c0 + k8 + j < kv) dv += piece_at<T>(u, j) * rnd<T>(gs[k0 + c0 + k8 + j]);
            }
      }
      if (kAhead == 1 && kc + 1 < nk) land(kc + 1);
    }
    // tanh(z + b) (kept in acc by the backward) and the logits' partial sums
    float rs[kPoolMT][2], bc[kPoolNT][2], qc[kPoolNT][2];
#pragma unroll
    for (int j = 0; j < kPoolNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // qc 0 marks a column past a (or past the warp's)
        const int col = n0 + 8 * j + 2 * c + e;
        const bool in = j < nt && col < a;
        bc[j][e] = in ? bs[col] : 0.f;
        qc[j][e] = in ? qs[col] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kPoolMT; ++u) {
      rs[u][0] = rs[u][1] = 0.f;
      const bool live = mg + kPoolMG * u < mt16;
#pragma unroll
      for (int j = 0; j < kPoolNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * c + e % 2;
          const float h = live && j < nt && col < a ? tanh_fast(acc[u][j][e] + bc[j][e % 2]) : 0.f;
          acc[u][j][e] = h;
          rs[u][e / 2] += rnd<T>(h) * qc[j][e % 2];
        }
      rs[u][0] = quad_sum(rs[u][0]);
      rs[u][1] = quad_sum(rs[u][1]);
    }
    if constexpr (kBwd) {
      dv += __shfl_xor_sync(0xffffffffu, dv, 1);
      if (tid % 2 == 0 && tid / 2 < L.t16) dvs[tid / 2] = dv;
    }
    // the forward's weighted sum: a warp's rows of 256 columns loaded together (the first
    // 256 before the softmax, which they do not need), then summed
    constexpr int kRw = kPoolMaxT / kWarps, kCw = 2;  // rows a warp at most; float4 a lane
    float4 ov[kCw][kRw];
    auto load_o = [&](int cb) {
#pragma unroll
      for (int h = 0; h < kCw; ++h)
#pragma unroll
        for (int k = 0; k < kRw; ++k) {
          const int r = warp + kWarps * k, col = cb + 128 * h + 4 * lane;
          float u[4] = {0.f, 0.f, 0.f, 0.f};
          if (r < t && col < d) {
            const S* sp = src + size_t(r) * p.lds + col;
            if (v4 && col + 3 < d) {
              const float4 w4 = *reinterpret_cast<const float4*>(sp);
              u[0] = w4.x, u[1] = w4.y, u[2] = w4.z, u[3] = w4.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) u[e] = col + e < d ? to_f<S>(sp[e]) : 0.f;
            }
          }
          ov[h][k] = make_float4(u[0], u[1], u[2], u[3]);
        }
    };
    if (!kBwd) load_o(0);
    __syncthreads();  // every warp is done with the chunks (R is free)
    if (c == 0)
#pragma unroll
      for (int u = 0; u < kPoolMT; ++u) {
        const int i = mg + kPoolMG * u;
        if (i < mt16) {
          scr[ng * L.t16 + 16 * i + g] = rs[u][0];
          scr[ng * L.t16 + 16 * i + g + 8] = rs[u][1];
        }
      }
    __syncthreads();
    for (int r = tid; r < t; r += kThreads) {
      float v = 0.f;
      for (int k = 0; k < kPoolNG; ++k) v += scr[k * L.t16 + r];
      att[r] = v;
    }
    __syncthreads();
    pooling_softmax(att, 1, t, wts);
    __syncthreads();
    if constexpr (!kBwd) {
      // out = sum over t of the fp32 o's rows times their weights
      float* part = reinterpret_cast<float*>(smem + L.r);  // [8][256]
      for (int cb = 0; cb < d; cb += 128 * kCw) {
        if (cb > 0) load_o(cb);
#pragma unroll
        for (int h = 0; h < kCw; ++h) {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < kRw; ++k) {
            const int r = warp + kWarps * k;
            const float w = r < t ? wts[r] : 0.f;
            v[0] += w * ov[h][k].x, v[1] += w * ov[h][k].y, v[2] += w * ov[h][k].z,
                v[3] += w * ov[h][k].w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) part[warp * 256 + 128 * h + 4 * lane + k] = v[k];
        }
        __syncthreads();
        if (cb + tid < d) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += part[w * 256 + tid];
          p.out[size_t(an) * d + cb + tid] = s;
        }
        __syncthreads();
      }
    } else {
      // datt = round(w (dvals - sum w dvals)) into att, zero past t
      if (warp == 0) {
        float v = 0.f;
        for (int r = lane; r < t; r += 32) v += wts[r] * dvs[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        for (int r = lane; r < L.t16; r += 32) att[r] = r < t ? rnd<T>(wts[r] * (dvs[r] - v)) : 0.f;
      }
      __syncthreads();
      // dz from the registers; the db and dq column sums; round(dz) into the tile
      T* dzs = reinterpret_cast<T*>(smem + L.r);
#pragma unroll
      for (int j = 0; j < kPoolNT; ++j) {
        float sdb[2] = {0.f, 0.f}, sdq[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < kPoolMT; ++u) {
          const int i = mg + kPoolMG * u;
          if (i >= mt16 || j >= nt) continue;
          float z[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * i + g + 8 * (e / 2), col = n0 + 8 * j + 2 * c + e % 2;
            const float h = acc[u][j][e], da = att[row];
            z[e] = col < a ? da * qs[col] * (1.f - h * h) : 0.f;
            sdb[e % 2] += z[e];
            sdq[e % 2] += rnd<T>(h) * da;
          }
          T* q0 = dzs + (16 * i + g) * L.ldw + n0 + 8 * j + 2 * c;
          T* q1 = q0 + 8 * L.ldw;
          if constexpr (kBf) {
            *reinterpret_cast<uint32_t*>(q0) = pack_bf16(z[0], z[1]);
            *reinterpret_cast<uint32_t*>(q1) = pack_bf16(z[2], z[3]);
          } else {
            *reinterpret_cast<float2*>(q0) = make_float2(z[0], z[1]);
            *reinterpret_cast<float2*>(q1) = make_float2(z[2], z[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sdb[e] += __shfl_xor_sync(0xffffffffu, sdb[e], off);
            sdq[e] += __shfl_xor_sync(0xffffffffu, sdq[e], off);
          }
        if (g == 0 && j < nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * j + 2 * c + e;
            scr[mg * a_pad + col] = sdb[e];
            scr[(kPoolMG + mg) * a_pad + col] = sdq[e];
          }
      }
      __syncthreads();
      for (int j = tid; j < a_pad; j += kThreads) {
        p.db_part[size_t(an) * a_pad + j] = scr[j] + scr[a_pad + j];
        p.dq_part[size_t(an) * a_pad + j] = scr[2 * a_pad + j] + scr[3 * a_pad + j];
      }
      // round(dz) of the article's rows to device memory, 16 bytes a thread
      T* dzg = static_cast<T*>(p.dz_c) + row0 * a_pad;
      const int per = a_pad * E / 16;
      for (int i = tid; i < t * per; i += kThreads) {
        const int r = i / per, cc = i % per * (16 / E);
        *reinterpret_cast<uint4*>(dzg + size_t(r) * a_pad + cc) =
            *reinterpret_cast<const uint4*>(dzs + r * L.ldw + cc);
      }
      // do = (w g + round(dz) round(W)^T) * mask by units of 16 rows x 64 columns, each warp
      // a contiguous range of them
      // do = (w g + round(dz) round(W)^T) * mask by units of 32 rows (two m-tiles) x 64
      // columns, each warp a contiguous range of them: W's fragments taken once a k-step for
      // both m-tiles. The stream-1 mask of a unit comes first as bits in the warp's words
      // (a Philox block a 4 columns, in a loop that is not unrolled), then the epilogue
      // reads them.
      T* doc = static_cast<T*>(p.do_c) + row0 * d;
      uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + L.mb) + warp * 64;  // [32 rows][2]
      const int npair = (mt16 + 1) / 2, ncb = (d + 63) / 64, units = npair * ncb;
      const int ks = a_pad / 16;
      for (int u = warp * units / kWarps; u < (warp + 1) * units / kWarps; ++u) {
        const int m0 = 32 * (u / ncb), c0 = 64 * (u % ncb), nn = min(8, (L.d16 - c0) / 8);
        const bool two = m0 + 16 < L.t16;
        float o8[2][8][4];
        zero_frag(o8[0]);
        zero_frag(o8[1]);
        if constexpr (kBf) {
          for (int kk = 0; kk < ks; ++kk) {  // unconditional, on clamped rows and columns
            uint32_t fb[4][4];
#pragma unroll
            for (int jp = 0; jp < 4; ++jp)
              ldb_nk(fb[jp], ws, L.ldw, 16 * kk, min(c0 + 16 * jp, L.d16 - 16));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t fa[4];
              lda_rm(fa, dzs, L.ldw, min(m0 + 16 * h, L.t16 - 16), 16 * kk);
#pragma unroll
              for (int jp = 0; jp < 4; ++jp) mma_pair(o8[h][2 * jp], o8[h][2 * jp + 1], fa, fb[jp]);
            }
          }
        } else {
          smm<T, 8, false, false>(o8[0], dzs, L.ldw, m0, ws, L.ldw, c0, ks, nn);
          if (two) smm<T, 8, false, false>(o8[1], dzs, L.ldw, m0 + 16, ws, L.ldw, c0, ks, nn);
        }
        if (dr.thr_att) {
          __syncwarp();  // the last unit's bits are read
#pragma unroll 1
          for (int w = lane; w < 64; w += 32) {  // word w: row w / 2, columns 32 (w % 2) + [0, 32)
            const int row = m0 + w / 2;
            uint32_t bits = 0;
#pragma unroll 1
            for (int q = 0; q < 8; ++q) {
              const int col = c0 + 32 * (w % 2) + 4 * q;
              if (row < t && col < d) {
                const uint4 pb = philox::philox4x32_10(
                    make_uint4(uint32_t(row0 + row), uint32_t(col >> 2), 1u, 0u), dr.key);
                bits |= (uint32_t((pb.x >> 8) < dr.thr_att) | uint32_t((pb.y >> 8) < dr.thr_att) << 1 |
                         uint32_t((pb.z >> 8) < dr.thr_att) << 2 |
                         uint32_t((pb.w >> 8) < dr.thr_att) << 3) << (4 * q);
              }
            }
            mbits[w] = bits;
          }
          __syncwarp();
        }
        // the epilogue: lane (g, c) holds rows m0 + 16 h + g + 8 hh, columns c0 + 8 j + 2 c + {0, 1}
        const int mode = dr.thr_att ? 1 : p.ext != nullptr ? 2 : 0;  // mask bits, external, none
        const bool pairs = d % 2 == 0;  // a column pair is one aligned 4- or 8-byte store
        float gc[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * j + 2 * c + e;
            gc[j][e] = col < d ? gs[col] : 0.f;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + 16 * h + g + 8 * hh;
            if (row >= t) continue;
            const float w = wts[row];
            T* orow = doc + size_t(row) * d;
            const uint32_t* bits = mbits + (row - m0) * 2;
            const float* xrow = mode == 2 ? p.ext + (row0 + row) * d : nullptr;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = c0 + 8 * j + 2 * c;
              if (col >= d) continue;
              float v0 = w * gc[j][0] + o8[h][j][2 * hh], v1 = w * gc[j][1] + o8[h][j][2 * hh + 1];
              if (mode == 1) {
                const uint32_t b = bits[(col - c0) / 32] >> ((col - c0) % 32);
                v0 *= b & 1u ? dr.inv_att : 0.f;
                v1 *= b & 2u ? dr.inv_att : 0.f;
              } else if (mode == 2) {
                v0 *= xrow[col] * p.inv_ext;
                v1 *= col + 1 < d ? xrow[col + 1] * p.inv_ext : 0.f;
              }
              if (pairs) {
                if constexpr (kBf)
                  *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
                else
                  *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
              } else {
                orow[col] = from_f<T>(v0);
                if (col + 1 < d) orow[col + 1] = from_f<T>(v1);
              }
            }
          }
      }
    }
    __syncthreads();  // R, g and the arrays are spent before the next article
  }
}

// ---- T3 "streamed": W_att held, the article walked in rounds of 128 rows ----

constexpr int kPoolRound = kPoolMaxT;      // rows of a round: the resident kernel's warp map
constexpr int kPoolHalf = kPoolRound / 2;  // rows of the backward's round(dz) tile

// Shared memory of T3 "streamed" (byte offsets): W_att [d16][ldw] as the
// resident kernel's; region R: two chunks of a round's round(o) [128][lda]
// (or the forward's weighted-sum partials [8][256] fp32, or the backward's
// round(dz) tile of half a round [64][ldw]); then fp32 arrays: b_att,
// round(q_att), the article's logits (the backward's datt after the
// softmax), its weights, the backward's dvals [t16] and g [d], a scratch of
// a round's logit partials [4][128] or the backward's db and dq column sums
// [2][2][a_pad], and the backward's mask bits (the resident kernel's [8][64]
// words; its 32 x 32 do units use [8][32]). Only the [t16] arrays grow
// with T.
struct PoolStreamPlan {
  int t16, d16, ldw, lda;
  size_t r, b, q, att, wts, dv, g, scr, mb, total;
};
__host__ __device__ inline PoolStreamPlan pool_stream_plan(int t, int d, int a_pad, int elem,
                                                           bool bwd) {
  PoolStreamPlan L;
  L.t16 = r16(t);
  L.d16 = r16(d);
  L.ldw = pad_ld(a_pad, elem);
  L.lda = pad_ld(kPoolChunk, elem);
  L.r = align128(size_t(L.d16) * L.ldw * elem);
  size_t r = smax(2 * size_t(kPoolRound) * L.lda * elem, size_t(kWarps) * 256 * 4);
  if (bwd) r = smax(r, size_t(kPoolHalf) * L.ldw * elem);
  L.b = L.r + align128(r);
  L.q = L.b + size_t(a_pad) * 4;
  L.att = L.q + size_t(a_pad) * 4;
  L.wts = L.att + size_t(L.t16) * 4;
  L.dv = L.wts + size_t(L.t16) * 4;
  L.g = L.dv + (bwd ? size_t(L.t16) * 4 : 0);
  L.scr = L.g + (bwd ? size_t(d) * 4 : 0);
  L.mb = L.scr + smax(size_t(kPoolNG) * kPoolRound, bwd ? size_t(2 * kPoolMG) * a_pad : 0) * 4;
  L.total = L.mb + (bwd ? size_t(kWarps) * 64 * 4 : 0);
  return L;
}

// The streamed kernel's rounds of 128 rows for articles of t rows; its
// backward keeps each round's tanh in a scratch of
// pool_stream_rounds(t) * 32,768 floats a block (``att``).
__host__ __device__ inline int pool_stream_rounds(int t) {
  return (r16(t) + kPoolRound - 1) / kPoolRound;
}

// Whether a "streamed" request fits: a_pad within the warp map, the layout
// within a block's shared memory (any T while its [t16] arrays fit).
inline bool pool_stream_fits(int t, int d, int a_pad, int elem, bool bwd) {
  return a_pad <= kPoolMaxA && pool_stream_plan(t, d, a_pad, elem, bwd).total <= size_t(kSmemLimit);
}

// T3, streamed: past the resident kernel's reach (T rounded up to 16 past
// 128, or a layout the resident one's three chunk buffers do not leave
// room for), for a_pad <= 256. A persistent block per SM holds W_att (and
// b_att, round(q)) in shared memory, as the resident kernel does, and walks
// each article in rounds of at most 128 rows with the resident kernel's
// warp map of z in registers (warp (mg, ng): m-tiles mg, mg + 2, ... of the
// round, its column group's tiles). Only the article's [t16] arrays stay
// whole in shared memory: nothing of z outlives its round. A round's z =
// round(o) round(W_att) runs over 64-column chunks of o in two buffers
// (the next chunk in flight while the current one is used: round(o) by
// cp.async in the backward, the forward's fp32 o by float4 loads held in
// registers and rounded into the buffer after the products), then tanh(z +
// b) and the round's logits. After the last round the softmax over the
// article's T rows. Forward: the weighted sum of the fp32 o by rounds (a
// warp's 16 rows of a round and 256 columns loaded together), the 8 warps'
// partials summed in a fixed order. Backward: the first sweep also takes
// dvals = round(o) round(g) from the chunks, and each thread writes its
// fragments of the round's tanh to the block's scratch in device memory
// (``att``: 128 KB a round, so at the history-200 user tower 256 KB a
// block and 34 MB in all, which L2 holds; the same thread reads them back,
// so no barrier orders them). datt = round(w (dvals - sum w dvals)). A
// second sweep of the rounds takes each round's tanh back into the
// registers, then dz = round(datt) round(q) (1 - tanh^2), the db and dq
// column sums added to shared memory by their one warp (the rounds in
// order), round(dz) of the round's first 64 rows into a tile in R and of
// the rest straight to device memory; a half-round at a time, round(dz) in
// the tile (the second half back from L2), to device memory by 16-byte
// stores, and do = (w g + round(dz) round(W)^T) * mask from the tile and
// W_att by 32-row x 32-column units (the stream-1 mask as bits first, as
// the resident kernel draws it). Every output has one writer; no atomics.
// What bounds it (PERF.md): at the history-200 user tower its bytes (1.6
// and 2.0 ms); it runs at 4x and 9x that. Trial builds there (not
// committed; the backward timed by chip_smoke.py's c3b_timed_h200_pool):
// taking z again in the second sweep in place of the scratch, 23.5 ms
// against 18.4; keeping the last round's tanh in registers across the
// softmax spilled (its 128 registers live around the do products) and was
// slower still; the do units 64 columns wide (the resident kernel's)
// spilled, 32 wide they do not; storing do and round(dz) 8 or 16 bytes a
// lane after swapping words between lanes was slower (the swaps'
// registers) than a word a lane; reading each half-round's tanh back on
// its own, both halves through the tile, spilled and took 21.2 ms;
// skipping a warp's m-tiles past the round by a warp-uniform branch was
// slower than computing them. At T <= 128 (one round) the resident kernel
// stays: the two forwards take about the same time there and the streamed
// backward is the slower (PERF.md).
template <typename T, typename S, bool kBwd>
__global__ void __launch_bounds__(kThreads, 1) tiled_pool_streamed_kernel(PoolArgs p) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int E = sizeof(T);
  // the A chunks: cp.async where o comes in the compute dtype, else fp32 loads held in
  // registers across the products and rounded into the buffer after them
  constexpr bool kCopy = std::is_same<T, S>::value;
  constexpr int kPf = kCopy ? 1 : kPoolRound * kPoolChunk / 4 / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const PoolStreamPlan L = pool_stream_plan(p.t, p.d, p.a_pad, E, kBwd);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int t = p.t, d = p.d, a = p.a, a_pad = p.a_pad;
  const int nk = (d + kPoolChunk - 1) / kPoolChunk;
  const int mg = warp % kPoolMG, ng = warp / kPoolMG;
  const int np = a_pad / 16, p0 = ng * np / kPoolNG, p1 = (ng + 1) * np / kPoolNG;
  const int n0 = 16 * p0, nt = 2 * (p1 - p0);
  T* ws = reinterpret_cast<T*>(smem);
  T* abuf = reinterpret_cast<T*>(smem + L.r);
  float* bs = reinterpret_cast<float*>(smem + L.b);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* att = reinterpret_cast<float*>(smem + L.att);
  float* wts = reinterpret_cast<float*>(smem + L.wts);
  float* dvs = reinterpret_cast<float*>(smem + L.dv);
  float* gs = reinterpret_cast<float*>(smem + L.g);
  float* scr = reinterpret_cast<float*>(smem + L.scr);
  const int valid = valid_at(p.n_valid, p.nv_dev, p.n);
  stage(ws, L.ldw, static_cast<const T*>(p.w_att), size_t(a_pad), d, L.d16, a_pad, a_pad);
  cp_async_commit();
  for (int j = tid; j < a_pad; j += kThreads) {
    bs[j] = j < a ? p.b_att[j] : 0.f;
    qs[j] = j < a ? rnd<T>(p.q_att[j]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  philox::Dropout dr = p.dr;
  dr.key = philox::key_at(dr.key, p.seed_dev);
  const bool v4 = p.lds % 4 == 0;
  for (int an = blockIdx.x; an < p.n; an += gridDim.x) {
    if (an >= valid) {  // zeros out, or zero partials
      for (int i = tid; i < (kBwd ? 0 : d); i += kThreads) p.out[size_t(an) * d + i] = 0.f;
      for (int j = tid; j < (kBwd ? a_pad : 0); j += kThreads) {
        p.db_part[size_t(an) * a_pad + j] = 0.f;
        p.dq_part[size_t(an) * a_pad + j] = 0.f;
      }
      continue;
    }
    const size_t row0 = size_t(an) * t;
    const S* src = static_cast<const S*>(p.src) + row0 * p.lds;
    if constexpr (kBwd)
      for (int i = tid; i < d; i += kThreads) gs[i] = p.g[size_t(an) * d + i];
    float acc[kPoolMT][kPoolNT][4];
    float rs[kPoolMT][2];
    // z of the round [r0, r0 + rows) (mt m-tiles) into acc, then tanh(z + b) in place and the
    // rows' logit partials in rs; the backward's dvals of the round's rows into dvs. Starts on
    // spent chunk buffers (the caller's barrier), leaves them in use.
    auto sweep = [&](int r0, int rows, int mt) {
      const S* sr = src + size_t(r0) * p.lds;
      float4 pf[kPf];
      auto buf = [&](int kc) { return abuf + (kc % 2) * kPoolRound * L.lda; };
      auto issue = [&](int kc) {
        const int k0 = kc * kPoolChunk;
        if constexpr (kCopy) {
          stage(buf(kc), L.lda, sr + k0, p.lds, rows, 16 * mt, min(kPoolChunk, d - k0),
                kPoolChunk);
          cp_async_commit();
        } else {
#pragma unroll
          for (int i = 0; i < kPf; ++i) {
            const int e = tid + kThreads * i, r = e / (kPoolChunk / 4);
            const int col = k0 + e % (kPoolChunk / 4) * 4;
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (r < rows) {
              const S* s = sr + size_t(r) * p.lds + col;
              if (v4 && col + 3 < d) {
                const float4 u = *reinterpret_cast<const float4*>(s);
                v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
              } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) v[k] = col + k < d ? to_f<S>(s[k]) : 0.f;
              }
            }
            pf[i] = make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      };
      auto land = [&](int kc) {
        if constexpr (!kCopy) {
          T* dst = buf(kc);
#pragma unroll
          for (int i = 0; i < kPf; ++i) {
            const int e = tid + kThreads * i, r = e / (kPoolChunk / 4);
            const int c4 = e % (kPoolChunk / 4) * 4;
            if (r < 16 * mt)
              *reinterpret_cast<uint2*>(dst + r * L.lda + c4) =
                  make_uint2(pack_bf16(pf[i].x, pf[i].y), pack_bf16(pf[i].z, pf[i].w));
          }
        }
      };
#pragma unroll
      for (int u = 0; u < kPoolMT; ++u) zero_frag(acc[u]);
      float dv = 0.f;  // the backward's dvals: row tid / 2, half tid % 2 of each chunk's columns
      issue(0);
      land(0);
      for (int kc = 0; kc < nk; ++kc) {
        const int k0 = kc * kPoolChunk, ks = min(kPoolChunk / 16, (d - k0 + 15) / 16);
        if constexpr (kCopy) cp_async_wait<0>();
        __syncthreads();  // chunk kc is in; chunk kc - 1's buffer is spent
        if (kc + 1 < nk) issue(kc + 1);
        const T* A = buf(kc);
        if constexpr (kBf) {
          // all 4 x 8 tiles' products without a branch between them, as the resident kernel's
          // (in a trial build, skipping the warp's m-tiles past the round by a warp-uniform
          // branch was 3% slower in both directions at the history-200 user tower)
          for (int kk = 0; kk < ks; ++kk) {
            uint32_t fb[kPoolNT / 2][4];
#pragma unroll
            for (int jp = 0; jp < kPoolNT / 2; ++jp)
              ldb_kn(fb[jp], ws, L.ldw, k0 + 16 * kk, min(n0 + 16 * jp, a_pad - 16));
#pragma unroll
            for (int u = 0; u < kPoolMT; ++u) {
              uint32_t fa[4];
              lda_rm(fa, A, L.lda, 16 * min(mg + kPoolMG * u, mt - 1), 16 * kk);
#pragma unroll
              for (int jp = 0; jp < kPoolNT / 2; ++jp)
                mma_pair(acc[u][2 * jp], acc[u][2 * jp + 1], fa, fb[jp]);
            }
          }
        } else {
          for (int k = 0; k < 16 * ks; ++k) {
            const T* wr = ws + size_t(k0 + k) * L.ldw + n0 + 2 * c;
#pragma unroll
            for (int u = 0; u < kPoolMT; ++u) {
              const int i = mg + kPoolMG * u;
              if (i < mt) {
                const float a0 = A[(16 * i + g) * L.lda + k], a1 = A[(16 * i + g + 8) * L.lda + k];
#pragma unroll
                for (int j = 0; j < kPoolNT; ++j)
                  if (j < nt) {
                    const float b0 = wr[8 * j], b1 = wr[8 * j + 1];
                    acc[u][j][0] += a0 * b0;
                    acc[u][j][1] += a0 * b1;
                    acc[u][j][2] += a1 * b0;
                    acc[u][j][3] += a1 * b1;
                  }
              }
            }
          }
        }
        if constexpr (kBwd) {  // 32 columns a thread, 16 bytes at a time
          constexpr int kV = 16 / E;
          const int r = tid / 2, c0 = 32 * (tid % 2), kv = min(kPoolChunk, d - k0);
          if (r < rows)
#pragma unroll
            for (int k8 = 0; k8 < 32; k8 += kV)
              if (c0 + k8 < kv) {
                const uint4 u = *reinterpret_cast<const uint4*>(A + r * L.lda + c0 + k8);
#pragma unroll
                for (int j = 0; j < kV; ++j)
                  if (c0 + k8 + j < kv) dv += piece_at<T>(u, j) * rnd<T>(gs[k0 + c0 + k8 + j]);
              }
        }
        if (kc + 1 < nk) land(kc + 1);
      }
      float bc[kPoolNT][2], qc[kPoolNT][2];  // the warp's columns of b_att and round(q); 0 past a
#pragma unroll
      for (int j = 0; j < kPoolNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * c + e;
          const bool in = j < nt && col < a;
          bc[j][e] = in ? bs[col] : 0.f;
          qc[j][e] = in ? qs[col] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kPoolMT; ++u) {
        rs[u][0] = rs[u][1] = 0.f;
        const bool live = mg + kPoolMG * u < mt;
#pragma unroll
        for (int j = 0; j < kPoolNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 8 * j + 2 * c + e % 2;
            const float h =
                live && j < nt && col < a ? tanh_fast(acc[u][j][e] + bc[j][e % 2]) : 0.f;
            acc[u][j][e] = h;
            rs[u][e / 2] += rnd<T>(h) * qc[j][e % 2];
          }
        rs[u][0] = quad_sum(rs[u][0]);
        rs[u][1] = quad_sum(rs[u][1]);
      }
      if (kBwd) {
        dv += __shfl_xor_sync(0xffffffffu, dv, 1);
        if (tid % 2 == 0 && tid / 2 < rows) dvs[r0 + tid / 2] = dv;
      }
    };
    // the backward's tanh of each round, by thread: [round][m-tile u][tile j][thread] float4
    float4* tsc = kBwd ? reinterpret_cast<float4*>(p.att) + size_t(blockIdx.x) * pool_stream_rounds(t) *
                             kPoolMT * kPoolNT * kThreads
                       : nullptr;
    // the first sweep: the logits of every round
    for (int r0 = 0; r0 < t; r0 += kPoolRound) {
      const int rows = min(kPoolRound, t - r0), mt = (rows + 15) / 16;
      sweep(r0, rows, mt);
      if (kBwd)  // the round's tanh to the block's scratch (it stays in L2)
#pragma unroll
        for (int u = 0; u < kPoolMT; ++u) {
          if (mg + kPoolMG * u >= mt) continue;  // warp-uniform
#pragma unroll
          for (int j = 0; j < kPoolNT; ++j)
            if (j < nt)
              tsc[((r0 / kPoolRound * kPoolMT + u) * kPoolNT + j) * kThreads + tid] =
                  make_float4(acc[u][j][0], acc[u][j][1], acc[u][j][2], acc[u][j][3]);
        }
      if (c == 0)
#pragma unroll
        for (int u = 0; u < kPoolMT; ++u) {
          const int i = mg + kPoolMG * u;
          if (i < mt) {
            scr[ng * kPoolRound + 16 * i + g] = rs[u][0];
            scr[ng * kPoolRound + 16 * i + g + 8] = rs[u][1];
          }
        }
      __syncthreads();  // the partials are in; every warp is done with the chunks
      if (tid < rows) {
        float v = 0.f;
        for (int k = 0; k < kPoolNG; ++k) v += scr[k * kPoolRound + tid];
        att[r0 + tid] = v;
      }
      __syncthreads();  // scr and R are free for the next round
    }
    pooling_softmax(att, 1, t, wts);
    __syncthreads();
    if constexpr (!kBwd) {
      // out = sum over t of the fp32 o's rows times their weights: a warp's rows of a round
      // (16 at most) and 256 columns loaded together, summed over the rounds in registers
      constexpr int kRw = kPoolRound / kWarps, kCw = 2;  // rows a warp a round; float4 a lane
      float* part = reinterpret_cast<float*>(smem + L.r);  // [8][256]
      for (int cb = 0; cb < d; cb += 128 * kCw) {
        float v[kCw][4] = {};
        for (int r0 = 0; r0 < t; r0 += kPoolRound) {
          float4 ov[kCw][kRw];
#pragma unroll
          for (int h = 0; h < kCw; ++h)
#pragma unroll
            for (int k = 0; k < kRw; ++k) {
              const int r = r0 + warp + kWarps * k, col = cb + 128 * h + 4 * lane;
              float u[4] = {0.f, 0.f, 0.f, 0.f};
              if (r < t && col < d) {
                const S* sp = src + size_t(r) * p.lds + col;
                if (v4 && col + 3 < d) {
                  const float4 w4 = *reinterpret_cast<const float4*>(sp);
                  u[0] = w4.x, u[1] = w4.y, u[2] = w4.z, u[3] = w4.w;
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e) u[e] = col + e < d ? to_f<S>(sp[e]) : 0.f;
                }
              }
              ov[h][k] = make_float4(u[0], u[1], u[2], u[3]);
            }
#pragma unroll
          for (int h = 0; h < kCw; ++h)
#pragma unroll
            for (int k = 0; k < kRw; ++k) {
              const int r = r0 + warp + kWarps * k;
              const float w = r < t ? wts[r] : 0.f;
              v[h][0] += w * ov[h][k].x, v[h][1] += w * ov[h][k].y, v[h][2] += w * ov[h][k].z,
                  v[h][3] += w * ov[h][k].w;
            }
        }
#pragma unroll
        for (int h = 0; h < kCw; ++h)
#pragma unroll
          for (int k = 0; k < 4; ++k) part[warp * 256 + 128 * h + 4 * lane + k] = v[h][k];
        __syncthreads();
        if (cb + tid < d) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += part[w * 256 + tid];
          p.out[size_t(an) * d + cb + tid] = s;
        }
        __syncthreads();
      }
    } else {
      // datt = round(w (dvals - sum w dvals)) into att, zero past t; the column sums zeroed
      if (warp == 0) {
        float v = 0.f;
        for (int r = lane; r < t; r += 32) v += wts[r] * dvs[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        for (int r = lane; r < L.t16; r += 32) att[r] = r < t ? rnd<T>(wts[r] * (dvs[r] - v)) : 0.f;
      }
      for (int j = tid; j < 2 * kPoolMG * a_pad; j += kThreads) scr[j] = 0.f;
      __syncthreads();
      T* dzs = reinterpret_cast<T*>(smem + L.r);  // a half-round's round(dz) [64][ldw]
      T* dzg = static_cast<T*>(p.dz_c) + row0 * a_pad;
      T* doc = static_cast<T*>(p.do_c) + row0 * d;
      uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + L.mb) + warp * 32;  // [32 rows]
      const int mode = dr.thr_att ? 1 : p.ext != nullptr ? 2 : 0;  // mask bits, external, none
      const bool pairs = d % 2 == 0;  // a column pair is one aligned 4- or 8-byte store
      const int per = a_pad * E / 16, ncb = (d + 31) / 32, ks = a_pad / 16;
      // the second sweep: each round's tanh from the scratch, then its dz, partials, round(dz)
      // and do
      for (int r0 = 0; r0 < t; r0 += kPoolRound) {
        const int rows = min(kPoolRound, t - r0), mt = (rows + 15) / 16;
#pragma unroll
        for (int u = 0; u < kPoolMT; ++u) {
          if (mg + kPoolMG * u >= mt) continue;  // warp-uniform
#pragma unroll
          for (int j = 0; j < kPoolNT; ++j)
            if (j < nt) {
              const float4 v = tsc[((r0 / kPoolRound * kPoolMT + u) * kPoolNT + j) * kThreads + tid];
              acc[u][j][0] = v.x, acc[u][j][1] = v.y, acc[u][j][2] = v.z, acc[u][j][3] = v.w;
            }
        }
        __syncthreads();  // every warp is done with the chunks and the last tile: R is the tile
        // dz = round(datt) round(q) (1 - tanh^2) of the whole round from acc: the first half's
        // m-tiles (u 0, 1) into the tile, the second's straight to device memory (it comes back
        // into the tile from L2 for its do products), so that acc is spent before them and
        // nothing is held across them; the column sums, added once a round
#pragma unroll
        for (int j = 0; j < kPoolNT; ++j) {
          float sdb[2] = {0.f, 0.f}, sdq[2] = {0.f, 0.f};
#pragma unroll
          for (int u = 0; u < kPoolMT; ++u) {
            const int i = mg + kPoolMG * u;
            if (i >= mt || j >= nt) continue;
            float z[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * i + g + 8 * (e / 2), col = n0 + 8 * j + 2 * c + e % 2;
              const float h = acc[u][j][e], da = att[r0 + row];
              z[e] = col < a ? da * qs[col] * (1.f - h * h) : 0.f;
              sdb[e % 2] += z[e];
              sdq[e % 2] += rnd<T>(h) * da;
            }
            const int row = 16 * i + g, col = n0 + 8 * j + 2 * c;
            T* q0 = u < 2 ? dzs + row * L.ldw + col : dzg + size_t(r0 + row) * a_pad + col;
            const int ld = u < 2 ? L.ldw : a_pad;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8; past the article's rows only
              if (u >= 2 && row + 8 * hh >= rows) continue;  // the tile's
              T* q = q0 + 8 * hh * ld;
              if constexpr (kBf)
                *reinterpret_cast<uint32_t*>(q) = pack_bf16(z[2 * hh], z[2 * hh + 1]);
              else
                *reinterpret_cast<float2*>(q) = make_float2(z[2 * hh], z[2 * hh + 1]);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              sdb[e] += __shfl_xor_sync(0xffffffffu, sdb[e], off);
              sdq[e] += __shfl_xor_sync(0xffffffffu, sdq[e], off);
            }
          if (g == 0 && j < nt)  // the column's one writer adds the round's sums
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + 8 * j + 2 * c + e;
              scr[mg * a_pad + col] += sdb[e];
              scr[(kPoolMG + mg) * a_pad + col] += sdq[e];
            }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int mh = min(4, mt - 4 * hf);  // live m-tiles of the half (block-uniform)
          if (mh <= 0) continue;
          const int hr0 = kPoolHalf * hf;  // the half's first row in the round
          const int hrows = min(16 * mh, rows - hr0);  // the half's rows within the article
          if (hf == 1) {  // the second half's round(dz) back from device memory into the tile
            stage(dzs, L.ldw, dzg + size_t(r0 + hr0) * a_pad, size_t(a_pad), hrows, 16 * mh, a_pad,
                  a_pad);
            cp_async_commit();
            cp_async_wait<0>();
          }
          __syncthreads();  // the tile is whole
          if (hf == 0)  // round(dz) of the first half's rows to device memory, 16 bytes a thread
            for (int i = tid; i < hrows * per; i += kThreads) {
              const int r = i / per, cc = i % per * (16 / E);
              *reinterpret_cast<uint4*>(dzg + size_t(r0 + r) * a_pad + cc) =
                  *reinterpret_cast<const uint4*>(dzs + r * L.ldw + cc);
            }
          // do = (w g + round(dz) round(W)^T) * mask by units of 32 rows x 32 columns, each warp
          // a contiguous range of them
          const int units = (mh + 1) / 2 * ncb, tr = 16 * mh;  // the tile's rows
          for (int un = warp * units / kWarps; un < (warp + 1) * units / kWarps; ++un) {
            const int m0 = 32 * (un / ncb), c0 = 32 * (un % ncb), nn = min(4, (L.d16 - c0) / 8);
            const bool two = m0 + 16 < tr;
            float o8[2][4][4];
            zero_frag(o8[0]);
            zero_frag(o8[1]);
            if constexpr (kBf) {
              for (int kk = 0; kk < ks; ++kk) {  // unconditional, on clamped rows and columns
                uint32_t fb[2][4];
#pragma unroll
                for (int jp = 0; jp < 2; ++jp)
                  ldb_nk(fb[jp], ws, L.ldw, 16 * kk, min(c0 + 16 * jp, L.d16 - 16));
#pragma unroll
                for (int mm = 0; mm < 2; ++mm) {
                  uint32_t fa[4];
                  lda_rm(fa, dzs, L.ldw, min(m0 + 16 * mm, tr - 16), 16 * kk);
#pragma unroll
                  for (int jp = 0; jp < 2; ++jp)
                    mma_pair(o8[mm][2 * jp], o8[mm][2 * jp + 1], fa, fb[jp]);
                }
              }
            } else {
              smm<T, 4, false, false>(o8[0], dzs, L.ldw, m0, ws, L.ldw, c0, ks, nn);
              if (two) smm<T, 4, false, false>(o8[1], dzs, L.ldw, m0 + 16, ws, L.ldw, c0, ks, nn);
            }
            const int ar0 = r0 + hr0 + m0;  // the article's row of the unit's first
            if (dr.thr_att) {  // word w: row w of the unit, its 32 columns
              __syncwarp();  // the last unit's bits are read
              const int row = ar0 + lane;
              uint32_t bits = 0;
#pragma unroll 1
              for (int q = 0; q < 8; ++q) {
                const int col = c0 + 4 * q;
                if (row < t && col < d) {
                  const uint4 pb = philox::philox4x32_10(
                      make_uint4(uint32_t(row0 + row), uint32_t(col >> 2), 1u, 0u), dr.key);
                  bits |= (uint32_t((pb.x >> 8) < dr.thr_att) | uint32_t((pb.y >> 8) < dr.thr_att) << 1 |
                           uint32_t((pb.z >> 8) < dr.thr_att) << 2 |
                           uint32_t((pb.w >> 8) < dr.thr_att) << 3)
                          << (4 * q);
                }
              }
              mbits[lane] = bits;
              __syncwarp();
            }
            // the epilogue: lane (g, c) holds rows ar0 + 16 mm + g + 8 hh, columns c0 + 8 j + 2 c
            float gc[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = c0 + 8 * j + 2 * c + e;
                gc[j][e] = col < d ? gs[col] : 0.f;
              }
#pragma unroll
            for (int mm = 0; mm < 2; ++mm)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int rl = 16 * mm + g + 8 * hh, row = ar0 + rl;
                if (rl >= tr || row >= t) continue;
                const float w = wts[row];
                T* orow = doc + size_t(row) * d;
                const uint32_t bits = mbits[rl];
                const float* xrow = mode == 2 ? p.ext + (row0 + row) * d : nullptr;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const int col = c0 + 8 * j + 2 * c;
                  if (col >= d) continue;
                  float v0 = w * gc[j][0] + o8[mm][j][2 * hh];
                  float v1 = w * gc[j][1] + o8[mm][j][2 * hh + 1];
                  if (mode == 1) {
                    const uint32_t b = bits >> (col - c0);
                    v0 *= b & 1u ? dr.inv_att : 0.f;
                    v1 *= b & 2u ? dr.inv_att : 0.f;
                  } else if (mode == 2) {
                    v0 *= xrow[col] * p.inv_ext;
                    v1 *= col + 1 < d ? xrow[col + 1] * p.inv_ext : 0.f;
                  }
                  if (pairs) {
                    if constexpr (kBf)
                      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
                    else
                      *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
                  } else {
                    orow[col] = from_f<T>(v0);
                    if (col + 1 < d) orow[col + 1] = from_f<T>(v1);
                  }
                }
              }
          }
          __syncthreads();  // the tile and the column sums are spent before the next half
        }
      }
      for (int j = tid; j < a_pad; j += kThreads) {
        p.db_part[size_t(an) * a_pad + j] = scr[j] + scr[a_pad + j];
        p.dq_part[size_t(an) * a_pad + j] = scr[2 * a_pad + j] + scr[3 * a_pad + j];
      }
    }
    __syncthreads();  // R, g and the arrays are spent before the next article
  }
}

// ---- launchers ----

// T1 "tf32x3" (fp32): a persistent grid, at most one CTA an SM; x [x_rows,
// din] K-major and the weight [din, P] N-major by tensor maps.
int launch_qkv_tf32x3(const QkvArgs& p, int x_rows, cudaStream_t stream) {
  const long long tiles = (long long)((p.rows + kTfBM - 1) / kTfBM) * (p.P / kTfBN);
  if (tiles == 0) return 0;
  CUtensorMap xmap, wmap;
  if (x_rows < 1 || !hop::f32_map(&xmap, p.x, p.din, x_rows, p.din, kTfBK, kTfBM) ||
      !hop::f32_map(&wmap, p.wqkv, p.P, p.din, p.P, 32, kTfBK))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(tiled_qkv_tf32x3_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(e);
  // the valid rows: rows, or with nv_dev the first *nv_dev articles of t rows
  const TfArgs a{static_cast<float*>(p.qkv), p.rows, p.P, p.din, p.din, 1, p.rows, p.key,
                 p.thr_emb, p.inv_emb, p.seed_dev, p.nv_dev, p.t};
  tiled_qkv_tf32x3_kernel<<<unsigned(std::min<long long>(tiles, sms)), kTfThreads, kTfSmem,
                            stream>>>(xmap, wmap, a);
  return int(cudaGetLastError());
}

// T1 "tma" (bf16): a persistent grid, at most one CTA an SM; x, the weight
// and the output by tensor maps.
int launch_qkv_tma(QkvArgs p, int x_rows, cudaStream_t stream) {
  const int blocks = (p.rows + kT1Rows - 1) / kT1Rows;
  if (blocks == 0) return 0;
  const T1Plan L = t1_plan(p.din);
  if (L.stages < 2 || L.total > size_t(kSmemLimit)) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  e = cudaFuncSetAttribute(tiled_qkv_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(L.total));
  if (e != cudaSuccess) return int(e);
  CUtensorMap xmap, wmap, omap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  memset(&omap, 0, sizeof(omap));
  // x [x_rows, din] (rows past it arrive as zeros), wqkv [din, P], qkv [rows, P] (stores past
  // `rows` are dropped)
  if (x_rows < 1 || !hop::bf16_map(&xmap, p.x, p.din, x_rows, p.din, kQkvBK, kT1Rows) ||
      !hop::bf16_map(&wmap, p.wqkv, p.P, p.din, p.P, 64, kQkvBK) ||
      !hop::bf16_map(&omap, p.qkv, p.P, p.rows, p.P, 64, 64))
    return int(cudaErrorInvalidValue);
  tiled_qkv_tma_kernel<<<unsigned(std::max(1, std::min(blocks, sms))), kQkvThreads, L.total,
                         stream>>>(xmap, wmap, omap, p);
  return int(cudaGetLastError());
}

// T1: "tma" (variant 1, bf16 only), "tf32x3" (variant 2, fp32 only) or the
// panel kernel (0); any other request is refused.
template <typename T>
int launch_qkv(QkvArgs p, int x_rows, int variant, cudaStream_t stream) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  if (p.rows < 0 || p.din < 1 || p.P < kPanel || p.P % kPanel || p.din % (16 / int(sizeof(T))) ||
      (p.thr_emb && (kBf || p.din % 4)) || variant < 0 || variant > 2 ||
      (variant == 1 && !kBf) || (variant == 2 && kBf))
    return int(cudaErrorInvalidValue);
  if (variant == 1) return launch_qkv_tma(p, x_rows, stream);
  if (variant == 2) return launch_qkv_tf32x3(p, x_rows, stream);
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

// Launch a staged kernel on `blocks` blocks of `threads` with `smem` bytes
// of dynamic shared memory.
template <typename Kern, typename... Args>
int launch_staged(Kern kern, long long blocks, int threads, size_t smem, cudaStream_t stream,
                  Args... args) {
  if (blocks > (1LL << 31) - 1) return int(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<unsigned(blocks), threads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

// The staged kernels' instances, by T rounded up to 16 (16 .. kStagedT): NK = T16 / 8.
#define NE_STAGED_CASES(K) K(2) K(4) K(6) K(8) K(10) K(12) K(14) K(16)
static_assert(kStagedT == 8 * 16, "NE_STAGED_CASES runs to NK 16");

template <typename T>
int launch_attention_staged(const AttArgs& p, bool o_f32, cudaStream_t stream) {
  const int hd = p.d / p.heads;
  if (!staged_fits(p.t, hd, sizeof(T), false)) return int(cudaErrorInvalidValue);
  const long long blocks = (long long)p.n * p.heads;
  const size_t smem = staged_smem(p.t, hd, sizeof(T), false);
  switch (r16(p.t) / 8) {
#define NE_CASE(NK)                                                                          \
  case NK:                                                                                   \
    return launch_staged(tiled_attention_staged_kernel<T, NK>, blocks, 16 * NK, smem, stream, \
                         p, o_f32);
    NE_STAGED_CASES(NE_CASE)
#undef NE_CASE
  }
  return int(cudaErrorInvalidValue);
}

// T2 and T4's kernels, as the C entries' `variant` names them.
enum AttVariant { kGather = 0, kStaged = 1, kStreamed = 2 };

template <typename T, typename O>
int launch_attention(const AttArgs& p, int variant, cudaStream_t stream) {
  if (p.t < 1 || !heads_ok(p.d, p.heads, p.gh, p.pw, p.P) || p.ldo < p.d)
    return int(cudaErrorInvalidValue);
  constexpr bool kF32 = std::is_same<O, float>::value;
  if (variant == kStaged) return launch_attention_staged<T>(p, kF32, stream);
  if (variant == kStreamed) {
    const int hd = p.d / p.heads;
    if (!streamed_fits(p.t, hd, sizeof(T), false)) return int(cudaErrorInvalidValue);
    const StreamPlan L = streamed_plan(p.t, hd, sizeof(T), false);
    return L.rt == 2 ? launch_staged(tiled_attention_streamed_kernel<T, 2>,
                                     (long long)p.n * p.heads, kAttThreads, L.total, stream, p, kF32)
                     : launch_staged(tiled_attention_streamed_kernel<T, 1>,
                                     (long long)p.n * p.heads, kAttThreads, L.total, stream, p, kF32);
  }
  if (variant != kGather) return int(cudaErrorInvalidValue);
  const long long blocks = (long long)p.n * p.heads * ((p.t + kTile - 1) / kTile);
  if (blocks > (1LL << 31) - 1) return int(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  tiled_attention_kernel<T, O><<<unsigned(blocks), kAttThreads, 0, stream>>>(p);
  return int(cudaGetLastError());
}

// T3's kernels, as the C entry's `variant` names them.
enum PoolVariant { kChunked = 0, kResident = 1, kPoolStreamed = 2, kPoolTf32x3 = 3 };

// T3 "tf32x3" (fp32): the logits on the 3xTF32 core (a persistent grid, at
// most one CTA an SM; o [n t, lds] K-major, W_att [d, a_pad] N-major by
// tensor maps), the per-article pass (a block an article), and in the
// backward do on the core (dz [n t, a_pad] and W_att, both K-major).
// Refused where TMA does not take o's or W_att's rows (16-byte strides and
// bases) or d is not a whole number of 16-byte pieces; p.att holds
// pool_tf32x3_scratch floats (ops/news_encoder.py), p.wts n t.
int launch_pool_tf32x3(const PoolArgs& p, bool bwd, cudaStream_t stream) {
  const long long rows = (long long)p.n * p.t;
  if (p.d % 4 || p.lds % 4 || rows > (1LL << 31) - 1 || p.att == nullptr || p.wts == nullptr ||
      reinterpret_cast<uintptr_t>(p.src) % 16 ||
      reinterpret_cast<uintptr_t>(bwd ? p.g : p.out) % 16 || (bwd ? p.g : p.out) == nullptr)
    return int(cudaErrorInvalidValue);
  const int M = int(rows), ct = pool_tf_tiles(p.a_pad);
  CUtensorMap omap, wmap, dzmap, wkmap;
  if (!hop::f32_map(&omap, p.src, p.d, M, p.lds, kTfBK, kTfBM) ||
      !hop::f32_map(&wmap, p.w_att, p.a_pad, p.d, p.a_pad, 32, kTfBK) ||
      (bwd && (!hop::f32_map(&dzmap, p.dz_c, p.a_pad, M, p.a_pad, kTfBK, kTfBM) ||
               !hop::f32_map(&wkmap, p.w_att, p.a_pad, p.d, p.a_pad, kTfBK, kTfBN))))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(pool_logits_tf32x3_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (e == cudaSuccess && bwd)
    e = cudaFuncSetAttribute(pool_do_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTfSmem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const long long m_tiles = (M + kTfBM - 1) / kTfBM;
  // z = o W_att: rows of the first n_valid (or *nv_dev) articles; the logits' partials and,
  // backward, tanh(z + b) after them
  TfArgs z{nullptr, M, p.a_pad, p.d, p.d, 1, p.n_valid * p.t, philox::Key{0u, 0u}, 0u, 1.f,
           nullptr, p.nv_dev, p.t};
  z.pool = TfPool{p.b_att, p.q_att, p.att, bwd ? p.att + pool_tf_h_offset(M, p.a_pad) : nullptr,
                  p.a, nullptr, nullptr, p.t, nullptr, 1.f};
  pool_logits_tf32x3_kernel<<<unsigned(std::min<long long>(m_tiles * ct, sms)), kTfThreads,
                              kTfSmem, stream>>>(omap, wmap, z);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  if (bwd)
    pool_article_kernel<true><<<unsigned(p.n), kPoolArtThreads, 0, stream>>>(p, ct);
  else
    pool_article_kernel<false><<<unsigned(p.n), kPoolArtThreads, 0, stream>>>(p, ct);
  if ((e = cudaGetLastError()) != cudaSuccess || !bwd) return int(e);
  // do = (w g + dz W_att^T) mask: the stream-1 mask drawn from the seed (or read from device
  // memory), else the external one
  TfArgs o{static_cast<float*>(p.do_c), M, p.d, p.a_pad, p.a_pad, 1, p.n_valid * p.t, p.dr.key,
           p.dr.thr_att, p.dr.inv_att, p.seed_dev, p.nv_dev, p.t};
  o.pool = TfPool{nullptr, nullptr, nullptr, nullptr, p.a, p.wts, p.g, p.t, p.ext, p.inv_ext};
  const long long d_tiles = m_tiles * ((p.d + kTfBN - 1) / kTfBN);
  pool_do_tf32x3_kernel<<<unsigned(std::min<long long>(d_tiles, sms)), kTfThreads, kTfSmem,
                          stream>>>(dzmap, wkmap, o);
  return int(cudaGetLastError());
}

// T3: "resident" (a persistent block an SM; refused where pool_fits does not
// hold), "streamed" (the same, by rounds; refused where pool_stream_fits
// does not hold), "tf32x3" (fp32 only: launch_pool_tf32x3) or the chunked
// kernel (a block an article).
template <typename T, typename S, bool kBwd>
int launch_pool(const PoolArgs& p, int variant, cudaStream_t stream) {
  if (p.t < 1 || p.d < 1 || p.a < 1 || p.a > p.a_pad || p.a_pad % 16 || p.lds < p.d)
    return int(cudaErrorInvalidValue);
  if (variant == kPoolTf32x3) {
    if (!std::is_same<T, float>::value) return int(cudaErrorInvalidValue);
    return p.n == 0 ? 0 : launch_pool_tf32x3(p, kBwd, stream);
  }
  if ((variant == kResident && !pool_fits(p.t, p.d, p.a_pad, sizeof(T), kBwd)) ||
      (variant == kPoolStreamed &&
       (!pool_stream_fits(p.t, p.d, p.a_pad, sizeof(T), kBwd) || (kBwd && p.att == nullptr))) ||
      (variant != kChunked && variant != kResident && variant != kPoolStreamed))
    return int(cudaErrorInvalidValue);
  if (p.n == 0) return 0;
  if (variant != kChunked) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    const bool res = variant == kResident;
    const size_t smem = res ? pool_plan(p.t, p.d, p.a_pad, sizeof(T), kBwd).total
                            : pool_stream_plan(p.t, p.d, p.a_pad, sizeof(T), kBwd).total;
    auto kern = res ? tiled_pool_resident_kernel<T, S, kBwd> : tiled_pool_streamed_kernel<T, S, kBwd>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    kern<<<unsigned(std::min(p.n, sms)), kThreads, smem, stream>>>(p);
    return int(cudaGetLastError());
  }
  const Layout L = make_layout(p.d, p.a_pad, sizeof(T), 1, true);
  const size_t smem = pool_smem(L, p.a_pad, sizeof(T));
  auto kern = tiled_pool_kernel<T, S, kBwd>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<unsigned(p.n), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int launch_attention_bwd(const AttBwdArgs& p, int variant, cudaStream_t stream) {
  if (p.t < 1 || !heads_ok(p.d, p.heads, p.gh, p.pw, p.P)) return int(cudaErrorInvalidValue);
  const long long blocks = (long long)p.n * p.heads;
  if (variant == kStreamed) {
    const int hd = p.d / p.heads;
    if (!streamed_fits(p.t, hd, sizeof(T), true)) return int(cudaErrorInvalidValue);
    const StreamPlan L = streamed_plan(p.t, hd, sizeof(T), true);
    return launch_staged(tiled_attention_bwd_streamed_kernel<T>, blocks, 32 * L.warps, L.total,
                         stream, p);
  }
  if (variant != kGather && variant != kStaged) return int(cudaErrorInvalidValue);
  if (variant == kStaged) {
    const int hd = p.d / p.heads;
    if (!staged_fits(p.t, hd, sizeof(T), true)) return int(cudaErrorInvalidValue);
    const size_t smem = staged_smem(p.t, hd, sizeof(T), true);
    switch (r16(p.t) / 8) {
#define NE_CASE(NK)                                                                              \
  case NK:                                                                                       \
    return launch_staged(tiled_attention_bwd_staged_kernel<T, NK>, blocks, 16 * NK, smem, stream, \
                         p);
      NE_STAGED_CASES(NE_CASE)
#undef NE_CASE
    }
    return int(cudaErrorInvalidValue);
  }
  if (blocks > (1LL << 31) - 1 || p.delta == nullptr) return int(cudaErrorInvalidValue);
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
// of the first *nv_dev articles are computed. variant: 1 the "tma" kernel
// (bf16 only), 2 the "tf32x3" kernel (fp32 only), 0 the panel kernel.
int tiled_qkv(const void* x, int x_rows, const void* wqkv, void* qkv, int rows, int n, int t,
              int din, int P, const void* nv_dev, int is_bf16, unsigned seed_lo, unsigned seed_hi,
              const void* seed_dev, unsigned thr_emb, float inv_emb, int variant, void* stream) {
  const QkvArgs p{x,  wqkv, qkv, rows, n, t, din, P, 1, 1, 0, philox::Key{seed_lo, seed_hi},
                  thr_emb, inv_emb, static_cast<const int*>(nv_dev),
                  static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_qkv<bf16>(p, x_rows, variant, s)
                 : launch_qkv<float>(p, x_rows, variant, s);
}

// T2. qkv [n * t, P] (head h: Q at (h / gh) * pw + (h % gh) * hd, K gh * hd
// further, V 2 gh hd further); o [n * t, ldo] fp32 (o_f32) or in the
// compute dtype: o after the stream-1 mask (thr_att, inv_att under the
// seed) or ext [n * t, d] times inv_ext; stats (may be null) [2][n * t]
// [heads] fp32: each row's max of the base-2 logits and its sum of exp2.
// Articles at or past n_valid (or *nv_dev) are left unwritten. variant: 1
// the staged kernel (a pair in shared memory; refused where it does not
// fit), 2 the streamed one (refused where its plan does not fit), 0 the
// gathering one; any other value is refused.
int tiled_attention(const void* qkv, void* o, int ldo, int o_f32, void* stats, int n, int t, int d,
                    int heads, int gh, int pw, int P, int n_valid, const void* nv_dev, float scale,
                    int is_bf16, unsigned seed_lo, unsigned seed_hi, const void* seed_dev,
                    unsigned thr_att, float inv_att, const void* ext, float inv_ext, int variant,
                    void* stream) {
  const AttArgs p{qkv, o, static_cast<float*>(stats), static_cast<const float*>(ext), inv_ext, n, t,
                  d, heads, gh, pw, P, ldo, n_valid, scale,
                  philox::Dropout{{seed_lo, seed_hi}, 0u, thr_att, 1.f, inv_att},
                  static_cast<const int*>(nv_dev), static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return o_f32 ? launch_attention<bf16, float>(p, variant, s)
                 : launch_attention<bf16, bf16>(p, variant, s);
  return launch_attention<float, float>(p, variant, s);
}

// T3. Forward (is_bwd 0): src = o [n * t, lds] fp32 -> out [n, d] fp32
// (zeros at or past n_valid). Backward: src = round(o) [n * t, lds] in the
// compute dtype, g [n, d] fp32 -> dz_c [n * t, a_pad], do_c [n * t, d] in
// the compute dtype, db_part and dq_part [n, a_pad] fp32 (zeros at or past
// n_valid). att and wts: [n * t] fp32 scratch (the chunked kernel's; the
// streamed backward's att: min(n, SMs) * pool_stream_rounds(t) * 32,768
// fp32, refused when null; the "tf32x3" kernels' att: n * t column tiles
// of 256 fp32, in the backward rounded up to 4 and then n * t * a_pad more,
// wts [n * t]). w_att
// [d, a_pad] in the compute dtype, b_att and q_att [a] fp32. variant: 1 the
// resident kernel, 2 the streamed one (each refused where its plan does not
// fit), 3 the "tf32x3" kernels (fp32 only; refused where TMA does not take
// the rows), 0 the chunked one; any other value is refused.
int tiled_pool(const void* src, int lds, const void* w_att, const void* b_att, const void* q_att,
               const void* g, void* out, void* att, void* wts, void* dz_c, void* do_c,
               void* db_part, void* dq_part, int n, int t, int d, int a, int a_pad, int n_valid,
               const void* nv_dev, int is_bf16, int is_bwd, unsigned seed_lo, unsigned seed_hi,
               const void* seed_dev, unsigned thr_att, float inv_att, const void* ext,
               float inv_ext, int variant, void* stream) {
  const PoolArgs p{src, lds, w_att, static_cast<const float*>(b_att),
                   static_cast<const float*>(q_att), static_cast<const float*>(g),
                   static_cast<float*>(out), static_cast<float*>(att), static_cast<float*>(wts),
                   dz_c, do_c, static_cast<float*>(db_part), static_cast<float*>(dq_part),
                   static_cast<const float*>(ext), inv_ext, n, t, d, a, a_pad, n_valid,
                   philox::Dropout{{seed_lo, seed_hi}, 0u, thr_att, 1.f, inv_att},
                   static_cast<const int*>(nv_dev), static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return is_bwd ? launch_pool<bf16, bf16, true>(p, variant, s)
                  : launch_pool<bf16, float, false>(p, variant, s);
  return is_bwd ? launch_pool<float, float, true>(p, variant, s)
                : launch_pool<float, float, false>(p, variant, s);
}

// T4. qkv [n * t, P] as T2's, do_c [n * t, d], stats from T2, delta
// [n * t, heads] fp32 scratch (the gathering kernel's; the others keep it
// in shared memory and take null) -> dqkv [n * t, P] (dQ|dK|dV where T1
// puts Q|K|V; other columns and rows untouched). variant as T2's.
int tiled_attention_bwd(const void* qkv, const void* do_c, const void* stats, void* delta,
                        void* dqkv, int n, int t, int d, int heads, int gh, int pw, int P,
                        int n_valid, const void* nv_dev, float scale, int is_bf16, int variant,
                        void* stream) {
  const AttBwdArgs p{qkv,   do_c, static_cast<const float*>(stats), static_cast<float*>(delta),
                     dqkv,  n,    t,  d, heads, gh, pw, P, n_valid, scale,
                     static_cast<const int*>(nv_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_attention_bwd<bf16>(p, variant, s)
                 : launch_attention_bwd<float>(p, variant, s);
}

const char* tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
