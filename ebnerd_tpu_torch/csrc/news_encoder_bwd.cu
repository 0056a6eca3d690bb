// Fused NRMS news encoder, recompute backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_news_encoder_bwd` / `_bwd_kernel` /
// `_bwd_body` in ebnerd_tpu/ops/news_encoder.py. Given x (in bf16 with
// the embedding mask: round(x * mask) and its keep bits, as the forward
// drew them), the packed weights, the dropout (Philox seed or external
// mask) and the output cotangent g [N, D] fp32, it returns dx [N, T, Din]
// (x's dtype), the packed dWqkv [Din, P] and dW [D, A], db [A], dq [A] in
// fp32.
//
// The kernels:
//   1. news_encoder_bwd_kernel, one block per 64 rows, as the forward:
//      recompute QKV panel by panel (bf16: the forward's QKV stage, TMA-fed
//      wgmma, on the masked x, in clusters of 1 by its measured plan; fp32:
//      the forward's 3xTF32 stage, drawing the stream-0 mask) and the
//      attention, keeping the fp32 o; dropout on o; the pooling forward
//      (z, tanh, weights) and backward (dvals = round(o).round(g), datt,
//      per-block partials of dq = round(tanh)^T round(datt) and db = sum
//      dz); do = (w g + round(dz) round(W)^T) * mask, kept in the compute
//      dtype over o; then the attention backward of each (article, head)
//      on one warp: P, dP = dO V^T, dS, dV = P^T dO, dQ = dS K,
//      dK = dS^T Q (wmma 32 x 32 tiles in bf16; fp32: attention_bwd_tf32,
//      3xTF32 mma.sync by 16-row query and key tiles, with do, z and the
//      recomputed forward's products the same way). The operands
//      of every product are rounded to the compute dtype where the TPU
//      kernel's `_cdot`/`_bdot` round them. It writes per row: dQ|dK|dV in
//      the packed panel layout (dqkv, compute dtype), round(o) and
//      round(dz) for the weight products.
//   2. bwd_gemm_wgmma_kernel (bf16): dx = (dqkv Wqkv^T) * stream-0 mask,
//      and the weight gradients dWqkv = round(x * mask)^T dqkv and
//      dW = round(o)^T round(dz), which reduce over all N*T rows: split
//      along the rows into a number of slices fixed by the shapes, each
//      writing its own fp32 partial. bwd_mask_x_kernel draws the x
//      (stream-0) mask once per step, before the forward: round(x * mask)
//      for K1, this kernel and dWqkv, and one keep bit per element for
//      dx. bwd_gemm_fma_kernel computes the same products in fp32 (the
//      fp32 checks), drawing the mask itself.
//   3. reduce_rows_kernel sums partials (the GEMM slices, the per-block
//      db and dq) in a fixed order, in one pass or, for tall narrow
//      partials, in row chunks and then the chunk sums.
// So every weight gradient is the same bits on every run: no atomics.
//
// Blocks wholly past n_valid do nothing: their rows are left out of the
// GEMMs' reduction and dx there is written as zeros. Inside a valid block,
// articles at or past n_valid take g = 0 (the forward returns zeros for
// them), so they add nothing. With n_valid (and the seed) read from device
// memory, as a replayed CUDA graph needs, every launch takes the bucket's
// geometry instead: the GEMMs clip their rows to the count they read, and
// the blocks past it write zero partials and zero their rows up to the
// next 64-row k-tile edge, the last rows a weight-gradient k-tile reads.
//
// What bounds it on the card: counted by useful work, per article at the
// article-tower shape (T 30, Din 1024, D 400, A 200) the recompute forward
// is about 80 MFLOP and the backward's products about 155 MFLOP more (dx
// and dWqkv 74 each, the attention 5, pooling 5), so about 235 MFLOP per
// article: bf16 tensor-core operations bound it, not the bytes (x read
// twice, dx written, the dqkv scratch written and read twice).
// The GEMM: dx and dWqkv are bound by operations (2 x 671,100 x 1,024 x
// 1,280 = 1.76 TFLOP each at the news shape, 1.78 ms at 989 TFLOP/s; over
// 500 FLOP per byte moved, past the card's 295), dW by bytes (round(o) and
// round(dz) read once, 0.82 GB). Only wgmma reaches the tensor cores' rate,
// so the GEMM is warp-specialised: one producer thread keeps a 3- or
// 4-stage ring of 128 x 64 and 256 x 64 bf16 tiles in flight by TMA
// (128-byte swizzled, zeros past
// each operand's extent, so pad rows past n_valid add nothing without a
// branch), and two consumer warpgroups run m64n256k16 wgmma on them,
// reading dWqkv's and dW's [rows, features] operands through wgmma's
// transpose bits as they lie; registers move from the producer to the
// consumers (setmaxnreg). The x mask is one pass over x before the
// forward: inside a product's main loop it would be regenerated for every
// column tile, and its Philox work slows the GEMM wherever it runs there
// (see bwd_gemm_wgmma_kernel). The reduction is bound by bytes: 16-byte
// loads, columns spread over enough blocks, and tall narrow partials cut
// into row chunks so that they fill the card too.
// What is left: the dqkv round trip through device memory, the per-block
// kernel's attention, pooling and attention backward on wmma, in series
// with its QKV stage.

// Interface: plain C, bound from Python with ctypes
// (ebnerd_tpu_torch/ops/news_encoder.py); each entry point launches on
// the caller's stream and returns cudaGetLastError().

#include <string.h>

#include <algorithm>

#include "hopper.cuh"
#include "news_encoder_common.cuh"

namespace {

using namespace ne;

constexpr int kDoRows = 32;  // W_att rows (columns of do) per staged chunk

// Shared memory of the backward kernel: region R (reused by phase), then o
// [kRows][ldf] fp32 (later do in the compute dtype [kRows][ldo] at its
// start; sized for the wider of the two), then att, wts, dvals, datt [kRows] fp32 each, then (bf16) the
// QKV stage's barriers; bf16 offsets from the 1,024-aligned base, as the
// forward's. R holds, in turn,
// the forward's phases (Layout), then the pooling backward (hact / dz fp32
// [kRows][ldz] at R, or the two W_att chunks of the do product and
// per-warp scratch; dz in the compute dtype [kRows][lda] at dzc), then the per-warp
// attention-backward tiles (Q, K, V, dO in the compute dtype, one fp32).
// The wide instance keeps no dz in shared memory (it writes round(dz) to
// device memory and the do product reads it there) and its attention
// backward takes wpairs (article, head) pairs at a time, each with tiles Q,
// K, V, P and dS [kRows][wld] in the compute dtype (wld covers T and the
// head width up to 64).
// The fp32 stages on the tensor cores (tc) keep, instead of either
// instance's attention-backward tiles, tc_pairs (article, head) pairs at a
// time, each Q, K, V, P and dS [TR][TR + 4] fp32 (TR: the instance's T
// limit, 32 or 64; rows 4 mod 16 words apart for the fragments, see 3xTF32
// in news_encoder_common.cuh).
template <bool kWide>
struct TcTiles {
  static constexpr int kTR = kWide ? kWideMaxT : kMaxT, kLd = kTR + 4;
  static constexpr int kPairs = kWide ? 1 : 4;  // narrow: 4 pairs x 2 query tiles = 8 warps
  static constexpr size_t kPair = size_t(5) * kTR * kLd * 4;
};

struct BwdLayout {
  Layout f;
  int ldt, ldF, att_warps, wld, wpairs;
  size_t tile, warp_bytes, dzc, wpair, r, o, small, bars, total;
};

__host__ __device__ inline BwdLayout make_bwd_layout(int d, int a_pad, int elem, int stages,
                                                     bool wide, bool tc = false) {
  BwdLayout B;
  B.f = make_layout(d, a_pad, elem, stages, wide, tc);
  const bool bf = elem == 2;
  B.ldt = bf ? kTileLd : 33;
  B.ldF = bf ? kTileLdF : 33;
  B.att_warps = bf ? kWarps : kWarps / 2;
  B.tile = size_t(32) * B.ldt * elem;
  B.warp_bytes = align128(4 * B.tile + size_t(32) * B.ldF * 4);
  const size_t z = align128(size_t(kRows) * B.f.ldz * 4);
  const size_t wchunk = 2 * align128(size_t(kDoRows) * B.f.lda * elem) + size_t(kWarps) * 1024;
  B.dzc = smax(z, wchunk);
  B.wld = kWideMaxT + (bf ? 2 : 1);  // odd rows of 4-byte words
  B.wpairs = bf ? 2 : 1;
  B.wpair = align128(size_t(5) * kRows * B.wld * elem);
  const size_t pool_bwd = wide ? wchunk : B.dzc + align128(size_t(kRows) * B.f.lda * elem);
  const size_t att = tc ? (wide ? TcTiles<true>::kPairs * TcTiles<true>::kPair
                                 : TcTiles<false>::kPairs * TcTiles<false>::kPair)
                     : wide ? B.wpairs * B.wpair
                            : B.att_warps * B.warp_bytes;
  const size_t r = smax(smax(B.f.r, pool_bwd), att);
  B.r = bf ? align1024(r) : align128(r);
  B.o = B.r;
  // do's rows are the wider at a narrow D (fp32 at D 8: 20 floats, o's 9)
  B.small = B.o + align128(size_t(kRows) * smax(size_t(B.f.ldf) * 4, size_t(B.f.ldo) * elem));
  B.bars = B.small + size_t(4) * kRows * 4;
  B.total = bf ? B.bars + align128(2 * kQkvMaxStages * 8) + 1024 : B.bars;
  return B;
}

// The backward's slots against the widest tensor written into each (see
// layout_fits): the forward's phases in R, then the pooling backward (z or
// hact, the do product's two W_att chunks and per-warp 16 x 16 fp32
// scratch, the narrow instance's round(dz) at dzc) and the attention
// backward's tiles (narrow: per warp Q, K, V, dO and one fp32 tile of 32
// rows; wide: per pair Q, K, V, P, dS of up to 64 x 64); o's slot holds o
// in fp32, later do in the compute dtype; then att, wts, dvals, datt.
__host__ inline bool bwd_layout_fits(const BwdLayout& B, int d, int a_pad, int elem, int stages,
                                     bool wide, bool tc = false) {
  const Layout& L = B.f;
  const size_t wchunk = size_t(kDoRows) * L.lda * elem;
  const size_t do_prod = 2 * align128(wchunk) + size_t(kWarps) * 256 * 4;
  const size_t tc_tiles = wide ? TcTiles<true>::kPairs * 5 * TcTiles<true>::kTR *
                                     TcTiles<true>::kLd * 4
                               : TcTiles<false>::kPairs * 5 * TcTiles<false>::kTR *
                                     TcTiles<false>::kLd * 4;
  const size_t tiles = tc     ? tc_tiles
                       : wide ? size_t(B.wpairs) * 5 * kRows * B.wld * elem
                              : size_t(B.att_warps) * (4 * 32 * B.ldt * elem + 32 * B.ldF * 4);
  const bool narrow_dz = wide || (B.dzc >= size_t(kRows) * L.ldz * 4 && B.dzc >= do_prod &&
                                  B.r >= B.dzc + size_t(kRows) * L.lda * elem);
  return layout_fits(L, d, a_pad, elem, stages, wide, tc) && B.wld >= kWideMaxT &&
         B.wld >= kWideMaxHeadDim && B.ldt >= 32 && B.ldF >= 32 && B.r >= L.r && B.r >= do_prod &&
         B.r >= tiles && narrow_dz && B.small - B.o >= size_t(kRows) * L.ldf * 4 &&
         B.small - B.o >= size_t(kRows) * L.ldo * elem && B.bars - B.small >= size_t(4) * kRows * 4;
}

// F[i][j] = sum_k A'(i, k) B'(k, j) over 32 x 32 x 32 tiles of one warp;
// A' = A^T when TA, B' = B^T when TB; A and B are [32][ld] in the compute
// dtype, F [32][ldF] fp32.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void warp_mm(const T* A, const T* Bm, int ld, float* F, int ldF) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], TA ? A + kk * ld + i * 16 : A + i * 16 * ld + kk, ld);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bfr;
        wmma::load_matrix_sync(bfr, TB ? Bm + j * 16 * ld + kk : Bm + kk * ld + j * 16, ld);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(F + i * 16 * ldF + j * 16, acc[i][j], ldF, wmma::mem_row_major);
  } else {
    const int i = threadIdx.x % 32;
    float a[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) a[k] = to_f<T>(TA ? A[k * ld + i] : A[i * ld + k]);
    for (int j = 0; j < 32; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k) s += a[k] * to_f<T>(TB ? Bm[j * ld + k] : Bm[k * ld + j]);
      F[i * ldF + j] = s;
    }
  }
}

// Rows r < t, columns e < hd of F, rounded, to the panel slice at dst
// (row stride P).
template <typename T>
__device__ __forceinline__ void store_tile(const float* F, int ldF, T* dst, int P, int t, int hd) {
  if (std::is_same<T, bf16>::value && hd % 4 == 0) {  // 8 bytes a lane (see warp_tiles)
    const int q4 = hd / 4;
    for (int i = threadIdx.x % 32; i < t * q4; i += 32) {
      const int r = i / q4, c = (i % q4) * 4;
      const float4 f = *reinterpret_cast<const float4*>(F + r * ldF + c);
      *reinterpret_cast<uint2*>(dst + size_t(r) * P + c) =
          make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
    }
    return;
  }
  for (int i = threadIdx.x % 32; i < t * hd; i += 32) {
    const int r = i / hd, e = i % hd;
    dst[size_t(r) * P + e] = from_f<T>(F[r * ldF + e]);
  }
}

// Attention backward of one head group (heads [h0, h0 + nh) of the block's
// na articles): Q, K and V from the block's panel rows of the dqkv scratch
// (columns col0 + ...), dO from doc; dQ, dK and dV replace Q, K and V
// there. One warp per (article, head).
template <typename T>
__device__ void attention_bwd_group(T* qkv, int P, int col0, const T* doc, int ldo, int na, int t,
                                    int hd, int gh, int h0, int nh, float scale,
                                    unsigned char* R, const BwdLayout& B) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= B.att_warps) return;
  const int ld = B.ldt;
  T* Qs = reinterpret_cast<T*>(R + size_t(warp) * B.warp_bytes);
  T* Ks = Qs + 32 * ld;
  T* Vs = Ks + 32 * ld;
  T* Os = Vs + 32 * ld;
  float* F = reinterpret_cast<float*>(Os + 32 * ld);
  const T zero = from_f<T>(0.f);
  for (int pair = warp; pair < na * nh; pair += B.att_warps) {
    const int an = pair / nh, hl = pair % nh;
    T* q = qkv + size_t(an) * t * P + col0 + hl * hd;
    T* k = q + gh * hd;
    T* v = q + 2 * gh * hd;
    const T* dob = doc + an * t * ldo + (h0 + hl) * hd;
    if constexpr (std::is_same<T, bf16>::value) {
      T* const dst[4] = {Qs, Ks, Vs, Os};
      const T* const src[4] = {q, k, v, dob};
      const int lds[4] = {P, P, P, ldo};
      warp_tiles<4>(dst, src, lds, t, hd);
    } else {
      for (int i = lane; i < 32 * 32; i += 32) {
        const int r = i / 32, c = i % 32;
        const bool ok = r < t && c < hd;
        const size_t g = size_t(r) * P + c;
        Qs[r * ld + c] = ok ? q[g] : zero;
        Ks[r * ld + c] = ok ? k[g] : zero;
        Vs[r * ld + c] = ok ? v[g] : zero;
        Os[r * ld + c] = ok ? dob[r * ldo + c] : zero;
      }
    }
    __syncwarp();
    warp_mm<T, false, true>(Qs, Ks, ld, F, B.ldF);  // S = Q K^T
    __syncwarp();
    float p[32], ds[32];
    // one lane's row of F (bf16: 16 bytes at a time, see load_row32)
    auto row_of_f = [&](float (&v)[32]) {
      if constexpr (std::is_same<T, bf16>::value) {
        load_row32(v, F + lane * B.ldF);
      } else {
#pragma unroll
        for (int c = 0; c < 32; ++c) v[c] = F[lane * B.ldF + c];
      }
    };
    auto row_to_tile = [&](T* tile, const float (&v)[32]) {
      if constexpr (std::is_same<T, bf16>::value) {
        store_row32(tile + lane * ld, v);
      } else {
#pragma unroll
        for (int c = 0; c < 32; ++c) tile[lane * ld + c] = from_f<T>(v[c]);
      }
    };
    {  // softmax of query row `lane` over the t real keys (rows past t: 0);
       // bf16 as the forward's (exp2, reciprocal: see kLog2e)
      constexpr bool kFast = std::is_same<T, bf16>::value;
      float m = -INFINITY;
      row_of_f(p);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        p[c] *= kFast ? scale * kLog2e : scale;
        if (c < t) m = fmaxf(m, p[c]);
      }
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        p[c] = c < t && lane < t ? (kFast ? exp2f(p[c] - m) : expf(p[c] - m)) : 0.f;
        sum += p[c];
      }
      const float inv = 1.f / sum;
#pragma unroll
      for (int c = 0; c < 32; ++c) p[c] = lane < t ? (kFast ? p[c] * inv : p[c] / sum) : 0.f;
    }
    __syncwarp();
    warp_mm<T, false, true>(Os, Vs, ld, F, B.ldF);  // dP = dO V^T
    __syncwarp();
    {
      float ip = 0.f;
      row_of_f(ds);
#pragma unroll
      for (int c = 0; c < 32; ++c) ip += p[c] * ds[c];
#pragma unroll
      for (int c = 0; c < 32; ++c) ds[c] = p[c] * (ds[c] - ip) * scale;
    }
    row_to_tile(Vs, p);  // P over the spent V
    __syncwarp();
    warp_mm<T, true, false>(Vs, Os, ld, F, B.ldF);  // dV = P^T dO
    __syncwarp();
    store_tile<T>(F, B.ldF, v, P, t, hd);
    row_to_tile(Os, ds);  // dS over the spent dO
    __syncwarp();
    warp_mm<T, false, false>(Os, Ks, ld, F, B.ldF);  // dQ = dS K
    __syncwarp();
    store_tile<T>(F, B.ldF, q, P, t, hd);
    __syncwarp();
    warp_mm<T, true, false>(Os, Qs, ld, F, B.ldF);  // dK = dS^T Q
    __syncwarp();
    store_tile<T>(F, B.ldF, k, P, t, hd);
    __syncwarp();  // the tiles are free for the next pair
  }
}

// The wide instance's attention backward of one head group (heads [h0,
// h0 + nh) of the block's na articles), B.wpairs (article, head) pairs at a
// time: their Q, K and V copied from the dqkv scratch to tiles; then pass
// A, one warp per (pair, 16-row query tile): S, P, dP = dO V^T, dS = P (dP
// - rowsum(P dP)) scale, round(P) and round(dS) to tiles, dQ = round(dS) K
// to the scratch; pass B, one warp per (pair, 16-row key tile): dV =
// round(P)^T dO and dK = round(dS)^T Q to the scratch. bf16 on mma.sync
// fragments (news_encoder_common.cuh); fp32 by FMA, one thread per query
// row (pass A) and per key (pass B).
template <typename T>
__device__ void attention_bwd_wide(T* qkv, int P, int col0, const T* doc, int ldo, int na, int t,
                                   int hd, int gh, int h0, int nh, float scale, unsigned char* R,
                                   const BwdLayout& B) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int ld = B.wld, nq = (t + 15) / 16, pairs = na * nh;
  auto tile = [&](int slot, int m) {  // m: 0 Q, 1 K, 2 V, 3 P, 4 dS
    return reinterpret_cast<T*>(R + slot * B.wpair) + m * kRows * ld;
  };
  auto head = [&](int pair) { return qkv + size_t(pair / nh) * t * P + col0 + pair % nh * hd; };
  for (int p0 = 0; p0 < pairs; p0 += B.wpairs) {
    const int np = min(B.wpairs, pairs - p0);
    for (int slot = 0; slot < np; ++slot) {
      const T* src = head(p0 + slot);
      for (int i = tid; i < 3 * t * hd; i += kThreads) {
        const int m = i / (t * hd), r = i % (t * hd) / hd, e = i % hd;
        tile(slot, m)[r * ld + e] = src[size_t(r) * P + m * gh * hd + e];
      }
    }
    csync();
    if constexpr (std::is_same<T, bf16>::value) {
      const int slot = warp / 4, qt = warp % 4, g = tid % 32 / 4;
      const int pair = p0 + slot;
      const bool on = slot < np && qt < nq;
      const int an = pair / nh, hl = pair % nh;
      const int nkh = (hd + 15) / 16, nnh = (hd + 7) / 8, nnt = (t + 7) / 8;
      const Mat dO{doc + an * t * ldo + (h0 + hl) * hd, ldo, t, hd, false};
      if (on) {  // pass A
        float s[8][4], dp[8][4];
        warp_mma_rows(s, Mat{tile(slot, 0), ld, t, hd, false}, 16 * qt,
                      Mat{tile(slot, 1), ld, t, hd, true}, nkh, nnt);
        softmax_rows(s, t, scale, 16 * qt + g < t, 16 * qt + g + 8 < t);
        warp_mma_rows(dp, dO, 16 * qt, Mat{tile(slot, 2), ld, t, hd, true}, nkh, nnt);
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          d0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
          d1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, off);
          d1 += __shfl_xor_sync(0xffffffffu, d1, off);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dp[j][0] = s[j][0] * (dp[j][0] - d0) * scale;
          dp[j][1] = s[j][1] * (dp[j][1] - d0) * scale;
          dp[j][2] = s[j][2] * (dp[j][2] - d1) * scale;
          dp[j][3] = s[j][3] * (dp[j][3] - d1) * scale;
        }
        store_rows(s, tile(slot, 3), ld, 16 * qt, t, t);
        store_rows(dp, tile(slot, 4), ld, 16 * qt, t, t);
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        const Mat k{tile(slot, 1), ld, t, hd, false};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= nq) break;
          uint32_t fa[4];
          c_to_a(dp, kk, fa);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < nnh) {
              uint32_t fb[2];
              frag_b(k, 16 * kk, 8 * j, fb);
              mma_16816(acc[j], fa, fb);
            }
          }
        }
        store_rows(acc, head(pair), P, 16 * qt, t, hd);  // dQ over Q
      }
      csync();
      if (on) {  // pass B: key tile qt
        float acc[8][4];
        warp_mma_rows(acc, Mat{tile(slot, 3), ld, t, t, true}, 16 * qt, dO, nq, nnh);
        store_rows(acc, head(pair) + 2 * gh * hd, P, 16 * qt, t, hd);  // dV over V
        warp_mma_rows(acc, Mat{tile(slot, 4), ld, t, t, true}, 16 * qt,
                      Mat{tile(slot, 0), ld, t, hd, false}, nq, nnh);
        store_rows(acc, head(pair) + gh * hd, P, 16 * qt, t, hd);  // dK over K
      }
    } else {
      const int an = p0 / nh, hl = p0 % nh;
      const T* qs = tile(0, 0);
      const T* ks = tile(0, 1);
      const T* vs = tile(0, 2);
      T* ps = tile(0, 3);
      T* dss = tile(0, 4);
      const T* dob = doc + an * t * ldo + (h0 + hl) * hd;
      T* dst = head(p0);
      constexpr int kH = kWideMaxHeadDim;
      for (int i = tid; i < t; i += kThreads) {  // pass A: query row i
        float qv[kH];
#pragma unroll
        for (int e = 0; e < kH; ++e) qv[e] = e < hd ? qs[i * ld + e] : 0.f;
        auto logit = [&](int j) {
          float l = 0.f;
#pragma unroll
          for (int e = 0; e < kH; ++e)
            if (e < hd) l += qv[e] * ks[j * ld + e];
          return l * scale;
        };
        float m = -INFINITY, sum = 0.f, di = 0.f;
        for (int j = 0; j < t; ++j) m = fmaxf(m, logit(j));
        for (int j = 0; j < t; ++j) sum += expf(logit(j) - m);
        for (int j = 0; j < t; ++j) {
          const float pj = expf(logit(j) - m) / sum;
          float dpj = 0.f;
#pragma unroll
          for (int e = 0; e < kH; ++e)
            if (e < hd) dpj += dob[i * ldo + e] * vs[j * ld + e];
          ps[i * ld + j] = pj;
          dss[i * ld + j] = dpj;
          di += pj * dpj;
        }
        float acc[kH];
#pragma unroll
        for (int e = 0; e < kH; ++e) acc[e] = 0.f;
        for (int j = 0; j < t; ++j) {
          const float ds = ps[i * ld + j] * (dss[i * ld + j] - di) * scale;
          dss[i * ld + j] = ds;
#pragma unroll
          for (int e = 0; e < kH; ++e)
            if (e < hd) acc[e] += ds * ks[j * ld + e];
        }
#pragma unroll
        for (int e = 0; e < kH; ++e)
          if (e < hd) dst[size_t(i) * P + e] = acc[e];  // dQ over Q
      }
      csync();
      for (int j = tid; j < t; j += kThreads) {  // pass B: key j
        float dv[kH], dk[kH];
#pragma unroll
        for (int e = 0; e < kH; ++e) dv[e] = dk[e] = 0.f;
        for (int i = 0; i < t; ++i) {
          const float pij = ps[i * ld + j], dsij = dss[i * ld + j];
#pragma unroll
          for (int e = 0; e < kH; ++e)
            if (e < hd) {
              dv[e] += pij * dob[i * ldo + e];
              dk[e] += dsij * qs[i * ld + e];
            }
        }
#pragma unroll
        for (int e = 0; e < kH; ++e)
          if (e < hd) {
            dst[size_t(j) * P + gh * hd + e] = dk[e];      // dK over K
            dst[size_t(j) * P + 2 * gh * hd + e] = dv[e];  // dV over V
          }
      }
    }
    csync();  // the tiles are free for the next pairs
  }
}
static_assert(kWideMaxT <= 4 * 16 && kWideMaxHeadDim <= 8 * 8 && kWarps == 2 * 4,
              "a warp's query or key tile of 16 rows, 8 column tiles of 8; 2 pairs x 4 tiles");

// The fp32 attention backward of one head group on the tensor cores
// (3xTF32, both instances; news_encoder_common.cuh): TcTiles' kPairs
// (article, head) pairs at a time, their Q, K and V copied from the dqkv
// scratch into tiles; then pass A, one warp per (pair, 16-row query tile):
// S and dP = dO V^T (in one loop), P, dS = P (dP - rowsum(P dP)) scale,
// P and dS to tiles,
// dQ = dS K (dS's C fragments as the A operand) to the scratch over Q; pass
// B, one warp per (pair, 16-row key tile): dV = P^T dO and dK = dS^T Q (in
// one loop, paired k-steps down the tiles' rows) to the scratch over V and
// K.
template <bool kWide>
__device__ void attention_bwd_tf32(float* qkv, int P, int col0, const float* doc, int ldo, int na,
                                   int t, int hd, int gh, int h0, int nh, float scale,
                                   unsigned char* R) {
  using TT = TcTiles<kWide>;
  constexpr int ld = TT::kLd, kN = TT::kTR / 8;  // key and head tiles of 8 at the most
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4;
  const int nq = (t + 15) / 16, pairs = na * nh, nkh = (hd + 7) / 8, nkt = (t + 7) / 8;
  auto tile = [&](int slot, int m) {  // m: 0 Q, 1 K, 2 V, 3 P, 4 dS
    return reinterpret_cast<float*>(R + slot * TT::kPair) + m * TT::kTR * ld;
  };
  auto head = [&](int pair) { return qkv + size_t(pair / nh) * t * P + col0 + pair % nh * hd; };
  for (int p0 = 0; p0 < pairs; p0 += TT::kPairs) {
    const int np = min(TT::kPairs, pairs - p0);
    // Q, K and V of the pairs by cp.async (16 bytes where a head's columns are whole 16-byte
    // pieces, as they are in the panel layout when hd % 4 == 0), all in flight together
    const int vec = hd % 4 == 0 ? 4 : 1, hv = hd / vec;
    for (int i = tid; i < np * 3 * t * hv; i += kThreads) {
      const int e = i % hv * vec, r = i / hv % t, m = i / (t * hv) % 3, slot = i / (3 * t * hv);
      float* dst = tile(slot, m) + r * ld + e;
      const float* src = head(p0 + slot) + size_t(r) * P + m * gh * hd + e;
      if (vec == 4)
        cp_async16(dst, src, true);
      else
        cp_async4(dst, src);
    }
    cp_async_commit();
    cp_async_wait<0>();
    csync();
    for (int it = warp; it < np * nq; it += kWarps) {  // pass A: query tile qt
      const int slot = it / nq, qt = it % nq, pair = p0 + slot, an = pair / nh, hl = pair % nh;
      const FMat dO{doc + an * t * ldo + (h0 + hl) * hd, ldo, t, hd, false};
      float s[kN][4], dp[kN][4], acc[kN][4];
      warp_mma2_tf32<false>(s, FMat{tile(slot, 0), ld, t, hd, false},
                            FMat{tile(slot, 1), ld, t, hd, true}, dp, dO,
                            FMat{tile(slot, 2), ld, t, hd, true}, 16 * qt, nkh, nkt);
      softmax_rows(s, t, scale, 16 * qt + g < t, 16 * qt + g + 8 < t);
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        d0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
        d1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, off);
        d1 += __shfl_xor_sync(0xffffffffu, d1, off);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        dp[j][0] = s[j][0] * (dp[j][0] - d0) * scale;
        dp[j][1] = s[j][1] * (dp[j][1] - d0) * scale;
        dp[j][2] = s[j][2] * (dp[j][2] - d1) * scale;
        dp[j][3] = s[j][3] * (dp[j][3] - d1) * scale;
      }
      store_rows(s, tile(slot, 3), ld, 16 * qt, t, t);
      store_rows(dp, tile(slot, 4), ld, 16 * qt, t, t);
      warp_mma_tf32_c(acc, dp, FMat{tile(slot, 1), ld, t, hd, false}, nkt, nkh);
      store_rows(acc, head(pair), P, 16 * qt, t, hd);  // dQ over Q
    }
    csync();
    for (int it = warp; it < np * nq; it += kWarps) {  // pass B: key tile kt
      const int slot = it / nq, kt = it % nq, pair = p0 + slot, an = pair / nh, hl = pair % nh;
      const FMat dO{doc + an * t * ldo + (h0 + hl) * hd, ldo, t, hd, false};
      float dv[kN][4], dk[kN][4];
      warp_mma2_tf32<true>(dv, FMat{tile(slot, 3), ld, t, t, true}, dO, dk,
                           FMat{tile(slot, 4), ld, t, t, true},
                           FMat{tile(slot, 0), ld, t, hd, false}, 16 * kt, nkt, nkh);
      store_rows(dv, head(pair) + 2 * gh * hd, P, 16 * kt, t, hd);  // dV over V
      store_rows(dk, head(pair) + gh * hd, P, 16 * kt, t, hd);      // dK over K
    }
    csync();  // the tiles are free for the next pairs
  }
}

// K2's do = (w g + round(dz) W^T) * dropout mask on the tensor cores
// (3xTF32), over o's spent slot (doc [kRows][ldo]): A = round(dz) [rows x
// a_pad] (dzs, shared or device memory), B = W_att^T read from device
// memory (every block reads W_att; L2 keeps it); warp w takes the column
// tiles w, w + 8, w + 16, w + 24 (then 32 on) of 8 columns and the 4 row
// tiles, and scales its own outputs (the stream-1 mask, or the external
// one) as it stores them.
__device__ void do_tf32(const float* dzs, int ldzs, int rows, int a_pad, int d,
                        const float* __restrict__ w_att, const float* wts,
                        const float* __restrict__ gm, int g0, int t, int n_valid, int row0,
                        const philox::Dropout& dr, const float* __restrict__ ext, float inv_ext,
                        float* doc, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int nct = (d + 7) / 8, nk = a_pad / 8;
  const FMat a{dzs, ldzs, rows, a_pad, false};
  const FMat b{w_att, a_pad, d, a_pad, true};  // (j, col) = W[col][j]
  for (int ct0 = warp; ct0 < nct; ct0 += 4 * kWarps) {
    float acc[4][4][4];
    warp_mma_4x4_tf32(acc, a, b, ct0, nct, nk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * (ct0 + kWarps * j) + 2 * c;
      if (col >= d) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * i + g + 8 * h;
          if (r >= rows) continue;
          const int art = g0 + r / t;
          float4 m = make_float4(1.f, 1.f, 1.f, 1.f);
          if (dr.thr_att)
            m = philox::mask4(dr.key, uint32_t(row0 + r), uint32_t(col >> 2), 1u, dr.thr_att,
                              dr.inv_att);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col + e;
            if (cc >= d) break;
            float mj = philox::pick(m, cc & 3);
            if (!dr.thr_att && ext != nullptr) mj = ext[size_t(row0 + r) * d + cc] * inv_ext;
            const float gv = art < n_valid ? gm[size_t(art) * d + cc] : 0.f;
            doc[r * ldo + cc] = (wts[r] * gv + acc[i][j][2 * h + e]) * mj;
          }
        }
    }
  }
}

struct BwdArgs {
  const void* x;
  const void* wqkv;
  const void* w_att;
  const float* b_att;
  const float* q_att;
  const float* g;   // [n, d] fp32
  void* qkv;        // [n*t, P] compute dtype: Q|K|V panels, then dQ|dK|dV
  void* o_c;        // [n*t, ldoc] compute dtype: round(o) after dropout, zeros past d
  void* dz_c;       // [n*t, a_pad] compute dtype: round(dz)
  float* db_part;   // [blocks, a_pad]
  float* dq_part;   // [blocks, a_pad]
  int n, t, din, d, heads, gh, a, a_pad, n_valid, nb, stages, cluster, ldoc;
  float scale;
  philox::Dropout dr;
  const float* ext_mask;
  float inv_ext;
  const int* nv_dev;                  // n_valid in device memory, or null (n_valid above)
  const unsigned long long* seed_dev; // the seed in device memory, or null (dr.key above)
};

template <typename T, int kCta, bool kWide, bool kTc>
__global__ void __launch_bounds__(kCta, 1)
    news_encoder_bwd_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap, BwdArgs p) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  static_assert(!(kBf && kTc), "kTc: the fp32 stages on the tensor cores");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = kBf ? align_smem(smem_raw) : smem_raw;
  const BwdLayout B = make_bwd_layout(p.d, p.a_pad, sizeof(T), p.stages, kWide, kTc);
  const Layout& L = B.f;
  unsigned char* R = smem;
  float* o = reinterpret_cast<float*>(smem + B.o);
  float* att = reinterpret_cast<float*>(smem + B.small);
  float* wts = att + kRows;
  float* dvals = wts + kRows;
  float* datt = dvals + kRows;
  constexpr int VE = 16 / sizeof(T);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = p.t, d = p.d, a = p.a, a_pad = p.a_pad, din = p.din, ldoc = p.ldoc;
  const int g0 = blockIdx.x * p.nb;
  const int n_valid = valid_at(p.n_valid, p.nv_dev, p.n);
  const bool active = g0 < n_valid;  // blocks past it are left out of the GEMMs and reductions
  const int na = max(0, min(p.nb, p.n - g0));
  const int rows = na * t, row0 = g0 * t;
  const int hd = d / p.heads;
  const int n_groups = (p.heads + p.gh - 1) / p.gh;
  const int P = n_groups * kPanel;
  const T* w_att = static_cast<const T*>(p.w_att);
  T* qkv = static_cast<T*>(p.qkv) + size_t(row0) * P;
  philox::Dropout dr = p.dr;
  dr.key = philox::key_at(dr.key, p.seed_dev);

  // With n_valid in device memory the GEMMs and reductions take the
  // bucket's geometry: a block wholly past n_valid writes zero partials, and
  // zeros into its rows below the 64-row k-tile edge after the last valid
  // row, which the weight-gradient GEMM's last k-tile reads (TMA fills only
  // rows past the bucket with zeros).
  auto zero_tail = [&]() {
    for (int j = tid; j < a_pad; j += kThreads) {
      p.db_part[size_t(blockIdx.x) * a_pad + j] = 0.f;
      p.dq_part[size_t(blockIdx.x) * a_pad + j] = 0.f;
    }
    const int lim = max(0, min(rows, (n_valid * t + 63) / 64 * 64 - row0));
    T* oc = static_cast<T*>(p.o_c) + size_t(row0) * ldoc;
    T* dz = static_cast<T*>(p.dz_c) + size_t(row0) * a_pad;
    for (int i = tid; i < lim * P; i += kThreads) qkv[i] = from_f<T>(0.f);
    for (int i = tid; i < lim * ldoc; i += kThreads) oc[i] = from_f<T>(0.f);
    for (int i = tid; i < lim * a_pad; i += kThreads) dz[i] = from_f<T>(0.f);
  };

  // 1. recompute the forward: QKV panels (kept in the dqkv scratch) and o
  // (each panel copied out of R before that group's attention)
  auto keep_panel = [&](int g) {
    const T* panel = reinterpret_cast<const T*>(R);
    for (int i = tid; i < rows * (kPanel / VE); i += kThreads) {
      const int r = i / (kPanel / VE), c = (i % (kPanel / VE)) * VE;
      *reinterpret_cast<uint4*>(qkv + size_t(r) * P + g * kPanel + c) =
          *reinterpret_cast<const uint4*>(panel + r * L.ldw + c);
    }
  };
  auto attend = [&](int g) {
    if (!(NE_PHASES & 2)) return;
    if constexpr (kTc)
      attention_group_tf32<kWide ? 8 : 4>(reinterpret_cast<const float*>(R), L.ldw, o, L.ldf, na, t, hd, p.gh,
                           g * p.gh, min(p.gh, p.heads - g * p.gh), p.scale);
    else
      attention_group<T, kWide>(reinterpret_cast<const T*>(R), L.ldw, o, L.ldf, na, t, hd, p.gh,
                                g * p.gh, min(p.gh, p.heads - g * p.gh), p.scale, R + L.panel);
  };
  if constexpr (kBf) {
    const int nk = (din + kQkvBK - 1) / kQkvBK;
    // the cluster's CTAs run the QKV stage together when its first block is valid
    const bool run_qkv = int(blockIdx.x) / p.cluster * p.cluster * p.nb < n_valid;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + B.bars);
    const QkvRing q{smem, bars, bars + kQkvMaxStages, p.stages, p.cluster};
    if (tid == 0) qkv_ring_init(q);
    hop::cluster_sync();
    if (tid >= kThreads) {  // the producer warpgroup
      hop::regs_dec<40>();
      if (tid == kThreads && run_qkv && (NE_PHASES & 1))
        qkv_produce(q, &xmap, &wmap, row0, n_groups, nk);
      return;
    }
    hop::regs_inc<232>();
    if (!active && p.nv_dev != nullptr) zero_tail();
    if (!run_qkv) return;
    int it = 0;
    for (int g = 0; g < n_groups; ++g) {
      if (NE_PHASES & 1) qkv_panel_wgmma(q, it, nk, reinterpret_cast<bf16*>(R), L.ldw);
      csync();
      if (active) {
        keep_panel(g);
        attend(g);
      }
      if (NE_PHASES & 1)
        qkv_panel_done(q, it);  // the ring is free to refill
      else
        csync();
    }
    if (!active) return;
  } else {
    if (!active) {
      if (p.nv_dev != nullptr) zero_tail();
      return;
    }
    const float* xb = static_cast<const float*>(p.x) + size_t(row0) * din;
    const EmbDrop ed{dr.key, dr.thr_emb, dr.inv_emb, row0};
    const float* wq = static_cast<const float*>(p.wqkv);
    for (int g = 0; g < n_groups; ++g) {
      if (NE_PHASES & 1) {
        if constexpr (kTc)
          qkv_panel_tf32(xb, rows, din, wq + g * kPanel, P, L, R, ed);
        else
          qkv_panel_fp32(xb, rows, din, wq + g * kPanel, P, L, R, ed);
      }
      csync();
      keep_panel(g);
      attend(g);
      csync();
    }
  }
  drop_o(o, L.ldf, rows, d, row0, dr, p.ext_mask, p.inv_ext);
  csync();

  // 2. round(o) for dW (zeros past d); dvals[r] = round(o[r]) . round(g[article])
  T* o_c = static_cast<T*>(p.o_c) + size_t(row0) * ldoc;
  if (ldoc == d) {  // no pad columns: the loop without a per-column check
    for (int i = tid; i < rows * d; i += kThreads) o_c[i] = from_f<T>(o[(i / d) * L.ldf + i % d]);
  } else {
    for (int i = tid; i < rows * ldoc; i += kThreads) {
      const int r = i / ldoc, c = i % ldoc;
      o_c[i] = from_f<T>(c < d ? o[r * L.ldf + c] : 0.f);
    }
  }
  for (int r = warp; r < rows; r += kWarps) {
    const int art = g0 + r / t;
    float v = 0.f;
    if (art < n_valid)
      for (int c = lane; c < d; c += 32) v += rnd<T>(o[r * L.ldf + c]) * rnd<T>(p.g[size_t(art) * d + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) dvals[r] = v;
  }
  csync();

  // 3. pooling forward: z = round(o) W, hact = tanh(z + b) kept in place, weights
  //    (wide: z by column chunks from round(o) in device memory, hact recomputed in 5)
  float* hz = reinterpret_cast<float*>(R);
  T* dz_g = static_cast<T*>(p.dz_c) + size_t(row0) * a_pad;
  if constexpr (kWide) {
    pooling_wide<T, T, kTc>(o_c, ldoc, rows, na, t, d, w_att, p.b_att, p.q_att, a, a_pad, L, R,
                            att, wts);
  } else if (NE_PHASES & 4) {
    pooling_logits<T, kTc>(o, rows, d, w_att, a_pad, L, R);
    csync();
    pooling_weights<T>(hz, L.ldz, p.b_att, p.q_att, a, rows, na, t, att, wts, true);
  }

  // 4. datt = w (dvals - sum_t w dvals); zero for articles past n_valid
  if constexpr (kWide) {  // lanes stride the tokens
    for (int an = warp; an < na; an += kWarps) {
      float inner = 0.f;
      for (int l = lane; l < t; l += 32) inner += wts[an * t + l] * dvals[an * t + l];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) inner += __shfl_xor_sync(0xffffffffu, inner, off);
      for (int l = lane; l < t; l += 32) {
        const int r = an * t + l;
        datt[r] = g0 + an < n_valid ? wts[r] * (dvals[r] - inner) : 0.f;
      }
    }
  } else {
    for (int an = warp; an < na; an += kWarps) {
      const int r = an * t + lane;
      const float wv = lane < t ? wts[r] * dvals[r] : 0.f;
      float inner = wv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) inner += __shfl_xor_sync(0xffffffffu, inner, off);
      if (lane < t) datt[r] = g0 + an < n_valid ? wts[r] * (dvals[r] - inner) : 0.f;
    }
  }
  csync();

  // 5. per column j: dq += round(hact) round(datt); dz = round(datt) round(q) (1 - hact^2);
  //    db += dz; round(dz) kept for do and written for dW (wide: by column chunks, z
  //    recomputed, round(dz) to device memory only)
  if constexpr (kWide) {
    for (int c0 = 0; c0 < ((NE_PHASES & 4) ? a_pad : 0); c0 += kAttChunk) {
      pooling_logits_chunk<T, T, kTc>(o_c, ldoc, rows, d, w_att, a_pad, c0, L, R);
      csync();
      const int j = c0 + tid;
      if (tid < min(kAttChunk, a_pad - c0)) {
        const float qj = j < a ? rnd<T>(p.q_att[j]) : 0.f, bj = j < a ? p.b_att[j] : 0.f;
        float dq = 0.f, db = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float h = j < a ? tanhf(hz[r * L.ldz + tid] + bj) : 0.f, dr = rnd<T>(datt[r]);
          dq += rnd<T>(h) * dr;
          const float dz = j < a ? dr * qj * (1.f - h * h) : 0.f;
          db += dz;
          dz_g[size_t(r) * a_pad + j] = from_f<T>(dz);
        }
        p.db_part[size_t(blockIdx.x) * a_pad + j] = db;
        p.dq_part[size_t(blockIdx.x) * a_pad + j] = j < a ? dq : 0.f;
      }
      csync();  // z is spent before the next chunk's product
    }
  }
  T* dzc = reinterpret_cast<T*>(R + B.dzc);
  for (int j = tid; j < ((NE_PHASES & 4) && !kWide ? a_pad : 0); j += kThreads) {
    const float qj = j < a ? rnd<T>(p.q_att[j]) : 0.f;
    float dq = 0.f, db = 0.f;
    for (int r = 0; r < kRows; ++r) {
      float dz = 0.f;
      if (r < rows) {
        const float h = hz[r * L.ldz + j], dr = rnd<T>(datt[r]);
        dq += rnd<T>(h) * dr;
        dz = j < a ? dr * qj * (1.f - h * h) : 0.f;
        db += dz;
      }
      dzc[r * L.lda + j] = from_f<T>(dz);
    }
    p.db_part[size_t(blockIdx.x) * a_pad + j] = db;
    p.dq_part[size_t(blockIdx.x) * a_pad + j] = j < a ? dq : 0.f;
  }
  csync();
  for (int i = tid; i < (kWide ? 0 : rows * (a_pad / VE)); i += kThreads) {
    const int r = i / (a_pad / VE), c = (i % (a_pad / VE)) * VE;
    *reinterpret_cast<uint4*>(dz_g + size_t(r) * a_pad + c) =
        *reinterpret_cast<const uint4*>(dzc + r * L.lda + c);
  }

  // 6. do = (w g + round(dz) round(W)^T) * dropout mask, in the compute
  //    dtype over o (spent), kDoRows columns at a time; the W_att chunks
  //    double-buffered by cp.async, 16 bytes a copy (a_pad % 16 == 0);
  //    round(dz) from shared memory (wide: from device memory)
  T* doc = reinterpret_cast<T*>(o);
  const T* dzs = kWide ? dz_g : dzc;
  const int ldzs = kWide ? a_pad : L.lda;
  const size_t wchunk = align128(size_t(kDoRows) * L.lda * sizeof(T));
  auto wsc = [&](int s) { return reinterpret_cast<T*>(R + s * wchunk); };
  float* scr = reinterpret_cast<float*>(R + 2 * wchunk);
  auto issue_w = [&](int kc, int s) {
    T* dst = wsc(s);
    for (int i = tid; i < kDoRows * (a_pad / VE); i += kThreads) {
      const int rr = i / (a_pad / VE), j = (i % (a_pad / VE)) * VE, r = kc * kDoRows + rr;
      cp_async16(dst + rr * L.lda + j, r < d ? w_att + size_t(r) * a_pad + j : w_att, r < d);
    }
  };
  if constexpr (kTc) {
    if (NE_PHASES & 8)
      do_tf32(dzs, ldzs, rows, a_pad, d, w_att, wts, p.g, g0, t, n_valid, row0, dr, p.ext_mask,
              p.inv_ext, doc, L.ldo);
    csync();
  }
  const int n_do = (NE_PHASES & 8) && !kTc ? (d + kDoRows - 1) / kDoRows : 0;
  pipeline<2>(n_do, issue_w, [&](int kc, int s) {
    const int c0 = kc * kDoRows;
    const T* ws = wsc(s);
    // each warp: a 16 x 16 tile (rows mi*16, columns c0 + nj*16); fp32 also per tile
    const int mi = warp / 2, nj = warp % 2;
    float* sc = scr + warp * 256;
    if constexpr (std::is_same<T, bf16>::value) {
      using namespace nvcuda;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < a_pad; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, dzs + mi * 16 * ldzs + kk, ldzs);
        wmma::load_matrix_sync(bfr, ws + nj * 16 * L.lda + kk, L.lda);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
    } else {
      for (int e = lane; e < 256; e += 32) {
        const T* zr = dzs + (mi * 16 + e / 16) * ldzs;
        const T* wr = ws + (nj * 16 + e % 16) * L.lda;
        float s = 0.f;
        for (int j = 0; j < a_pad; ++j) s += to_f<T>(zr[j]) * to_f<T>(wr[j]);
        sc[e] = s;
      }
    }
    __syncwarp();
    for (int e4 = lane; e4 < 64; e4 += 32) {
      const int rr = e4 / 4, cc = (e4 % 4) * 4;
      const int r = mi * 16 + rr, c = c0 + nj * 16 + cc;
      if (r >= rows || c >= d) continue;
      const int art = g0 + r / t;
      float4 m = make_float4(1.f, 1.f, 1.f, 1.f);
      if (dr.thr_att)
        m = philox::mask4(dr.key, uint32_t(row0 + r), uint32_t(c >> 2), 1u, dr.thr_att,
                          dr.inv_att);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j >= d) break;
        float mj = philox::pick(m, j);
        if (!dr.thr_att && p.ext_mask != nullptr)
          mj = p.ext_mask[size_t(row0 + r) * d + c + j] * p.inv_ext;
        const float gv = art < n_valid ? p.g[size_t(art) * d + c + j] : 0.f;
        doc[r * L.ldo + c + j] = from_f<T>((wts[r] * gv + sc[rr * 16 + cc + j]) * mj);
      }
    }
  });

  // 7. attention backward, head group by head group
  for (int g = 0; g < ((NE_PHASES & 16) ? n_groups : 0); ++g) {
    if constexpr (kTc)
      attention_bwd_tf32<kWide>(qkv, P, g * kPanel, doc, L.ldo, na, t, hd, p.gh, g * p.gh,
                                min(p.gh, p.heads - g * p.gh), p.scale, R);
    else if constexpr (kWide)
      attention_bwd_wide<T>(qkv, P, g * kPanel, doc, L.ldo, na, t, hd, p.gh, g * p.gh,
                            min(p.gh, p.heads - g * p.gh), p.scale, R, B);
    else
      attention_bwd_group<T>(qkv, P, g * kPanel, doc, L.ldo, na, t, hd, p.gh, g * p.gh,
                             min(p.gh, p.heads - g * p.gh), p.scale, R, B);
  }
}

// ---- the weight-gradient and dx GEMM, bf16: warp-specialised wgmma ----
// kDx: C [M, N] bf16 = A [M, K] B[N, K]^T, times the stream-0 mask of
//      (row m, column n); rows m >= m_valid are zeros. Both operands are
//      K-major (rows of dqkv, rows of wqkv).
// else: partial C_z [M, N] fp32 = sum over rows k of slice z of
//      A[k, m] B[k, n]: both operands M/N-major as they lie ([rows,
//      features]); wgmma reads them through its transpose bits. The rows
//      past K arrive from TMA as zeros.
// Persistent: one CTA per SM walks the 128 x kWBN output tiles (and row
// slices) in a fixed order, column tiles fastest, so the CTAs that run
// together share their A rows in L2; each tile, slice by slice, is
// computed whole by one CTA in k order, so its bits do not depend on the
// CTA count. Warpgroup 0 gives up registers; one of its threads issues the
// TMA loads of a kWStages-deep ring of 64-deep k-tiles, one stream across
// all the CTA's tiles (so the next tile's loads overlap this tile's
// epilogue), handed over through full/empty mbarriers. Warpgroups 1 and 2
// each own 64 rows of the tile and issue m64n256k16 wgmma with fp32
// accumulators in registers, one k-tile's products in flight while the
// next is issued. The epilogue stores from the accumulators: the partials
// as fp32 pairs, dx in bf16 after a transpose within each quad of lanes,
// so that every lane stores 16 bytes and each store fills whole sectors.
// A masked dx reads the stream-0 keep bits that bwd_mask_x_kernel drew,
// one per element: on an H100, Philox work inside this kernel (in the
// epilogue, in idle producer warps or beside the main loop's wgmma) cost
// the news tower's dx 0.5-1.0 ms.
// The ring is 4 stages deep, 3 for the weight gradients of outputs of at
// most 512 rows (dW, the user tower's dWqkv); launch_gemm_bf16 chooses by
// the shape, and the depth does not change the summation order.
constexpr int kWBM = 128, kWBN = 256, kWBK = 64, kWThreads = 384;
constexpr int kWAtom = kWBK * 128;  // one [64 k][64 m or n] box of an M/N-major operand
constexpr int kWABytes = kWBM * kWBK * 2, kWBBytes = kWBN * kWBK * 2;
constexpr int kWStage = kWABytes + kWBBytes;
// the ring, its full and empty barriers, and room to align it to 1,024 bytes
constexpr int wg_smem(int stages) { return stages * kWStage + 2 * stages * 8 + 1024; }
constexpr int kWKeepWords = kWBN / 32;  // keep-bit words of one tile row
static_assert(kWBK * 2 == 128, "a k-tile row is one 128-byte swizzle span");
static_assert(kWABytes % 1024 == 0 && kWStage % 1024 == 0, "tiles stay 1,024-byte aligned");
static_assert(wg_smem(4) <= kSmemLimit, "the ring fits in shared memory");

struct WgArgs {
  void* out;
  int M, N, K, k_per_split, splits, m_valid;
  const uint32_t* keep;  // dx: keep bits [m_valid, keep_ld] of the mask, or null (no mask)
  int keep_ld;
  float inv;             // 1 / keep probability: a kept element's scale
  const int* nv_dev;     // a valid count in device memory, or null: valid rows are nv_mul
  int nv_mul;            // times it (dx: m_valid; weight gradients: K at most)
};

// The rows a launch reads: with a valid count in device memory (a CUDA
// graph's replay), dx's m_valid and the weight gradients' K become at most
// nv_mul times it; else they are as passed.
__device__ __forceinline__ int rows_at(int rows, const int* dev, int mul) {
  return dev != nullptr ? min(rows, max(0, *dev) * mul) : rows;
}

// Tile t of the walk: column tile fastest, then row tile, then slice.
struct WgTile {
  int m0, n0, z, k_begin, nk;
};

template <bool kDx>
__device__ __forceinline__ WgTile wg_tile(const WgArgs& p, int t) {
  const int n_tiles = (p.N + kWBN - 1) / kWBN, m_tiles = (p.M + kWBM - 1) / kWBM;
  WgTile w;
  w.n0 = (t % n_tiles) * kWBN;
  w.m0 = (t / n_tiles % m_tiles) * kWBM;
  w.z = t / (n_tiles * m_tiles);
  w.k_begin = w.z * p.k_per_split;
  const int k_end = min(p.K, w.k_begin + p.k_per_split);
  w.nk = k_end > w.k_begin ? (k_end - w.k_begin + kWBK - 1) / kWBK : 0;
  if (kDx && w.m0 >= p.m_valid) w.nk = 0;  // rows past n_valid: zeros, nothing loaded
  return w;
}

template <bool kDx, int kWStages>
__global__ void __launch_bounds__(kWThreads, 1)
    bwd_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, WgArgs p) {
  extern __shared__ __align__(1024) unsigned char wsm_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsm_raw) + 1023) & ~uintptr_t(1023));
  if (kDx)
    p.m_valid = rows_at(p.m_valid, p.nv_dev, p.nv_mul);
  else
    p.K = rows_at(p.K, p.nv_dev, p.nv_mul);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kWStages * kWStage);
  uint64_t* empty = full + kWStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int tiles = ((p.N + kWBN - 1) / kWBN) * ((p.M + kWBM - 1) / kWBM) * (kDx ? 1 : p.splits);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hop::regs_dec<40>();
    if (tid == 0) {
      hop::tma_prefetch_map(&ta);
      hop::tma_prefetch_map(&tb);
      int it = 0;  // k-tiles issued by this CTA
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const WgTile w = wg_tile<kDx>(p, t);
        for (int kt = 0; kt < w.nk; ++kt, ++it) {
          const int s = it % kWStages;
          hop::mbar_wait(&empty[s], ((it / kWStages) & 1) ^ 1);
          hop::mbar_expect_tx(&full[s], kWStage);
          unsigned char* a_s = sm + s * kWStage;
          unsigned char* b_s = a_s + kWABytes;
          const int k0 = w.k_begin + kt * kWBK;
          if constexpr (kDx) {
            hop::tma_load_2d(a_s, &ta, &full[s], k0, w.m0);
            hop::tma_load_2d(b_s, &tb, &full[s], k0, w.n0);
          } else {
#pragma unroll
            for (int j = 0; j < kWBM / 64; ++j)
              hop::tma_load_2d(a_s + j * kWAtom, &ta, &full[s], w.m0 + 64 * j, k0);
#pragma unroll
            for (int j = 0; j < kWBN / 64; ++j)
              hop::tma_load_2d(b_s + j * kWAtom, &tb, &full[s], w.n0 + 64 * j, k0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each tile;
  // thread (warp, lane) holds rows r and r + 8, columns
  // 8 i + 2 (lane % 4) + {0, 1} of each 8-column group i
  hop::regs_inc<232>();
  const int cw = wg - 1;
  float acc[kWBN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const WgTile w = wg_tile<kDx>(p, t);
    const int r = w.m0 + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < kWBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < w.nk; ++kt, ++it) {
      const int s = it % kWStages;
      hop::mbar_wait(&full[s], (it / kWStages) & 1);
      const unsigned char* a_s = sm + s * kWStage;
      const unsigned char* b_s = a_s + kWABytes;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk) {
        const uint64_t da = kDx ? hop::smem_desc(a_s + cw * 64 * 128 + kk * 32, 16, 1024)
                                : hop::smem_desc(a_s + cw * kWAtom + kk * 2048, kWAtom, 1024);
        const uint64_t db = kDx ? hop::smem_desc(b_s + kk * 32, 16, 1024)
                                : hop::smem_desc(b_s + kk * 2048, kWAtom, 1024);
        hop::wgmma_m64n256k16<kDx ? 0 : 1, kDx ? 0 : 1>(acc, da, db);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // k-tile it - 1 is consumed: hand its stage back
      if (kt > 0 && lane == 0) hop::mbar_arrive(&empty[(it - 1) % kWStages]);
    }
    hop::wgmma_wait<0>();
    if (w.nk > 0 && lane == 0) hop::mbar_arrive(&empty[(it - 1) % kWStages]);
    hop::fence_regs(acc);

    if constexpr (kDx) {
      // keep bits of rows r and r + 8 over the tile's columns (word q:
      // columns n0 + 32 q + [0, 32)); all kept without a mask
      uint32_t k0[kWKeepWords], k8[kWKeepWords];
#pragma unroll
      for (int q = 0; q < kWKeepWords; ++q) {
        const bool in = p.keep != nullptr && w.n0 + 32 * q < p.N;
        k0[q] = in && r < p.m_valid ? p.keep[size_t(r) * p.keep_ld + w.n0 / 32 + q] : ~0u;
        k8[q] = in && r + 8 < p.m_valid ? p.keep[size_t(r + 8) * p.keep_ld + w.n0 / 32 + q] : ~0u;
      }
      const float inv = p.keep != nullptr ? p.inv : 1.f;
      bf16* C = static_cast<bf16*>(p.out);
      const int qd = lane % 4;
#pragma unroll
      for (int i2 = 0; i2 < kWBN / 16; ++i2) {
        // this lane's bf16 pairs of groups 2 i2 and 2 i2 + 1, rows r and r + 8
        uint32_t v[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * i2 + h;
          const int sh = 8 * (i % 4) + 2 * (lane % 4);
          const uint32_t b0 = k0[i / 4] >> sh, b8 = k8[i / 4] >> sh;
          v[h] = pack_bf16(acc[4 * i] * (b0 & 1 ? inv : 0.f), acc[4 * i + 1] * (b0 & 2 ? inv : 0.f));
          v[2 + h] =
              pack_bf16(acc[4 * i + 2] * (b8 & 1 ? inv : 0.f), acc[4 * i + 3] * (b8 & 2 ? inv : 0.f));
        }
        // 4 x 4 transpose in the quad: lane qd gathers (row r + 8 (qd / 2),
        // group 2 i2 + qd % 2), the four lanes' pairs in column order
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int src = qd ^ k;
          const uint32_t send = src == 0 ? v[0] : src == 1 ? v[1] : src == 2 ? v[2] : v[3];
          const uint32_t got = k ? __shfl_xor_sync(0xffffffffu, send, k) : send;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j == src) o[j] = got;
        }
        const int row = r + 8 * (qd / 2), col = w.n0 + 16 * i2 + 8 * (qd % 2);
        if (row < p.M && col < p.N)
          *reinterpret_cast<uint4*>(C + size_t(row) * p.N + col) =
              row < p.m_valid ? make_uint4(o[0], o[1], o[2], o[3]) : make_uint4(0, 0, 0, 0);
      }
    } else {
      float* C = static_cast<float*>(p.out) + size_t(w.z) * p.M * p.N;
#pragma unroll
      for (int i = 0; i < kWBN / 8; ++i) {
        const int c = w.n0 + 8 * i + 2 * (lane % 4);
        if (c >= p.N) continue;
        if (r < p.M)
          *reinterpret_cast<float2*>(C + size_t(r) * p.N + c) = make_float2(acc[4 * i], acc[4 * i + 1]);
        if (r + 8 < p.M)
          *reinterpret_cast<float2*>(C + size_t(r + 8) * p.N + c) =
              make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
  }
}

// The stream-0 mask of rows [0, rows) and columns [0, cols), drawn once
// for both products that need it: xm [rows, cols] = round(a * mask) in
// bf16 (when xm is given; a is [rows, a_cols], a_cols <= cols, and xm is
// zero past a_cols: the kernels' zero-padded x) and the keep bits [rows,
// keep_ld] (when keep is given; bit j of word q is column 32 q + j, 0 past
// cols). A quad of lanes per 32-column word, 8 columns a lane: two Philox
// calls, one 16-byte load and store, so that a warp reads and writes 512
// contiguous bytes; the quad ORs its four bytes of the word together.
// Where a's rows are not 16-byte aligned (a_cols % 8 != 0) or the 8
// columns cross a_cols, the lane loads them one by one. Grid-stride;
// rows * words * 4 < 2^31 and cols % 8 == 0.
__global__ void __launch_bounds__(256) bwd_mask_x_kernel(const bf16* __restrict__ a, int a_cols,
                                                         bf16* __restrict__ xm,
                                                         uint32_t* __restrict__ keep, int keep_ld,
                                                         int rows, int cols, philox::Key key,
                                                         uint32_t thr, float inv,
                                                         const int* rows_dev, int rows_mul,
                                                         const unsigned long long* seed) {
  const int words = (cols + 31) / 32, n = rows * words * 4, j = threadIdx.x % 4;
  const unsigned quad = 0xFu << (threadIdx.x % 32 & ~3);
  const int valid = rows_at(rows, rows_dev, rows_mul);  // rows past it: zeros, no bit kept
  key = philox::key_at(key, seed);
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    const int r = i / 4 / words, q = i / 4 % words, c = 32 * q + 8 * j;
    const bool live = r < valid;
    uint32_t b = 0;
    if (c < cols && live)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 x = philox::philox4x32_10(make_uint4(uint32_t(r), uint32_t(c / 4 + h), 0u, 0u), key);
        b |= (uint32_t((x.x >> 8) < thr) | uint32_t((x.y >> 8) < thr) << 1 |
              uint32_t((x.z >> 8) < thr) << 2 | uint32_t((x.w >> 8) < thr) << 3)
             << (4 * h);
      }
    if (keep != nullptr) {
      uint32_t word = b << (8 * j);
      word |= __shfl_xor_sync(quad, word, 1);
      word |= __shfl_xor_sync(quad, word, 2);
      if (j == 0) keep[size_t(r) * keep_ld + q] = word;
    }
    if (xm != nullptr && c < cols) {
      const bf16* src = a + size_t(r) * a_cols + c;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      bf16* e = reinterpret_cast<bf16*>(&u);
      if (live && a_cols % 8 == 0 && c + 8 <= a_cols) {
        u = *reinterpret_cast<const uint4*>(src);
      } else if (live) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (c + k < a_cols) e[k] = src[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e[k] = __float2bfloat16_rn(__bfloat162float(e[k]) * ((b >> k) & 1 ? inv : 0.f));
      *reinterpret_cast<uint4*>(xm + size_t(r) * cols + c) = u;
    }
  }
}

// ---- the same products in fp32 (the fp32 checks): FMA ----
// 128 x 128 tiles, 256 threads each 8 x 8 by FMA, kGStages-deep cp.async
// pipeline over 64-byte contraction chunks; the weight gradient's A is
// masked in shared memory when thr != 0.
constexpr int kBM = 128, kBN = 128, kGThreads = 256, kGBytes = 64, kGStages = 3;

template <bool kDx>
struct GemmTiles {
  static constexpr int VE = 4;
  static constexpr int BK = kGBytes / 4;
  // A: kDx [BM][BK + VE] (m rows), else [BK][BM + VE] (k rows)
  static constexpr int lda = kDx ? BK + VE : kBM + VE;
  static constexpr int a_elems = kDx ? kBM * lda : BK * lda;
  // B: kDx [BN][BK + VE] (n rows), else [BK][BN + VE] (k rows)
  static constexpr int ldb = kDx ? BK + VE : kBN + VE;
  static constexpr int b_elems = kDx ? kBN * ldb : BK * ldb;
  static constexpr int stage = ((a_elems + b_elems) * 4 + 127) / 128 * 128;
  static constexpr int total = kGStages * stage;
};

template <bool kDx>
__global__ void __launch_bounds__(kGThreads) bwd_gemm_fma_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm, float* out, int M, int N, int K,
    int lda_g, int ldb_g, int k_per_split, int m_valid, philox::Key key, uint32_t thr, float inv,
    const int* nv_dev, int nv_mul, const unsigned long long* seed) {
  using G = GemmTiles<kDx>;
  constexpr int VE = G::VE, BK = G::BK;
  extern __shared__ __align__(128) unsigned char sm[];
  const int tid = threadIdx.x;
  if (kDx)
    m_valid = rows_at(m_valid, nv_dev, nv_mul);
  else
    K = rows_at(K, nv_dev, nv_mul);
  key = philox::key_at(key, seed);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(K, k_begin + k_per_split);

  if (kDx && m0 >= m_valid) {  // rows past n_valid: zeros
    for (int i = tid; i < kBM * kBN; i += kGThreads) {
      const int m = m0 + i / kBN, n = n0 + i % kBN;
      if (m < M && n < N) out[size_t(m) * N + n] = 0.f;
    }
    return;
  }
  auto As = [&](int s) { return reinterpret_cast<float*>(sm + s * G::stage); };
  auto Bs = [&](int s) { return reinterpret_cast<float*>(sm + s * G::stage) + G::a_elems; };
  auto issue = [&](int kc, int s) {
    const int k0 = k_begin + kc * BK;
    float* a_s = As(s);
    float* b_s = Bs(s);
    if constexpr (kDx) {
      for (int i = tid; i < kBM * (BK / VE); i += kGThreads) {
        const int r = i / (BK / VE), c = (i % (BK / VE)) * VE, m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < k_end;
        cp_async16(a_s + r * G::lda + c, ok ? A + size_t(m) * lda_g + k : A, ok);
      }
      for (int i = tid; i < kBN * (BK / VE); i += kGThreads) {
        const int r = i / (BK / VE), c = (i % (BK / VE)) * VE, n = n0 + r, k = k0 + c;
        const bool ok = n < N && k < k_end;
        cp_async16(b_s + r * G::ldb + c, ok ? Bm + size_t(n) * ldb_g + k : Bm, ok);
      }
    } else {
      for (int i = tid; i < BK * (kBM / VE); i += kGThreads) {
        const int r = i / (kBM / VE), c = (i % (kBM / VE)) * VE, k = k0 + r, m = m0 + c;
        const bool ok = k < k_end && m < M;
        cp_async16(a_s + r * G::lda + c, ok ? A + size_t(k) * lda_g + m : A, ok);
      }
      for (int i = tid; i < BK * (kBN / VE); i += kGThreads) {
        const int r = i / (kBN / VE), c = (i % (kBN / VE)) * VE, k = k0 + r, n = n0 + c;
        const bool ok = k < k_end && n < N;
        cp_async16(b_s + r * G::ldb + c, ok ? Bm + size_t(k) * ldb_g + n : Bm, ok);
      }
    }
  };
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  // thread (ty, tx) owns rows ty*8 + [0,8) and columns tx + 16*[0,8)
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  pipeline<kGStages>(nk, issue, [&](int kc, int s) {
    if (!kDx && thr) {  // A = x * mask for the weight gradient: rows k, columns m
      const int k0 = k_begin + kc * BK;
      mask_x_tile<float>(As(s), G::lda, k_end - k0, BK, m0, kBM, M, EmbDrop{key, thr, inv, k0});
      __syncthreads();
    }
    const float* a_s = As(s);
    const float* b_s = Bs(s);
    for (int k = 0; k < BK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int mm = ty * 8 + i;
        av[i] = kDx ? a_s[mm * G::lda + k] : a_s[k * G::lda + mm];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nn = tx + 16 * j;
        bv[j] = kDx ? b_s[nn * G::ldb + k] : b_s[k * G::ldb + nn];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
  });
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + ty * 8 + i, n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      if constexpr (kDx) {
        const float mk = thr && m < m_valid ? philox::mask1(key, m, n, 0u, thr, inv) : 1.f;
        out[size_t(m) * N + n] = m < m_valid ? acc[i][j] * mk : 0.f;
      } else {
        out[size_t(blockIdx.z) * M * N + size_t(m) * N + n] = acc[i][j];
      }
    }
}

// ---- fixed-order reduction ----
// out_y[c] = sum of part[r, c] over the rows r of chunk y (rows_per_chunk
// rows each). V columns (one 16-byte load when V = 4) per lane; the 8
// warps of a block either stride the chunk's rows together (rw = 8; the
// warp sums are then added in warp order) or each take other columns
// (rw = 1). The order is a function of the shape and the plan alone.
template <int V>
__global__ void __launch_bounds__(256) reduce_rows_kernel(const float* __restrict__ part,
                                                          int nrows, long long ncols,
                                                          int rows_per_chunk, int rw,
                                                          float* __restrict__ out) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  __shared__ Vec s[8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % rw, wc = warp / rw;
  const long long nvec = ncols / V;
  const long long g = (blockIdx.x * (8LL / rw) + wc) * 32 + lane;
  const int r0 = blockIdx.y * rows_per_chunk, r1 = min(nrows, r0 + rows_per_chunk);
  const Vec* src = reinterpret_cast<const Vec*>(part);
  float a[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = 0.f;
  if (g < nvec) {
#pragma unroll 4
    for (int r = r0 + wr; r < r1; r += rw) {
      const Vec v = src[r * nvec + g];
      const float* e = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] += e[j];
    }
  }
  if (rw > 1) {
    *reinterpret_cast<Vec*>(&s[warp][lane]) = *reinterpret_cast<const Vec*>(a);
    __syncthreads();
    if (wr != 0) return;
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = 0.f;
    for (int q = 0; q < rw; ++q) {
      const float* e = reinterpret_cast<const float*>(&s[wc * rw + q][lane]);
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] += e[j];
    }
  }
  if (g < nvec)
    reinterpret_cast<Vec*>(out + blockIdx.y * ncols)[g] = *reinterpret_cast<const Vec*>(a);
}

template <typename T, bool kWide, bool kTc>
int launch_core(BwdArgs& p, int x_rows, cudaStream_t stream) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  if (!kBf) p.stages = p.cluster = 1;
  const BwdLayout B = make_bwd_layout(p.d, p.a_pad, sizeof(T), p.stages, kWide, kTc);
  if (B.total > size_t(kSmemLimit) ||
      !bwd_layout_fits(B, p.d, p.a_pad, sizeof(T), p.stages, kWide, kTc))
    return int(cudaErrorInvalidValue);
  constexpr int kCta = kBf ? kQkvThreads : kThreads;
  auto kern = news_encoder_bwd_kernel<T, kCta, kWide, kTc>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(B.total));
  if (e != cudaSuccess) return int(e);
  p.nb = p.t < kRows ? kRows / p.t : 1;
  const int blocks = (p.n + p.nb - 1) / p.nb;
  if (blocks == 0) return 0;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  const int P = (p.heads + p.gh - 1) / p.gh * kPanel;
  // bf16: x [x_rows, din] (rows past it arrive as zeros), wqkv [din, P]
  if (kBf && x_rows > 0 && p.n_valid > 0 &&
      !(hop::bf16_map(&xmap, p.x, p.din, x_rows, p.din, kQkvBK, kRows) &&
        hop::bf16_map(&wmap, p.wqkv, P, p.din, P, 64, kQkvBK)))
    return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(unsigned((blocks + p.cluster - 1) / p.cluster * p.cluster));
  cfg.blockDim = dim3(kCta);
  cfg.dynamicSmemBytes = B.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, xmap, wmap, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// The shapes the per-block kernel takes (ops/news_encoder.py's check_shape
// mirrors this), then the instance: the narrow one wherever it fits; fp32
// on the tensor cores (3xTF32) when kTc, else by FMA.
template <typename T, bool kTc>
int launch_core(BwdArgs& p, int x_rows, cudaStream_t stream) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  const int hd = p.heads > 0 ? p.d / p.heads : 0;
  const int nk = (p.din + kQkvBK - 1) / kQkvBK;
  if (p.t < 1 || p.t > kWideMaxT || p.heads < 1 || p.d % p.heads || hd > kWideMaxHeadDim ||
      p.gh < 1 || 3 * p.gh * hd > kPanel || p.a > p.a_pad || p.a_pad > kWideMaxAtt ||
      p.a_pad % 16 || p.din % (16 / int(sizeof(T))) || p.din % 4 || p.ldoc < p.d ||
      (kBf && (p.dr.thr_emb || p.stages < (nk > 1 ? 2 : 1) || p.stages > kQkvMaxStages ||
               p.stages > nk ||
               (p.cluster != 1 && p.cluster != 2))))
    return int(cudaErrorInvalidValue);
  return is_wide(p.t, hd, p.a_pad) ? launch_core<T, true, kTc>(p, x_rows, stream)
                                   : launch_core<T, false, kTc>(p, x_rows, stream);
}

template <bool kDx, int kWStages>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, const WgArgs& p, long long tiles,
                 cudaStream_t stream) {
  auto kern = bwd_gemm_wgmma_kernel<kDx, kWStages>;
  constexpr int smem = wg_smem(kWStages);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(e);
  kern<<<unsigned(std::min<long long>(tiles, sms)), kWThreads, smem, stream>>>(ta, tb, p);
  return int(cudaGetLastError());
}

template <bool kDx>
int launch_gemm_bf16(const void* A, const void* Bm, void* out, const uint32_t* keep, int keep_ld,
                     int M, int N, int K, int lda, int ldb, int splits, int kps, int m_valid,
                     const int* nv_dev, int nv_mul, float inv, cudaStream_t stream) {
  const int m_tiles = (M + kWBM - 1) / kWBM, n_tiles = (N + kWBN - 1) / kWBN;
  if (M < 1 || N < 1 || K < 0 || N % (kDx ? 8 : 2) ||
      (long long)m_tiles * n_tiles * splits > (1LL << 31) - 1 ||
      (keep != nullptr && keep_ld < (N + 31) / 32) ||
      (!kDx && (splits < 1 || kps < kWBK || kps % kWBK)))
    return int(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  const bool ok = kDx ? hop::bf16_map(&ta, A, K, M, lda, kWBK, kWBM) &&
                            hop::bf16_map(&tb, Bm, K, N, ldb, kWBK, kWBN)
                      : hop::bf16_map(&ta, A, M, K, lda, 64, kWBK) &&
                            hop::bf16_map(&tb, Bm, N, K, ldb, 64, kWBK);
  if (!ok) return int(cudaErrorInvalidValue);
  const long long tiles = (long long)n_tiles * m_tiles * (kDx ? 1 : splits);
  const WgArgs p{out,   M,       N,   K,      kDx ? K : kps, kDx ? 1 : splits, kDx ? m_valid : 0,
                 keep,  keep_ld, inv, nv_dev, nv_mul};
  // the ring's depth: 3 stages for the weight gradient of an output of at
  // most 512 rows, where 3 beat 4 on an H100 (PERF.md), else 4
  if constexpr (!kDx)
    if (M <= 4 * kWBM) return launch_wgmma<false, 3>(ta, tb, p, tiles, stream);
  return launch_wgmma<kDx, 4>(ta, tb, p, tiles, stream);
}

template <bool kDx>
int launch_gemm_fp32(const void* A, const void* Bm, void* out, int M, int N, int K, int lda,
                     int ldb, int splits, int kps, int m_valid, philox::Key key, uint32_t thr,
                     float inv, const int* nv_dev, int nv_mul, const unsigned long long* seed,
                     cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 0 || lda % 4 || ldb % 4 || (kDx ? K % 4 : (M % 4 || N % 4)) ||
      (thr && (kDx ? N % 4 : M % 4)) || (!kDx && (splits < 1 || kps < 1)))
    return int(cudaErrorInvalidValue);
  auto kern = bwd_gemm_fma_kernel<kDx>;
  constexpr int smem = GemmTiles<kDx>::total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, kDx ? 1 : splits);
  kern<<<grid, kGThreads, smem, stream>>>(static_cast<const float*>(A),
                                           static_cast<const float*>(Bm), static_cast<float*>(out),
                                           M, N, K, lda, ldb, kDx ? std::max(K, 1) : kps, m_valid, key,
                                           thr, inv, nv_dev, nv_mul, seed);
  return int(cudaGetLastError());
}

// One pass of the reduction: chunks of rows_per_chunk rows of part
// [nrows, ncols] into out [chunks, ncols].
int reduce_pass(const float* part, int nrows, long long ncols, int rows_per_chunk, float* out,
                cudaStream_t stream) {
  const int rw = rows_per_chunk > 32 ? 8 : 1;
  const int chunks = (nrows + rows_per_chunk - 1) / rows_per_chunk;
  const bool v4 = ncols % 4 == 0 && reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long nvec = v4 ? ncols / 4 : ncols;
  const long long per_block = 32LL * (8 / rw);
  const dim3 grid(unsigned((nvec + per_block - 1) / per_block), unsigned(std::max(chunks, 1)));
  if (v4)
    reduce_rows_kernel<4><<<grid, 256, 0, stream>>>(part, nrows, ncols, rows_per_chunk, rw, out);
  else
    reduce_rows_kernel<1><<<grid, 256, 0, stream>>>(part, nrows, ncols, rows_per_chunk, rw, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

long long news_encoder_bwd_smem_bytes(int t, int d, int heads, int a_pad, int is_bf16,
                                      int stages, int fp32_variant) {
  const bool wide = is_wide(t, heads > 0 ? d / heads : 0, a_pad);
  const bool tc = !is_bf16 && fp32_variant == 1;
  return (long long)make_bwd_layout(d, a_pad, is_bf16 ? 2 : 4, stages, wide, tc).total;
}

// The per-block backward kernel. Inputs as news_encoder_fwd (x [x_rows,
// din]: in bf16 already masked, as the forward read it), plus g [n, d]
// fp32. Writes qkv [n*t, P] (dQ|dK|dV in the packed panel layout), o_c
// [n*t, ldoc] (zeros past d), dz_c [n*t, a_pad] (compute dtype; the wide
// instance reads up to 63 rows past a block's last, so the wrapper gives
// dz_c 64 more rows), db_part and dq_part [ceil(n / max(1, 64 / t)),
// a_pad] fp32, for the blocks before n_valid only.
// With nv_dev (n_valid in device memory; the launch passes n_valid = n and
// x_rows = n * t) the blocks past it write zero partials too, and zeros into
// their rows below the 64-row edge after the last valid row; seed_dev: as
// news_encoder_fwd; fp32_variant too (1: 3xTF32 on the tensor cores, 0: FMA).
int news_encoder_bwd_core(const void* x, int x_rows, const void* wqkv, const void* w_att,
                          const void* b_att, const void* q_att, const void* g, void* qkv,
                          void* o_c, int ldoc, void* dz_c, void* db_part, void* dq_part, int n,
                          int t, int din, int d, int heads, int gh, int a, int a_pad, int n_valid,
                          const void* nv_dev, float scale, int is_bf16, unsigned seed_lo,
                          unsigned seed_hi, const void* seed_dev, unsigned thr_emb,
                          unsigned thr_att, float inv_emb, float inv_att, const void* ext_mask,
                          float inv_ext, int stages, int cluster, int fp32_variant,
                          void* stream) {
  BwdArgs p{x, wqkv, w_att, static_cast<const float*>(b_att), static_cast<const float*>(q_att),
            static_cast<const float*>(g), qkv, o_c, dz_c, static_cast<float*>(db_part),
            static_cast<float*>(dq_part), n, t, din, d, heads, gh, a, a_pad, n_valid, 0, stages,
            cluster, ldoc, scale, philox::Dropout{{seed_lo, seed_hi}, thr_emb, thr_att, inv_emb, inv_att},
            static_cast<const float*>(ext_mask), inv_ext, static_cast<const int*>(nv_dev),
            static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_core<bf16, false>(p, x_rows, s);
  if (fp32_variant != 0 && fp32_variant != 1) return int(cudaErrorInvalidValue);
  return fp32_variant ? launch_core<float, true>(p, x_rows, s) : launch_core<float, false>(p, x_rows, s);
}

// is_dx: out [M, N] (compute dtype) = A [M, K] (row stride lda) times
//   B [N, K]^T (row stride ldb), times the stream-0 mask; rows >= m_valid
//   are zeros.
// else: out [splits, M, N] fp32 partials of A^T B over rows [0, K) cut into
//   `splits` slices of k_per_split rows (a multiple of 64), A [K, M]
//   (stride lda; times the stream-0 mask), B [K, N] (stride ldb).
// bf16 runs on the tensor cores and takes the mask as news_encoder_mask_x
// draws it: dx reads its keep bits [m_valid, keep_ld] (null: no mask) and
// scales kept elements by inv; the weight gradient's A comes masked. fp32
// draws the mask in the kernel from (seed, thr, inv); thr = 0: no mask.
// nv_dev, when not null, is a valid count in device memory: dx's m_valid
// and the weight gradients' K become at most nv_mul times it (the launch
// passes the bucket's rows as m_valid and K, and cuts the slices by them).
// seed_dev: the fp32 mask's seed in device memory, or null.
int news_encoder_gemm(const void* A, const void* B, void* out, const void* keep, int keep_ld,
                      int M, int N, int K, int lda, int ldb, int is_dx, int splits,
                      int k_per_split, int m_valid, const void* nv_dev, int nv_mul, int is_bf16,
                      unsigned seed_lo, unsigned seed_hi, const void* seed_dev, unsigned thr,
                      float inv, void* stream) {
  const philox::Key key{seed_lo, seed_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* kb = static_cast<const uint32_t*>(keep);
  const int* nv = static_cast<const int*>(nv_dev);
  const auto* sd = static_cast<const unsigned long long*>(seed_dev);
  if (is_bf16)
    return is_dx ? launch_gemm_bf16<true>(A, B, out, kb, keep_ld, M, N, K, lda, ldb, 1, 0, m_valid,
                                          nv, nv_mul, inv, s)
                 : launch_gemm_bf16<false>(A, B, out, nullptr, 0, M, N, K, lda, ldb, splits,
                                           k_per_split, 0, nv, nv_mul, inv, s);
  return is_dx ? launch_gemm_fp32<true>(A, B, out, M, N, K, lda, ldb, 1, 0, m_valid, key, thr, inv,
                                        nv, nv_mul, sd, s)
               : launch_gemm_fp32<false>(A, B, out, M, N, K, lda, ldb, splits, k_per_split, 0, key,
                                         thr, inv, nv, nv_mul, sd, s);
}

// The stream-0 mask of rows [0, rows), columns [0, cols): xm [rows, cols]
// = round(x * mask) in bf16 (x [rows, x_cols], contiguous, x_cols <= cols;
// xm zero past x_cols; skipped when xm is null) and the keep bits [rows,
// keep_ld] (skipped when keep is null). rows_dev, when not null, is a valid
// count in device memory: rows at or past rows_mul times it get zeros in
// xm and no kept bit. seed_dev: the seed in device memory, or null.
int news_encoder_mask_x(const void* x, int x_cols, void* xm, void* keep, int keep_ld, int rows,
                        const void* rows_dev, int rows_mul, int cols, unsigned seed_lo,
                        unsigned seed_hi, const void* seed_dev, unsigned thr, float inv,
                        void* stream) {
  const long long n = (long long)rows * ((cols + 31) / 32) * 4;
  if (rows < 0 || cols < 1 || cols % 8 || thr == 0 || n >= (1LL << 31) ||
      (keep != nullptr && keep_ld < (cols + 31) / 32) ||
      (xm != nullptr && (x == nullptr || x_cols < 1 || x_cols > cols ||
                         reinterpret_cast<uintptr_t>(x) % 16 ||
                         reinterpret_cast<uintptr_t>(xm) % 16)))
    return int(cudaErrorInvalidValue);
  if (n > 0)
    bwd_mask_x_kernel<<<unsigned(std::min((n + 255) / 256, 132LL * 16)), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), x_cols, static_cast<bf16*>(xm),
        static_cast<uint32_t*>(keep), keep_ld, rows, cols, philox::Key{seed_lo, seed_hi}, thr,
        inv, static_cast<const int*>(rows_dev), rows_mul,
        static_cast<const unsigned long long*>(seed_dev));
  return int(cudaGetLastError());
}

// out [ncols] = sum of part [nrows, ncols] over rows, in a fixed order:
// chunks of rows_per_chunk rows, summed into scratch [chunks, ncols]
// when there is more than one chunk, then the chunk sums in order.
int news_encoder_reduce(const void* part, int nrows, long long ncols, int rows_per_chunk,
                        void* scratch, void* out, void* stream) {
  if (nrows < 0 || ncols < 1 || rows_per_chunk < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(part);
  float* dst = static_cast<float*>(out);
  if (nrows <= rows_per_chunk) return reduce_pass(src, nrows, ncols, std::max(nrows, 1), dst, s);
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  const int chunks = (nrows + rows_per_chunk - 1) / rows_per_chunk;
  const int e = reduce_pass(src, nrows, ncols, rows_per_chunk, static_cast<float*>(scratch), s);
  if (e != 0) return e;
  return reduce_pass(static_cast<const float*>(scratch), chunks, ncols, chunks, dst, s);
}

const char* news_encoder_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
