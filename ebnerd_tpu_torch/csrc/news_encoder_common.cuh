// Device code shared by the fused NRMS news encoder's forward
// (news_encoder.cu) and its recompute backward (news_encoder_bwd.cu): the
// block layout, the cp.async pipeline, the head-group QKV panel GEMM (with
// the embedding-dropout mask applied to x as it is staged), the per-head
// attention of one panel, the attention-output dropout and the pooling
// projection. See news_encoder.cu for the design of the forward.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

// Profiling switch: tools/kernel_phases.py builds variants of the forward
// that leave phases out to see where the time goes. Without all three bits
// the result is wrong: such a build is for timing only.
#ifndef NE_PHASES
#define NE_PHASES 7  // bit 0: QKV GEMM, bit 1: attention, bit 2: pooling GEMM
#endif

namespace ne {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;           // rows (article tokens) per block
constexpr int kPanel = 256;         // packed QKV columns per head group
constexpr int kChunkBytes = 128;    // contraction depth per staged chunk (bytes of a row)
constexpr int kStages = 2;          // cp.async pipeline depth of the QKV GEMM
constexpr int kPoolRows = 64;       // rows of W_att per staged pooling chunk
constexpr int kPoolStages = 2;      // cp.async pipeline depth of the pooling GEMM
constexpr int kMaxT = 32;
constexpr int kMaxHeadDim = 32;
constexpr int kMaxAtt = 256;        // padded attention width
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use on sm_90
// bf16 attention: per warp, Q, K and V of one (article, head) zero-padded
// to 32 x 32 ([32][kTileLd] bf16); the logits, probabilities and output
// ([32][kTileLdF] fp32 / [32][kTileLd] bf16) reuse the space of Q and K
constexpr int kTileLd = 40;
constexpr int kTileLdF = 36;
constexpr int kAttWarpBytes = 3 * 32 * kTileLd * 2;
static_assert(32 * kTileLdF * 4 <= 2 * 32 * kTileLd * 2, "S and O fit over Q and K");

static_assert(kWarps == 8, "GEMM warp maps assume 8 warps");
static_assert(kChunkBytes % 32 == 0 && kPoolRows % 16 == 0 && kStages >= 2 && kPoolStages >= 2,
              "chunks hold whole wmma k-steps; pipelines are at least double-buffered");
static_assert(kRows == 2 * 32 && kPanel == 4 * 64, "QKV GEMM: 2 x 4 warps of 32 x 64");
static_assert(kAttWarpBytes % 128 == 0 && kAttWarpBytes >= 1024, "per-warp attention tiles");

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t smax(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory of the forward: region R (reused by phase), then o
// [kRows][ldf] fp32, then the pooling logits and weights [2][kRows] fp32.
// R holds, in turn:
//   GEMM:      kStages stages of { x chunk [kRows][ldx], W chunk [kc][ldw] }
//   attention: Q|K|V of one head group [kRows][ldw], then per-warp tiles
//              (bf16; the first KB of a warp's tiles is also its GEMM
//              epilogue scratch)
//   pooling:   bf16 o [kRows][ldo] + kPoolStages W_att chunks [kPoolRows][lda]
//              (fp32 mode: one W_att chunk, FMA)
//   logits:    z = o W [kRows][ldz] fp32
// o's rows are ldf = d | 1 floats apart: odd, so column writes do not
// collide in a bank.
struct Layout {
  int ldx, ldw, ldo, lda, ldz, ldf, kc, d_pad;
  size_t stage, xs_bytes, panel, pool_w, r, o, small, total;
};

__host__ __device__ inline Layout make_layout(int d, int a_pad, int elem) {
  const bool bf = elem == 2;
  const int ve = 16 / elem;
  Layout L;
  L.kc = kChunkBytes / elem;
  L.ldx = L.kc + ve;
  L.ldw = kPanel + ve;
  L.d_pad = (d + 15) / 16 * 16;
  L.ldo = L.d_pad + ve;
  L.lda = a_pad + ve;
  L.ldz = a_pad + 4;
  L.ldf = d | 1;
  L.xs_bytes = align128(size_t(kRows) * L.ldx * elem);
  L.stage = L.xs_bytes + align128(size_t(L.kc) * L.ldw * elem);
  L.panel = align128(size_t(kRows) * L.ldw * elem);
  L.pool_w = align128(size_t(kPoolRows) * L.lda * elem);
  const size_t gemm = kStages * L.stage;
  const size_t att = L.panel + (bf ? size_t(kWarps) * kAttWarpBytes : 0);
  const size_t pool =
      bf ? align128(size_t(kRows) * L.ldo * elem) + kPoolStages * L.pool_w : L.pool_w;
  const size_t z = size_t(kRows) * L.ldz * 4;
  L.r = align128(smax(smax(gemm, att), smax(pool, z)));
  L.o = L.r;
  L.small = L.o + align128(size_t(kRows) * L.ldf * 4);
  L.total = L.small + align128(size_t(2) * kRows * 4);
  return L;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// Round an fp32 value to the compute dtype and back (identity in fp32).
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

// 16-byte asynchronous copy global -> shared; zero-fills when !valid (no
// bytes are read then, but the address must still be a mapped one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A multi-stage cp.async pipeline over nk chunks: issue(k, stage) starts
// the copies of chunk k, compute(k, stage) consumes a landed chunk. One
// __syncthreads per chunk; the staging space is free again when it returns.
template <int S, typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int nk, Issue issue, Compute compute) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk k has landed for all; chunk k-1's stage is consumed
    if (k + S - 1 < nk) issue(k + S - 1, (k + S - 1) % S);
    cp_async_commit();
    compute(k, k % S);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The embedding-dropout mask (stream 0) of one block: rows of the block
// start at global row row0; thr == 0 means no dropout.
struct EmbDrop {
  philox::Key key;
  uint32_t thr;
  float inv;
  int row0;
};

// x chunk [kRows][ld] in shared memory, columns [k0, k0 + kc) of x:
// x <- round(x * mask) for the block's real rows and columns (din % 4 == 0).
template <typename T>
__device__ __forceinline__ void mask_x_tile(T* xs, int ld, int rows, int nrow_tile, int k0,
                                            int kc, int din, const EmbDrop& ed) {
  const int g4 = kc / 4;
  for (int i = threadIdx.x; i < nrow_tile * g4; i += blockDim.x) {
    const int r = i / g4, c = (i % g4) * 4;
    if (r >= rows || k0 + c >= din) continue;
    const float4 m = philox::mask4(ed.key, uint32_t(ed.row0 + r), uint32_t((k0 + c) >> 2), 0u,
                                   ed.thr, ed.inv);
    T* e = xs + r * ld + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = from_f<T>(to_f<T>(e[j]) * philox::pick(m, j));
  }
}

// One head group's Q|K|V = round(x_block * emb mask) @ wqkv[:, panel],
// written to the start of R ([kRows][ldw], compute dtype). x rows
// [0, rows) and contraction [0, din) are real, the rest zero-filled. The
// wrapper guarantees din % (16 / sizeof(T)) == 0 and 16-byte aligned x
// and wqkv.
template <typename T>
__device__ void qkv_panel(const T* __restrict__ xb, int rows, int din, const T* __restrict__ wp,
                          int np_cols, const Layout& L, unsigned char* R, const EmbDrop& ed) {
  constexpr int VE = 16 / sizeof(T);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (din + L.kc - 1) / L.kc;
  auto xs = [&](int s) { return reinterpret_cast<T*>(R + s * L.stage); };
  auto ws = [&](int s) { return reinterpret_cast<T*>(R + s * L.stage + L.xs_bytes); };
  auto issue = [&](int kc, int s) {
    const int k0 = kc * L.kc, xv = L.kc / VE, wv = kPanel / VE;
    T* x_s = xs(s);
    T* w_s = ws(s);
    for (int i = tid; i < kRows * xv; i += kThreads) {
      const int r = i / xv, c = (i % xv) * VE, k = k0 + c;
      const bool ok = r < rows && k < din;
      cp_async16(x_s + r * L.ldx + c, ok ? xb + size_t(r) * din + k : xb, ok);
    }
    for (int i = tid; i < L.kc * wv; i += kThreads) {
      const int kr = i / wv, c = (i % wv) * VE, k = k0 + kr;
      const bool ok = k < din;
      cp_async16(w_s + kr * L.ldw + c, ok ? wp + size_t(k) * np_cols + c : wp, ok);
    }
  };
  auto mask_chunk = [&](int kc, int s) {
    if (ed.thr) {
      mask_x_tile<T>(xs(s), L.ldx, rows, kRows, kc * L.kc, L.kc, din, ed);
      __syncthreads();
    }
  };
  T* qkv = reinterpret_cast<T*>(R);
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm*32 + [0,32), cols wn*64 + [0,64)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    pipeline<kStages>(nk, issue, [&](int kc, int s) {
      mask_chunk(kc, s);
      const T* x_s = xs(s);
      const T* w_s = ws(s);
#pragma unroll
      for (int kk = 0; kk < kChunkBytes / 2; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], x_s + (wm * 32 + i * 16) * L.ldx + kk, L.ldx);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, w_s + kk * L.ldw + wn * 64 + j * 16, L.ldw);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
        }
      }
    });
    // epilogue: accumulators -> compute dtype, through a per-warp scratch tile
    float* sc = reinterpret_cast<float*>(R + L.panel + size_t(warp) * kAttWarpBytes);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          qkv[(wm * 32 + i * 16 + e / 16) * L.ldw + wn * 64 + j * 16 + e % 16] = from_f<T>(sc[e]);
        __syncwarp();
      }
  } else {
    // fp32: thread (ty, tx) owns rows ty*8 + [0,8) and columns tx + 32*[0,8)
    const int tx = lane, ty = warp;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    pipeline<kStages>(nk, issue, [&](int kc, int s) {
      mask_chunk(kc, s);
      const T* x_s = xs(s);
      const T* w_s = ws(s);
      for (int k = 0; k < L.kc; ++k) {
        float wv[8], xv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = to_f<T>(w_s[k * L.ldw + tx + 32 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = to_f<T>(x_s[(ty * 8 + i) * L.ldx + k]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * wv[j];
      }
    });
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) qkv[(ty * 8 + i) * L.ldw + tx + 32 * j] = from_f<T>(acc[i][j]);
  }
}

// Attention of one head group: heads [h0, h0 + nh) of the block's na
// articles; in the panel, Q of local head hl sits at column hl*hd, K at
// gh*hd + hl*hd, V at 2*gh*hd + hl*hd. o gets each head's slice in fp32.
//
// bf16: one warp per (article, head). Q, K and V are copied into 32 x 32
// tiles, zero past t rows and hd columns, so padded keys add nothing to
// the logits and get probability 0; S = Q K^T and O = P V run on wmma with
// fp32 accumulation, the softmax in fp32 with one lane per query row.
template <typename T>
__device__ void attention_group(const T* qkv, int ldp, float* o, int ldf, int na, int t, int hd,
                                int gh, int h0, int nh, float scale, unsigned char* tiles) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = tid / 32, lane = tid % 32;
    bf16* Qs = reinterpret_cast<bf16*>(tiles + size_t(warp) * kAttWarpBytes);
    bf16* Ks = Qs + 32 * kTileLd;
    bf16* Vs = Ks + 32 * kTileLd;
    float* Ss = reinterpret_cast<float*>(Qs);  // S, later O, over the spent Q and K
    bf16* Ps = Qs;                             // P over S, from rows held in registers
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int pair = warp; pair < na * nh; pair += kWarps) {
      const int an = pair / nh, hl = pair % nh;
      const bf16* src = qkv + an * t * ldp + hl * hd;
      for (int i = lane; i < 32 * 32; i += 32) {
        const int r = i / 32, c = i % 32;
        const bool ok = r < t && c < hd;
        const bf16* e = src + r * ldp + c;
        Qs[r * kTileLd + c] = ok ? e[0] : zero;
        Ks[r * kTileLd + c] = ok ? e[gh * hd] : zero;
        Vs[r * kTileLd + c] = ok ? e[2 * gh * hd] : zero;
      }
      __syncwarp();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], Qs + i * 16 * kTileLd + kk, kTileLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;  // K^T
          wmma::load_matrix_sync(bfr, Ks + j * 16 * kTileLd + kk, kTileLd);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
        }
      }
      __syncwarp();  // Q and K are spent
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Ss + i * 16 * kTileLdF + j * 16, acc[i][j], kTileLdF,
                                  wmma::mem_row_major);
      __syncwarp();
      {  // softmax of query row `lane` over the t real keys
        float sr[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) sr[c] = Ss[lane * kTileLdF + c] * scale;
        __syncwarp();  // every row is in registers before P overwrites S
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < 32; ++c)
          if (c < t) m = fmaxf(m, sr[c]);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          sr[c] = c < t ? expf(sr[c] - m) : 0.f;
          sum += sr[c];
        }
#pragma unroll
        for (int c = 0; c < 32; ++c)
          Ps[lane * kTileLd + c] = c < t ? __float2bfloat16_rn(sr[c] / sum) : zero;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], Ps + i * 16 * kTileLd + kk, kTileLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, Vs + kk * kTileLd + j * 16, kTileLd);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
        }
      }
      __syncwarp();  // P is spent
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(Ss + i * 16 * kTileLdF + j * 16, acc[i][j], kTileLdF,
                                  wmma::mem_row_major);
      __syncwarp();
      float* obase = o + an * t * ldf + (h0 + hl) * hd;
      for (int i = lane; i < t * hd; i += 32) {
        const int r = i / hd, e = i % hd;
        obase[r * ldf + e] = Ss[r * kTileLdF + e];
      }
      __syncwarp();  // the tiles are free for the next pair
    }
  } else {
    // fp32: one thread per (article, head, query row), FMA
    for (int it = tid; it < na * nh * t; it += kThreads) {
      const int qi = it % t, hl = (it / t) % nh, an = it / (t * nh);
      const int r = an * t + qi;
      const T* qrow = qkv + r * ldp + hl * hd;
      const T* kbase = qkv + an * t * ldp + gh * hd + hl * hd;
      const T* vbase = kbase + gh * hd;
      float qv[kMaxHeadDim];
#pragma unroll
      for (int e = 0; e < kMaxHeadDim; ++e) qv[e] = e < hd ? to_f<T>(qrow[e]) : 0.f;
      float p[kMaxT];
      float m = -INFINITY;
#pragma unroll
      for (int kj = 0; kj < kMaxT; ++kj) {
        p[kj] = -INFINITY;
        if (kj < t) {
          const T* kr = kbase + kj * ldp;
          float l = 0.f;
#pragma unroll
          for (int e = 0; e < kMaxHeadDim; ++e)
            if (e < hd) l += qv[e] * to_f<T>(kr[e]);
          p[kj] = l * scale;
          m = fmaxf(m, p[kj]);
        }
      }
      float s = 0.f;
#pragma unroll
      for (int kj = 0; kj < kMaxT; ++kj) {
        p[kj] = kj < t ? expf(p[kj] - m) : 0.f;
        s += p[kj];
      }
      float acc[kMaxHeadDim];
#pragma unroll
      for (int e = 0; e < kMaxHeadDim; ++e) acc[e] = 0.f;
#pragma unroll
      for (int kj = 0; kj < kMaxT; ++kj) {
        if (kj < t) {
          const float pk = rnd<T>(p[kj] / s);
          const T* vr = vbase + kj * ldp;
#pragma unroll
          for (int e = 0; e < kMaxHeadDim; ++e)
            if (e < hd) acc[e] += pk * to_f<T>(vr[e]);
        }
      }
      float* orow = o + r * ldf + (h0 + hl) * hd;
#pragma unroll
      for (int e = 0; e < kMaxHeadDim; ++e)
        if (e < hd) orow[e] = acc[e];
    }
  }
}

// Dropout between attention and pooling, on the block's fp32 o [rows][ldf]
// (rows start at global row row0): the stream-1 mask when dr.thr_att, else
// the external 0/1 mask [N*T, d] times 1/keep when ext is given.
__device__ __forceinline__ void drop_o(float* o, int ldf, int rows, int d, int row0,
                                       const philox::Dropout& dr, const float* __restrict__ ext,
                                       float inv_ext) {
  if (dr.thr_att) {
    const int g4 = d / 4;  // the wrapper requires d % 4 == 0 with dropout
    for (int i = threadIdx.x; i < rows * g4; i += blockDim.x) {
      const int r = i / g4, c = (i % g4) * 4;
      const float4 m =
          philox::mask4(dr.key, uint32_t(row0 + r), uint32_t(c >> 2), 1u, dr.thr_att, dr.inv_att);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[r * ldf + c + j] *= philox::pick(m, j);
    }
  } else if (ext != nullptr) {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, c = i % d;
      o[r * ldf + c] *= ext[size_t(row0 + r) * d + c] * inv_ext;
    }
  }
}

// z = round(o) @ W_att ([kRows][ldz] fp32 at the start of R). bf16: wmma
// over staged, pipelined W_att chunks; fp32: one thread per column.
template <typename T>
__device__ void pooling_logits(const float* o, int rows, int d, const T* __restrict__ w_att,
                               int a_pad, const Layout& L, unsigned char* R) {
  const int tid = threadIdx.x;
  float* z = reinterpret_cast<float*>(R);
  const int nk = (L.d_pad + kPoolRows - 1) / kPoolRows;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    constexpr int VE = 16 / sizeof(T);
    const int warp = tid / 32, av = a_pad / VE;
    T* ob = reinterpret_cast<T*>(R);
    unsigned char* wbase = R + align128(size_t(kRows) * L.ldo * sizeof(T));
    auto wa = [&](int s) { return reinterpret_cast<T*>(wbase + s * L.pool_w); };
    auto issue = [&](int kc, int s) {
      T* dst = wa(s);
      for (int i = tid; i < kPoolRows * av; i += kThreads) {
        const int kr = i / av, c = (i % av) * VE, k = kc * kPoolRows + kr;
        const bool ok = k < d;
        cp_async16(dst + kr * L.lda + c, ok ? w_att + size_t(k) * a_pad + c : w_att, ok);
      }
    };
    for (int i = tid; i < kRows * L.d_pad; i += kThreads) {
      const int r = i / L.d_pad, c = i % L.d_pad;
      ob[r * L.ldo + c] = from_f<T>(r < rows && c < d ? o[r * L.ldf + c] : 0.f);
    }
    const int nct = a_pad / 16;  // column tiles; warp w takes w and w + 8
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    pipeline<kPoolStages>(nk, issue, [&](int kc, int s) {
      const T* w_s = wa(s);
#pragma unroll
      for (int kk = 0; kk < kPoolRows; kk += 16) {
        const int k = kc * kPoolRows + kk;
        if (k < L.d_pad) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(af[i], ob + i * 16 * L.ldo + k, L.ldo);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ct = warp + j * kWarps;
            if (ct < nct) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
              wmma::load_matrix_sync(bfr, w_s + kk * L.lda + ct * 16, L.lda);
#pragma unroll
              for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
            }
          }
        }
      }
    });
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ct = warp + j * kWarps;
      if (ct < nct) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::store_matrix_sync(z + i * 16 * L.ldz + ct * 16, acc[i][j], L.ldz,
                                  wmma::mem_row_major);
      }
    }
  } else {
    T* ws = reinterpret_cast<T*>(R);
    float zr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) zr[r] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      for (int i = tid; i < kPoolRows * a_pad; i += kThreads) {
        const int k = kc * kPoolRows + i / a_pad;
        ws[i] = k < d ? w_att[size_t(k) * a_pad + i % a_pad] : from_f<T>(0.f);
      }
      __syncthreads();
      if (tid < a_pad) {
        const int kn = min(kPoolRows, d - kc * kPoolRows);
        for (int kr = 0; kr < kn; ++kr) {
          const float w = to_f<T>(ws[kr * a_pad + tid]);
          const int c = kc * kPoolRows + kr;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < rows) zr[r] += o[r * L.ldf + c] * w;
        }
      }
      __syncthreads();
    }
    if (tid < a_pad) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) z[r * L.ldz + tid] = zr[r];
    }
  }
}

// Pooling weights of the block's articles: att[r] = sum_j round(tanh(z + b))
// * round(q) (one warp per row), then a softmax over t per article (one
// lane per token; max subtracted, +1e-8 in the denominator) into wts.
// With keep_hact, z is replaced by tanh(z + b) (fp32) for the backward.
template <typename T>
__device__ void pooling_weights(float* z, int ldz, const float* __restrict__ b_att,
                                const float* __restrict__ q_att, int a, int rows, int na, int t,
                                float* att, float* wts, bool keep_hact) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float v = 0.f;
    for (int j = lane; j < a; j += 32) {
      const float h = tanhf(z[r * ldz + j] + b_att[j]);
      if (keep_hact) z[r * ldz + j] = h;
      v += rnd<T>(h) * rnd<T>(q_att[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) att[r] = v;
  }
  __syncthreads();
  for (int an = warp; an < na; an += kWarps) {
    const float v = lane < t ? att[an * t + lane] : -INFINITY;
    float mx = v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e = lane < t ? expf(v - mx) : 0.f;
    float sum = e;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane < t) wts[an * t + lane] = e / (sum + 1e-8f);
  }
  __syncthreads();
}

}  // namespace ne
