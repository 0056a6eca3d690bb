// Fused NRMS news encoder, recompute backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_news_encoder_bwd` / `_bwd_kernel` /
// `_bwd_body` in ebnerd_tpu/ops/news_encoder.py. Given x, the packed
// weights, the dropout (Philox seed or external mask) and the output
// cotangent g [N, D] fp32, it returns dx [N, T, Din] (x's dtype), the
// packed dWqkv [Din, P] and dW [D, A], db [A], dq [A] in fp32.
//
// Three kernels:
//   1. news_encoder_bwd_kernel, one block per 64 rows, as the forward:
//      recompute QKV panel by panel (with the stream-0 mask on x) and the
//      attention, keeping the fp32 o; dropout on o; the pooling forward
//      (z, tanh, weights) and backward (dvals = round(o).round(g), datt,
//      per-block partials of dq = round(tanh)^T round(datt) and db = sum
//      dz); do = (w g + round(dz) round(W)^T) * mask, kept in the compute
//      dtype over o; then the attention backward of each (article, head)
//      on one warp: P, dP = dO V^T, dS, dV = P^T dO, dQ = dS K,
//      dK = dS^T Q (wmma 32 x 32 tiles in bf16, FMA in fp32). The operands
//      of every product are rounded to the compute dtype where the TPU
//      kernel's `_cdot`/`_bdot` round them. It writes per row: dQ|dK|dV in
//      the packed panel layout (dqkv, compute dtype), round(o) and
//      round(dz) for the weight products.
//   2. gemm_kernel, a tiled wmma GEMM (128 x 128 tiles, 8 warps, a 3-stage
//      cp.async pipeline; FMA in fp32): dx = (dqkv Wqkv^T) * stream-0 mask, and
//      the weight gradients dWqkv = round(x * mask)^T dqkv and
//      dW = round(o)^T round(dz), which reduce over all N*T rows. Those are
//      split along the rows into a fixed number of slices, each writing
//      its own fp32 partial;
//   3. reduce_rows_kernel sums partials (the GEMM slices, the per-block
//      db and dq) in a fixed order.
// So every weight gradient is the same bits on every run: no atomics.
//
// Blocks wholly past n_valid do nothing: their rows are left out of the
// GEMMs' reduction and dx there is written as zeros. Inside a valid block,
// articles at or past n_valid take g = 0 (the forward returns zeros for
// them), so they add nothing.
//
// What bounds it on the card: counted by useful work, per article at the
// article-tower shape (T 30, Din 1024, D 400, A 200) the recompute forward
// is about 80 MFLOP and the backward's products about 155 MFLOP more (dx
// and dWqkv 74 each, the attention 5, pooling 5), so about 235 MFLOP per
// article: bf16 tensor-core operations bound it, not the bytes (x read
// twice, dx written, the dqkv scratch written and read twice).
// What the design does about it: every product is on the tensor cores;
// the QKV GEMM runs once (the recompute) and its panels are kept in the
// dqkv scratch (L2-resident while the block runs), so the attention
// backward re-reads them instead of a second recompute; dx and the weight
// gradients are large GEMMs over all rows instead of per-block products
// accumulated across blocks. What is left: wmma instead of wgmma, no TMA,
// and the dqkv round trip through device memory.
//
// Interface: plain C, bound from Python with ctypes
// (ebnerd_tpu_torch/ops/news_encoder.py); each entry point launches on
// the caller's stream and returns cudaGetLastError().

#include "news_encoder_common.cuh"

namespace {

using namespace ne;

constexpr int kDoRows = 32;  // W_att rows (columns of do) per staged chunk

// Shared memory of the backward kernel: region R (reused by phase), then o
// [kRows][ldf] fp32 (later do in the compute dtype [kRows][ldo] at its
// start), then att, wts, dvals, datt [kRows] fp32 each. R holds, in turn,
// the forward's phases (Layout), then the pooling backward (hact / dz fp32
// [kRows][ldz] at R, or the W_att chunk of the do product and per-warp
// scratch; dz in the compute dtype [kRows][lda] at dzc), then the per-warp
// attention-backward tiles (Q, K, V, dO in the compute dtype, one fp32).
struct BwdLayout {
  Layout f;
  int ldt, ldF, att_warps;
  size_t tile, warp_bytes, dzc, r, o, small, total;
};

__host__ __device__ inline BwdLayout make_bwd_layout(int d, int a_pad, int elem) {
  BwdLayout B;
  B.f = make_layout(d, a_pad, elem);
  const bool bf = elem == 2;
  B.ldt = bf ? kTileLd : 33;
  B.ldF = bf ? kTileLdF : 33;
  B.att_warps = bf ? kWarps : kWarps / 2;
  B.tile = size_t(32) * B.ldt * elem;
  B.warp_bytes = align128(4 * B.tile + size_t(32) * B.ldF * 4);
  const size_t z = align128(size_t(kRows) * B.f.ldz * 4);
  const size_t wchunk = align128(size_t(kDoRows) * B.f.lda * elem) + size_t(kWarps) * 1024;
  B.dzc = smax(z, wchunk);
  const size_t pool_bwd = B.dzc + align128(size_t(kRows) * B.f.lda * elem);
  B.r = align128(smax(smax(B.f.r, pool_bwd), B.att_warps * B.warp_bytes));
  B.o = B.r;
  B.small = B.o + align128(size_t(kRows) * B.f.ldf * 4);
  B.total = B.small + size_t(4) * kRows * 4;
  return B;
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
    for (int i = lane; i < 32 * 32; i += 32) {
      const int r = i / 32, c = i % 32;
      const bool ok = r < t && c < hd;
      const size_t g = size_t(r) * P + c;
      Qs[r * ld + c] = ok ? q[g] : zero;
      Ks[r * ld + c] = ok ? k[g] : zero;
      Vs[r * ld + c] = ok ? v[g] : zero;
      Os[r * ld + c] = ok ? dob[r * ldo + c] : zero;
    }
    __syncwarp();
    warp_mm<T, false, true>(Qs, Ks, ld, F, B.ldF);  // S = Q K^T
    __syncwarp();
    float p[32], ds[32];
    {  // softmax of query row `lane` over the t real keys (rows past t: 0)
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        p[c] = F[lane * B.ldF + c] * scale;
        if (c < t) m = fmaxf(m, p[c]);
      }
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        p[c] = c < t && lane < t ? expf(p[c] - m) : 0.f;
        sum += p[c];
      }
#pragma unroll
      for (int c = 0; c < 32; ++c) p[c] = lane < t ? p[c] / sum : 0.f;
    }
    __syncwarp();
    warp_mm<T, false, true>(Os, Vs, ld, F, B.ldF);  // dP = dO V^T
    __syncwarp();
    {
      float ip = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        ds[c] = F[lane * B.ldF + c];
        ip += p[c] * ds[c];
      }
#pragma unroll
      for (int c = 0; c < 32; ++c) ds[c] = p[c] * (ds[c] - ip) * scale;
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) Vs[lane * ld + c] = from_f<T>(p[c]);  // P over the spent V
    __syncwarp();
    warp_mm<T, true, false>(Vs, Os, ld, F, B.ldF);  // dV = P^T dO
    __syncwarp();
    store_tile<T>(F, B.ldF, v, P, t, hd);
#pragma unroll
    for (int c = 0; c < 32; ++c) Os[lane * ld + c] = from_f<T>(ds[c]);  // dS over the spent dO
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

struct BwdArgs {
  const void* x;
  const void* wqkv;
  const void* w_att;
  const float* b_att;
  const float* q_att;
  const float* g;   // [n, d] fp32
  void* qkv;        // [n*t, P] compute dtype: Q|K|V panels, then dQ|dK|dV
  void* o_c;        // [n*t, d] compute dtype: round(o) after dropout
  void* dz_c;       // [n*t, a_pad] compute dtype: round(dz)
  float* db_part;   // [blocks, a_pad]
  float* dq_part;   // [blocks, a_pad]
  int n, t, din, d, heads, gh, a, a_pad, n_valid, nb;
  float scale;
  philox::Dropout dr;
  const float* ext_mask;
  float inv_ext;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) news_encoder_bwd_kernel(BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout B = make_bwd_layout(p.d, p.a_pad, sizeof(T));
  const Layout& L = B.f;
  unsigned char* R = smem;
  float* o = reinterpret_cast<float*>(smem + B.o);
  float* att = reinterpret_cast<float*>(smem + B.small);
  float* wts = att + kRows;
  float* dvals = wts + kRows;
  float* datt = dvals + kRows;
  constexpr int VE = 16 / sizeof(T);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = p.t, d = p.d, a = p.a, a_pad = p.a_pad, din = p.din;
  const int g0 = blockIdx.x * p.nb;
  if (g0 >= p.n_valid) return;  // left out of the GEMMs and the reductions
  const int na = min(p.nb, p.n - g0);
  const int rows = na * t, row0 = g0 * t;
  const int hd = d / p.heads;
  const int n_groups = (p.heads + p.gh - 1) / p.gh;
  const int P = n_groups * kPanel;
  const T* xb = static_cast<const T*>(p.x) + size_t(row0) * din;
  const T* wqkv = static_cast<const T*>(p.wqkv);
  const T* w_att = static_cast<const T*>(p.w_att);
  T* qkv = static_cast<T*>(p.qkv) + size_t(row0) * P;

  // 1. recompute the forward: QKV panels (kept in the dqkv scratch) and o
  const EmbDrop ed{p.dr.key, p.dr.thr_emb, p.dr.inv_emb, row0};
  for (int g = 0; g < n_groups; ++g) {
    qkv_panel<T>(xb, rows, din, wqkv + g * kPanel, P, L, R, ed);
    __syncthreads();
    const T* panel = reinterpret_cast<const T*>(R);
    for (int i = tid; i < rows * (kPanel / VE); i += kThreads) {
      const int r = i / (kPanel / VE), c = (i % (kPanel / VE)) * VE;
      *reinterpret_cast<uint4*>(qkv + size_t(r) * P + g * kPanel + c) =
          *reinterpret_cast<const uint4*>(panel + r * L.ldw + c);
    }
    attention_group<T>(panel, L.ldw, o, L.ldf, na, t, hd, p.gh, g * p.gh,
                       min(p.gh, p.heads - g * p.gh), p.scale, R + L.panel);
    __syncthreads();
  }
  drop_o(o, L.ldf, rows, d, row0, p.dr, p.ext_mask, p.inv_ext);
  __syncthreads();

  // 2. round(o) for dW; dvals[r] = round(o[r]) . round(g[article])
  T* o_c = static_cast<T*>(p.o_c) + size_t(row0) * d;
  for (int i = tid; i < rows * d; i += kThreads) o_c[i] = from_f<T>(o[(i / d) * L.ldf + i % d]);
  for (int r = warp; r < rows; r += kWarps) {
    const int art = g0 + r / t;
    float v = 0.f;
    if (art < p.n_valid)
      for (int c = lane; c < d; c += 32) v += rnd<T>(o[r * L.ldf + c]) * rnd<T>(p.g[size_t(art) * d + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) dvals[r] = v;
  }
  __syncthreads();

  // 3. pooling forward: z = round(o) W, hact = tanh(z + b) kept in place, weights
  pooling_logits<T>(o, rows, d, w_att, a_pad, L, R);
  __syncthreads();
  float* hz = reinterpret_cast<float*>(R);
  pooling_weights<T>(hz, L.ldz, p.b_att, p.q_att, a, rows, na, t, att, wts, true);

  // 4. datt = w (dvals - sum_t w dvals); zero for articles past n_valid
  for (int an = warp; an < na; an += kWarps) {
    const int r = an * t + lane;
    const float wv = lane < t ? wts[r] * dvals[r] : 0.f;
    float inner = wv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) inner += __shfl_xor_sync(0xffffffffu, inner, off);
    if (lane < t) datt[r] = g0 + an < p.n_valid ? wts[r] * (dvals[r] - inner) : 0.f;
  }
  __syncthreads();

  // 5. per column j: dq += round(hact) round(datt); dz = round(datt) round(q) (1 - hact^2);
  //    db += dz; round(dz) kept for do and written for dW
  T* dzc = reinterpret_cast<T*>(R + B.dzc);
  for (int j = tid; j < a_pad; j += kThreads) {
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
  __syncthreads();
  T* dz_g = static_cast<T*>(p.dz_c) + size_t(row0) * a_pad;
  for (int i = tid; i < rows * (a_pad / VE); i += kThreads) {
    const int r = i / (a_pad / VE), c = (i % (a_pad / VE)) * VE;
    *reinterpret_cast<uint4*>(dz_g + size_t(r) * a_pad + c) =
        *reinterpret_cast<const uint4*>(dzc + r * L.lda + c);
  }

  // 6. do = (w g + round(dz) round(W)^T) * dropout mask, in the compute
  //    dtype over o (spent), kDoRows columns at a time
  T* doc = reinterpret_cast<T*>(o);
  T* ws = reinterpret_cast<T*>(R);
  float* scr = reinterpret_cast<float*>(R + align128(size_t(kDoRows) * L.lda * sizeof(T)));
  for (int c0 = 0; c0 < d; c0 += kDoRows) {
    for (int i = tid; i < kDoRows * a_pad; i += kThreads) {
      const int rr = i / a_pad, j = i % a_pad;
      ws[rr * L.lda + j] = c0 + rr < d ? w_att[size_t(c0 + rr) * a_pad + j] : from_f<T>(0.f);
    }
    __syncthreads();
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
        wmma::load_matrix_sync(af, dzc + mi * 16 * L.lda + kk, L.lda);
        wmma::load_matrix_sync(bfr, ws + nj * 16 * L.lda + kk, L.lda);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
    } else {
      for (int e = lane; e < 256; e += 32) {
        const T* zr = dzc + (mi * 16 + e / 16) * L.lda;
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
      if (p.dr.thr_att)
        m = philox::mask4(p.dr.key, uint32_t(row0 + r), uint32_t(c >> 2), 1u, p.dr.thr_att,
                          p.dr.inv_att);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j >= d) break;
        float mj = philox::pick(m, j);
        if (!p.dr.thr_att && p.ext_mask != nullptr)
          mj = p.ext_mask[size_t(row0 + r) * d + c + j] * p.inv_ext;
        const float gv = art < p.n_valid ? p.g[size_t(art) * d + c + j] : 0.f;
        doc[r * L.ldo + c + j] = from_f<T>((wts[r] * gv + sc[rr * 16 + cc + j]) * mj);
      }
    }
    __syncthreads();
  }

  // 7. attention backward, head group by head group
  for (int g = 0; g < n_groups; ++g)
    attention_bwd_group<T>(qkv, P, g * kPanel, doc, L.ldo, na, t, hd, p.gh, g * p.gh,
                           min(p.gh, p.heads - g * p.gh), p.scale, R, B);
}

// ---- tiled GEMM ----
// kDx: C [M, N] (compute dtype) = A [M, K] B[N, K]^T, times the stream-0
//      mask of (row m, column n); rows m >= m_valid are zeros.
// else: partial C_z [M, N] fp32 = sum over rows k of slice z of
//      A[k, m] B[k, n], with A = round(x * stream-0 mask) when thr != 0.
// 128 x 128 tiles, 8 warps (bf16: each 64 x 32 of wmma fragments; fp32:
// each thread 8 x 8 by FMA), kGStages-deep cp.async pipeline over 64-byte
// contraction chunks.
constexpr int kBM = 128, kBN = 128, kGThreads = 256, kGBytes = 64, kGStages = 3;

template <typename T, bool kDx>
struct GemmTiles {
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int BK = kGBytes / sizeof(T);
  // A: kDx [BM][BK + VE] (m rows), else [BK][BM + VE] (k rows)
  static constexpr int lda = kDx ? BK + VE : kBM + VE;
  static constexpr int a_elems = kDx ? kBM * lda : BK * lda;
  // B: kDx [BN][BK + VE] (n rows), else [BK][BN + VE] (k rows)
  static constexpr int ldb = kDx ? BK + VE : kBN + VE;
  static constexpr int b_elems = kDx ? kBN * ldb : BK * ldb;
  static constexpr int stage = ((a_elems + b_elems) * int(sizeof(T)) + 127) / 128 * 128;
  static constexpr int scratch = kGThreads / 32 * 16 * 16 * 4;  // one fragment per warp
  static constexpr int total = kGStages * stage + scratch;
};

template <typename T, bool kDx>
__global__ void __launch_bounds__(kGThreads) gemm_kernel(const T* __restrict__ A,
                                                         const T* __restrict__ Bm, void* out,
                                                         int M, int N, int K, int lda_g, int ldb_g,
                                                         int k_per_split, int m_valid,
                                                         philox::Key key, uint32_t thr, float inv) {
  using G = GemmTiles<T, kDx>;
  constexpr int VE = G::VE, BK = G::BK;
  extern __shared__ __align__(128) unsigned char sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(K, k_begin + k_per_split);

  if (kDx && m0 >= m_valid) {  // rows past n_valid: zeros
    T* C = static_cast<T*>(out);
    for (int i = tid; i < kBM * kBN; i += kGThreads) {
      const int m = m0 + i / kBN, n = n0 + i % kBN;
      if (m < M && n < N) C[size_t(m) * N + n] = from_f<T>(0.f);
    }
    return;
  }
  auto As = [&](int s) { return reinterpret_cast<T*>(sm + s * G::stage); };
  auto Bs = [&](int s) { return reinterpret_cast<T*>(sm + s * G::stage) + G::a_elems; };
  auto issue = [&](int kc, int s) {
    const int k0 = k_begin + kc * BK;
    T* a_s = As(s);
    T* b_s = Bs(s);
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
  // A = round(x * mask) for the weight gradient: rows k, columns m
  auto mask_a = [&](int kc, int s) {
    if (!kDx && thr) {
      const int k0 = k_begin + kc * BK;
      mask_x_tile<T>(As(s), G::lda, k_end - k0, BK, m0, kBM, M, EmbDrop{key, thr, inv, k0});
      __syncthreads();
    }
  };
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using LA = typename std::conditional<kDx, wmma::row_major, wmma::col_major>::type;
    using LB = typename std::conditional<kDx, wmma::col_major, wmma::row_major>::type;
    const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm*64, cols wn*32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    pipeline<kGStages>(nk, issue, [&](int kc, int s) {
      mask_a(kc, s);
      const T* a_s = As(s);
      const T* b_s = Bs(s);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mm = wm * 64 + i * 16;
          wmma::load_matrix_sync(af[i], kDx ? a_s + mm * G::lda + kk : a_s + kk * G::lda + mm,
                                 G::lda);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nn = wn * 32 + j * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bfr;
          wmma::load_matrix_sync(bfr, kDx ? b_s + nn * G::ldb + kk : b_s + kk * G::ldb + nn,
                                 G::ldb);
#pragma unroll
          for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
        }
      }
    });
    // epilogue, one fragment at a time through the warp's scratch tile
    float* sc = reinterpret_cast<float*>(sm + kGStages * G::stage) + warp * 256;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int mb = m0 + wm * 64 + i * 16, nb = n0 + wn * 32 + j * 16;
        if constexpr (kDx) {
          T* C = static_cast<T*>(out);
          for (int e4 = lane; e4 < 64; e4 += 32) {
            const int r = e4 / 4, c = (e4 % 4) * 4, m = mb + r, n = nb + c;
            if (m >= M) continue;
            float4 mk = make_float4(1.f, 1.f, 1.f, 1.f);
            if (thr && m < m_valid && n < N)
              mk = philox::mask4(key, uint32_t(m), uint32_t(n >> 2), 0u, thr, inv);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < N)
                C[size_t(m) * N + n + q] =
                    from_f<T>(m < m_valid ? sc[r * 16 + c + q] * philox::pick(mk, q) : 0.f);
          }
        } else {
          float* C = static_cast<float*>(out) + size_t(blockIdx.z) * M * N;
          for (int e = lane; e < 256; e += 32) {
            const int m = mb + e / 16, n = nb + e % 16;
            if (m < M && n < N) C[size_t(m) * N + n] = sc[e];
          }
        }
        __syncwarp();
      }
  } else {
    // fp32: thread (ty, tx) owns rows ty*8 + [0,8) and columns tx + 16*[0,8)
    const int ty = tid / 16, tx = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    pipeline<kGStages>(nk, issue, [&](int kc, int s) {
      mask_a(kc, s);
      const T* a_s = As(s);
      const T* b_s = Bs(s);
      for (int k = 0; k < BK; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int mm = ty * 8 + i;
          av[i] = to_f<T>(kDx ? a_s[mm * G::lda + k] : a_s[k * G::lda + mm]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nn = tx + 16 * j;
          bv[j] = to_f<T>(kDx ? b_s[nn * G::ldb + k] : b_s[k * G::ldb + nn]);
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
          static_cast<T*>(out)[size_t(m) * N + n] = from_f<T>(m < m_valid ? acc[i][j] * mk : 0.f);
        } else {
          (static_cast<float*>(out) + size_t(blockIdx.z) * M * N)[size_t(m) * N + n] = acc[i][j];
        }
      }
  }
}

// out[c] = sum over r of part[r, c], r in order within each of 8 warps,
// then the 8 warp sums in order: the same bits on every run.
__global__ void reduce_rows_kernel(const float* __restrict__ part, int nrows, long long ncols,
                                   float* __restrict__ out) {
  __shared__ float s[8][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long c = blockIdx.x * 32LL + lane;
  float acc = 0.f;
  if (c < ncols)
    for (int r = warp; r < nrows; r += 8) acc += part[r * ncols + c];
  s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < ncols) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) v += s[w][lane];
    out[c] = v;
  }
}

template <typename T>
int launch_core(BwdArgs& p, cudaStream_t stream) {
  const int hd = p.heads > 0 ? p.d / p.heads : 0;
  if (p.t < 1 || p.t > kMaxT || p.heads < 1 || p.d % p.heads || hd > kMaxHeadDim || p.gh < 1 ||
      3 * p.gh * hd > kPanel || p.a > p.a_pad || p.a_pad > kMaxAtt || p.a_pad % 16 ||
      p.din % (16 / int(sizeof(T))) || p.din % 4 || p.d % 4)
    return int(cudaErrorInvalidValue);
  const BwdLayout B = make_bwd_layout(p.d, p.a_pad, sizeof(T));
  if (B.total > size_t(kSmemLimit)) return int(cudaErrorInvalidValue);
  auto kern = news_encoder_bwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(B.total));
  if (e != cudaSuccess) return int(e);
  p.nb = kRows / p.t;
  const int grid = (p.n + p.nb - 1) / p.nb;
  if (grid == 0) return 0;
  kern<<<grid, kThreads, B.total, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, bool kDx>
int launch_gemm(const void* A, const void* Bm, void* out, int M, int N, int K, int lda, int ldb,
                int splits, int m_valid, philox::Key key, uint32_t thr, float inv,
                cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T), BK = GemmTiles<T, kDx>::BK;
  if (M < 1 || N < 1 || K < 0 || splits < 1 || lda % VE || ldb % VE ||
      (kDx ? K % VE : (M % VE || N % VE)) || (thr && (kDx ? N % 4 : M % 4)))
    return int(cudaErrorInvalidValue);
  const int kps = kDx ? K : ((K + splits - 1) / splits + BK - 1) / BK * BK;
  auto kern = gemm_kernel<T, kDx>;
  constexpr int smem = GemmTiles<T, kDx>::total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, kDx ? 1 : splits);
  kern<<<grid, kGThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(Bm), out, M, N, K, lda, ldb,
      kps > 0 ? kps : BK, m_valid, key, thr, inv);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

long long news_encoder_bwd_smem_bytes(int d, int a_pad, int is_bf16) {
  return (long long)make_bwd_layout(d, a_pad, is_bf16 ? 2 : 4).total;
}

// The per-block backward kernel. Inputs as news_encoder_fwd, plus g [n, d]
// fp32. Writes qkv [n*t, P] (dQ|dK|dV in the packed panel layout), o_c
// [n*t, d], dz_c [n*t, a_pad] (compute dtype), db_part and dq_part
// [ceil(n / (64 / t)), a_pad] fp32, for the blocks before n_valid only.
int news_encoder_bwd_core(const void* x, const void* wqkv, const void* w_att, const void* b_att,
                          const void* q_att, const void* g, void* qkv, void* o_c, void* dz_c,
                          void* db_part, void* dq_part, int n, int t, int din, int d, int heads,
                          int gh, int a, int a_pad, int n_valid, float scale, int is_bf16,
                          unsigned seed_lo, unsigned seed_hi, unsigned thr_emb, unsigned thr_att,
                          float inv_emb, float inv_att, const void* ext_mask, float inv_ext,
                          void* stream) {
  BwdArgs p{x, wqkv, w_att, static_cast<const float*>(b_att), static_cast<const float*>(q_att),
            static_cast<const float*>(g), qkv, o_c, dz_c, static_cast<float*>(db_part),
            static_cast<float*>(dq_part), n, t, din, d, heads, gh, a, a_pad, n_valid, 0, scale,
            philox::Dropout{{seed_lo, seed_hi}, thr_emb, thr_att, inv_emb, inv_att},
            static_cast<const float*>(ext_mask), inv_ext};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_core<bf16>(p, s) : launch_core<float>(p, s);
}

// is_dx: out [M, N] (compute dtype) = A [M, K] (row stride lda) times
//   B [N, K]^T (row stride ldb), times the stream-0 mask when thr != 0;
//   rows >= m_valid are zeros.
// else: out [splits, M, N] fp32 partials of A^T B over rows [0, K) cut into
//   `splits` slices, A [K, M] (stride lda; masked by stream 0 when
//   thr != 0), B [K, N] (stride ldb).
int news_encoder_gemm(const void* A, const void* B, void* out, int M, int N, int K, int lda,
                      int ldb, int is_dx, int splits, int m_valid, int is_bf16, unsigned seed_lo,
                      unsigned seed_hi, unsigned thr, float inv, void* stream) {
  const philox::Key key{seed_lo, seed_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return is_dx ? launch_gemm<bf16, true>(A, B, out, M, N, K, lda, ldb, 1, m_valid, key, thr, inv, s)
                 : launch_gemm<bf16, false>(A, B, out, M, N, K, lda, ldb, splits, 0, key, thr, inv, s);
  return is_dx ? launch_gemm<float, true>(A, B, out, M, N, K, lda, ldb, 1, m_valid, key, thr, inv, s)
               : launch_gemm<float, false>(A, B, out, M, N, K, lda, ldb, splits, 0, key, thr, inv, s);
}

// out [ncols] = sum of part [nrows, ncols] over rows, in a fixed order.
int news_encoder_reduce(const void* part, int nrows, long long ncols, void* out, void* stream) {
  if (nrows < 0 || ncols < 1) return int(cudaErrorInvalidValue);
  const long long blocks = (ncols + 31) / 32;
  reduce_rows_kernel<<<unsigned(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), nrows, ncols, static_cast<float*>(out));
  return int(cudaGetLastError());
}

const char* news_encoder_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
