// Fused NRMS news encoder, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_news_encoder` / `_kernel` in
// ebnerd_tpu/ops/news_encoder.py, eval and training mode. For each block
// of articles it computes, keeping every intermediate in shared memory:
//   1. QKV = round(x * emb mask) @ [Wq | Wk | Wv], one head group at a time
//      (bf16 tensor cores via wmma with fp32 accumulation; fp32 mode uses
//      FMA), stored in the compute dtype -- the rounding point of the TPU
//      kernel's `_bdot` casts. With in-kernel dropout the stream-0 Philox
//      mask (csrc/philox.cuh) scales each staged x chunk in fp32 before
//      the rounding, as the TPU kernel does before its QKV product;
//   2. per-head self-attention of that group (bf16: wmma on 32 x 32 tiles,
//      one warp per article and head; fp32: FMA) with an fp32 softmax over
//      the head's keys (probabilities rounded to the compute dtype before
//      the product with V, as `_bdot` does), no biases, no output
//      projection, scale 1/sqrt(head_dim); the attention output o stays
//      in fp32;
//   3. dropout on o: the stream-1 Philox mask, or an external 0/1 mask
//      [N, T, D] times 1/keep;
//   4. additive pooling: z = o W (operands in the compute dtype, wmma in
//      bf16), softmax_t(tanh(z + b) . q) (max subtracted, +1e-8 in the
//      denominator) and the weighted sum of the fp32 o over t.
// Output [N, D] fp32. Articles at or past n_valid are written as zeros; a
// block whose first article is past n_valid skips all compute.
//
// What bounds it on the card: at the article-tower shape (T 30, Din 1024,
// D 400, A 200) about 74 of the 80 MFLOP per article are the QKV GEMM, so
// the kernel is bound by bf16 tensor-core operations (989 TFLOP/s on an
// H100 SXM), not by reading x (252 MB per 4,096-article chunk).
// What the design does about it: every product runs on the tensor cores,
// and the GEMM operands are staged with cp.async, double-buffered, so the
// next chunk's loads overlap the current chunk's products. A block holds 64 rows (two articles at
// T 30, three at T 20), so the packed QKV weight is streamed from L2 once
// per 64 rows. The QKV product is cut into panels of 256 columns, each
// holding the Q, K and V of a group of heads: only one panel's Q/K/V sit
// in shared memory beside the fp32 o tile, which must stay resident for
// the weighted sum. What is left: the weight re-streaming from L2 (about
// 3.3 MB per block), one block per SM, wmma (mma.sync) instead of wgmma,
// no TMA or warp specialisation; with embedding dropout, the x mask is
// regenerated for every head-group panel (one Philox call per four
// elements per panel).
//
// Interface: plain C, bound from Python with ctypes
// (ebnerd_tpu_torch/ops/news_encoder.py). The wrapper validates shapes,
// dtypes, alignment and contiguity and allocates the output; its
// pack_weights packs the QKV weight into head-group panels and pads
// W_att's columns once per set of weights. This file launches on the
// caller's stream and returns cudaGetLastError().

#include "news_encoder_common.cuh"

namespace {

using namespace ne;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
news_encoder_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                        const T* __restrict__ w_att, const float* __restrict__ b_att,
                        const float* __restrict__ q_att, float* __restrict__ out, int n, int t,
                        int din, int d, int heads, int gh, int a, int a_pad, int n_valid, int nb,
                        float scale, philox::Dropout dr, const float* __restrict__ ext_mask,
                        float inv_ext) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d, a_pad, sizeof(T));
  unsigned char* R = smem;
  float* o = reinterpret_cast<float*>(smem + L.o);
  float* att = reinterpret_cast<float*>(smem + L.small);
  float* wts = att + kRows;

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * nb;  // first article of this block
  const int na = min(nb, n - g0);  // its articles inside N
  const int rows = na * t;
  const int hd = d / heads;

  if (g0 >= n_valid) {  // wholly past n_valid: zeros, no compute
    for (int i = tid; i < na * d; i += kThreads) out[size_t(g0) * d + i] = 0.f;
    return;
  }

  // 1-2. per head group: QKV panel, then that group's attention
  const T* xb = x + size_t(g0) * t * din;
  const EmbDrop ed{dr.key, dr.thr_emb, dr.inv_emb, g0 * t};
  const int n_groups = (heads + gh - 1) / gh;
  for (int g = 0; g < n_groups; ++g) {
    if (NE_PHASES & 1) qkv_panel<T>(xb, rows, din, wqkv + g * kPanel, n_groups * kPanel, L, R, ed);
    __syncthreads();
    if (NE_PHASES & 2)
      attention_group<T>(reinterpret_cast<const T*>(R), L.ldw, o, L.ldf, na, t, hd, gh, g * gh,
                         min(gh, heads - g * gh), scale, R + L.panel);
    __syncthreads();  // the panel is consumed before R is refilled
  }

  // 3. dropout between attention and pooling
  drop_o(o, L.ldf, rows, d, g0 * t, dr, ext_mask, inv_ext);
  __syncthreads();

  // 4. pooling projection z = o W_att, pooling weights
  if (NE_PHASES & 4) pooling_logits<T>(o, rows, d, w_att, a_pad, L, R);
  __syncthreads();
  pooling_weights<T>(reinterpret_cast<float*>(R), L.ldz, b_att, q_att, a, rows, na, t, att, wts,
                     false);

  // 5. weighted sum over t of the fp32 o; articles at or past n_valid are zeros
  for (int i = tid; i < na * d; i += kThreads) {
    const int an = i / d, dd = i % d;
    float v = 0.f;
    if (g0 + an < n_valid) {
      for (int tt = 0; tt < t; ++tt) v += o[(an * t + tt) * L.ldf + dd] * wts[an * t + tt];
    }
    out[size_t(g0) * d + i] = v;
  }
}

template <typename T>
int launch(const void* x, const void* wqkv, const void* w_att, const void* b_att,
           const void* q_att, void* out, int n, int t, int din, int d, int heads, int gh, int a,
           int a_pad, int n_valid, float scale, const philox::Dropout& dr, const float* ext_mask,
           float inv_ext, cudaStream_t stream) {
  const int hd = heads > 0 ? d / heads : 0;
  if (t < 1 || t > kMaxT || heads < 1 || d % heads || hd > kMaxHeadDim || gh < 1 ||
      3 * gh * hd > kPanel || a > a_pad || a_pad > kMaxAtt || a_pad % 16 ||
      din % (16 / int(sizeof(T))) || ((dr.thr_emb || dr.thr_att) && (din % 4 || d % 4)))
    return int(cudaErrorInvalidValue);
  const Layout L = make_layout(d, a_pad, sizeof(T));
  if (L.total > size_t(kSmemLimit)) return int(cudaErrorInvalidValue);
  auto kern = news_encoder_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L.total));
  if (e != cudaSuccess) return int(e);
  const int nb = kRows / t;
  const int grid = (n + nb - 1) / nb;
  if (grid == 0) return 0;
  kern<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(w_att),
      static_cast<const float*>(b_att), static_cast<const float*>(q_att),
      static_cast<float*>(out), n, t, din, d, heads, gh, a, a_pad, n_valid, nb, scale, dr,
      ext_mask, inv_ext);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper refuses shapes over
// the limit before launching).
long long news_encoder_smem_bytes(int d, int a_pad, int is_bf16) {
  return (long long)make_layout(d, a_pad, is_bf16 ? 2 : 4).total;
}

// x [n, t, din] in the compute dtype (bf16 when is_bf16, else fp32);
// wqkv [din, ceil(heads / gh) * 256] in the compute dtype, head-group
// panels of 256 columns: Q of heads [g*gh, g*gh + gh) at 0, K at gh*hd,
// V at 2*gh*hd, zeros elsewhere; w_att [d, a_pad] in the compute dtype
// (zero columns past a); b_att, q_att [a] fp32; out [n, d] fp32.
// Dropout: thr_emb / thr_att are the 24-bit keep thresholds of the Philox
// streams 0 (x) and 1 (o) under the key (seed_lo, seed_hi), 0 = off, with
// inv_emb / inv_att = 1 / keep; or, with thr_att == 0, ext_mask [n*t, d]
// fp32 0/1 (may be null) times inv_ext.
// Requires t <= 32, d / heads <= 32, 3 * gh * hd <= 256, a_pad % 16 == 0,
// a_pad <= 256, din % (16 / elem) == 0, din % 4 == d % 4 == 0 with Philox
// dropout, 16-byte aligned pointers. Returns a cudaError_t code (0 =
// launched).
int news_encoder_fwd(const void* x, const void* wqkv, const void* w_att, const void* b_att,
                     const void* q_att, void* out, int n, int t, int din, int d, int heads,
                     int gh, int a, int a_pad, int n_valid, float scale, int is_bf16,
                     unsigned seed_lo, unsigned seed_hi, unsigned thr_emb, unsigned thr_att,
                     float inv_emb, float inv_att, const void* ext_mask, float inv_ext,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const philox::Dropout dr{{seed_lo, seed_hi}, thr_emb, thr_att, inv_emb, inv_att};
  const float* ext = static_cast<const float*>(ext_mask);
  if (is_bf16)
    return launch<bf16>(x, wqkv, w_att, b_att, q_att, out, n, t, din, d, heads, gh, a, a_pad,
                        n_valid, scale, dr, ext, inv_ext, s);
  return launch<float>(x, wqkv, w_att, b_att, q_att, out, n, t, din, d, heads, gh, a, a_pad,
                       n_valid, scale, dr, ext, inv_ext, s);
}

const char* news_encoder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
