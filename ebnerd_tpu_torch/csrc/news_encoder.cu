// Fused NRMS news encoder, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_news_encoder` / `_kernel` in
// ebnerd_tpu/ops/news_encoder.py, eval and training mode. For each block
// of articles it computes, keeping every intermediate in shared memory:
//   1. QKV = round(x * emb mask) @ [Wq | Wk | Wv], one head group at a time,
//      stored in the compute dtype -- the rounding point of the TPU
//      kernel's `_bdot` casts. bf16: the QKV stage of
//      news_encoder_common.cuh (TMA-fed wgmma, fp32 accumulators); x comes
//      already masked (the wrapper draws the embedding mask once, with
//      K2's mask kernel, and the backward reuses it). fp32: mma.sync on the
//      tensor cores in 3xTF32 (news_encoder_common.cuh) over a cp.async
//      pipeline of x and of the weight's TF32 split, the stream-0 Philox
//      mask (csrc/philox.cuh) scaling each staged x chunk before the
//      product, as the TPU kernel does before its QKV product. When a
//      gradient will follow, each panel is also written to device memory
//      (qkv_out), and the backward's per-block kernel reads it there
//      instead of running this stage again;
//   2. per-head self-attention of that group (bf16: wmma on 32 x 32 tiles,
//      one warp per article and head, or in the wide instance mma.sync per
//      article, head and 16-row query tile; fp32: 3xTF32 mma.sync per
//      article, head and 16-row query tile) with an fp32 softmax over
//      the head's keys (probabilities rounded to the compute dtype before
//      the product with V, as `_bdot` does), no biases, no output
//      projection, scale 1/sqrt(head_dim); the attention output o stays
//      in fp32;
//   3. dropout on o: the stream-1 Philox mask, or an external 0/1 mask
//      [N, T, D] times 1/keep;
//   4. additive pooling: z = o W (operands in the compute dtype, wmma in
//      bf16, 3xTF32 mma.sync in fp32; the wide instance in chunks of 256
//      columns of W), softmax_t(
//      tanh(z + b) . q) (max subtracted, +1e-8 in the denominator) and the
//      weighted sum of the fp32 o over t.
// Two instances of the kernel (news_encoder_common.cuh): the narrow one for
// T <= 32, head width <= 32 and padded attention width <= 256, and the wide
// one for the rest of T <= 64, head width <= 64, attention width <= 512
// (one article per block past T 32).
// Output [N, D] fp32. Articles at or past n_valid are written as zeros; a
// block whose first article is past n_valid computes nothing past the QKV
// stage (bf16: it runs that stage only when a block of its cluster is
// valid, fp32: not at all). n_valid and the dropout seed may be read from
// device memory (a replayed CUDA graph serves each step's own).
//
// What bounds it on the card: at the article-tower shape (T 30, Din 1024,
// D 400, A 200) about 74 of the 80 MFLOP per article are the QKV product,
// so the kernel is bound by bf16 tensor-core operations (989 TFLOP/s on an
// H100 SXM), not by reading x (1.4 GB per news-tower call of the training
// step). What the design does about it: the QKV product runs on wgmma fed
// by TMA from a producer warp, so loads overlap the products and no
// compute thread spends instructions on copies; a cluster of CTAs shares
// each weight k-tile by multicast, cutting the weight's L2 traffic (each
// block of 64 rows reads the whole 2.6 MB packed weight). A block holds 64
// rows (two articles at T 30, three at T 20); only one panel's Q/K/V sit
// in shared memory beside the fp32 o tile, which must stay resident for
// the weighted sum. What is left: one CTA per SM with the phases in
// series (the attention and the pooling on wmma leave the producer idle,
// and the ring refills only after each panel's attention), and the
// weight's L2 traffic divided only by the cluster size.
// fp32 (the JAX package's default dtype) is bound by the same products at
// a third of the TF32 tensor-core rate: 3xTF32 keeps an fp32 product's
// accuracy with three TF32 products (495 / 3 = 165 TFLOP/s on an H100 SXM,
// 2.5x the 67 of FMA; one TF32 product, about 5e-4 relative, would fail the
// fp32 checks). Its stages (fp32_variant 1) take each product on mma.sync
// m16n8k8, each operand split in registers; the FMA stages stay for head widths under 8 and for
// timing (fp32_variant 0). What is left: the same 64-row blocks, one an SM
// (the fp32 o tile fills shared memory beside the stages), so a small
// batch (the CLI's user tower: 11 blocks) leaves most SMs idle.

// Interface: plain C, bound from Python with ctypes
// (ebnerd_tpu_torch/ops/news_encoder.py). The wrapper validates shapes,
// dtypes, alignment and contiguity and allocates the output; its
// pack_weights packs the QKV weight into head-group panels and pads
// W_att's columns once per set of weights. This file launches on the
// caller's stream and returns cudaGetLastError().

#include <string.h>

#include "news_encoder_common.cuh"

namespace {

using namespace ne;

struct FwdArgs {
  const void* x;  // fp32: [n * t, din]; bf16: read through the tensor map
  const void* wqkv;
  const void* w_att;
  const float* b_att;
  const float* q_att;
  float* out;
  void* qkv_out;  // [n * t, P] compute dtype: the Q|K|V panels kept for the backward, or null
  int n, t, din, d, heads, gh, a, a_pad, n_valid, nb, stages, cluster;
  float scale;
  philox::Dropout dr;
  const float* ext_mask;
  float inv_ext;
  const int* nv_dev;                  // n_valid in device memory, or null (n_valid above)
  const unsigned long long* seed_dev; // the seed in device memory, or null (dr.key above)
};

template <typename T, int kCta, bool kWide, bool kTc>
__global__ void __launch_bounds__(kCta, 1)
    news_encoder_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap, FwdArgs p) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  static_assert(!(kBf && kTc), "kTc: the fp32 stages on the tensor cores");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = kBf ? align_smem(smem_raw) : smem_raw;
  const int t = p.t, d = p.d, din = p.din;
  const Layout L = make_layout(d, p.a_pad, sizeof(T), p.stages, kWide, kTc);
  unsigned char* R = smem;  // region R starts at the base
  float* o = reinterpret_cast<float*>(smem + L.o);
  float* att = reinterpret_cast<float*>(smem + L.small);
  float* wts = att + kRows;

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * p.nb;              // first article of this block
  const int na = max(0, min(p.nb, p.n - g0));    // its articles inside N
  const int rows = na * t;
  const int hd = d / p.heads;
  const int n_valid = valid_at(p.n_valid, p.nv_dev, p.n);
  const bool active = g0 < n_valid;
  const int n_groups = (p.heads + p.gh - 1) / p.gh;
  // where a valid block keeps each group's Q|K|V for the backward (null: not kept)
  T* keep = active && p.qkv_out != nullptr
                ? static_cast<T*>(p.qkv_out) + size_t(g0) * t * n_groups * kPanel
                : nullptr;

  // 1-2. per head group: QKV panel (kept in qkv_out), then that group's attention
  if constexpr (kBf) {
    const int nk = (din + kQkvBK - 1) / kQkvBK;
    // the cluster's CTAs run the QKV stage together when its first block is valid
    const bool run_qkv = int(blockIdx.x) / p.cluster * p.cluster * p.nb < n_valid;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
    const QkvRing q{smem, bars, bars + kQkvMaxStages, p.stages, p.cluster};
    if (tid == 0) qkv_ring_init(q);
    hop::cluster_sync();
    if (tid >= kThreads) {  // the producer warpgroup
      hop::regs_dec<40>();
      if (tid == kThreads && run_qkv && (NE_PHASES & 1))
        qkv_produce(q, &xmap, &wmap, g0 * t, n_groups, nk);
      return;
    }
    hop::regs_inc<232>();
    if (!active)
      for (int i = tid; i < na * d; i += kThreads) p.out[size_t(g0) * d + i] = 0.f;
    if (!run_qkv) return;
    const bf16* panel = reinterpret_cast<const bf16*>(R);
    int it = 0;
    for (int g = 0; g < n_groups; ++g) {
      if (NE_PHASES & 1) qkv_panel_wgmma(q, it, nk, reinterpret_cast<bf16*>(R), L.ldw);
      csync();
      if (keep != nullptr)
        store_panel<T, true>(reinterpret_cast<const T*>(R), L.ldw, keep + g * kPanel,
                             n_groups * kPanel, rows);
      if (active && (NE_PHASES & 2))
        attention_group<T, kWide>(reinterpret_cast<const T*>(panel), L.ldw, o, L.ldf, na, t, hd, p.gh,
                           g * p.gh, min(p.gh, p.heads - g * p.gh), p.scale, R + L.panel);
      if (NE_PHASES & 1)
        qkv_panel_done(q, it);  // the ring is free to refill
      else
        csync();
    }
    if (!active) return;
  } else {
    if (!active) {  // wholly past n_valid: zeros, no compute
      for (int i = tid; i < na * d; i += kThreads) p.out[size_t(g0) * d + i] = 0.f;
      return;
    }
    const float* xb = static_cast<const float*>(p.x) + size_t(g0) * t * din;
    const EmbDrop ed{philox::key_at(p.dr.key, p.seed_dev), p.dr.thr_emb, p.dr.inv_emb, g0 * t};
    const float* wq = static_cast<const float*>(p.wqkv);
    for (int g = 0; g < n_groups; ++g) {
      const int nh = min(p.gh, p.heads - g * p.gh);
      if (NE_PHASES & 1) {
        if constexpr (kTc)
          qkv_panel_tf32(xb, rows, din, wq + g * kPanel, n_groups * kPanel, L, R, ed);
        else
          qkv_panel_fp32(xb, rows, din, wq + g * kPanel, n_groups * kPanel, L, R, ed);
      }
      csync();
      if (keep != nullptr)
        store_panel<T, true>(reinterpret_cast<const T*>(R), L.ldw, keep + g * kPanel,
                             n_groups * kPanel, rows);
      if (NE_PHASES & 2) {
        if constexpr (kTc)
          attention_group_tf32<kWide ? 8 : 4>(reinterpret_cast<const float*>(R), L.ldw, o, L.ldf, na, t, hd,
                               p.gh, g * p.gh, nh, p.scale);
        else
          attention_group<T, kWide>(reinterpret_cast<const T*>(R), L.ldw, o, L.ldf, na, t, hd,
                                    p.gh, g * p.gh, nh, p.scale, R + L.panel);
      }
      csync();  // the panel is consumed before R is refilled
    }
  }

  // 3. dropout between attention and pooling
  philox::Dropout dr = p.dr;
  dr.key = philox::key_at(dr.key, p.seed_dev);
  drop_o(o, L.ldf, rows, d, g0 * t, dr, p.ext_mask, p.inv_ext);
  csync();

  // 4. pooling projection z = o W_att, pooling weights
  if constexpr (kWide) {
    pooling_wide<T, float, kTc>(o, L.ldf, rows, na, t, d, static_cast<const T*>(p.w_att),
                                p.b_att, p.q_att, p.a, p.a_pad, L, R, att, wts);
  } else {
    if (NE_PHASES & 4)
      pooling_logits<T, kTc>(o, rows, d, static_cast<const T*>(p.w_att), p.a_pad, L, R);
    csync();
    pooling_weights<T>(reinterpret_cast<float*>(R), L.ldz, p.b_att, p.q_att, p.a, rows, na, t,
                       att, wts, false);
  }

  // 5. weighted sum over t of the fp32 o; articles at or past n_valid are zeros
  for (int i = tid; i < na * d; i += kThreads) {
    const int an = i / d, dd = i % d;
    float v = 0.f;
    if (g0 + an < n_valid) {
      for (int tt = 0; tt < t; ++tt) v += o[(an * t + tt) * L.ldf + dd] * wts[an * t + tt];
    }
    p.out[size_t(g0) * d + i] = v;
  }
}

// A bf16 QKV stage's ring depth and cluster size the kernel takes.
inline bool qkv_plan_ok(int din, int stages, int cluster) {
  const int nk = (din + kQkvBK - 1) / kQkvBK;
  return stages >= (nk > 1 ? 2 : 1) && stages <= kQkvMaxStages && stages <= nk &&
         (cluster == 1 || cluster == 2);
}

template <typename T, bool kWide, bool kTc>
int launch(FwdArgs p, int x_rows, cudaStream_t stream) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  if (!kBf) p.stages = p.cluster = 1;
  const Layout L = make_layout(p.d, p.a_pad, sizeof(T), p.stages, kWide, kTc);
  if (L.total > size_t(kSmemLimit) ||
      !layout_fits(L, p.d, p.a_pad, sizeof(T), p.stages, kWide, kTc))
    return int(cudaErrorInvalidValue);
  constexpr int kCta = kBf ? kQkvThreads : kThreads;
  auto kern = news_encoder_fwd_kernel<T, kCta, kWide, kTc>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L.total));
  if (e != cudaSuccess) return int(e);
  p.nb = p.t < kRows ? kRows / p.t : 1;
  const int blocks = (p.n + p.nb - 1) / p.nb;
  if (blocks == 0) return 0;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  const int n_groups = (p.heads + p.gh - 1) / p.gh;
  // bf16: x [x_rows, din] (rows past it arrive as zeros), wqkv [din, n_groups * 256]
  if (kBf && x_rows > 0 && p.n_valid > 0 &&
      !(hop::bf16_map(&xmap, p.x, p.din, x_rows, p.din, kQkvBK, kRows) &&
        hop::bf16_map(&wmap, p.wqkv, n_groups * kPanel, p.din, n_groups * kPanel, 64, kQkvBK)))
    return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(unsigned((blocks + p.cluster - 1) / p.cluster * p.cluster));
  cfg.blockDim = dim3(kCta);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, xmap, wmap, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// The shapes the kernel takes (ops/news_encoder.py's check_shape mirrors
// this), then the instance: the narrow one wherever it fits; fp32 on the
// tensor cores (3xTF32) when `tc`, else by FMA.
template <typename T, bool kTc>
int launch(FwdArgs p, int x_rows, cudaStream_t stream) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  const int hd = p.heads > 0 ? p.d / p.heads : 0;
  if (p.t < 1 || p.t > kWideMaxT || p.heads < 1 || p.d % p.heads || hd > kWideMaxHeadDim ||
      p.gh < 1 || 3 * p.gh * hd > kPanel || p.a > p.a_pad || p.a_pad > kWideMaxAtt ||
      p.a_pad % 16 || p.din % (16 / int(sizeof(T))) ||
      ((p.dr.thr_emb || p.dr.thr_att) && p.din % 4) ||
      (kBf && (p.dr.thr_emb || !qkv_plan_ok(p.din, p.stages, p.cluster))))
    return int(cudaErrorInvalidValue);
  return is_wide(p.t, hd, p.a_pad) ? launch<T, true, kTc>(p, x_rows, stream)
                                   : launch<T, false, kTc>(p, x_rows, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper refuses shapes over
// the limit before launching), with a QKV ring of `stages` stages (bf16),
// in the instance that (t, head width d / heads, a_pad) takes; fp32 with
// its stages on the tensor cores when tc (fp32_variant 1), else by FMA.
long long news_encoder_smem_bytes(int t, int d, int heads, int a_pad, int is_bf16, int stages,
                                  int fp32_variant) {
  const bool wide = is_wide(t, heads > 0 ? d / heads : 0, a_pad);
  const bool tc = !is_bf16 && fp32_variant == 1;
  return (long long)make_layout(d, a_pad, is_bf16 ? 2 : 4, stages, wide, tc).total;
}

// x [x_rows, din] in the compute dtype (bf16 when is_bf16, else fp32):
// bf16 reads rows [0, x_rows) and takes the rows past them as zeros (the
// wrapper passes at most n_valid * t), fp32 needs all n * t rows; wqkv [din, ceil(heads / gh) * 256] in the compute
// dtype, head-group panels of 256 columns: Q of heads [g*gh, g*gh + gh) at
// 0, K at gh*hd, V at 2*gh*hd, zeros elsewhere; w_att [d, a_pad] in the
// compute dtype (zero columns past a); b_att, q_att [a] fp32; out [n, d]
// fp32. Dropout: thr_emb / thr_att are the 24-bit keep thresholds of the
// Philox streams 0 (x; fp32 only: in bf16 x comes masked) and 1 (o) under
// the key (seed_lo, seed_hi), 0 = off, with inv_emb / inv_att = 1 / keep;
// or, with thr_att == 0, ext_mask [n*t, d] fp32 0/1 (may be null) times
// inv_ext. bf16 runs the QKV stage with a ring of `stages` stages (1-3, at
// most ceil(din / 64)) in clusters of `cluster` CTAs (1 or 2).
// nv_dev, when not null, holds n_valid in device memory (int32; the launch
// then takes n_valid = n for its geometry and x_rows = n * t) and seed_dev
// the 64-bit seed (the key then comes from it, not from seed_lo/seed_hi):
// what a captured CUDA graph reads anew at each replay.
// fp32_variant (fp32 only; ops/news_encoder.py's fp32_variant): 1 runs the
// products on the tensor cores in 3xTF32, 0 by FMA (the first stages, kept
// for the widths too narrow for a TF32 tile and for timing); any other
// value is refused.
// qkv_out, when not null, is [n * t, ceil(heads / gh) * 256] in the compute
// dtype: each block before n_valid writes there the Q|K|V panels of its
// rows (round(x * mask) @ wqkv in the compute dtype, as the QKV stage left
// them in shared memory, the layout of wqkv's columns), which the
// backward's per-block kernel then reads instead of computing them again
// (news_encoder_bwd_core's qkv_saved); the blocks past n_valid leave
// their rows unwritten.
// Requires t <= 64, d / heads <= 64, 3 * gh * hd <= 256, a_pad % 16 == 0,
// a_pad <= 512, din % (16 / elem) == 0, din % 4 == 0 with Philox dropout,
// 16-byte aligned pointers, and the block's shared memory within the
// card's. Returns a cudaError_t code (0 = launched).
int news_encoder_fwd(const void* x, int x_rows, const void* wqkv, const void* w_att,
                     const void* b_att, const void* q_att, void* out, int n, int t, int din, int d,
                     int heads, int gh, int a, int a_pad, int n_valid, const void* nv_dev,
                     float scale, int is_bf16, unsigned seed_lo, unsigned seed_hi,
                     const void* seed_dev, unsigned thr_emb, unsigned thr_att, float inv_emb,
                     float inv_att, const void* ext_mask, float inv_ext, int stages, int cluster,
                     int fp32_variant, void* qkv_out, void* stream) {
  const FwdArgs p{x, wqkv, w_att, static_cast<const float*>(b_att), static_cast<const float*>(q_att),
                  static_cast<float*>(out), qkv_out, n, t, din, d, heads, gh, a, a_pad, n_valid, 0, stages,
                  cluster, scale,
                  philox::Dropout{{seed_lo, seed_hi}, thr_emb, thr_att, inv_emb, inv_att},
                  static_cast<const float*>(ext_mask), inv_ext, static_cast<const int*>(nv_dev),
                  static_cast<const unsigned long long*>(seed_dev)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16, false>(p, x_rows, s);
  if (fp32_variant != 0 && fp32_variant != 1) return int(cudaErrorInvalidValue);
  return fp32_variant ? launch<float, true>(p, x_rows, s) : launch<float, false>(p, x_rows, s);
}

const char* news_encoder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
