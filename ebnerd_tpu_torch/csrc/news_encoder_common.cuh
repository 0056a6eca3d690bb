// Device code shared by the fused NRMS news encoder's forward
// (news_encoder.cu) and its recompute backward (news_encoder_bwd.cu): the
// block layout, the QKV stage (bf16: TMA-fed wgmma, see below; fp32: a
// cp.async pipeline and 3xTF32 mma.sync, see "3xTF32", or FMA,
// with the embedding-dropout mask applied to x as it is staged), the
// per-head attention of one panel, the
// attention-output dropout and the pooling projection. See news_encoder.cu
// for the design of the forward.
//
// The bf16 QKV stage. A block of 64 rows computes Q|K|V one head-group
// panel of 256 columns at a time: [64 x Din] x [Din x 256], 64-deep
// k-tiles. The CTA has three warpgroups: warpgroups 0 and 1 are the 8
// compute warps of every phase (threads [0, 256), synchronised among
// themselves by a named barrier, csync), warpgroup 2 the producer. One
// producer thread streams the k-tiles of all panels by TMA (128-byte
// swizzle, zeros past each tensor's extent) into a ring of `stages`
// stages, each { x box [64 rows][64 k], 4 weight boxes [64 k][64 n] },
// handed over through full/empty mbarriers. Each compute warpgroup runs
// m64n128k16 wgmma on its half of the panel's columns (the weight read
// N-major through wgmma's transpose bit), with fp32 accumulators in
// registers, one k-tile's products in flight while the next is issued;
// the epilogue writes Q|K|V in bf16 straight from the accumulators. The
// panel and the attention's tiles reuse the ring's bytes: the consumers
// release the panel's last `stages` k-tiles only once they are done with
// the panel. Registers move from the producer to the consumers
// (setmaxnreg). With `cluster` > 1, the CTAs of a thread-block cluster
// (consecutive row blocks) share every weight k-tile: CTA rank r loads
// boxes r, r + cluster, ... and multicasts them to all, and each
// consumer warp releases a stage to every CTA of the cluster, so the
// weight is read from L2 once per cluster instead of once per block. The
// CTAs of a cluster run the stage together, including blocks past
// n_valid or past N beside a valid one (zeros in, nothing out).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "philox.cuh"

// Profiling switch: tools/kernel_phases.py builds variants of the forward
// and of the backward's per-block kernel that leave phases out to see where
// the time goes. Without all bits the result is wrong: such a build is for
// timing only. Bit 0: the QKV product (recomputed in the backward), bit 1:
// the attention (recomputed), bit 2: the pooling product (forward) or the
// pooling forward and backward (backward), bit 3: the backward's do
// product, bit 4: the attention backward.
#ifndef NE_PHASES
#define NE_PHASES 31
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
// The narrow instance (the one the kernels had first, kept as it was for
// the shapes it takes): T, head width and padded attention width up to
// these; warp-per-(article, head) attention on 32 x 32 tiles, one lane per
// token in the pooling softmax, one pooling column per thread.
constexpr int kMaxT = 32;
constexpr int kMaxHeadDim = 32;
constexpr int kMaxAtt = 256;        // padded attention width
// The wide instance takes the rest of the domain: T and head width up to
// 64 (an article in at most one 64-row block), padded attention width up to
// 512 (the pooling in column chunks of kAttChunk). Its bf16 attention runs
// mma.sync fragments per (article, head, 16-row query tile) straight from
// the QKV panel (forward) or from per-pair tiles (backward); fp32 runs FMA.
constexpr int kWideMaxT = 64;
constexpr int kWideMaxHeadDim = 64;
constexpr int kWideMaxAtt = 512;
constexpr int kAttChunk = 256;      // pooling columns per chunk (one per thread)
// The fp32 QKV stage on the tensor cores (qkv_panel_tf32): chunks of 32 k
// through kStages cp.async stages, x [kRows][kTcLdx] and the weight
// [kTcKc][kTcLdw], rows 4 mod 8 and 8 mod 32 words apart (the A and B
// fragments' conflict-free strides)
constexpr int kTcKc = kChunkBytes / 4;
constexpr int kTcLdx = kTcKc + 4;
constexpr int kTcLdw = kPanel + 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use on sm_90
// bf16 attention: per warp, Q, K and V of one (article, head) zero-padded
// to 32 x 32 ([32][kTileLd] bf16); the logits, probabilities and output
// ([32][kTileLdF] fp32 / [32][kTileLd] bf16) reuse the space of Q and K
constexpr int kTileLd = 40;
constexpr int kTileLdF = 36;
constexpr int kAttWarpBytes = 3 * 32 * kTileLd * 2;
static_assert(32 * kTileLdF * 4 <= 2 * 32 * kTileLd * 2, "S and O fit over Q and K");

// the bf16 QKV stage (see the top of this file)
constexpr int kProducerThreads = 128;               // the producer warpgroup
constexpr int kQkvThreads = kThreads + kProducerThreads;
constexpr int kQkvBK = 64;                          // contraction depth of a k-tile
constexpr int kQkvBox = kRows * kQkvBK * 2;         // one [64][64] bf16 box: 8,192 B
constexpr int kQkvStage = kQkvBox * (1 + kPanel / 64);  // x box + 4 weight boxes: 40,960 B
constexpr int kQkvMaxStages = 3;
static_assert(kQkvBK * 2 == 128 && kRows == 64, "a k-tile row is one 128-byte swizzle span; "
                                                "one m64 wgmma covers the block");
static_assert(kPanel == 2 * 128, "two compute warpgroups of m64n128 cover a panel");

static_assert(kWarps == 8, "GEMM warp maps assume 8 warps");
static_assert(kChunkBytes % 32 == 0 && kPoolRows % 16 == 0 && kStages >= 2 && kPoolStages >= 2,
              "chunks hold whole wmma k-steps; pipelines are at least double-buffered");
static_assert(kRows == 2 * 32 && kPanel == 4 * 64, "QKV GEMM: 2 x 4 warps of 32 x 64");
static_assert(kAttWarpBytes % 128 == 0 && kAttWarpBytes >= 1024, "per-warp attention tiles");

// Which instance a shape takes: the narrow one wherever it fits.
__host__ __device__ constexpr bool is_wide(int t, int hd, int a_pad) {
  return t > kMaxT || hd > kMaxHeadDim || a_pad > kMaxAtt;
}

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t align1024(size_t v) { return (v + 1023) & ~size_t(1023); }
__host__ __device__ constexpr size_t smax(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory of the forward: region R (reused by phase), then o
// [kRows][ldf] fp32, then the pooling logits and weights [2][kRows] fp32,
// then (bf16) the QKV stage's full and empty mbarriers. R holds, in turn:
//   QKV:       bf16: `stages` TMA stages of kQkvStage bytes;
//              fp32: kStages stages of { x chunk [kRows][ldx], W chunk [kc][ldw] }
//   attention: Q|K|V of one head group [kRows][ldw], then per-warp tiles
//              (narrow bf16; the wide instance reads the panel itself)
//   pooling:   narrow bf16: o [kRows][ldo] + kPoolStages W_att chunks
//              [kPoolRows][lda]; wide bf16: kPoolStages stages of { W_att
//              chunk [kPoolRows][ldc] (kAttChunk columns), round(o) chunk
//              [kRows][ldoc] }; fp32: one W_att chunk, FMA
//   logits:    z = o W [kRows][ldz] fp32 (wide: one column chunk)
// bf16 offsets are from the dynamic shared memory's start rounded up to
// 1,024 bytes (the swizzled TMA boxes' alignment); `total` includes that
// slack. o's rows are ldf = d | 1 floats apart: odd, so column writes do
// not collide in a bank. The fp32 stages on the tensor cores (`tc`, see
// "3xTF32" below) read mma.sync fragments instead: a fragment's 8 rows x 4
// columns fall in 32 distinct banks where a row stride is 4 mod 8 words (o:
// ldf = D rounded up to 8, + 4; the panel's 260), and its QKV stage's
// weight chunk [32][kTcLdw] 8 mod 32 (kTcLdw above).
struct Layout {
  int ldx, ldw, ldo, lda, ldz, ldf, kc, d_pad, ldc, ldoc;
  size_t stage, xs_bytes, panel, pool_w, pool_wc, pool_stage, r, o, small, bars, total;
};

__host__ __device__ inline Layout make_layout(int d, int a_pad, int elem, int stages,
                                              bool wide, bool tc = false) {
  const bool bf = elem == 2;
  const int ve = 16 / elem;
  const int ac = a_pad < kAttChunk ? a_pad : kAttChunk;  // wide: a column chunk's width
  Layout L;
  L.kc = kChunkBytes / elem;
  L.ldx = L.kc + ve;
  L.ldw = kPanel + ve;
  L.d_pad = (d + 15) / 16 * 16;
  L.ldo = L.d_pad + ve;
  L.lda = a_pad + ve;
  L.ldz = (wide ? ac : a_pad) + 4;
  L.ldf = tc ? (d + 7) / 8 * 8 + 4 : d | 1;
  L.ldc = ac + ve;
  L.ldoc = kPoolRows + ve;
  L.xs_bytes = align128(size_t(kRows) * L.ldx * elem);
  L.stage = L.xs_bytes + align128(size_t(L.kc) * (tc ? kTcLdw : L.ldw) * elem);
  L.panel = align128(size_t(kRows) * L.ldw * elem);
  L.pool_w = align128(size_t(kPoolRows) * (wide ? ac : L.lda) * elem);
  L.pool_wc = align128(size_t(kPoolRows) * L.ldc * elem);
  L.pool_stage = L.pool_wc + align128(size_t(kRows) * L.ldoc * elem);
  const size_t gemm = bf ? size_t(stages) * kQkvStage : kStages * L.stage;
  const size_t att = L.panel + (bf && !wide ? size_t(kWarps) * kAttWarpBytes : 0);
  const size_t pool = !bf  ? L.pool_w
                      : wide ? kPoolStages * L.pool_stage
                             : align128(size_t(kRows) * L.ldo * elem) + kPoolStages * L.pool_w;
  const size_t z = size_t(kRows) * L.ldz * 4;
  const size_t r = smax(smax(gemm, att), smax(pool, z));
  L.r = bf ? align1024(r) : align128(r);
  L.o = L.r;
  L.small = L.o + align128(size_t(kRows) * L.ldf * 4);
  L.bars = L.small + align128(size_t(2) * kRows * 4);
  L.total = bf ? L.bars + align128(2 * kQkvMaxStages * 8) + 1024 : L.bars;
  return L;
}

// Each slot of the forward's layout against the widest tensor the kernels
// write into it (C2 was a slot sized for one tensor and overwritten by a
// wider one): the launchers refuse a layout that fails this. Region R
// holds, in turn, the QKV stage, the panel (and the narrow bf16 attention
// tiles), the pooling product's staging and z; o's slot the fp32 o; the
// small arrays att and wts.
__host__ inline bool layout_fits(const Layout& L, int d, int a_pad, int elem, int stages,
                                 bool wide, bool tc = false) {
  const bool bf = elem == 2;
  const int zc = wide ? (a_pad < kAttChunk ? a_pad : kAttChunk) : a_pad;  // z's columns
  const size_t qkv = bf ? size_t(stages) * kQkvStage
                     : kStages * (size_t(kRows) * L.ldx * elem +
                                  size_t(L.kc) * (tc ? kTcLdw : L.ldw) * elem);
  const size_t att = size_t(kRows) * L.ldw * elem + (bf && !wide ? kWarps * kAttWarpBytes : 0);
  size_t pool = size_t(kPoolRows) * zc * elem;  // fp32: the W_att chunk
  if (bf && wide)
    pool = kPoolStages * (align128(size_t(kPoolRows) * L.ldc * elem) +
                          size_t(kRows) * L.ldoc * elem);
  else if (bf)
    pool = size_t(kRows) * L.ldo * elem + kPoolStages * size_t(kPoolRows) * L.lda * elem;
  return L.ldx >= L.kc && L.ldw >= kPanel && L.ldo >= d && L.lda >= a_pad && L.ldz >= zc &&
         L.ldf >= d && L.ldc >= zc && L.ldoc >= kPoolRows && L.r >= qkv && L.r >= att &&
         L.r >= pool && L.r >= size_t(kRows) * L.ldz * 4 && L.small - L.o >= size_t(kRows) * L.ldf * 4 &&
         L.bars - L.small >= size_t(2) * kRows * 4;
}

// The bf16 kernels' shared-memory base: the dynamic shared memory's start
// rounded up to 1,024 bytes (the same offset in every CTA of a cluster).
// An offset added to the shared array, not a rounded integer cast back to
// a pointer: the compiler then still knows the pointer is shared and
// accesses it with shared-memory instructions, not generic ones (which
// made the phases after the QKV stage up to 35% slower on an H100).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((1024u - (hop::smem_u32(raw) & 1023u)) & 1023u);
}

// Barrier among the 8 compute warps (threads [0, kThreads)): the bf16
// kernels' producer warpgroup does not take part. The same as
// __syncthreads in a CTA of kThreads threads.
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
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
// 4-byte asynchronous copy global -> shared (both 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A multi-stage cp.async pipeline over nk chunks, run by kThreads threads:
// issue(k, stage) starts the copies of chunk k, compute(k, stage) consumes
// a landed chunk. One csync per chunk; the staging space is free again
// when it returns.
template <int S, typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int nk, Issue issue, Compute compute) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<S - 2>();
    csync();  // chunk k has landed for all; chunk k-1's stage is consumed
    if (k + S - 1 < nk) issue(k + S - 1, (k + S - 1) % S);
    cp_async_commit();
    compute(k, k % S);
  }
  cp_async_wait<0>();
  csync();
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
  for (int i = threadIdx.x; i < nrow_tile * g4; i += kThreads) {
    const int r = i / g4, c = (i % g4) * 4;
    if (r >= rows || k0 + c >= din) continue;
    const float4 m = philox::mask4(ed.key, uint32_t(ed.row0 + r), uint32_t((k0 + c) >> 2), 0u,
                                   ed.thr, ed.inv);
    T* e = xs + r * ld + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = from_f<T>(to_f<T>(e[j]) * philox::pick(m, j));
  }
}

// fp32: one head group's Q|K|V = x_block * emb mask @ wqkv[:, panel],
// written to the start of R ([kRows][ldw]). x rows [0, rows) and
// contraction [0, din) are real, the rest zero-filled. The wrapper
// guarantees din % 4 == 0 and 16-byte aligned x and wqkv. Thread (ty, tx)
// owns rows ty*8 + [0,8) and columns tx + 32*[0,8), FMA over a cp.async
// pipeline.
__device__ void qkv_panel_fp32(const float* __restrict__ xb, int rows, int din,
                               const float* __restrict__ wp, int np_cols, const Layout& L,
                               unsigned char* R, const EmbDrop& ed) {
  using T = float;
  constexpr int VE = 4;
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
  T* qkv = reinterpret_cast<T*>(R);
  const int tx = lane, ty = warp;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  pipeline<kStages>(nk, issue, [&](int kc, int s) {
    if (ed.thr) {
      mask_x_tile<T>(xs(s), L.ldx, rows, kRows, kc * L.kc, L.kc, din, ed);
      csync();
    }
    const T* x_s = xs(s);
    const T* w_s = ws(s);
    for (int k = 0; k < L.kc; ++k) {
      float wv[8], xv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = w_s[k * L.ldw + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = x_s[(ty * 8 + i) * L.ldx + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * wv[j];
    }
  });
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) qkv[(ty * 8 + i) * L.ldw + tx + 32 * j] = acc[i][j];
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 QKV stage's ring (see the top of this file): `stages` stages of
// kQkvStage bytes at `ring` (1,024-byte aligned), their full and empty
// mbarriers, and the cluster size.
struct QkvRing {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, cluster;
};

// One thread, before the cluster's first cluster_sync: a full barrier
// takes its producer's arrival and the stage's bytes, an empty barrier one
// arrival from each compute warp of each CTA of the cluster.
__device__ __forceinline__ void qkv_ring_init(const QkvRing& q) {
  for (int s = 0; s < q.stages; ++s) {
    hop::mbar_init(&q.full[s], 1);
    hop::mbar_init(&q.empty[s], kWarps * q.cluster);
  }
  hop::fence_barrier_init();
}

// The producer (one thread): the k-tiles of panels [0, n_groups) in
// order, the x box of rows [row0, row0 + 64) and this CTA's share of the
// weight boxes (multicast to the cluster); then it waits until every
// stage is released by every consumer warp of the cluster, so that no
// CTA exits while another may still arrive on its barriers.
__device__ void qkv_produce(const QkvRing& q, const CUtensorMap* xmap, const CUtensorMap* wmap,
                            int row0, int n_groups, int nk) {
  const int rank = q.cluster > 1 ? int(hop::cluster_ctarank()) : 0;
  const uint16_t all = uint16_t((1u << q.cluster) - 1);
  hop::tma_prefetch_map(xmap);
  hop::tma_prefetch_map(wmap);
  int it = 0;
  for (int g = 0; g < n_groups; ++g)
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % q.stages;
      hop::mbar_wait(&q.empty[s], ((it / q.stages) & 1) ^ 1);
      hop::mbar_expect_tx(&q.full[s], kQkvStage);
      unsigned char* st = q.ring + size_t(s) * kQkvStage;
      hop::tma_load_2d(st, xmap, &q.full[s], kt * kQkvBK, row0);
      for (int j = rank; j < kPanel / 64; j += q.cluster) {
        unsigned char* dst = st + kQkvBox * (1 + j);
        if (q.cluster > 1)
          hop::tma_load_2d_multicast(dst, wmap, &q.full[s], g * kPanel + 64 * j, kt * kQkvBK, all);
        else
          hop::tma_load_2d(dst, wmap, &q.full[s], g * kPanel + 64 * j, kt * kQkvBK);
      }
    }
  for (int i = 0; i < q.stages; ++i, ++it)
    hop::mbar_wait(&q.empty[it % q.stages], ((it / q.stages) & 1) ^ 1);
}

// One compute warp hands stage s back to the producers of its cluster.
__device__ __forceinline__ void qkv_release(const QkvRing& q, int s) {
  if (threadIdx.x % 32 != 0) return;
  if (q.cluster == 1) {
    hop::mbar_arrive(&q.empty[s]);
    return;
  }
  for (int c = 0; c < q.cluster; ++c) hop::mbar_arrive_cluster(&q.empty[s], uint32_t(c));
}

// The compute warps: k-tiles it .. it + nk - 1 (one panel) on wgmma, each
// warpgroup cw the columns [128 cw, 128 cw + 128); the stages are handed
// back as they are consumed, but for the panel's last `stages` k-tiles
// (qkv_panel_done). Then Q|K|V in bf16 from the accumulators to
// panel [kRows][ldw] (over the ring). Requires 2 <= stages <= nk, or
// stages = nk = 1: a k-tile's stage is handed back only after the next
// k-tile's products are issued.
__device__ void qkv_panel_wgmma(const QkvRing& q, int& it, int nk, bf16* panel, int ldw) {
  const int tid = threadIdx.x, cw = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % q.stages;
    hop::mbar_wait(&q.full[s], (it / q.stages) & 1);
    const unsigned char* st = q.ring + size_t(s) * kQkvStage;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQkvBK / 16; ++kk)
      hop::wgmma_m64n128k16<0, 1>(acc, hop::smem_desc(st + kk * 32, 16, 1024),
                                  hop::smem_desc(st + kQkvBox * (1 + 2 * cw) + kk * 2048, kQkvBox,
                                                 1024));
    hop::wgmma_commit();
    hop::wgmma_wait<1>();  // k-tile it - 1 is consumed
    if (kt > 0 && kt - 1 < nk - q.stages) qkv_release(q, (it - 1) % q.stages);
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  csync();  // both warpgroups are done with the ring before the panel overwrites it
  // thread (warp, lane) holds rows r and r + 8, columns 8 j + 2 (lane % 4) + {0, 1}
  const int r = warp * 16 + lane / 4, c = 128 * cw + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(panel + r * ldw + c + 8 * j) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(panel + (r + 8) * ldw + c + 8 * j) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The compute warps, once done with the panel and everything else they
// wrote over the ring: hand back the panel's last `stages` k-tiles (it is
// one past the panel's last).
__device__ __forceinline__ void qkv_panel_done(const QkvRing& q, int it) {
  hop::fence_proxy_async();  // this thread's writes over the ring come before TMA's
  csync();
  for (int i = it - q.stages; i < it; ++i) qkv_release(q, i % q.stages);
}

// One lane's row of a 32 x 32 attention tile, 16 bytes at a time, so that
// each quarter of a warp reaches 8 rows in distinct banks (lane by lane,
// column by column, 4 lanes shared each bank): 32 fp32 values from a
// [32][kTileLdF] tile, or 32 values rounded to bf16 into a [32][kTileLd]
// tile.
__device__ __forceinline__ void load_row32(float (&v)[32], const float* row) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 f = reinterpret_cast<const float4*>(row)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}
__device__ __forceinline__ void store_row32(bf16* row, const float (&v)[32]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    reinterpret_cast<uint4*>(row)[q] =
        make_uint4(pack_bf16(v[8 * q], v[8 * q + 1]), pack_bf16(v[8 * q + 2], v[8 * q + 3]),
                   pack_bf16(v[8 * q + 4], v[8 * q + 5]), pack_bf16(v[8 * q + 6], v[8 * q + 7]));
}
static_assert(kTileLdF % 4 == 0 && kTileLd % 8 == 0, "tile rows hold whole 16-byte pieces");

// bf16 softmaxes take exp(x) as exp2(x log2 e) (the hardware's ex2, within
// a few fp32 ulp of expf, far under the bf16 rounding of the
// probabilities) and divide by the row sum through its reciprocal: expf
// and 32 divisions a row weighed more in the attention backward's time on
// an H100 than its products.
constexpr float kLog2e = 1.4426950408889634f;

// One warp copies rows [0, t) and columns [0, hd) of N bf16 matrices
// (src[m] with row stride lds[m] elements) into zero-padded 32 x 32 tiles
// dst[m] ([32][kTileLd]). With hd % 4 == 0 (then every source row is
// 8-byte aligned in the panel layout) 8 bytes a lane, all loads issued
// before any store so that they are in flight together; else element by
// element.
template <int N>
__device__ __forceinline__ void warp_tiles(bf16* const (&dst)[N], const bf16* const (&src)[N],
                                           const int (&lds)[N], int t, int hd) {
  const int lane = threadIdx.x % 32;
  if (hd % 4 == 0) {
    uint2 v[N][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = lane + 32 * j, r = i / 8, c = (i % 8) * 4;
      const bool ok = r < t && c < hd;
#pragma unroll
      for (int m = 0; m < N; ++m)
        v[m][j] = ok ? *reinterpret_cast<const uint2*>(src[m] + size_t(r) * lds[m] + c)
                     : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = lane + 32 * j, r = i / 8, c = (i % 8) * 4;
#pragma unroll
      for (int m = 0; m < N; ++m) *reinterpret_cast<uint2*>(dst[m] + r * kTileLd + c) = v[m][j];
    }
    return;
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = lane; i < 32 * 32; i += 32) {
    const int r = i / 32, c = i % 32;
    const bool ok = r < t && c < hd;
#pragma unroll
    for (int m = 0; m < N; ++m) dst[m][r * kTileLd + c] = ok ? src[m][size_t(r) * lds[m] + c] : zero;
  }
}

// ---- the wide instance's attention: mma.sync m16n8k16 (bf16 in, fp32
// accumulators) on fragments gathered element by element, zero outside
// the matrix, so that no tile needs padding and any head width and T take
// the same code. Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane
// = 4 g + c; A (16 x 16, row-major) regs {(g, 2c..2c+1), (g+8, 2c..),
// (g, 2c+8..), (g+8, 2c+8..)}; B (16 x 8) regs {(2c..2c+1, g), (2c+8..
// 2c+9, g)}; C (16 x 8) {(g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)}. A C
// fragment pair of columns 16 k + [0, 16) is the A fragment of k-step k.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A bf16 matrix of rows x cols at p (row stride ld), read as its logical
// (i, j) = stored (i, j), or stored (j, i) when tr; zero outside it.
struct Mat {
  const bf16* p;
  int ld, rows, cols;
  bool tr;
  __device__ __forceinline__ uint32_t at(int i, int j) const {
    const int r = tr ? j : i, c = tr ? i : j;
    return r < rows && c < cols ? uint32_t(__bfloat16_as_ushort(p[r * ld + c])) : 0u;
  }
  __device__ __forceinline__ uint32_t two(int i, int j, int di, int dj) const {
    return at(i, j) | at(i + di, j + dj) << 16;
  }
};

// The A fragment of logical rows [m0, m0 + 16) and columns [k0, k0 + 16),
// the B fragment of logical rows [k0, k0 + 16) and columns [n0, n0 + 8).
__device__ __forceinline__ void frag_a(const Mat& m, int m0, int k0, uint32_t (&a)[4]) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  a[0] = m.two(m0 + g, k0 + 2 * c, 0, 1);
  a[1] = m.two(m0 + g + 8, k0 + 2 * c, 0, 1);
  a[2] = m.two(m0 + g, k0 + 2 * c + 8, 0, 1);
  a[3] = m.two(m0 + g + 8, k0 + 2 * c + 8, 0, 1);
}
__device__ __forceinline__ void frag_b(const Mat& m, int k0, int n0, uint32_t (&b)[2]) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  b[0] = m.two(k0 + 2 * c, n0 + g, 1, 0);
  b[1] = m.two(k0 + 2 * c + 8, n0 + g, 1, 0);
}

// The A fragment of k-step kk from C fragments (N column tiles of 8),
// rounded to bf16.
template <int N>
__device__ __forceinline__ void c_to_a(const float (&f)[N][4], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(f[2 * kk][0], f[2 * kk][1]);
  a[1] = pack_bf16(f[2 * kk][2], f[2 * kk][3]);
  a[2] = pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]);
  a[3] = pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3]);
}

// ---- m16n8k16 fragments from bf16 tiles in shared memory by ldmatrix
// (the tiled route's staged T2 and T4). A tile's rows start 16-byte
// aligned; with a row stride of an odd number of 16-byte pieces the 8 rows
// of each 8 x 8 matrix fall in 8 distinct bank groups (no conflicts). Lane
// l gives the address of row l % 8 of matrix l / 8; plain ldmatrix hands
// lane 4 g + c the stored (g, 2c..2c+1), .trans the stored (2c..2c+1, g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hop::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hop::smem_u32(p)));
}
// The A fragment of rows [m0, m0 + 16) and columns [k0, k0 + 16) of A
// stored row-major (s[m][k]: lda_rm) or transposed (s[k][m]: lda_tr).
__device__ __forceinline__ void lda_rm(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, s + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}
__device__ __forceinline__ void lda_tr(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x % 32, mi = l >> 3;
  ldsm_x4_t(a, s + (k0 + (l & 7) + (mi >> 1) * 8) * ld + m0 + (mi & 1) * 8);
}
// The B fragments of rows [k0, k0 + 16) and the two column tiles at n0 and
// n0 + 8 ({b[0], b[1]} and {b[2], b[3]}) of B stored by columns (s[n][k]:
// ldb_nk, as K for Q K^T) or row-major (s[k][n]: ldb_kn, as V for P V).
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0) {
  const int l = threadIdx.x % 32, mi = l >> 3;
  ldsm_x4(b, s + (n0 + (l & 7) + (mi >> 1) * 8) * ld + k0 + (mi & 1) * 8);
}
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0) {
  const int l = threadIdx.x % 32, mi = l >> 3;
  ldsm_x4_t(b, s + (k0 + (l & 7) + (mi & 1) * 8) * ld + n0 + (mi >> 1) * 8);
}

// acc [16 x 64] (8 column tiles) = A [16 x K] B [K x 64] over nk k-steps
// of 16 and the column tiles below nn; A's rows from a, B from b.
__device__ __forceinline__ void warp_mma_rows(float (&acc)[8][4], const Mat& a, int m0,
                                              const Mat& b, int nk, int nn) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= nk) break;
    uint32_t fa[4];
    frag_a(a, m0, 16 * kk, fa);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nn) {
        uint32_t fb[2];
        frag_b(b, 16 * kk, 8 * j, fb);
        mma_16816(acc[j], fa, fb);
      }
    }
  }
}

// The softmax over keys [0, t) of the 16 query rows a warp holds as C
// fragments s (raw Q K^T over N key tiles), in place: p = exp(s scale -
// max) / sum in fp32, 0 past t and on rows at or past row_lim (rows g and
// g + 8 of the tile are live when below it). As the narrow bf16 softmax:
// exp2 and a reciprocal (see kLog2e).
template <int N>
__device__ __forceinline__ void softmax_rows(float (&s)[N][4], int t, float scale, bool live0,
                                             bool live1) {
  const int c = threadIdx.x % 4;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = 8 * j + 2 * c + e < t;
      s[j][e] = in ? s[j][e] * scale * kLog2e : -INFINITY;
      s[j][2 + e] = in ? s[j][2 + e] * scale * kLog2e : -INFINITY;
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = exp2f(s[j][e] - m0);
      s[j][2 + e] = exp2f(s[j][2 + e] - m1);
      s0 += s[j][e];
      s1 += s[j][2 + e];
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  const float i0 = live0 ? 1.f / s0 : 0.f, i1 = live1 ? 1.f / s1 : 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j][0] *= i0;
    s[j][1] *= i0;
    s[j][2] *= i1;
    s[j][3] *= i1;
  }
}

// C fragments f (16 x 8 N: rows r0 + g, r0 + g + 8; N column tiles) to
// fp32 or bf16 storage (row stride ld), rows below rlim, columns below clim.
template <typename S, int N>
__device__ __forceinline__ void store_rows(const float (&f)[N][4], S* dst, int ld, int r0,
                                           int rlim, int clim) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * c + e;
      if (col >= clim) continue;
      if (r0 + g < rlim) dst[size_t(r0 + g) * ld + col] = from_f<S>(f[j][e]);
      if (r0 + g + 8 < rlim) dst[size_t(r0 + g + 8) * ld + col] = from_f<S>(f[j][2 + e]);
    }
}

// The wide instance's bf16 attention of one head group: one warp per
// (article, head, 16-row query tile); S = Q K^T over up to 64 keys, the
// softmax and O = round(P) V in registers, Q, K and V read from the panel.
__device__ void attention_group_wide(const bf16* qkv, int ldp, float* o, int ldf, int na, int t,
                                     int hd, int gh, int h0, int nh, float scale) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  const int nq = (t + 15) / 16, nkh = (hd + 15) / 16, nnh = (hd + 7) / 8, nnt = (t + 7) / 8;
  for (int it = warp; it < na * nh * nq; it += kWarps) {
    const int qt = it % nq, hl = it / nq % nh, an = it / (nq * nh);
    const bf16* base = qkv + size_t(an) * t * ldp;
    const Mat q{base + hl * hd, ldp, t, hd, false};
    const Mat kt{base + (gh + hl) * hd, ldp, t, hd, true};  // K^T: (e, key)
    const Mat v{base + (2 * gh + hl) * hd, ldp, t, hd, false};
    float s[8][4];
    warp_mma_rows(s, q, 16 * qt, kt, nkh, nnt);
    softmax_rows(s, t, scale, 16 * qt + g < t, 16 * qt + g + 8 < t);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= nq) break;
      uint32_t fa[4];
      c_to_a(s, kk, fa);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nnh) {
          uint32_t fb[2];
          frag_b(v, 16 * kk, 8 * j, fb);
          mma_16816(acc[j], fa, fb);
        }
      }
    }
    store_rows(acc, o + size_t(an) * t * ldf + (h0 + hl) * hd, ldf, 16 * qt, t, hd);
  }
}

// Attention of one head group: heads [h0, h0 + nh) of the block's na
// articles; in the panel, Q of local head hl sits at column hl*hd, K at
// gh*hd + hl*hd, V at 2*gh*hd + hl*hd. o gets each head's slice in fp32.
//
// Narrow bf16: one warp per (article, head). Q, K and V are copied into 32 x 32
// tiles, zero past t rows and hd columns, so padded keys add nothing to
// the logits and get probability 0; S = Q K^T and O = P V run on wmma with
// fp32 accumulation, the softmax in fp32 with one lane per query row. Wide
// bf16: attention_group_wide. fp32: FMA, one thread per query row (the
// wide instance's keys in a loop, each logit computed once per pass: its
// max, its sum, then the product with V, so that no row of 64 keys is
// unrolled into registers).
template <typename T, bool kWide>
__device__ void attention_group(const T* qkv, int ldp, float* o, int ldf, int na, int t, int hd,
                                int gh, int h0, int nh, float scale, unsigned char* tiles) {
  const int tid = threadIdx.x;
  constexpr int kT = kMaxT, kH = kWide ? kWideMaxHeadDim : kMaxHeadDim;
  if constexpr (std::is_same<T, bf16>::value && kWide) {
    attention_group_wide(qkv, ldp, o, ldf, na, t, hd, gh, h0, nh, scale);
  } else if constexpr (kWide) {
    for (int it = tid; it < na * nh * t; it += kThreads) {
      const int qi = it % t, hl = (it / t) % nh, an = it / (t * nh);
      const int r = an * t + qi;
      const T* qrow = qkv + r * ldp + hl * hd;
      const T* kbase = qkv + an * t * ldp + gh * hd + hl * hd;
      const T* vbase = kbase + gh * hd;
      float qv[kH];
#pragma unroll
      for (int e = 0; e < kH; ++e) qv[e] = e < hd ? to_f<T>(qrow[e]) : 0.f;
      auto logit = [&](int kj) {
        const T* kr = kbase + kj * ldp;
        float l = 0.f;
#pragma unroll
        for (int e = 0; e < kH; ++e)
          if (e < hd) l += qv[e] * to_f<T>(kr[e]);
        return l * scale;
      };
      float m = -INFINITY, s = 0.f;
      for (int kj = 0; kj < t; ++kj) m = fmaxf(m, logit(kj));
      for (int kj = 0; kj < t; ++kj) s += expf(logit(kj) - m);
      float acc[kH];
#pragma unroll
      for (int e = 0; e < kH; ++e) acc[e] = 0.f;
      for (int kj = 0; kj < t; ++kj) {
        const float pk = rnd<T>(expf(logit(kj) - m) / s);
        const T* vr = vbase + kj * ldp;
#pragma unroll
        for (int e = 0; e < kH; ++e)
          if (e < hd) acc[e] += pk * to_f<T>(vr[e]);
      }
      float* orow = o + r * ldf + (h0 + hl) * hd;
#pragma unroll
      for (int e = 0; e < kH; ++e)
        if (e < hd) orow[e] = acc[e];
    }
  } else if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = tid / 32, lane = tid % 32;
    bf16* Qs = reinterpret_cast<bf16*>(tiles + size_t(warp) * kAttWarpBytes);
    bf16* Ks = Qs + 32 * kTileLd;
    bf16* Vs = Ks + 32 * kTileLd;
    float* Ss = reinterpret_cast<float*>(Qs);  // S, later O, over the spent Q and K
    bf16* Ps = Qs;                             // P over S, from rows held in registers
    for (int pair = warp; pair < na * nh; pair += kWarps) {
      const int an = pair / nh, hl = pair % nh;
      const bf16* src = qkv + an * t * ldp + hl * hd;
      bf16* const dst[3] = {Qs, Ks, Vs};
      const bf16* const srcs[3] = {src, src + gh * hd, src + 2 * gh * hd};
      const int lds[3] = {ldp, ldp, ldp};
      warp_tiles<3>(dst, srcs, lds, t, hd);
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
        load_row32(sr, Ss + lane * kTileLdF);
#pragma unroll
        for (int c = 0; c < 32; ++c) sr[c] *= scale * kLog2e;
        __syncwarp();  // every row is in registers before P overwrites S
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < 32; ++c)
          if (c < t) m = fmaxf(m, sr[c]);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          sr[c] = c < t ? exp2f(sr[c] - m) : 0.f;
          sum += sr[c];
        }
        const float inv = 1.f / sum;
#pragma unroll
        for (int c = 0; c < 32; ++c) sr[c] = c < t ? sr[c] * inv : 0.f;
        store_row32(Ps + lane * kTileLd, sr);
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
      float qv[kH];
#pragma unroll
      for (int e = 0; e < kH; ++e) qv[e] = e < hd ? to_f<T>(qrow[e]) : 0.f;
      float p[kT];
      float m = -INFINITY;
#pragma unroll
      for (int kj = 0; kj < kT; ++kj) {
        p[kj] = -INFINITY;
        if (kj < t) {
          const T* kr = kbase + kj * ldp;
          float l = 0.f;
#pragma unroll
          for (int e = 0; e < kH; ++e)
            if (e < hd) l += qv[e] * to_f<T>(kr[e]);
          p[kj] = l * scale;
          m = fmaxf(m, p[kj]);
        }
      }
      float s = 0.f;
#pragma unroll
      for (int kj = 0; kj < kT; ++kj) {
        p[kj] = kj < t ? expf(p[kj] - m) : 0.f;
        s += p[kj];
      }
      float acc[kH];
#pragma unroll
      for (int e = 0; e < kH; ++e) acc[e] = 0.f;
#pragma unroll
      for (int kj = 0; kj < kT; ++kj) {
        if (kj < t) {
          const float pk = rnd<T>(p[kj] / s);
          const T* vr = vbase + kj * ldp;
#pragma unroll
          for (int e = 0; e < kH; ++e)
            if (e < hd) acc[e] += pk * to_f<T>(vr[e]);
        }
      }
      float* orow = o + r * ldf + (h0 + hl) * hd;
#pragma unroll
      for (int e = 0; e < kH; ++e)
        if (e < hd) orow[e] = acc[e];
    }
  }
}

// ---- fp32 on the tensor cores: 3xTF32 ----
// The fp32 instance's products run on mma.sync m16n8k8 with TF32 operands
// and fp32 accumulators. One TF32 product keeps 10 mantissa bits of each
// operand (about 5e-4 relative), so each fp32 operand v is split into a
// TF32 high part hi = rna(v) and a TF32 remainder lo = rna(v - hi)
// (round to nearest, ties away from zero: tf32_rna), and a product
// sums lo*hi + hi*lo + hi*hi into the accumulator (lo*lo, under 2^-22 of the
// product, is dropped): close to an fp32 product at a third of the TF32
// rate (495 / 3 = 165 TFLOP/s on an H100 SXM against 67 by FMA). The plain
// version is ops/news_encoder.py's tf32_matmul. Fragment layouts (PTX ISA,
// mma.m16n8k8 with .tf32): lane = 4 g + c; A (16 x 8) {(g, c), (g + 8, c),
// (g, c + 4), (g + 8, c + 4)}, B (8 x 8) {(c, g), (c + 4, g)}, C (16 x 8)
// {(g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1)}. The order of the 8
// k-indices of a k-step is free as long as A and B agree: "paired" k-steps
// give slots c and c + 4 the indices 2c and 2c + 1, so that a C fragment's
// 8 columns are an A fragment as they lie (P V, dS K: no shuffle), and a
// fragment read down a matrix's rows (P^T dO) takes 2c * ld + g, no bank
// conflict where the row stride is 4 mod 16 words.

// rna(v) as cvt.rna.tf32.f32 rounds every finite v: half a TF32 unit added
// to the magnitude bits, the 13 low bits cleared (ops/news_encoder.py's
// tf32_round). sm_90a expands cvt.rna.tf32.f32 with a test for infinities
// and NaN around the same two operations: the kernels were 8-10% slower
// with it on an H100, to the same bits (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// An A (16 x 8) or B (8 x 8) fragment of N values split into hi and lo.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

template <int N>
__device__ __forceinline__ void split_tf32(const float (&v)[N], Frag<N>& f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.hi[i] = tf32_rna(v[i]);
    f.lo[i] = tf32_rna(v[i] - __uint_as_float(f.hi[i]));
  }
}

__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const FragB& b) {
  mma_1688(d, a.lo, b.hi);
  mma_1688(d, a.hi, b.lo);
  mma_1688(d, a.hi, b.hi);
}

// An fp32 matrix of rows x cols at p (row stride ld, shared or device
// memory), read as its logical (i, j) = stored (i, j), or stored (j, i) when
// tr; zero outside it.
struct FMat {
  const float* p;
  int ld, rows, cols;
  bool tr;
  __device__ __forceinline__ float at(int i, int j) const {
    const int r = tr ? j : i, c = tr ? i : j;
    return r < rows && c < cols ? p[r * ld + c] : 0.f;
  }
};

// The k-indices of this lane's two slots of the k-step at k0 (see above).
template <bool kPaired>
__device__ __forceinline__ int2 k_slots(int k0) {
  const int c = threadIdx.x % 4;
  return kPaired ? make_int2(k0 + 2 * c, k0 + 2 * c + 1) : make_int2(k0 + c, k0 + c + 4);
}

// The A fragment of logical rows [m0, m0 + 16) at the k-step k0, and the B
// fragment of the k-step k0 and columns [n0, n0 + 8), split.
template <bool kPaired>
__device__ __forceinline__ void load_a(const FMat& m, int m0, int k0, FragA& f) {
  const int g = threadIdx.x % 32 / 4;
  const int2 k = k_slots<kPaired>(k0);
  const float v[4] = {m.at(m0 + g, k.x), m.at(m0 + g + 8, k.x), m.at(m0 + g, k.y),
                      m.at(m0 + g + 8, k.y)};
  split_tf32(v, f);
}
template <bool kPaired>
__device__ __forceinline__ void load_b(const FMat& m, int k0, int n0, FragB& f) {
  const int g = threadIdx.x % 32 / 4;
  const int2 k = k_slots<kPaired>(k0);
  const float v[2] = {m.at(k.x, n0 + g), m.at(k.y, n0 + g)};
  split_tf32(v, f);
}

// acc [16 x 8 N] (N column tiles of 8) = A [16 x K] B [K x 8 N] over nk
// k-steps of 8 and the column tiles below nn; A's rows from a at m0. N is
// the instance's most tiles (4 at T and head widths up to 32, else 8).
template <bool kPaired, int N>
__device__ __forceinline__ void warp_mma_tf32(float (&acc)[N][4], const FMat& a, int m0,
                                              const FMat& b, int nk, int nn) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < nk; ++kk) {
    FragA fa;
    load_a<kPaired>(a, m0, 8 * kk, fa);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < nn) {
        FragB fb;
        load_b<kPaired>(b, 8 * kk, 8 * j, fb);
        mma_3xtf32(acc[j], fa, fb);
      }
    }
  }
}

// Two products of one shape in one loop, for twice the independent work a
// warp has in flight: acc0 = A0 B0 and acc1 = A1 B1 (as warp_mma_tf32).
template <bool kPaired, int N>
__device__ __forceinline__ void warp_mma2_tf32(float (&acc0)[N][4], const FMat& a0,
                                               const FMat& b0, float (&acc1)[N][4],
                                               const FMat& a1, const FMat& b1, int m0, int nk,
                                               int nn) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[j][e] = acc1[j][e] = 0.f;
  for (int kk = 0; kk < nk; ++kk) {
    FragA fa0, fa1;
    load_a<kPaired>(a0, m0, 8 * kk, fa0);
    load_a<kPaired>(a1, m0, 8 * kk, fa1);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < nn) {
        FragB fb0, fb1;
        load_b<kPaired>(b0, 8 * kk, 8 * j, fb0);
        load_b<kPaired>(b1, 8 * kk, 8 * j, fb1);
        mma_3xtf32(acc0[j], fa0, fb0);
        mma_3xtf32(acc1[j], fa1, fb1);
      }
    }
  }
}

// acc [16 x 8 N] = S [16 x K] B [K x 8 N], S given as the C fragments s of
// its N column tiles (probabilities or dS: A operands as they lie, by
// paired k-steps), over nk k-steps and the column tiles below nn.
template <int N>
__device__ __forceinline__ void warp_mma_tf32_c(float (&acc)[N][4], const float (&s)[N][4],
                                                const FMat& b, int nk, int nn) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    if (kk >= nk) break;
    const float v[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
    FragA fa;
    split_tf32(v, fa);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < nn) {
        FragB fb;
        load_b<true>(b, 8 * kk, 8 * j, fb);
        mma_3xtf32(acc[j], fa, fb);
      }
    }
  }
}

// fp32 QKV stage on the tensor cores: one head group's Q|K|V = x_block *
// emb mask @ wqkv[:, panel], written to the start of R ([kRows][ldw]), as
// qkv_panel_fp32 stages it (cp.async, 32-deep chunks, the x mask on each
// staged x chunk); warp (wm, wn) = (warp / 4, warp % 4) takes rows
// 32 wm + [0, 32) and columns 64 wn + [0, 64): 2 x 8 tiles of 16 x 8,
// both operands split in registers. On an H100 this beat, in turns, 3-
// and 4-stage rings of 24- and 16-deep chunks (within 2-9%) and the
// weight split once on the host and staged as (hi, lo) pairs K-major
// (16-byte B fragments, no B split, but twice the weight's bytes: 11-23%
// slower); warp pairs taking alternate k-steps of 64 x 64 tiles gained
// 1-3% and were not kept (PERF.md).
__device__ void qkv_panel_tf32(const float* __restrict__ xb, int rows, int din,
                               const float* __restrict__ wp, int np_cols, const Layout& L,
                               unsigned char* R, const EmbDrop& ed) {
  using T = float;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int nk = (din + kTcKc - 1) / kTcKc;
  auto xs = [&](int s) { return reinterpret_cast<T*>(R + s * L.stage); };
  auto ws = [&](int s) { return reinterpret_cast<T*>(R + s * L.stage + L.xs_bytes); };
  auto issue = [&](int kc, int s) {
    const int k0 = kc * kTcKc;
    T* x_s = xs(s);
    T* w_s = ws(s);
    for (int i = tid; i < kRows * (kTcKc / 4); i += kThreads) {
      const int r = i / (kTcKc / 4), cc = i % (kTcKc / 4) * 4, k = k0 + cc;
      const bool ok = r < rows && k < din;
      cp_async16(x_s + r * kTcLdx + cc, ok ? xb + size_t(r) * din + k : xb, ok);
    }
    for (int i = tid; i < kTcKc * (kPanel / 4); i += kThreads) {
      const int kr = i / (kPanel / 4), cc = i % (kPanel / 4) * 4, k = k0 + kr;
      const bool ok = k < din;
      cp_async16(w_s + kr * kTcLdw + cc, ok ? wp + size_t(k) * np_cols + cc : wp, ok);
    }
  };
  const int r0 = 32 * (warp / 4), n0 = 64 * (warp % 4);
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  pipeline<kStages>(nk, issue, [&](int kc, int s) {
    if (ed.thr) {
      mask_x_tile<T>(xs(s), kTcLdx, rows, kRows, kc * kTcKc, kTcKc, din, ed);
      csync();
    }
    const T* x_s = xs(s) + (r0 + g) * kTcLdx + c;
    const T* w_s = ws(s) + c * kTcLdw + n0 + g;
#pragma unroll
    for (int kk = 0; kk < kTcKc; kk += 8) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* xa = x_s + 16 * i * kTcLdx + kk;
        const float v[4] = {xa[0], xa[8 * kTcLdx], xa[4], xa[8 * kTcLdx + 4]};
        split_tf32(v, fa[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* wb = w_s + kk * kTcLdw + 8 * j;
        const float v[2] = {wb[0], wb[4 * kTcLdw]};
        FragB fb;
        split_tf32(v, fb);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_3xtf32(acc[i][j], fa[i], fb);
      }
    }
  });
  T* qkv = reinterpret_cast<T*>(R);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T* dst = qkv + (r0 + 16 * i + g) * L.ldw + n0 + 8 * j + 2 * c;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(dst + 8 * L.ldw) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
}
static_assert(kRows == 2 * 32 && kPanel == 4 * 64 && kTcKc % 8 == 0 && kTcLdx % 8 == 4 &&
                  kTcLdw % 32 == 8,
              "fp32 QKV on the tensor cores: 2 x 4 warps of 32 x 64, whole k-steps per chunk, "
              "conflict-free fragment loads");

// fp32 attention of one head group on the tensor cores (both instances):
// one warp per (article, head, 16-row query tile), as attention_group_wide;
// S = Q K^T over up to 64 keys, the softmax in registers (softmax_rows: its
// exp2 and reciprocal are within a few fp32 ulp of expf and a division), O =
// P V with P's C fragments as the A operand; Q, K and V read from the panel,
// zero past t rows and hd columns; N key and head tiles of 8 at the most.
template <int N>
__device__ void attention_group_tf32(const float* qkv, int ldp, float* o, int ldf, int na, int t,
                                     int hd, int gh, int h0, int nh, float scale) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  const int nq = (t + 15) / 16, nkh = (hd + 7) / 8, nkt = (t + 7) / 8;
  for (int it = warp; it < na * nh * nq; it += kWarps) {
    const int qt = it % nq, hl = it / nq % nh, an = it / (nq * nh);
    const float* base = qkv + size_t(an) * t * ldp;
    const FMat q{base + hl * hd, ldp, t, hd, false};
    const FMat kt{base + (gh + hl) * hd, ldp, t, hd, true};  // K^T: (e, key)
    const FMat v{base + (2 * gh + hl) * hd, ldp, t, hd, false};
    float s[N][4], acc[N][4];
    warp_mma_tf32<false>(s, q, 16 * qt, kt, nkh, nkt);
    softmax_rows(s, t, scale, 16 * qt + g < t, 16 * qt + g + 8 < t);
    warp_mma_tf32_c(acc, s, v, nkt, nkh);
    store_rows(acc, o + size_t(an) * t * ldf + (h0 + hl) * hd, ldf, 16 * qt, t, hd);
  }
}
static_assert(kWideMaxT <= 8 * 8 && kWideMaxHeadDim <= 8 * 8,
              "a warp's keys and head columns: 8 tiles of 8");

// acc [64 x 4 column tiles] = A [64 x 8 nk] B [8 nk x ...] over the
// column tiles ct0, ct0 + 8, ct0 + 16, ct0 + 24 below nct (B read from
// device memory): B's values of the next k-step are loaded before this
// one's products, so that L2's latency overlaps them.
__device__ __forceinline__ void warp_mma_4x4_tf32(float (&acc)[4][4][4], const FMat& a,
                                                  const FMat& b, int ct0, int nct, int nk) {
  const int g = threadIdx.x % 32 / 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float next[4][2];
  auto fetch = [&](int kk) {
    const int2 k = k_slots<false>(8 * kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * (ct0 + kWarps * j) + g;
      next[j][0] = b.at(k.x, n);
      next[j][1] = b.at(k.y, n);
    }
  };
  fetch(0);
  for (int kk = 0; kk < nk; ++kk) {
    float cur[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j][0] = next[j][0], cur[j][1] = next[j][1];
    if (kk + 1 < nk) fetch(kk + 1);
    FragA fa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_a<false>(a, 16 * i, 8 * kk, fa[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ct0 + kWarps * j < nct) {
        FragB fb;
        split_tf32(cur[j], fb);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_3xtf32(acc[i][j], fa[i], fb);
      }
    }
  }
}

// z[r][j] = sum_k src[r][k] W_att[k][c0 + j] for the block's rows and the
// columns [c0, c0 + ac) (ac <= 256, a multiple of 16), into z [kRows][ldz]
// (zeros on rows past `rows`), 3xTF32: warp w takes column tiles w, w + 8,
// w + 16, w + 24 and the 4 row tiles; A from src (shared or device memory,
// zero past rows and d), B from W_att in device memory, which every block
// reads and L2 keeps.
__device__ void pool_z_tf32(const float* src, int lds, int rows, int d,
                            const float* __restrict__ w_att, int a_pad, int c0, int ac, float* z,
                            int ldz) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int nct = ac / 8, nk = (d + 7) / 8;
  const FMat a{src, lds, rows, d, false};
  const FMat b{w_att + c0, a_pad, d, ac, false};
  float acc[4][4][4];
  warp_mma_4x4_tf32(acc, a, b, warp, nct, nk);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ct = warp + kWarps * j;
    if (ct >= nct) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* dst = z + (16 * i + g) * ldz + 8 * ct + 2 * c;
      dst[0] = acc[i][j][0];
      dst[1] = acc[i][j][1];
      dst[8 * ldz] = acc[i][j][2];
      dst[8 * ldz + 1] = acc[i][j][3];
    }
  }
}
static_assert(kRows == 4 * 16 && kAttChunk == 4 * 8 * kWarps,
              "the pooling product: 4 row tiles, 4 column tiles of 8 a warp per chunk");

// The launch's valid article count: read from device memory when `dev` is
// given (a CUDA graph's replay serves each batch's own count), clamped to
// [0, n]; else the count the launch passed by value.
__device__ __forceinline__ int valid_at(int n_valid, const int* dev, int n) {
  return dev != nullptr ? min(n, max(0, *dev)) : n_valid;
}

// Dropout between attention and pooling, on the block's fp32 o [rows][ldf]
// (rows start at global row row0): the stream-1 mask when dr.thr_att, else
// the external 0/1 mask [N*T, d] times 1/keep when ext is given.
__device__ __forceinline__ void drop_o(float* o, int ldf, int rows, int d, int row0,
                                       const philox::Dropout& dr, const float* __restrict__ ext,
                                       float inv_ext) {
  if (dr.thr_att && d % 4 == 0) {  // whole groups of 4: no per-column check (about 1% of K1)
    const int g4 = d / 4;
    for (int i = threadIdx.x; i < rows * g4; i += kThreads) {
      const int r = i / g4, c = (i % g4) * 4;
      const float4 m =
          philox::mask4(dr.key, uint32_t(row0 + r), uint32_t(c >> 2), 1u, dr.thr_att, dr.inv_att);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[r * ldf + c + j] *= philox::pick(m, j);
    }
  } else if (dr.thr_att) {  // the last group of 4 columns is short
    const int g4 = (d + 3) / 4;
    for (int i = threadIdx.x; i < rows * g4; i += kThreads) {
      const int r = i / g4, c = (i % g4) * 4;
      const float4 m =
          philox::mask4(dr.key, uint32_t(row0 + r), uint32_t(c >> 2), 1u, dr.thr_att, dr.inv_att);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < d) o[r * ldf + c + j] *= philox::pick(m, j);
    }
  } else if (ext != nullptr) {
    for (int i = threadIdx.x; i < rows * d; i += kThreads) {
      const int r = i / d, c = i % d;
      o[r * ldf + c] *= ext[size_t(row0 + r) * d + c] * inv_ext;
    }
  }
}

// z = round(o) @ W_att ([kRows][ldz] fp32 at the start of R). bf16: wmma
// over staged, pipelined W_att chunks; fp32: 3xTF32 (kTc, pool_z_tf32) or
// one thread per column.
template <typename T, bool kTc = false>
__device__ void pooling_logits(const float* o, int rows, int d, const T* __restrict__ w_att,
                               int a_pad, const Layout& L, unsigned char* R) {
  const int tid = threadIdx.x;
  float* z = reinterpret_cast<float*>(R);
  const int nk = (L.d_pad + kPoolRows - 1) / kPoolRows;
  if constexpr (kTc) {
    pool_z_tf32(o, L.ldf, rows, d, w_att, a_pad, 0, a_pad, z, L.ldz);
  } else if constexpr (std::is_same<T, bf16>::value) {
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
      csync();
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
      csync();
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
  csync();
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
  csync();
}

// ---- the wide instance's pooling: W_att in column chunks of kAttChunk ----

// z = round(o) @ W_att[:, c0 : c0 + ac] ([kRows][ldz] fp32 at the start of
// R), ac = min(kAttChunk, a_pad - c0). o's rows [0, rows) come from src
// (row stride lds): the fp32 o in shared memory (the forward) or round(o)
// in the compute dtype in device memory (the backward, whose o space holds
// other things by then). bf16: wmma over pipelined stages of { W_att rows
// [kPoolRows][ac] by cp.async, the rounded o columns [kRows][kPoolRows]
// copied by the threads as they issue the stage }; fp32: one thread per
// column, FMA, or 3xTF32 (kTc, pool_z_tf32).
template <typename T, typename S, bool kTc = false>
__device__ void pooling_logits_chunk(const S* src, int lds, int rows, int d,
                                     const T* __restrict__ w_att, int a_pad, int c0,
                                     const Layout& L, unsigned char* R) {
  const int tid = threadIdx.x;
  const int ac = min(kAttChunk, a_pad - c0);
  const int nk = (d + kPoolRows - 1) / kPoolRows;
  float* z = reinterpret_cast<float*>(R);
  if constexpr (kTc) {
    pool_z_tf32(src, lds, rows, d, w_att, a_pad, c0, ac, z, L.ldz);
  } else if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    constexpr int VE = 16 / sizeof(T);
    const int warp = tid / 32, av = ac / VE;
    auto wst = [&](int s) { return reinterpret_cast<T*>(R + s * L.pool_stage); };
    auto ost = [&](int s) { return reinterpret_cast<T*>(R + s * L.pool_stage + L.pool_wc); };
    auto issue = [&](int kc, int s) {
      T* dst = wst(s);
      for (int i = tid; i < kPoolRows * av; i += kThreads) {
        const int kr = i / av, c = (i % av) * VE, k = kc * kPoolRows + kr;
        const bool ok = k < d;
        cp_async16(dst + kr * L.ldc + c, ok ? w_att + size_t(k) * a_pad + c0 + c : w_att, ok);
      }
      T* od = ost(s);
      for (int i = tid; i < kRows * kPoolRows; i += kThreads) {
        const int r = i / kPoolRows, kr = i % kPoolRows, k = kc * kPoolRows + kr;
        od[r * L.ldoc + kr] =
            from_f<T>(r < rows && k < d ? to_f<S>(src[size_t(r) * lds + k]) : 0.f);
      }
    };
    const int nct = ac / 16;  // column tiles; warp w takes w and w + 8
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    pipeline<kPoolStages>(nk, issue, [&](int, int s) {
      const T* w_s = wst(s);
      const T* o_s = ost(s);
#pragma unroll
      for (int kk = 0; kk < kPoolRows; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(af[i], o_s + i * 16 * L.ldoc + kk, L.ldoc);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ct = warp + j * kWarps;
          if (ct < nct) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, w_s + kk * L.ldc + ct * 16, L.ldc);
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
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
      for (int i = tid; i < kPoolRows * ac; i += kThreads) {
        const int k = kc * kPoolRows + i / ac;
        ws[i] = k < d ? w_att[size_t(k) * a_pad + c0 + i % ac] : from_f<T>(0.f);
      }
      csync();
      if (tid < ac) {
        const int kn = min(kPoolRows, d - kc * kPoolRows);
        for (int kr = 0; kr < kn; ++kr) {
          const float w = to_f<T>(ws[kr * ac + tid]);
          const int c = kc * kPoolRows + kr;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < rows) zr[r] += to_f<S>(src[size_t(r) * lds + c]) * w;
        }
      }
      csync();
    }
    if (tid < ac) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) z[r * L.ldz + tid] = zr[r];
    }
  }
}
static_assert(kAttChunk == kThreads && kAttChunk == 16 * 2 * kWarps,
              "a chunk's columns: one per thread (fp32), two 16-column tiles per warp (bf16)");

// att[r] (+)= sum over the chunk's columns j < a of round(tanh(z + b)) *
// round(q), one warp per row (the first chunk sets att, later ones add).
template <typename T>
__device__ void pooling_att_chunk(const float* z, int ldz, const float* __restrict__ b_att,
                                  const float* __restrict__ q_att, int a, int c0, int rows,
                                  float* att) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ac = min(kAttChunk, a - c0);
  for (int r = warp; r < rows; r += kWarps) {
    float v = 0.f;
    for (int j = lane; j < ac; j += 32)
      v += rnd<T>(tanhf(z[r * ldz + j] + b_att[c0 + j])) * rnd<T>(q_att[c0 + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) att[r] = (c0 > 0 ? att[r] : 0.f) + v;
  }
}

// The pooling softmax over t of each article (one warp per article, lanes
// striding the tokens; max subtracted, +1e-8 in the denominator).
__device__ void pooling_softmax(const float* att, int na, int t, float* wts) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int an = warp; an < na; an += kWarps) {
    const float* a = att + an * t;
    float* w = wts + an * t;
    float mx = -INFINITY;
    for (int l = lane; l < t; l += 32) mx = fmaxf(mx, a[l]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int l = lane; l < t; l += 32) {
      w[l] = expf(a[l] - mx);
      sum += w[l];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int l = lane; l < t; l += 32) w[l] /= sum + 1e-8f;
  }
}

// The wide instance's pooling forward: z by column chunks, the logits att
// summed over them, then the weights (csync at the end).
template <typename T, typename S, bool kTc = false>
__device__ void pooling_wide(const S* src, int lds, int rows, int na, int t, int d,
                             const T* __restrict__ w_att, const float* __restrict__ b_att,
                             const float* __restrict__ q_att, int a, int a_pad, const Layout& L,
                             unsigned char* R, float* att, float* wts) {
  for (int c0 = 0; c0 < a; c0 += kAttChunk) {
    if (NE_PHASES & 4)
      pooling_logits_chunk<T, S, kTc>(src, lds, rows, d, w_att, a_pad, c0, L, R);
    csync();
    pooling_att_chunk<T>(reinterpret_cast<const float*>(R), L.ldz, b_att, q_att, a, c0, rows,
                         att);
    csync();  // z is spent before the next chunk's product
  }
  pooling_softmax(att, na, t, wts);
  csync();
}

}  // namespace ne
