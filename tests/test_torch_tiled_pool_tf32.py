"""The tiled route's T3 in fp32 as its "tf32x3" kernels compute it: the
two products, z = o W_att and do = dz W_att^T, in 3xTF32 across articles
(``tiled_pool_reference`` and ``tiled_pool_bwd_reference`` with
``tf32_passes=3``: both through ``tf32_matmul``), the softmax, the weighted
sum, datt and dz per article in fp32. The route composed on them (T1, T2,
T4 and K2's GEMMs on their 3xTF32 versions too, as on the card) against
the JAX package's fp32 fused encoder (its Pallas kernel in interpret mode,
its custom VJP's 7 gradients) within 1e-4 of each tensor's scale, the
card's fp32 check, at T 40, 130 and 200, n_valid below N and an attention
width past 256 (two 256-column tiles of W_att); the 3xTF32 versions against
the fp32 ones; ``tf32_passes`` checked; ``pool_variant``'s fp32 answers
either side of the TMA-stride rule (D a multiple of 4, a_pad of 16) at any
T and a_pad; and the launch counts and scratch kept apart by dtype."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.ops.news_encoder import fused_news_encoder as jax_fused
from ebnerd_tpu.ops.news_encoder import news_encoder as jax_news_encoder
from ebnerd_tpu_torch.ops import kernel_counters
from ebnerd_tpu_torch.ops import news_encoder as port

torch.set_num_threads(1)

FP32_CHECK = 1e-4  # the card's fp32 checks: FP32_ATOL, FP32_GRAD_REL (chip_smoke.py)
NAMES = ("x", "wq", "wk", "wv", "w_att", "b_att", "q_att")


def _inputs(seed, n, t, din, heads, head_dim, a):
    """x ~ N(0, 1), the weights ~ N(0, 0.05^2) scaled by fan-in as
    ``chip_smoke.make_inputs(fan=True)`` scales them."""
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    mk = lambda *s, f: rng.standard_normal(s, dtype=np.float32) * np.float32(0.05 * np.sqrt(f))
    return [rng.standard_normal((n, t, din), dtype=np.float32)] + [
        mk(*s, f=f) for s, f in (((din, d), 1024 / din), ((din, d), 1024 / din),
                                 ((din, d), 1024 / din), ((d, a), 400 / d), ((a,), 1.0),
                                 ((a, 1), 200 / a))]


def _tf32_route(monkeypatch, args, cot, heads, nv):
    """The route's output and 7 gradients with T1-T4 on their 3xTF32 plain
    versions and K2's GEMMs on the 3xTF32 GEMM's plain products."""
    monkeypatch.setattr(port, "tiled_qkv", lambda *a, nv_dev=None, **k: port.tiled_qkv_reference(
        *a, tf32_passes=3, **k))
    monkeypatch.setattr(port, "tiled_attention", lambda *a, nv_dev=None, backward=False, **k: (
        lambda o, st: (o, st if backward else None))(*port.tiled_attention_reference(
            *a, backward=backward, tf32_passes=3, **k)))
    monkeypatch.setattr(port, "tiled_attention_bwd", lambda *a, nv_dev=None, **k:
                        port.tiled_attention_bwd_reference(*a, tf32_passes=3, **k))
    monkeypatch.setattr(port, "tiled_pool", lambda *a, nv_dev=None, **k:
                        port.tiled_pool_reference(*a, tf32_passes=3, **k))
    monkeypatch.setattr(port, "tiled_pool_bwd", lambda *a, nv_dev=None, **k:
                        port.tiled_pool_bwd_reference(*a, tf32_passes=3, **k))
    x = torch.from_numpy(args[0])
    n, t, din = x.shape
    ws = [torch.from_numpy(v) for v in args[1:]]
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=torch.float32)
    d, a = ws[0].shape[1], ws[3].shape[1]
    xin, _, drop = port.kernel_input(x, nv, port.Dropout())
    out = port.tiled_forward(xin, packed, nv, drop, n=n, t=t)
    g = torch.from_numpy(cot).contiguous()
    dqkv, o_c, dz_c, db_part, dq_part = port.tiled_bwd_core(xin, packed, g, nv, drop, n=n, t=t)
    rows, p_cols, a_pad = nv * t, packed.wqkv.shape[1], packed.w_att.shape[1]
    gemm = lambda u, v, dx, **kw: port.bwd_gemm_reference(u, v, dx=dx, rows=rows, tf32_passes=3,
                                                          **kw)
    dx = gemm(dqkv, packed.wqkv, True)[:, :din].reshape(n, t, din)
    dwqkv = gemm(xin, dqkv, False, splits=port.gemm_splits_fp32(xin.shape[1], p_cols, rows))
    dw = gemm(o_c, dz_c, False, splits=port.gemm_splits_fp32(o_c.shape[1], a_pad, rows))
    dwq, dwk, dwv = (w[:din] for w in port.unpack_qkv(dwqkv, heads, d))
    return out, (dx, dwq, dwk, dwv, dw[:d, :a], db_part[:nv].sum(0)[:a],
                 dq_part[:nv].sum(0)[:a].reshape(a, 1))


@pytest.mark.parametrize("n,t,heads,head_dim,a,nv", [
    (3, 40, 2, 20, 24, 3),   # T 40 (the history-50 tower's class)
    (3, 40, 2, 20, 24, 2),   # n_valid below N
    (2, 130, 2, 20, 16, 2),  # T 130
    (3, 200, 2, 20, 16, 2),  # the history-200 tower's T, n_valid below N
    (2, 40, 2, 8, 300, 1),   # A 300: a_pad 304, two 256-column tiles of W_att
])
def test_tf32_pool_route_matches_jax_fused_encoder(monkeypatch, n, t, heads, head_dim, a, nv):
    """With T3 on its 3xTF32 version (and T1, T2, T4 and K2's GEMMs on
    theirs), the route gives JAX's output and its 7 gradients within 1e-4 of
    each one's scale; the rows past n_valid are zero and the rule gives T3
    its "tf32x3" kernels."""
    a_pad = -(-a // 16) * 16
    assert {port.pool_variant(t, heads * head_dim, a_pad, torch.float32, b)
            for b in (False, True)} == {"tf32x3"}
    args = _inputs(t + nv + a, n, t, 16, heads, head_dim, a)
    d = heads * head_dim
    cot = np.cos(np.arange(n * d, dtype=np.float32).reshape(n, d) * 0.1)
    cot[nv:] = 0.0
    jargs = [jnp.asarray(v) for v in args]
    want = np.asarray(jax_fused(*jargs, num_heads=heads, block_n=n, interpret=True,
                                n_valid=jnp.int32(nv)))
    tail = (jnp.ones((8, 128), jnp.float32), None, heads, n, True, 1.0, "float32", 1.0,
            jnp.asarray([nv], jnp.int32))
    loss = lambda *a_: jnp.sum(jax_news_encoder(*a_, *tail) * cot)
    jgrads = [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(*jargs)]
    out, grads = _tf32_route(monkeypatch, args, cot, heads, nv)
    scale = np.abs(want[:nv]).max()
    assert np.abs(out[:nv].numpy() - want[:nv]).max() <= FP32_CHECK * scale
    assert not out[nv:].any()
    for name, u, r in zip(NAMES, grads, jgrads):
        assert u.shape == r.shape, name
        assert np.abs(u.numpy() - r).max() <= FP32_CHECK * np.abs(r).max(), name


def _pool_case(seed, n, t, d, a):
    rng = np.random.default_rng(seed)
    mk = lambda *s, f=1.0: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                            * np.float32(f))
    ws = [mk(8, d, f=0.05) for _ in range(3)] + [
        mk(d, a, f=0.05 * np.sqrt(400 / d)), mk(a, f=0.1), mk(a, 1, f=0.05 * np.sqrt(200 / a))]
    packed = port.pack_weights(*ws, num_heads=1, compute_dtype=torch.float32)
    return packed, mk(n * t, d, f=0.5), mk(n, d, f=0.1)


@pytest.mark.parametrize("t,a,nv,drop", [(40, 24, 3, None), (130, 200, 2, "rng"),
                                         (200, 16, 1, "mask"), (50, 300, 2, "rng")])
def test_tf32_pool_against_fp32_plain(t, a, nv, drop):
    """T3's 3xTF32 versions against their fp32 products on the same o, g and
    dropout: the pooled rows, do, dz and the db and dq partials within 2e-6
    of each one's scale (a 3xTF32 product's own error is under 1e-6 of it);
    zeros past the nv valid articles."""
    n, d = 3, 32
    packed, o, g = _pool_case(t + a, n, t, d, a)
    mask = (torch.rand(n, t, d, generator=torch.Generator().manual_seed(t)) < 0.8).float()
    dr = port.dropout_config(n, t, d, 0.8 if drop else 1.0, 1.0, 7 if drop == "rng" else None,
                             mask if drop == "mask" else None, torch.device("cpu"))
    kw = dict(n=n, t=t, nv=nv)
    p3, p0 = (port.tiled_pool_reference(o, packed, tf32_passes=p, **kw) for p in (3, 0))
    assert (p3 - p0).abs().max() <= 2e-6 * p0.abs().max()
    assert not p3[nv:].any()
    b3 = port.tiled_pool_bwd_reference(o, packed, g, dr, tf32_passes=3, **kw)
    b0 = port.tiled_pool_bwd_reference(o, packed, g, dr, **kw)
    for u, v in zip(b3, b0):
        assert (u - v).abs().max() <= 2e-6 * v.abs().max()
    rows = nv * t
    assert not b3[0][rows:].any() and not b3[1][rows:].any()
    assert not b3[2][nv:].any() and not b3[3][nv:].any()


def test_pool_tf32_passes_are_checked():
    """``tf32_passes`` is 0 or 3, and 3 only in fp32, in T3's plain versions
    as in T1's, T2's and T4's."""
    ws = [torch.zeros(s) for s in ((8, 8), (8, 8), (8, 8), (8, 16), (16,), (16, 1))]
    for cdt, passes in ((torch.float32, 1), (torch.bfloat16, 3)):
        packed = port.pack_weights(*ws, num_heads=2, compute_dtype=cdt)
        with pytest.raises(ValueError, match="tf32_passes"):
            port.tiled_pool_reference(torch.zeros(4, 8), packed, n=1, t=4, nv=1,
                                      tf32_passes=passes)
        with pytest.raises(ValueError, match="tf32_passes"):
            port.tiled_pool_bwd_reference(torch.zeros(4, 8).to(cdt), packed, torch.zeros(1, 8),
                                          port.Dropout(), n=1, t=4, nv=1, tf32_passes=passes)


# pool_variant's answers either side of the TMA-stride rule: fp32 takes "tf32x3" wherever D is a
# multiple of 4 (o's rows whole 16 bytes) and a_pad of 16, at any T (1 to 12,800) and a_pad (16
# to 1,024: one to four 256-column tiles); one D (or a_pad) off it keeps the blocks' layouts'
# kernel (pool_plan_variant), as bf16 does everywhere
TMA_RULE = [
    # t, d, a_pad, dtype, kernel (both directions)
    (50, 400, 208, torch.float32, "tf32x3"), (50, 398, 208, torch.float32, "chunked"),
    (50, 402, 208, torch.float32, "chunked"), (50, 400, 200, torch.float32, "chunked"),
    (100, 144, 208, torch.float32, "tf32x3"), (100, 146, 208, torch.float32, "streamed"),
    (100, 142, 208, torch.float32, "resident"), (100, 144, 200, torch.float32, "resident"),
    (1, 4, 16, torch.float32, "tf32x3"), (1, 1, 16, torch.float32, "resident"),
    (200, 176, 208, torch.float32, "tf32x3"), (200, 178, 208, torch.float32, "chunked"),
    (200, 64, 272, torch.float32, "tf32x3"), (200, 66, 272, torch.float32, "chunked"),
    (100, 64, 304, torch.float32, "tf32x3"), (100, 62, 304, torch.float32, "chunked"),
    (30, 320, 208, torch.float32, "tf32x3"), (12_800, 400, 208, torch.float32, "tf32x3"),
    (1_000, 128, 1_024, torch.float32, "tf32x3"),
    (50, 400, 208, torch.bfloat16, "resident"), (200, 176, 208, torch.bfloat16, "streamed"),
    (100, 64, 304, torch.bfloat16, "chunked"), (12_800, 400, 208, torch.bfloat16, "chunked"),
]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("t,d,a_pad,dtype,kernel", TMA_RULE)
def test_pool_variant_fp32_either_side_of_the_tma_rule(t, d, a_pad, dtype, kernel, backward):
    assert port.pool_variant(t, d, a_pad, dtype, backward) == kernel
    if kernel != "tf32x3":
        assert kernel == port.pool_plan_variant(t, d, a_pad, dtype, backward)


@pytest.mark.parametrize("n,t,a_pad,backward,floats", [
    (16_384, 50, 208, False, 819_200), (16_384, 50, 208, True, 819_200 * 209),
    (3, 40, 304, False, 240), (3, 40, 304, True, 120 * (2 + 304)), (2, 7, 1_024, False, 56),
    (5, 65, 208, False, 325), (5, 65, 208, True, 328 + 325 * 208),
    (5, 65, 608, True, 976 + 325 * 608), (2, 7, 1_024, True, 56 + 14 * 1_024),
])
def test_pool_tf32x3_scratch(n, t, a_pad, backward, floats):
    """The scratch the wrapper gives T3's "tf32x3" kernels: a [N*T] slot of
    logit partials a 256-column tile of W_att, and in the backward tanh(z +
    b) [N*T, a_pad] from the next 16-byte boundary (0.68 GB at the
    history-50 user tower; an odd N*T, 325, moves it by 3 or 1 floats)."""
    assert port.pool_tf32x3_scratch(n, t, a_pad, backward) == floats


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("d,cdt,kernel", [(32, torch.float32, "tf32x3"),
                                          (30, torch.float32, "resident"),
                                          (32, torch.bfloat16, "resident")])
def test_launch_counts_kept_apart_by_dtype(monkeypatch, d, cdt, kernel, backward):
    """``_launch_pool`` counts an fp32 launch of the "tf32x3" kernels on
    ``tiled_pool.tf32x3`` (``tiled_pool_bwd.tf32x3``), passes the C entry its
    variant 3 with the scratch and weights arrays sized as
    ``pool_tf32x3_scratch`` gives them; bf16, and fp32 rows that are not
    whole 16 bytes, keep the kernels of the blocks' layouts (here the
    resident one) and their counters; ``kernel_counters`` names each."""
    seen, sizes = [], []
    monkeypatch.setattr(port, "_launch_tiled", lambda fn, name, dev, *args: seen.append(
        (fn, name, args)))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *s, **k: sizes.append(s) or real_empty(*s, **k))
    n, t, a = 3, 20, 40
    ws = [torch.zeros(s) for s in ((8, d), (8, d), (8, d), (d, a), (a,), (a, 1))]
    packed = port.pack_weights(*ws, num_heads=2, compute_dtype=cdt)
    a_pad = packed.w_att.shape[1]
    fn = port.tiled_pool_bwd if backward else port.tiled_pool
    src = torch.zeros(n * t, port.o_width(d) if backward else d, dtype=cdt)
    outs = (None,) * 5
    port._launch_pool(fn, src, packed, torch.zeros(n, d), outs, n, t, n, None, port.Dropout(),
                      backward)
    (got_fn, name, args), = seen
    assert name == "tiled_pool" and args[-1] == port._POOL_VARIANT[kernel]
    assert got_fn is getattr(fn, kernel, fn) and got_fn is getattr(fn, kernel)
    if kernel == "tf32x3":
        assert sizes == [(port.pool_tf32x3_scratch(n, t, a_pad, backward),), (n * t,)]
    counters = kernel_counters()
    base = "tiled_pool_bwd" if backward else "tiled_pool"
    assert counters[f"{base}_tf32x3"] is fn.tf32x3
    assert counters[f"{base}_resident"] is fn.resident and counters[base] is fn


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("t,d,a_pad,kernel", [
    (100, 144, 208, "resident"), (100, 152, 208, "streamed"), (1, 1, 16, "resident"),
    (200, 64, 256, "streamed"), (200, 64, 272, "chunked"), (200, 176, 208, "streamed"),
    (200, 184, 208, "chunked"), (50, 400, 208, "chunked"), (200, 400, 208, "chunked"),
])
def test_pool_plan_variant_keeps_the_fp32_limits(t, d, a_pad, kernel, backward):
    """The blocks' layouts' rule, which ``pool_variant`` answered in fp32
    before the "tf32x3" kernels and which the kernels kept for timing still
    follow: in fp32 the resident kernel to D 144 at T 100 and A 200, the
    streamed one past it (D 152) and past T 128 to D 176 at T 200, a_pad
    256; chunked past those (D 184, a_pad 272) and at the user towers' D
    400 (the chunked kernel the "tf32x3" kernels replace there)."""
    assert port.pool_plan_variant(t, d, a_pad, torch.float32, backward) == kernel
