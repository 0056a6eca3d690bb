"""The tiled route's T2 and T4 in fp32 as their staged and streamed kernels
compute them: every product in 3xTF32 (``tiled_attention_reference`` and
``tiled_attention_bwd_reference`` with ``tf32_passes=3``: Q K^T, P V, dO
V^T, dS K, P^T dO and dS^T Q through ``tf32_matmul``, P normalised and dS
unrounded, as the kernels form them). The route composed on them (T1 and
K2's GEMMs on their 3xTF32 versions too, as on the card) against the JAX
package's fp32 fused encoder (its Pallas kernel in interpret mode, its
custom VJP's 7 gradients) within 1e-4 of each tensor's scale, the card's
fp32 check, at T 40 (the staged kernels), T 130 and 200 (the streamed
ones) and n_valid below N; the products' rule (``tf32_passes``);
``attention_variant``'s fp32 answers either side of each limit, which this
redesign leaves as they were; and the launch counts kept apart by dtype."""
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
    ``chip_smoke.make_inputs(fan=True)`` scales them (at 0.05 alone the
    pooling's gradients cancel a thousandfold at these widths)."""
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    mk = lambda *s, f: rng.standard_normal(s, dtype=np.float32) * np.float32(0.05 * np.sqrt(f))
    return [rng.standard_normal((n, t, din), dtype=np.float32)] + [
        mk(*s, f=f) for s, f in (((din, d), 1024 / din), ((din, d), 1024 / din),
                                 ((din, d), 1024 / din), ((d, a), 400 / d), ((a,), 1.0),
                                 ((a, 1), 200 / a))]


def _tf32_route(monkeypatch, args, cot, heads, nv):
    """The route's output and 7 gradients with T1, T2 and T4 on their 3xTF32
    plain versions (T3 as on the card: fp32 products) and K2's GEMMs on the
    3xTF32 GEMM's plain products."""
    monkeypatch.setattr(port, "tiled_qkv", lambda *a, nv_dev=None, **k: port.tiled_qkv_reference(
        *a, tf32_passes=3, **k))
    monkeypatch.setattr(port, "tiled_attention", lambda *a, nv_dev=None, backward=False, **k: (
        lambda o, st: (o, st if backward else None))(*port.tiled_attention_reference(
            *a, backward=backward, tf32_passes=3, **k)))
    monkeypatch.setattr(port, "tiled_attention_bwd", lambda *a, nv_dev=None, **k:
                        port.tiled_attention_bwd_reference(*a, tf32_passes=3, **k))
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
    return out, (dx, dwq, dwk, dwv, dw[:d, :a], db_part.sum(0)[:a],
                 dq_part.sum(0)[:a].reshape(a, 1))


@pytest.mark.parametrize("n,t,heads,head_dim,a,nv,kernel", [
    (3, 40, 2, 20, 24, 3, "staged"),     # T 40: the staged kernels (the history-50 tower's class)
    (3, 40, 2, 20, 24, 2, "staged"),     # n_valid below N
    (2, 130, 2, 20, 16, 2, "streamed"),  # T 130: the streamed kernels, a part-filled last tile
    (3, 200, 2, 20, 16, 2, "streamed"),  # the history-200 tower's T, n_valid below N
])
def test_tf32_attention_route_matches_jax_fused_encoder(monkeypatch, n, t, heads, head_dim, a,
                                                        nv, kernel):
    """At heads 20 wide (3 k-steps of 8 over the head, not 32 padded
    columns), the route on the 3xTF32 T2 and T4 gives JAX's output and its 7
    gradients within 1e-4 of each one's scale; the rows past n_valid are zero
    and the rule gives the case's kernels."""
    assert {port.attention_variant(t, head_dim, torch.float32, b) for b in (False, True)} == {
        kernel}
    args = _inputs(t + nv, n, t, 16, heads, head_dim, a)
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


@pytest.mark.parametrize("t,nv", [(40, 3), (130, 2), (200, 1)])
def test_tf32_attention_against_fp32_plain(t, nv):
    """T2's and T4's 3xTF32 versions against their fp32 products on the
    same Q|K|V, dO and statistics: o (both modes), the statistics and
    dQ|dK|dV within 2e-6 of the scale (a 3xTF32 product's own error is under
    1e-6 of it); zeros past the nv valid articles."""
    n, heads, hd = 3, 2, 20
    rng = np.random.default_rng(t)
    ws = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.05)
          for s in ((16, 40), (16, 40), (16, 40), (40, 16), (16,), (16, 1))]
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=torch.float32)
    qkv = torch.from_numpy(rng.standard_normal((n * t, packed.wqkv.shape[1]), dtype=np.float32))
    do = torch.from_numpy(rng.standard_normal((n * t, heads * hd), dtype=np.float32) * 0.1)
    kw = dict(n=n, t=t, nv=nv)
    drop = port.Dropout()
    for backward in (False, True):
        o3, st3 = port.tiled_attention_reference(qkv, packed, drop, backward=backward,
                                                 tf32_passes=3, **kw)
        o0, st0 = port.tiled_attention_reference(qkv, packed, drop, backward=backward, **kw)
        assert (o3 - o0).abs().max() <= 2e-6 * o0.abs().max()
        assert (st3 - st0).abs().max() <= 2e-6 * st0.abs().max()
        assert not o3[nv * t:].any() and not st3[:, nv * t:].any()
    d3 = port.tiled_attention_bwd_reference(qkv, do, st0, packed, tf32_passes=3, **kw)
    d0 = port.tiled_attention_bwd_reference(qkv, do, st0, packed, **kw)
    assert (d3 - d0).abs().max() <= 2e-6 * d0.abs().max()
    assert not d3[nv * t:].any()


def test_tf32_passes_are_checked():
    """``tf32_passes`` is 0 or 3, and 3 only in fp32, in T2's and T4's plain
    versions as in T1's; 0 is the fp32 products."""
    ws = [torch.zeros(s) for s in ((8, 8), (8, 8), (8, 8), (8, 16), (16,), (16, 1))]
    qkv = torch.zeros(4, 256)
    for cdt, passes in ((torch.float32, 1), (torch.bfloat16, 3)):
        packed = port.pack_weights(*ws, num_heads=2, compute_dtype=cdt)
        with pytest.raises(ValueError, match="tf32_passes"):
            port.tiled_attention_reference(qkv.to(cdt), packed, port.Dropout(), n=1, t=4, nv=1,
                                           tf32_passes=passes)
        with pytest.raises(ValueError, match="tf32_passes"):
            port.tiled_attention_bwd_reference(qkv.to(cdt), torch.zeros(4, 8).to(cdt),
                                               torch.ones(2, 4, 2), packed, n=1, t=4, nv=1,
                                               tf32_passes=passes)


# attention_variant's fp32 answers either side of each limit (the plans are unchanged: the
# staged T2 to a head 144 wide at T 128 and T4 to 32; the streamed T2 to 448 at any T, T4 to 288
# up to T 512 and 256 to T 2,048; at the history towers' heads of 20, T4 streamed to T 12,800)
F32_VARIANTS = [
    # t, head_dim, backward, kernel
    (50, 20, False, "staged"), (50, 20, True, "staged"),
    (128, 20, False, "staged"), (129, 20, False, "streamed"),
    (128, 20, True, "staged"), (129, 20, True, "streamed"),
    (128, 144, False, "staged"), (128, 145, False, "streamed"),
    (128, 32, True, "staged"), (128, 33, True, "streamed"),
    (200, 20, False, "streamed"), (200, 20, True, "streamed"),
    (200, 448, False, "streamed"), (200, 449, False, "gather"),
    (100_000, 448, False, "streamed"), (100_000, 449, False, "gather"),
    (200, 288, True, "streamed"), (200, 289, True, "gather"),
    (512, 288, True, "streamed"), (513, 288, True, "gather"),
    (2_048, 256, True, "streamed"), (2_049, 256, True, "gather"),
    (12_800, 20, True, "streamed"), (12_801, 20, True, "gather"),
]


@pytest.mark.parametrize("t,head_dim,backward,kernel", F32_VARIANTS)
def test_attention_variant_fp32_limits_unchanged(t, head_dim, backward, kernel):
    assert port.attention_variant(t, head_dim, torch.float32, backward) == kernel


@pytest.mark.parametrize("fn", ["tiled_attention", "tiled_attention_bwd"])
def test_launch_counts_kept_apart_by_dtype(fn):
    """The staged and streamed kernels count their bf16 launches on
    ``staged`` / ``streamed`` and their fp32 (3xTF32) ones on
    ``staged_tf32x3`` / ``streamed_tf32x3``; the gathering kernel on the
    wrapper; ``kernel_counters`` names each."""
    w = getattr(port, fn)
    counters = kernel_counters()
    for variant in ("staged", "streamed"):
        assert port._att_count(w, variant, torch.bfloat16) is getattr(w, variant)
        assert port._att_count(w, variant, torch.float32) is getattr(w, variant + "_tf32x3")
        assert counters[f"{fn}_{variant}"] is getattr(w, variant)
        assert counters[f"{fn}_{variant}_tf32x3"] is getattr(w, variant + "_tf32x3")
    for cdt in (torch.bfloat16, torch.float32):
        assert port._att_count(w, "gather", cdt) is w
    assert counters[fn] is w
