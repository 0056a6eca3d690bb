"""The fused encoder's tiled route (``csrc/news_encoder_tiled.cu``: T1 the
QKV projection, T2 the attention, T3 the pooling forward and backward, T4
the attention backward) through the plain versions its kernels are held
against on the card: at the shapes the narrow and wide instances do not
take (T 65, 100, 130 and 200, head widths 80, 128 and 256, A 600, and an
fp32 D x A past the wide instance's shared memory; either side of T2's,
T4's and T3's kernel rules) the route's forward equals the JAX
package's Pallas kernel run in interpret mode, and its backward, finished
by the GEMMs' and reductions' arithmetic, the JAX custom VJP's 7 gradients
(outputs to 3e-5, gradients to 5e-5: ``tests/ops/test_news_encoder.py:34,
60``); T1-T4 put together equal ``bwd_core_reference``; the head-group
packing holds heads past 85 columns; ``route`` (T 33-64 on the tiled
route at the history-50 user tower's heads; the wide instance by its
override), ``attention_variant``, ``pool_variant`` (T3's streamed kernel
past T 128) and ``qkv_variant`` at each boundary; NRMS at history 100 and
200 equals JAX's NRMS through the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.models.config import HParamsNRMS as JaxHP
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.ops.news_encoder import fused_news_encoder as jax_fused
from ebnerd_tpu.ops.news_encoder import news_encoder as jax_news_encoder
from ebnerd_tpu_torch.bridge import load_nrms_params, nrms_state_dict
from ebnerd_tpu_torch.models import NRMS, HParamsNRMS
from ebnerd_tpu_torch.ops import news_encoder as port

torch.set_num_threads(1)

OUT_ATOL, GRAD_ATOL = 3e-5, 5e-5
NAMES = ("x", "wq", "wk", "wv", "w_att", "b_att", "q_att")
SHAPES = [
    # n, t, din, heads, head_dim, a, block (JAX block_n), n_valid
    (4, 65, 16, 2, 8, 16, 4, 4),      # T 65: past the wide instance
    (4, 100, 16, 2, 8, 16, 4, 3),     # T 100, n_valid inside the block
    (3, 130, 16, 2, 4, 8, 3, 3),      # T 130: three 64-row tiles
    (3, 40, 16, 1, 80, 24, 3, 3),     # head width 80: one head a panel of 256
    (3, 100, 16, 1, 128, 600, 3, 3),  # T 100, head width 128 (a 384-column panel), A 600
    (2, 64, 16, 8, 64, 512, 2, 2),    # fp32 D 512 x A 512: past the wide instance's smem
    # either side of T2's and T4's staged kernels (``attention_variant``)
    (2, 128, 16, 2, 8, 16, 2, 2),     # T 128: their last T
    (2, 129, 16, 2, 8, 16, 2, 1),     # T 129: the streamed kernels
    (2, 128, 16, 1, 32, 16, 2, 2),    # fp32 T4's head-width limit at T 128
    (2, 128, 16, 1, 33, 16, 2, 2),    # one past: T4 streamed, T2 staged
    (2, 128, 16, 1, 144, 24, 2, 2),   # fp32 T2's limit and bf16 T4's
    (2, 128, 16, 1, 145, 24, 2, 1),   # one past fp32 T2's
    (1, 128, 16, 1, 288, 16, 1, 1),   # bf16 T2's limit
    (1, 128, 16, 1, 290, 16, 1, 1),   # one (even width) past it
    # the streamed kernels past T 128: T 200, and a head 256 wide
    (2, 200, 16, 2, 8, 16, 2, 1),
    (1, 130, 16, 1, 256, 24, 1, 1),
    # either side of T3's resident kernel (``pool_variant``): a_pad 256 and 272, and fp32 D 144
    # (resident at T 100, A 200) and 152 (streamed)
    (2, 70, 16, 2, 8, 256, 2, 2),
    (2, 70, 16, 2, 8, 257, 2, 1),
    (1, 100, 16, 2, 72, 200, 1, 1),
    (1, 100, 16, 2, 76, 200, 1, 1),
    # T3's streamed kernel past T 128 with a_pad <= 256: T 129, 200 (a_pad 256) and 256
    (2, 129, 16, 2, 8, 200, 2, 1),
    (2, 200, 16, 2, 8, 256, 2, 2),
    (1, 256, 16, 2, 8, 64, 1, 1),
    # T 33-64 on the tiled route (``route``) at the history-50 user tower's heads (20 x 20, A 200)
    (2, 50, 16, 20, 20, 200, 2, 2),
    (2, 64, 16, 20, 20, 200, 2, 1),
]


def _inputs(seed, n, t, din, heads, head_dim, a, w_scale=0.05):
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    mk = lambda *s, sc=w_scale: rng.standard_normal(s, dtype=np.float32) * sc
    return [mk(n, t, din, sc=1.0), mk(din, d), mk(din, d), mk(din, d), mk(d, a), mk(a), mk(a, 1)]


def _tiled(args, cot, heads, nv, drop=port.Dropout(), cdt=torch.float32):
    """The route's output and 7 gradients from the plain versions of T1-T4
    (``tiled_forward``, ``tiled_bwd_core``), the GEMMs' and reductions'
    arithmetic after them as ``_backward`` runs it."""
    x = torch.from_numpy(args[0]).to(cdt)
    n, t, din = x.shape
    ws = [torch.from_numpy(v) for v in args[1:]]
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    d, a = ws[0].shape[1], ws[3].shape[1]
    xin, _, drop_in = port.kernel_input(x, nv, drop)
    out = port.tiled_forward(xin, packed, nv, drop_in, n=n, t=t)
    g = torch.from_numpy(cot).contiguous()
    dqkv, o_c, dz_c, db_part, dq_part = port.tiled_bwd_core(xin, packed, g, nv, drop_in, n=n, t=t)
    rows = nv * t
    dx = (dqkv.float() @ packed.wqkv.float().T)[:, :din]
    dx[rows:] = 0
    dwq, dwk, dwv = (w[:din] for w in port.unpack_qkv(xin[:rows].float().T @ dqkv[:rows].float(),
                                                      heads, d))
    dw = (o_c[:rows].float().T @ dz_c[:rows].float())[:d, :a]
    grads = (dx.reshape(n, t, din), dwq, dwk, dwv, dw, db_part[:nv, :a].sum(0),
             dq_part[:nv, :a].sum(0).reshape(a, 1))
    return out, grads


def _jax_grads(args, cot, *tail):
    jargs = [jnp.asarray(v) for v in args]
    loss = lambda *a_: jnp.sum(jax_news_encoder(*a_, *tail) * cot)
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(*jargs)]


@pytest.mark.parametrize("n,t,din,heads,head_dim,a,block,nv", SHAPES)
def test_tiled_route_matches_jax_kernel(n, t, din, heads, head_dim, a, block, nv):
    """The route at shapes past the instances: it is the route chosen, and
    its output and gradients equal JAX's Pallas kernel and custom VJP."""
    args = _inputs(0, n, t, din, heads, head_dim, a)
    d = heads * head_dim
    assert port.route(t, head_dim, -(-a // 16) * 16) == "tiled" or (d, a) == (512, 512)
    cot = np.cos(np.arange(n * d, dtype=np.float32).reshape(n, d) * 0.1)
    cot[nv:] = 0.0
    jargs = [jnp.asarray(v) for v in args]
    kern = np.asarray(jax_fused(*jargs, num_heads=heads, block_n=block, interpret=True,
                                n_valid=jnp.int32(nv)))
    ref = _jax_grads(args, cot, jnp.ones((8, 128), jnp.float32), None, heads, block, True, 1.0,
                     "float32", 1.0, jnp.asarray([nv], jnp.int32))
    out, grads = _tiled(args, cot, heads, nv)
    np.testing.assert_allclose(out[:nv].numpy(), kern[:nv], atol=OUT_ATOL)
    assert not out[nv:].any()
    for name, u, r in zip(NAMES, grads, ref):
        np.testing.assert_allclose(u.numpy(), r, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("n,t,din,heads,head_dim,a,block,nv", [
    (3, 100, 16, 1, 128, 600, 3, 3),  # past the instances: the route's own shape
    (7, 20, 16, 2, 8, 16, 7, 5),      # T 20 forced: 3 articles a block on the other route
])
def test_autograd_function_on_the_tiled_route_matches_jax(monkeypatch, n, t, din, heads,
                                                          head_dim, a, block, nv):
    """``NewsEncoderFunction`` forward and backward with ``_route`` answering
    "tiled" and K2's GEMM and reduction replaced by their plain versions (on
    CPU tensors T1-T4's wrappers are theirs): ``_backward``'s tiled branch,
    its one db and dq partial row per article and the products and sums
    after T1-T4, give JAX's output to 3e-5 and its 7 gradients to 5e-5; the
    backward keeps the forward's route, and neither K1 nor K2's per-block
    kernel is called. The weights are drawn at 0.3, not 0.05: there the
    pooling's gradients (dW, db, dq) are of order 1, where at 0.05 they are
    1e-6 to 1e-5 and a lost partial row would pass the tolerance."""
    routes = []

    def fake_route(packed, t_, din_, force_tiled=False, instance=False):
        routes.append((t_, force_tiled))
        return "tiled"

    def fake_gemm(a_, b, *, dx, rows, drop=port.Dropout(), splits=1, keep=None, valid=None):
        out = port.bwd_gemm_reference(a_, b, dx=dx, rows=rows, drop=drop)
        return out if dx else out[None]

    def refuse(*args, **kwargs):
        raise AssertionError("the tiled route launched an instance's kernel")

    monkeypatch.setattr(port, "_route", fake_route)
    monkeypatch.setattr(port, "bwd_gemm", fake_gemm)
    monkeypatch.setattr(port, "reduce_rows", lambda part: part.reshape(part.shape[0], -1).sum(0))
    monkeypatch.setattr(port, "launch", refuse)
    monkeypatch.setattr(port, "launch_bwd_core", refuse)
    monkeypatch.setattr(port, "_packed_for", lambda x, weights, packed, heads_, cdt:
                        port.pack_weights(*weights, num_heads=heads_, compute_dtype=cdt))
    args = _inputs(5, n, t, din, heads, head_dim, a, w_scale=0.3)
    d = heads * head_dim
    cot = np.cos(np.arange(n * d, dtype=np.float32).reshape(n, d) * 0.1)
    cot[nv:] = 0.0
    jargs = [jnp.asarray(v) for v in args]
    kern = np.asarray(jax_fused(*jargs, num_heads=heads, block_n=block, interpret=True,
                                n_valid=jnp.int32(nv)))
    ref = _jax_grads(args, cot, jnp.ones((8, 128), jnp.float32), None, heads, block, True, 1.0,
                     "float32", 1.0, jnp.asarray([nv], jnp.int32))
    ins = [torch.from_numpy(v).requires_grad_(True) for v in args]
    out = port.NewsEncoderFunction.apply(*ins, None, heads, torch.float32, nv, 1.0, 1.0, None,
                                         None)
    (out * torch.from_numpy(cot)).sum().backward()
    assert routes == [(t, False), (t, True)]
    np.testing.assert_allclose(out.detach()[:nv].numpy(), kern[:nv], atol=OUT_ATOL)
    for name, u, r in zip(NAMES, ins, ref):
        np.testing.assert_allclose(u.grad.numpy(), r, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,t,din,heads,head_dim,a,nv", [
    (4, 100, 16, 2, 8, 40, 3), (3, 70, 24, 1, 128, 600, 3), (5, 20, 32, 4, 16, 48, 4),
    # either side of T3's resident kernel (``pool_variant``): a_pad 256 and 272
    (2, 100, 24, 2, 8, 256, 2), (2, 100, 24, 2, 8, 257, 1)])
def test_tiled_parts_equal_bwd_core_reference(cdt, n, t, din, heads, head_dim, a, nv):
    """T1-T4's plain versions put together, with the attention output's
    Philox dropout (keep 0.8; fp32 also on x, which T1 draws): dQ|dK|dV,
    round(o) and round(dz) equal ``bwd_core_reference``'s over the valid
    rows, and the summed db and dq partials its summed ones (the blocks
    differ: T3 writes a partial per article); the forward equals
    ``news_encoder_reference``."""
    args = _inputs(3, n, t, din, heads, head_dim, a)
    d, seed = heads * head_dim, (7 << 40) + 11
    x = torch.from_numpy(args[0]).to(cdt)
    ws = [torch.from_numpy(v) for v in args[1:]]
    emb_keep = 0.8 if cdt == torch.float32 else 1.0  # bf16 draws stream 0 on the card only
    kw = dict(num_heads=heads, compute_dtype=cdt, n_valid=nv, keep_prob=0.8,
              emb_keep_prob=emb_keep, rng_seed=seed)
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    drop = port.dropout_config(n, t, d, 0.8, emb_keep, seed)
    xin, _, drop_in = port.kernel_input(x, nv, drop)
    out = port.tiled_forward(xin, packed, nv, drop_in, n=n, t=t)
    ref = port.news_encoder_reference(x, *ws, **kw)
    # fp32: the summation order; bf16: a probability's rounding flipped by the plain versions'
    # two softmax forms (exp2 with the row's statistics against torch.softmax)
    tol = (lambda r: 1e-6) if cdt == torch.float32 else (lambda r: 1e-2 * r.abs().max().item())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol(ref))
    g = torch.from_numpy(np.sin(np.arange(n * d, dtype=np.float32).reshape(n, d)))
    g[nv:] = 0
    got = port.tiled_bwd_core(xin, packed, g, nv, drop_in, n=n, t=t)
    xc = _masked(xin, seed, emb_keep, nv * t) if drop_in.thr_emb else xin
    want = port.bwd_core_reference(xc, packed, g, t=t, nv=nv, drop=drop_in._replace(thr_emb=0),
                                   seed=seed, keep_prob=0.8)
    rows = nv * t
    for name, u, r in zip(("dqkv", "o_c", "dz_c"), got[:3], want[:3]):
        assert u.dtype == r.dtype and u.shape[1] == r.shape[1], name
        torch.testing.assert_close(u[:rows].float(), r.float(), rtol=0, atol=tol(r.float()),
                                   msg=name)
        assert not u[rows:].float().any(), name
    a_ = packed.b_att.shape[0]
    for name, u, r in zip(("db", "dq"), got[3:], want[3:]):
        torch.testing.assert_close(u[:nv, :a_].sum(0), r.sum(0), rtol=0, atol=tol(r), msg=name)


def _masked(xin, seed, keep, rows):
    """fp32 x as the per-block kernel takes it: the stream-0 mask applied
    (K2's plain version takes x with its mask drawn)."""
    from ebnerd_tpu_torch.ops import philox

    out = xin.clone()
    out[:rows] *= philox.mask(seed, philox.STREAM_EMB, rows, xin.shape[1], keep)
    return out


@pytest.mark.parametrize("heads,head_dim", [(3, 80), (2, 86), (1, 128), (3, 128), (2, 256)])
def test_pack_qkv_holds_heads_past_85_columns(heads, head_dim):
    """A head whose Q, K and V pass 256 columns gets a panel of its own,
    ceil(3 * head_dim / 64) * 64 wide (P rounded up to 256); ``unpack_qkv``
    inverts the packing, and each head's slices sit where T1's panels put
    them."""
    rng = np.random.default_rng(9)
    d = heads * head_dim
    ws = [torch.from_numpy(rng.standard_normal((12, d), dtype=np.float32)) for _ in range(3)]
    packed, gh = port.pack_qkv(*ws, heads, torch.float32)
    lay_gh, pw, n_groups, p_cols = port.panel_layout(heads, head_dim)
    assert gh == lay_gh == (256 // (3 * head_dim) if 3 * head_dim <= 256 else 1)
    assert pw == (256 if 3 * head_dim <= 256 else -(-3 * head_dim // 64) * 64)
    assert packed.shape == (12, p_cols) and p_cols % 256 == 0 and p_cols >= n_groups * pw
    for u, w in zip(port.unpack_qkv(packed, heads, d), ws):
        torch.testing.assert_close(u, w, rtol=0, atol=0)
    for h in range(heads):
        col = (h // gh) * pw + (h % gh) * head_dim
        for i, w in enumerate(ws):
            torch.testing.assert_close(packed[:, col + i * gh * head_dim:][:, :head_dim],
                                       w[:, h * head_dim:(h + 1) * head_dim], rtol=0, atol=0)
    used = sum(3 * head_dim for _ in range(heads))
    assert int((packed != 0).any(0).sum()) == used


@pytest.mark.parametrize("t,head_dim,a,smem,expected", [
    (32, 32, 256, 0, "narrow"), (33, 32, 256, 0, "tiled"),
    (32, 33, 256, 0, "wide"), (32, 32, 257, 0, "wide"),
    (64, 64, 512, 0, "tiled"), (65, 64, 512, 0, "tiled"),
    (64, 65, 512, 0, "tiled"), (64, 64, 513, 0, "tiled"),
    (20, 20, 200, 232_448, "narrow"), (20, 20, 200, 232_449, "tiled"),
    (50, 40, 300, 232_449, "tiled"), (1, 1, 1, 0, "narrow"),
])
def test_route_at_each_boundary(t, head_dim, a, smem, expected):
    """T, head width and A at 32/33, 64/65, 256/257 and 512/513 (A padded to
    16, as the kernels take it), and a block past the card's 232,448 B of
    shared memory: the narrow instance keeps every shape it took, the wide
    one those at T <= 32, and the rest (every T past 32) takes the tiled
    route."""
    assert port.route(t, head_dim, -(-a // 16) * 16, smem) == expected


@pytest.mark.parametrize("t,head_dim,a,smem,expected", [
    (33, 32, 256, 0, "wide"), (50, 20, 200, 0, "wide"), (64, 64, 512, 0, "wide"),
    (65, 64, 512, 0, "tiled"), (64, 65, 512, 0, "tiled"), (64, 64, 513, 0, "tiled"),
    (50, 40, 300, 232_449, "tiled"), (20, 20, 200, 0, "narrow"), (32, 64, 300, 0, "wide"),
])
def test_route_instance_override_keeps_the_wide_domain(t, head_dim, a, smem, expected):
    """``instance`` (the checks' and timing tools' override) gives T 33-64
    back to the wide instance within its limits (T, head width <= 64, A <=
    512, a block within the shared memory); past them the tiled route, and
    at T <= 32 the rule's own answer."""
    assert port.route(t, head_dim, -(-a // 16) * 16, smem, instance=True) == expected
    assert port.route(t, head_dim, -(-a // 16) * 16, smem) == (
        expected if t <= 32 or expected == "tiled" else "tiled")


@pytest.mark.parametrize("t,head_dim,dtype,backward,expected", [
    (112, 20, torch.bfloat16, False, "staged"), (112, 20, torch.bfloat16, True, "staged"),
    (128, 20, torch.bfloat16, False, "staged"), (129, 20, torch.bfloat16, False, "streamed"),
    (128, 20, torch.bfloat16, True, "staged"), (129, 20, torch.bfloat16, True, "streamed"),
    (128, 288, torch.bfloat16, False, "staged"), (128, 290, torch.bfloat16, False, "streamed"),
    (128, 144, torch.bfloat16, True, "staged"), (128, 146, torch.bfloat16, True, "streamed"),
    (128, 144, torch.float32, False, "staged"), (128, 145, torch.float32, False, "streamed"),
    (128, 32, torch.float32, True, "staged"), (128, 33, torch.float32, True, "streamed"),
    (129, 8, torch.float32, False, "streamed"), (129, 8, torch.float32, True, "streamed"),
    (100, 176, torch.bfloat16, True, "staged"), (100, 178, torch.bfloat16, True, "streamed"),
    (100, 64, torch.float32, True, "staged"), (100, 65, torch.float32, True, "streamed"),
    (100, 21, torch.bfloat16, False, "streamed"), (100, 21, torch.float32, False, "staged"),
    (1, 1, torch.float32, True, "staged"), (100, 20, torch.bfloat16, True, "staged"),
    # past T 128: the history-200 user tower, an odd bf16 width, each dtype's widest head
    (200, 20, torch.bfloat16, False, "streamed"), (200, 20, torch.bfloat16, True, "streamed"),
    (200, 21, torch.bfloat16, False, "streamed"), (200, 21, torch.bfloat16, True, "streamed"),
    (129, 896, torch.bfloat16, False, "streamed"), (129, 898, torch.bfloat16, False, "gather"),
    (129, 576, torch.bfloat16, True, "streamed"), (129, 578, torch.bfloat16, True, "gather"),
    (200, 576, torch.bfloat16, True, "streamed"), (200, 578, torch.bfloat16, True, "gather"),
    (200, 448, torch.float32, False, "streamed"), (200, 449, torch.float32, False, "gather"),
    (200, 288, torch.float32, True, "streamed"), (200, 289, torch.float32, True, "gather"),
    (512, 288, torch.float32, True, "streamed"), (513, 288, torch.float32, True, "gather"),
    (2000, 256, torch.float32, True, "streamed"), (2000, 256, torch.bfloat16, True, "streamed"),
])
def test_attention_variant_at_each_boundary(t, head_dim, dtype, backward, expected):
    """T2's and T4's kernel: staged up to T 128 (112, 128 and 129 rounded to
    16) where the pair's tiles fit a block, at each dtype's and kernel's
    head-width limit (T 128: bf16 T2 288, T4 144; fp32 144 and 32; T 100:
    bf16 T4 176, fp32 T4 64) and the next width past it; an odd bf16 width
    (no whole 4-byte pieces for cp.async) takes the streamed kernel, an odd
    fp32 one the staged; the history-100 user tower's heads (20 of 20) take
    the staged T4. Everything past the staged kernels takes the streamed
    ones (the history-200 user tower, T 129, an odd bf16 width) up to each
    dtype's widest head: T2 896 in bf16 and 448 in fp32 at any T; T4 576
    in bf16 and 288 in fp32 to T 512, and 256 at T 2,000 in both; one width
    (or one T) past it gathers."""
    assert port.attention_variant(t, head_dim, dtype, backward) == expected


@pytest.mark.parametrize("t,d,a_pad,dtype,backward,expected", [
    (100, 400, 208, torch.bfloat16, False, "resident"), (100, 400, 208, torch.bfloat16, True,
                                                         "resident"),
    (100, 408, 208, torch.bfloat16, True, "streamed"), (100, 408, 208, torch.bfloat16, False,
                                                        "resident"),
    (100, 448, 208, torch.bfloat16, False, "resident"), (100, 456, 208, torch.bfloat16, False,
                                                         "chunked"),
    (128, 64, 64, torch.bfloat16, False, "resident"), (129, 64, 64, torch.bfloat16, False,
                                                       "streamed"),
    (128, 64, 64, torch.bfloat16, True, "resident"), (129, 64, 64, torch.bfloat16, True,
                                                      "streamed"),
    (100, 64, 256, torch.bfloat16, True, "resident"), (100, 64, 272, torch.bfloat16, True,
                                                       "chunked"),
    (100, 144, 208, torch.float32, True, "tf32x3"), (100, 152, 208, torch.float32, True,
                                                     "tf32x3"),
    (100, 144, 208, torch.float32, False, "tf32x3"), (100, 152, 208, torch.float32, False,
                                                      "tf32x3"),
    (1, 1, 16, torch.float32, True, "resident"), (50, 400, 304, torch.bfloat16, False, "chunked"),
    # the user tower's D 400 in bf16: the resident backward's last T is 112, its forward's 128
    (112, 400, 208, torch.bfloat16, True, "resident"), (113, 400, 208, torch.bfloat16, True,
                                                        "streamed"),
    (128, 400, 208, torch.bfloat16, False, "resident"), (128, 400, 208, torch.bfloat16, True,
                                                         "streamed"),
])
def test_pool_variant_at_each_boundary(t, d, a_pad, dtype, backward, expected):
    """T3's kernel: resident up to T 128 (128 and 129) and a_pad 256 (256 and
    272) where W_att and its buffers fit a block's 232,448 bytes: at the
    history-100 user tower (D 400, A 200 padded to 208) both directions in
    bf16, the backward's last D (400 in bf16, 144 in fp32) and the
    forward's (448, 144) and the next width of 8 past each, and at D 400
    the backward's last T (112) and the forward's (128); past the resident
    kernel the streamed one where its layout fits (T 129, the bf16
    backward at D 408 or T 113, fp32 D 152), else, and for wider
    attention, chunked. In fp32, D a multiple of 4 (D 144 and 152; not D
    1) takes the "tf32x3" kernels at any T and a_pad."""
    assert port.pool_variant(t, d, a_pad, dtype, backward) == expected


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("t,d,a_pad,dtype,expected", [
    # T past 128 at the user tower's D 400, A 200 (padded to 208): streamed
    (112, 400, 208, torch.bfloat16, "resident"), (129, 400, 208, torch.bfloat16, "streamed"),
    (200, 400, 208, torch.bfloat16, "streamed"), (208, 400, 208, torch.bfloat16, "streamed"),
    (512, 400, 208, torch.bfloat16, "streamed"), (1000, 400, 208, torch.bfloat16, "streamed"),
    # a_pad 256 and 272 at T 200
    (200, 64, 256, torch.bfloat16, "streamed"), (200, 64, 272, torch.bfloat16, "chunked"),
    (200, 64, 256, torch.float32, "tf32x3"), (200, 64, 272, torch.float32, "tf32x3"),
    # the widest D at T 200, A 208: bf16 416 (the backward's last), 432 (the forward's), fp32 176
    (200, 416, 208, torch.bfloat16, "streamed"), (200, 440, 208, torch.bfloat16, "chunked"),
    (200, 176, 208, torch.float32, "tf32x3"), (200, 184, 208, torch.float32, "tf32x3"),
])
def test_pool_variant_past_the_resident_kernel(t, d, a_pad, dtype, expected, backward):
    """T3 past the resident kernel: the streamed kernel at every T past 128
    (129, 200, 208, 512 and 1,000 at the user tower's D 400) with a_pad up
    to 256 where its layout fits (W_att, two 128-row chunks of round(o),
    the article's [T16] arrays): at T 200 and A 200 the widest D is 416 in
    the bf16 backward, 432 in its forward and 176 in fp32; a_pad 272 and the
    next D past each take the chunked kernel. fp32's rows (D a multiple of
    4) take the "tf32x3" kernels."""
    assert port.pool_variant(t, d, a_pad, dtype, backward) == expected


@pytest.mark.parametrize("t,d,dtype,backward,last", [
    (200, 416, torch.bfloat16, True, True), (200, 424, torch.bfloat16, True, False),
    (200, 432, torch.bfloat16, False, True), (200, 440, torch.bfloat16, False, False),
    (200, 176, torch.float32, True, True), (200, 184, torch.float32, True, False),
    (200, 176, torch.float32, False, True), (200, 184, torch.float32, False, False),
    (1168, 400, torch.bfloat16, True, True), (1169, 400, torch.bfloat16, True, False),
])
def test_pool_variant_streamed_plan_limits(t, d, dtype, backward, last):
    """The streamed plan's limits at A 200 (a_pad 208): each dtype's and
    direction's last D at T 200 streamed and the next width of 8 chunked
    (bf16 416 backward, 432 forward; fp32 176), and the bf16 backward's
    last T at D 400 (1,168; 1,169 rounds up to 1,184 rows of the [T16]
    arrays). fp32's rows, D a multiple of 4, take the "tf32x3" kernels
    either side; the streamed plan's fp32 limit stays ``pool_plan_variant``'s."""
    want = "streamed" if last else "chunked"
    if dtype == torch.float32:
        assert port.pool_plan_variant(t, d, 208, dtype, backward) == want
        want = "tf32x3"
    assert port.pool_variant(t, d, 208, dtype, backward) == want


@pytest.mark.parametrize("din,dtype,expected", [
    (400, torch.bfloat16, "tma"), (512, torch.bfloat16, "tma"), (520, torch.bfloat16, "tma"),
    (8, torch.bfloat16, "tma"), (400, torch.float32, "tf32x3"), (4, torch.float32, "tf32x3"),
])
def test_qkv_variant_by_dtype(din, dtype, expected):
    """T1's kernel: "tma" for every bf16 shape (x held once up to Din 512,
    streamed past it: 512 and 520), the 3xTF32 GEMM core in fp32 (the
    "panel" kernel stays for timing only)."""
    assert port.qkv_variant(dtype) == expected
    assert din % (16 // torch.tensor([], dtype=dtype).element_size()) == 0


@pytest.mark.parametrize("history", [100, 200])
def test_fused_nrms_at_history_100_matches_jax(history):
    """NRMS with the fused encoder at history 100 and 200 (the user tower
    past the wide instance: the tiled route on the card, with T2 and T4
    staged at 100 and streamed at 200), bridged weights: the port's logits
    and every parameter's gradient under sum(logits * c) equal the JAX
    fused NRMS's, its kernels run in interpret mode (logits to 1e-5,
    gradients to 5e-5)."""
    b, k, t, vocab, emb = 2, 3, 6, 90, 16
    hp = dict(title_size=t, history_size=history, head_num=2, head_dim=8,
              attention_hidden_dim=12)
    rng = np.random.default_rng(6)
    hist = rng.integers(0, vocab, (b, history, t)).astype(np.int32)
    hist[0, :9] = 0  # padded history slots
    cand = rng.integers(1, vocab, (b, k, t)).astype(np.int32)
    batch = {"hist_tokens": hist, "cand_tokens": cand}
    jbatch = {key: jnp.asarray(v) for key, v in batch.items()}
    jmodel = JaxNRMS(JaxHP(**hp), vocab_size=vocab, word_emb_dim=emb, use_fused_encoder=True,
                     fused_interpret=True)
    params = jmodel.init(jax.random.PRNGKey(2), jbatch)["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    for tower in ("news_pool", "user_pool"):
        params[tower]["b"] = rng.standard_normal(params[tower]["b"].shape).astype(np.float32) * 0.1
    c = rng.standard_normal((b, k)).astype(np.float32)
    loss = lambda p: jnp.sum(jmodel.apply({"params": p}, jbatch, False) * c)
    ref = np.asarray(jmodel.apply({"params": params}, jbatch, False))
    jgrads = nrms_state_dict(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    model = NRMS(HParamsNRMS(**hp), vocab_size=vocab, word_emb_dim=emb, use_fused_encoder=True,
                 device="cpu")
    model = load_nrms_params(model, params)
    out = model({key: torch.from_numpy(v).long() for key, v in batch.items()})
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    (out * torch.from_numpy(c)).sum().backward()
    grads = dict(model.named_parameters())
    assert set(grads) == set(jgrads)
    for key, r in jgrads.items():
        np.testing.assert_allclose(grads[key].grad.numpy(), r.numpy(), atol=GRAD_ATOL,
                                   err_msg=key)


def test_tiled_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors each of T1-T4's wrappers is its plain version and
    counts no launch."""
    n, t, heads = 2, 70, 2
    args = _inputs(4, n, t, 16, heads, 8, 16)
    packed = port.pack_weights(*map(torch.from_numpy, args[1:]), num_heads=heads,
                               compute_dtype=torch.float32)
    fns = (port.tiled_qkv, port.tiled_attention, port.tiled_pool, port.tiled_pool_bwd,
           port.tiled_attention_bwd)
    before = [f.launches for f in fns]
    x = torch.from_numpy(args[0]).reshape(n * t, 16)
    qkv = port.tiled_qkv(x, packed, port.Dropout(), n=n, t=t, nv=n)
    torch.testing.assert_close(qkv, port.tiled_qkv_reference(x, packed, port.Dropout(), n=n, t=t,
                                                             nv=n), rtol=0, atol=0)
    o, stats = port.tiled_attention(qkv, packed, port.Dropout(), n=n, t=t, nv=n)
    assert stats is None and o.shape == (n * t, heads * 8) and o.dtype == torch.float32
    oc, stats = port.tiled_attention(qkv, packed, port.Dropout(), n=n, t=t, nv=n, backward=True)
    assert stats.shape == (2, n * t, heads) and oc.shape == (n * t, port.o_width(heads * 8))
    assert port.tiled_pool(o, packed, n=n, t=t, nv=n).shape == (n, heads * 8)
    g = torch.ones(n, heads * 8)
    do = port.tiled_pool_bwd(oc, packed, g, port.Dropout(), n=n, t=t, nv=n)[0]
    assert port.tiled_attention_bwd(qkv, do, stats, packed, n=n, t=t, nv=n).shape == qkv.shape
    assert [f.launches for f in fns] == before
