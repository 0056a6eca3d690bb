"""The port's fused encoder in training: gradients of its plain version
(what the CUDA recompute backward is held against on the card) equal the
JAX package's custom VJP, whose backward is the Pallas kernel run in
interpret mode, in fp32 -- without dropout, with an external mask and with
``n_valid``; and the port's Philox dropout equals the JAX external-mask
path fed the same masks, as ``scripts/check_rng_dropout.py`` checks the
TPU's PRNG path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.ops.news_encoder import news_encoder as jax_news_encoder
from ebnerd_tpu_torch.ops import news_encoder as port
from ebnerd_tpu_torch.ops import philox

torch.set_num_threads(1)

GRAD_ATOL = 5e-5
NAMES = ("x", "wq", "wk", "wv", "w_att", "b_att", "q_att")


def _inputs(seed, n, t, din, heads, head_dim, a):
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    mk = lambda *s, sc=0.05: (rng.standard_normal(s, dtype=np.float32) * sc)
    return [mk(n, t, din, sc=1.0), mk(din, d), mk(din, d), mk(din, d), mk(d, a), mk(a), mk(a, 1)]


def _jax_grads(args, cot, *tail):
    """Output and grads of JAX news_encoder(*args, *tail) under sum(out * cot)."""
    jargs = [jnp.asarray(v) for v in args]
    loss = lambda *a_: jnp.sum(jax_news_encoder(*a_, *tail) * cot)
    out = jax_news_encoder(*jargs, *tail)
    return np.asarray(out), [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(*jargs)]


def _port_grads(args, cot, **kw):
    ins = [torch.from_numpy(v).requires_grad_(True) for v in args]
    out = port.news_encoder(*ins, **kw)
    (out * torch.from_numpy(np.asarray(cot))).sum().backward()
    return out.detach().numpy(), [v.grad.numpy() for v in ins]


@pytest.mark.parametrize("n,t,din,heads,head_dim,a,block", [
    (10, 12, 64, 4, 16, 32, 4),      # tests/ops/test_news_encoder.py custom-VJP shape
    (10, 30, 256, 4, 32, 64, 4),     # uneven N vs block
    (8, 30, 128, 20, 20, 200, 8),    # NRMS head geometry (20 x 20)
    (5, 12, 64, 2, 16, 32, 2),
    (5, 50, 64, 2, 32, 300, 5),      # T 50 (history 50), A 300: the kernels' wide instance
    (3, 33, 128, 2, 64, 300, 3),     # T 33, head width 64, A 300
])
def test_grads_match_jax_kernel(n, t, din, heads, head_dim, a, block):
    args = _inputs(0, n, t, din, heads, head_dim, a)
    cot = np.cos(np.arange(n * heads * head_dim, dtype=np.float32).reshape(n, -1) * 0.1)
    ones = jnp.ones((8, 128), jnp.float32)
    ref_out, ref = _jax_grads(args, cot, ones, None, heads, block, True)
    out, grads = _port_grads(args, cot, num_heads=heads)
    np.testing.assert_allclose(out, ref_out, atol=3e-5)
    for name, g, r in zip(NAMES, grads, ref):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, err_msg=name)


def test_grads_with_external_mask_match_jax_kernel():
    n, t, din, heads, head_dim, a, keep = 6, 10, 64, 4, 16, 32, 0.8
    args = _inputs(3, n, t, din, heads, head_dim, a)
    mask = (np.random.default_rng(4).random((n, t, heads * head_dim)) < keep).astype(np.float32)
    cot = np.sin(np.arange(n * heads * head_dim, dtype=np.float32).reshape(n, -1))
    ref_out, ref = _jax_grads(args, cot, jnp.asarray(mask), None, heads, 2, True, keep)
    out, grads = _port_grads(args, cot, num_heads=heads, keep_prob=keep,
                             drop_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out, ref_out, atol=3e-5)
    for name, g, r in zip(NAMES, grads, ref):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("nv", [13, 16])
def test_n_valid_grads_match_full_compute_and_jax(nv):
    """With the cotangent zero on pad rows (no slot reads them), the grads
    with n_valid equal the full computation's and the JAX kernel's; dx past
    n_valid is exactly 0."""
    n, t, din, heads, head_dim, a, bn = 24, 6, 16, 2, 4, 4, 4
    args = _inputs(5, n, t, din, heads, head_dim, a)
    cot = np.random.default_rng(6).standard_normal((n, heads * head_dim)).astype(np.float32)
    cot[nv:] = 0.0
    ones = jnp.ones((8, 128), jnp.float32)
    _, ref = _jax_grads(args, cot, ones, None, heads, bn, True, 1.0, "float32", 1.0,
                        jnp.asarray([nv], jnp.int32))
    _, full = _port_grads(args, cot, num_heads=heads)
    out, grads = _port_grads(args, cot, num_heads=heads, n_valid=nv)
    assert (out[nv:] == 0).all() and (grads[0][nv:] == 0).all()
    for name, g, f, r in zip(NAMES, grads, full, ref):
        np.testing.assert_allclose(g, f, rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("emb_keep", [1.0, 0.8])
def test_rng_dropout_matches_jax_external_mask_path(emb_keep):
    """The port's Philox path (keep 0.8 on the attention output, emb_keep
    on x) equals the JAX external-mask path fed the port's dumped stream-1
    0/1 mask and x pre-masked with the dumped stream-0 mask: outputs and
    all grads, dx through the chain rule."""
    n, t, din, heads, head_dim, a, keep, seed = 16, 30, 128, 4, 16, 32, 0.8, (3 << 40) + 123
    d = heads * head_dim
    args = _inputs(7, n, t, din, heads, head_dim, a)
    m1 = philox.dump_masks(seed, philox.STREAM_ATT, n * t, d, keep, device="cpu").numpy()
    m0 = philox.dump_masks(seed, philox.STREAM_EMB, n * t, din, 0.8, device="cpu").numpy()
    m0 = m0.reshape(n, t, din) if emb_keep < 1.0 else np.ones((n, t, din), np.float32)
    cot = np.cos(np.arange(n * d, dtype=np.float32).reshape(n, d) * 0.01)
    ext = jnp.asarray((m1 > 0).astype(np.float32).reshape(n, t, d))
    ref_out, ref = _jax_grads([args[0] * m0] + args[1:], cot, ext, None, heads, 8, True, keep)
    out, grads = _port_grads(args, cot, num_heads=heads, keep_prob=keep, emb_keep_prob=emb_keep,
                             rng_seed=seed)
    np.testing.assert_allclose(out, ref_out, atol=3e-5)
    np.testing.assert_allclose(grads[0], ref[0] * m0, atol=GRAD_ATOL, err_msg="x")
    for name, g, r in zip(NAMES[1:], grads[1:], ref[1:]):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, err_msg=name)


def test_bwd_wrapper_on_the_cpu_is_autograd_of_the_plain_version():
    args = [torch.from_numpy(v) for v in _inputs(8, 4, 6, 16, 2, 4, 8)]
    g = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    kw = dict(num_heads=2, keep_prob=0.8, emb_keep_prob=0.8, rng_seed=17)
    before = port.fused_news_encoder_bwd.launches
    grads = port.fused_news_encoder_bwd(*args, g, **kw)
    ref = port.news_encoder_bwd_reference(*args, g, **kw)
    assert port.fused_news_encoder_bwd.launches == before
    for a_, r in zip(grads, ref):
        assert torch.equal(a_, r)
    assert grads[0].shape == args[0].shape and grads[6].shape == (8, 1)


@pytest.mark.parametrize("heads,head_dim", [(20, 20), (6, 20), (2, 16)])
def test_unpack_qkv_inverts_pack_qkv(heads, head_dim):
    rng = np.random.default_rng(9)
    ws = [torch.from_numpy(rng.standard_normal((12, heads * head_dim), dtype=np.float32))
          for _ in range(3)]
    packed, _ = port.pack_qkv(*ws, heads, torch.float32)
    for u, w in zip(port.unpack_qkv(packed, heads, heads * head_dim), ws):
        assert torch.equal(u, w)


def test_dropout_arguments_are_checked():
    cfg = port.dropout_config(2, 3, 8, keep_prob=0.8, emb_keep_prob=0.9, rng_seed=5)
    assert cfg.thr_att == philox.threshold(0.8) and cfg.thr_emb == philox.threshold(0.9)
    assert cfg.ext_mask is None
    # a mask at keep 1 is ignored, as in the JAX package
    assert port.dropout_config(2, 3, 8, drop_mask=torch.ones(2, 3, 8)) == port.Dropout()
    with pytest.raises(ValueError, match="rng_seed"):
        port.dropout_config(2, 3, 8, emb_keep_prob=0.8)
    with pytest.raises(ValueError, match="drop_mask or rng_seed"):
        port.dropout_config(2, 3, 8, keep_prob=0.8)
    with pytest.raises(ValueError, match=r"\[2, 3, 8\]"):
        port.dropout_config(2, 3, 8, keep_prob=0.8, drop_mask=torch.ones(2, 8))


@pytest.mark.parametrize("n,t,din,heads,head_dim,a,block,nv", [
    (5, 50, 64, 2, 32, 300, 5, 5),   # one article per 64-row block
    (3, 33, 128, 2, 64, 300, 3, 2),  # head width 64; n_valid inside the last block
    (6, 64, 32, 4, 16, 512, 2, 6),   # T 64 fills a block; A 512: two pooling chunks
])
def test_bwd_core_reference_in_the_wide_domain_matches_jax(n, t, din, heads, head_dim, a,
                                                           block, nv):
    """K2's per-block plain version at the wide instance's shapes: its
    outputs, put together as the GEMMs and reductions do (dx = dQKV
    Wqkv^T, dWqkv = x^T dQKV, dW = round(o)^T round(dz), db and dq the sums
    of the per-block partials, one block per article past T 32), equal the
    JAX custom VJP's gradients (Pallas backward in interpret mode): 5e-5."""
    args = _inputs(11, n, t, din, heads, head_dim, a)
    d = heads * head_dim
    cot = np.cos(np.arange(n * d, dtype=np.float32).reshape(n, d) * 0.1)
    cot[nv:] = 0.0
    ones = jnp.ones((8, 128), jnp.float32)
    _, ref = _jax_grads(args, cot, ones, None, heads, block, True, 1.0, "float32", 1.0,
                        jnp.asarray([nv], jnp.int32))
    ws = [torch.from_numpy(v) for v in args[1:]]
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=torch.float32)
    x2 = torch.from_numpy(args[0]).reshape(n * t, din)
    dqkv, o_c, dz_c, db_part, dq_part = port.bwd_core_reference(
        x2, packed, torch.from_numpy(cot), t=t, nv=nv, drop=port.Dropout())
    rows = nv * t
    assert db_part.shape == (-(-nv // port.articles_per_block(t)), a)
    assert o_c.shape == (rows, port.o_width(d)) and dz_c.shape == (rows, packed.w_att.shape[1])
    dx = torch.zeros(n * t, din)
    dx[:rows] = dqkv @ packed.wqkv.T
    dwq, dwk, dwv = port.unpack_qkv(x2[:rows].T @ dqkv, heads, d)
    dw = (o_c.T @ dz_c[:, :a])[:d]
    got = (dx.reshape(n, t, din), dwq, dwk, dwv, dw, db_part.sum(0), dq_part.sum(0).reshape(a, 1))
    for name, u, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(u.numpy(), r, atol=GRAD_ATOL, err_msg=name)
