"""The fused encoder at a Din that is not a whole 16 bytes (300 and 36 in
bf16, 30 in fp32: the CLI's 300-wide word table, any odd pretrained width).
The kernels take x padded on their side: zero columns of x and zero rows of
the packed Wqkv up to ``padded_din``, dx and dWqkv cut back to Din. Here
the plain version on the padded operands is bit-equal to it on the
unpadded ones, forward and backward; the stream-0 mask's first Din
columns do not depend on the padded width; and the CUDA wrappers' data
flow (``NewsEncoderFunction`` with each kernel replaced by its plain
version) pads, cuts back and equals the JAX package's kernel, run in
interpret mode, at Din 300."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.ops.news_encoder import fused_news_encoder as jax_fused
from ebnerd_tpu.ops.news_encoder import news_encoder as jax_news_encoder
from ebnerd_tpu_torch.ops import news_encoder as port
from ebnerd_tpu_torch.ops import philox

torch.set_num_threads(1)

SEED = (0x5EED << 32) | 0x1234ABCD
KEEP = 0.8
NAMES = ("x", "wq", "wk", "wv", "w_att", "b_att", "q_att")


def _inputs(seed, n, t, din, heads, head_dim, a, dyadic=False):
    """x [N, T, Din] and the weights as numpy fp32. ``dyadic``: multiples
    of 2**-6 and 2**-10 of small integers, so that every QKV product and
    its partial sums are exact in fp32 whatever the summation order."""
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    if dyadic:
        x = rng.integers(-64, 65, (n, t, din)).astype(np.float32) / 64
        mk = lambda *s: rng.integers(-64, 65, s).astype(np.float32) / 1024
    else:
        x = rng.standard_normal((n, t, din), dtype=np.float32)
        mk = lambda *s: rng.standard_normal(s, dtype=np.float32) * 0.05
    return x, [mk(din, d), mk(din, d), mk(din, d), mk(d, a), mk(a), mk(a, 1)]


def test_padded_din_is_a_whole_16_bytes():
    assert port.padded_din(300, torch.bfloat16) == 304
    assert port.padded_din(300, torch.float32) == 300
    assert port.padded_din(30, torch.float32) == 32
    assert port.padded_din(1024, torch.bfloat16) == 1024
    assert port.padded_din(36, torch.bfloat16) == 40


@pytest.mark.parametrize("din,dtype", [(300, torch.bfloat16), (36, torch.bfloat16),
                                       (30, torch.float32)])
def test_pack_weights_pads_wqkv_with_zero_rows(din, dtype):
    x, ws = _inputs(0, 2, 12, din, 4, 16, 32)
    packed = port.pack_weights(*map(torch.from_numpy, ws), num_heads=4, compute_dtype=dtype)
    width = port.padded_din(din, dtype)
    assert packed.din == din and packed.wqkv.shape[0] == width
    assert (packed.wqkv[din:] == 0).all()
    for w, u in zip(ws, port.unpack_qkv(packed.wqkv, 4, 64)):
        assert torch.equal(u[:din], torch.from_numpy(w).to(dtype))


@pytest.mark.parametrize("din,dtype", [(300, torch.bfloat16), (36, torch.bfloat16),
                                       (300, torch.float32), (30, torch.float32)])
@pytest.mark.parametrize("dropout", [False, True])
def test_plain_version_on_padded_operands_is_bit_equal(din, dtype, dropout):
    n, t, heads, head_dim, a, nv = 5, 12, 4, 16, 32, 4
    width = port.padded_din(din, dtype) if din % 8 else din + 8
    x, ws = _inputs(1, n, t, din, heads, head_dim, a, dyadic=True)
    kw = dict(num_heads=heads, compute_dtype=dtype, n_valid=nv)
    if dropout:
        kw.update(keep_prob=KEEP, emb_keep_prob=KEEP, rng_seed=SEED)
    cot = torch.from_numpy(np.cos(np.arange(n * heads * head_dim, dtype=np.float32) * 0.1)
                           .reshape(n, -1))

    def run(xv, wv):
        ins = [torch.from_numpy(np.ascontiguousarray(xv)).to(dtype).requires_grad_(True)]
        ins += [torch.from_numpy(np.ascontiguousarray(w)).requires_grad_(True) for w in wv]
        out = port.news_encoder(*ins, **kw)
        (out * cot).sum().backward()
        return out.detach(), [v.grad for v in ins]

    out, grads = run(x, ws)
    xp = np.pad(x, ((0, 0), (0, 0), (0, width - din)))
    wp = [np.pad(w, ((0, width - din), (0, 0))) for w in ws[:3]] + ws[3:]
    out_p, grads_p = run(xp, wp)
    assert torch.equal(out, out_p)
    cut = [grads_p[0][..., :din]] + [g[:din] for g in grads_p[1:4]] + grads_p[4:]
    for name, g, gp in zip(NAMES, grads, cut):
        assert torch.equal(g, gp), name


@pytest.mark.parametrize("rows,din,width", [(37, 300, 304), (5, 36, 40), (12, 30, 32)])
def test_mask_of_the_first_din_columns_does_not_depend_on_the_width(rows, din, width):
    m = philox.mask(SEED, philox.STREAM_EMB, rows, din, KEEP)
    mp = philox.mask(SEED, philox.STREAM_EMB, rows, width, KEEP)
    assert torch.equal(mp[:, :din], m)
    x = torch.randn(rows, din, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    xm, keep = port.emb_mask_reference(rows, din, SEED, KEEP, x=x)
    xmp, keep_p = port.emb_mask_reference(rows, width, SEED, KEEP, x=x)
    assert xmp.shape == (rows, width) and torch.equal(xmp[:, :din], xm)
    assert (xmp[:, din:] == 0).all()
    bits = lambda k, w: ((k.to(torch.int64)[:, :, None] >> torch.arange(32)) & 1) \
        .reshape(k.shape[0], -1)[:, :w]
    assert torch.equal(bits(keep_p, width)[:, :din], bits(keep, din))


def _plain_kernels(monkeypatch, seen):
    """Replace every kernel the wrappers launch by its plain version, so that
    ``NewsEncoderFunction`` runs on CPU tensors with the CUDA path's data
    flow: ``kernel_input``'s padding, the packed weights and the backward's
    cut back to Din. ``seen`` records the operands the kernels receive."""

    def fake_mask(rows, width, drop, *, device, x=None, valid=None):
        seen.setdefault("mask", []).append((rows, width, None if x is None else x.shape[1]))
        return port.emb_mask_reference(rows, width, SEED, KEEP, x=x)

    def fake_launch(lib, xin, packed, nv, drop, *, n, t, nv_dev=None):
        seen.setdefault("launch", []).append((tuple(xin.shape), tuple(packed.wqkv.shape)))
        width, d = xin.shape[1], packed.w_att.shape[0]
        a = packed.b_att.shape[0]
        xfull = xin.new_zeros(n * t, width)
        xfull[:xin.shape[0]] = xin[:n * t]
        wq, wk, wv = port.unpack_qkv(packed.wqkv, packed.num_heads, d)
        return port.news_encoder_reference(
            xfull.reshape(n, t, width), wq.float(), wk.float(), wv.float(),
            packed.w_att[:, :a].float(), packed.b_att, packed.q_att.reshape(-1, 1),
            num_heads=packed.num_heads, compute_dtype=packed.wqkv.dtype, n_valid=nv,
            keep_prob=KEEP if drop.thr_att else 1.0,
            emb_keep_prob=KEEP if drop.thr_emb else 1.0,
            rng_seed=SEED if drop.thr_att or drop.thr_emb else None)

    def fake_core(lib, x, packed, g, nv, drop, *, n, t, nv_dev=None):
        seen.setdefault("core", []).append(tuple(x.shape))
        if drop.thr_emb:  # fp32: the kernel draws the stream-0 mask itself
            x = x * philox.mask(SEED, philox.STREAM_EMB, x.shape[0], x.shape[1], KEEP)
            drop = drop._replace(thr_emb=0)
        qkv, o_c, dz_c, db_part, dq_part = port.bwd_core_reference(
            x, packed, g, t=t, nv=nv, drop=drop, seed=SEED, keep_prob=KEEP)
        full = lambda v: torch.cat([v, v.new_zeros(n * t - v.shape[0], v.shape[1])])
        pad_a = lambda v: torch.nn.functional.pad(v, (0, packed.w_att.shape[1] - v.shape[1]))
        return full(qkv), full(o_c), full(dz_c), pad_a(db_part), pad_a(dq_part)

    def fake_gemm(a, b, *, dx, rows, drop=port.Dropout(), splits=1, keep=None, valid=None):
        out = port.bwd_gemm_reference(a, b, dx=dx, rows=rows, drop=drop, seed=SEED,
                                      emb_keep=KEEP)
        return out if dx else out[None]

    monkeypatch.setattr(port, "emb_mask", fake_mask)
    monkeypatch.setattr(port, "launch", fake_launch)
    monkeypatch.setattr(port, "launch_bwd_core", fake_core)
    monkeypatch.setattr(port, "bwd_gemm", fake_gemm)
    monkeypatch.setattr(port, "reduce_rows", lambda part: part.reshape(part.shape[0], -1).sum(0))
    monkeypatch.setattr(port, "_library", lambda: None)
    monkeypatch.setattr(port, "_library_bwd", lambda: None)
    monkeypatch.setattr(port, "_packed_for", lambda x, weights, packed, heads, cdt:
                        port.pack_weights(*weights, num_heads=heads, compute_dtype=cdt))


def _route(x, ws, cot, heads, dtype, nv=None, dropout=False):
    """Output and gradients of ``NewsEncoderFunction`` under sum(out * cot)."""
    ins = [torch.from_numpy(x).to(dtype).requires_grad_(True)]
    ins += [torch.from_numpy(w).requires_grad_(True) for w in ws]
    keep = KEEP if dropout else 1.0
    out = port.NewsEncoderFunction.apply(*ins, None, heads, dtype, nv, keep, keep,
                                         SEED if dropout else None, None)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), [v.grad for v in ins]


@pytest.mark.parametrize("dtype,dropout", [(torch.float32, False), (torch.float32, True),
                                           (torch.bfloat16, True), (torch.bfloat16, False)])
def test_wrapper_route_pads_and_cuts_back(monkeypatch, dtype, dropout):
    """At Din 300 the kernels get x and Wqkv 304 wide in bf16 (the x mask
    drawn into the padded width, no other copy), 300 in fp32; dx and the
    weight gradients come back at Din and equal autograd of the plain
    version on the unpadded operands (fp32 to 5e-5, bf16 to 2e-2 of each
    tensor's scale)."""
    n, t, din, heads, head_dim, a, nv = 6, 12, 300, 4, 16, 32, 5
    x, ws = _inputs(2, n, t, din, heads, head_dim, a)
    cot = np.cos(np.arange(n * heads * head_dim, dtype=np.float32).reshape(n, -1) * 0.1)
    seen = {}
    _plain_kernels(monkeypatch, seen)
    out, grads = _route(x, ws, cot, heads, dtype, nv, dropout)
    width = port.padded_din(din, dtype)
    k1_x, k1_w = seen["launch"][0]
    assert k1_x[1] == width and k1_w[0] == width and seen["core"][0][1] == width
    if dtype == torch.bfloat16 and dropout:
        assert seen["mask"] == [(nv * t, width, din)]
    else:
        assert "mask" not in seen
    keep = KEEP if dropout else 1.0
    ref_out = port.news_encoder_reference(
        torch.from_numpy(x).to(dtype), *map(torch.from_numpy, ws), num_heads=heads,
        compute_dtype=dtype, n_valid=nv, keep_prob=keep, emb_keep_prob=keep,
        rng_seed=SEED if dropout else None)
    ref = port.news_encoder_bwd_reference(
        torch.from_numpy(x).to(dtype), *map(torch.from_numpy, ws), torch.from_numpy(cot),
        num_heads=heads, compute_dtype=dtype, n_valid=nv, keep_prob=keep, emb_keep_prob=keep,
        rng_seed=SEED if dropout else None)
    fp32 = dtype == torch.float32
    assert torch.allclose(out, ref_out, atol=3e-5) if fp32 else \
        (out - ref_out).abs().max() <= 2e-2 * ref_out.abs().max()
    for name, g, r in zip(NAMES, grads, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        err = (g.float() - r.float()).abs().max().item()
        scale = max(r.float().abs().max().item(), ref[4].abs().max().item())
        assert err <= (5e-5 if fp32 else 2e-2 * scale), (name, err, scale)


@pytest.mark.parametrize("din", [300, 30])
def test_wrapper_route_matches_jax_kernel(monkeypatch, din):
    """The CUDA path's data flow in fp32 (plain kernels) at Din 300 and at
    Din 30 (padded to 32) equals the JAX custom VJP, whose forward and
    backward are the Pallas kernels run in interpret mode: outputs to 3e-5,
    gradients to 5e-5."""
    n, t, heads, head_dim, a, block = 6, 12, 4, 16, 32, 2
    x, ws = _inputs(3, n, t, din, heads, head_dim, a)
    cot = np.cos(np.arange(n * heads * head_dim, dtype=np.float32).reshape(n, -1) * 0.1)
    jargs = [jnp.asarray(v) for v in [x] + ws]
    ones = jnp.ones((8, 128), jnp.float32)
    tail = (ones, None, heads, block, True)
    kern = np.asarray(jax_fused(*jargs, num_heads=heads, block_n=block, interpret=True))
    loss = lambda *a_: jnp.sum(jax_news_encoder(*a_, *tail) * cot)
    jgrads = jax.grad(loss, argnums=tuple(range(7)))(*jargs)
    seen = {}
    _plain_kernels(monkeypatch, seen)
    out, grads = _route(x, ws, cot, heads, torch.float32)
    np.testing.assert_allclose(out.numpy(), kern, atol=3e-5)
    assert seen["launch"][0][0][1] == port.padded_din(din, torch.float32)
    for name, g, r in zip(NAMES, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5, err_msg=name)
