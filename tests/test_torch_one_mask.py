"""The fused encoder's embedding mask drawn once per call: the plain
version run on round(x * mask) (``emb_mask_reference``, the plain version
of the mask kernel) with the embedding dropout off equals the plain
version with it on, bit for bit, forward and backward (weight gradients,
and dx through the keep mask), in bf16 and fp32; ``NewsEncoderFunction``
draws the mask once, runs K1 on the masked x without stream 0 and keeps
the masked x and the keep bits for K2, not x; and the bf16 QKV stage's
plan (ring depth, cluster size) depends on the shapes alone."""
import numpy as np
import pytest
import torch

from ebnerd_tpu_torch.ops import _build
from ebnerd_tpu_torch.ops import news_encoder as port
from ebnerd_tpu_torch.ops import philox
from ebnerd_tpu_torch.tools import kernel_phases

torch.set_num_threads(1)

SEED = (0x5EED << 32) | 0x1234ABCD
KEEP = 0.8
NAMES = ("x", "wq", "wk", "wv", "w_att", "b_att", "q_att")


def _inputs(seed, n, t, din, heads, head_dim, a, dtype):
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    mk = lambda *s, sc=0.05: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * sc)
    x = mk(n, t, din, sc=1.0).to(dtype)
    return x, [mk(din, d), mk(din, d), mk(din, d), mk(d, a), mk(a), mk(a, 1)]


def _masked_x(x, nv):
    """round(x * mask) of the nv valid articles (the plain mask kernel), as
    [N, T, Din] with zero rows past them, and the fp32 mask."""
    n, t, din = x.shape
    xm, keep = port.emb_mask_reference(nv * t, din, SEED, KEEP, x=x.reshape(n * t, din))
    full = torch.zeros(n * t, din, dtype=x.dtype)
    full[:nv * t] = xm
    mask = philox.mask(SEED, philox.STREAM_EMB, nv * t, din, KEEP)
    return full.reshape(n, t, din), keep, mask


CASES = [  # n, t, din, heads, head_dim, a, n_valid
    (6, 12, 64, 4, 16, 32, None),
    (7, 20, 128, 20, 20, 200, 5),
    (5, 30, 96, 2, 16, 32, 4),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,t,din,heads,head_dim,a,n_valid", CASES)
def test_plain_forward_on_masked_x_equals_in_kernel_mask(dtype, n, t, din, heads, head_dim, a,
                                                         n_valid):
    x, ws = _inputs(0, n, t, din, heads, head_dim, a, dtype)
    nv = n if n_valid is None else n_valid
    kw = dict(num_heads=heads, compute_dtype=dtype, n_valid=n_valid, keep_prob=KEEP,
              rng_seed=SEED)
    on = port.news_encoder_reference(x, *ws, emb_keep_prob=KEEP, **kw)
    xm, _, _ = _masked_x(x, nv)
    once = port.news_encoder_reference(xm, *ws, **kw)
    assert torch.equal(on, once)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,t,din,heads,head_dim,a,n_valid", CASES)
def test_plain_backward_on_masked_x_equals_in_kernel_mask(dtype, n, t, din, heads, head_dim, a,
                                                          n_valid):
    """Weight gradients equal bit for bit; dx equals the masked x's
    gradient times the mask, rounded once to x's dtype (what the dx GEMM
    does with the keep bits)."""
    x, ws = _inputs(1, n, t, din, heads, head_dim, a, dtype)
    nv = n if n_valid is None else n_valid
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((n, heads * head_dim),
                                                                  dtype=np.float32))
    g[nv:] = 0
    kw = dict(num_heads=heads, compute_dtype=dtype, n_valid=n_valid, keep_prob=KEEP,
              rng_seed=SEED)
    on = port.news_encoder_bwd_reference(x, *ws, g, emb_keep_prob=KEEP, **kw)
    xm, keep, mask = _masked_x(x, nv)
    once = port.news_encoder_bwd_reference(xm, *ws, g, **kw)
    for name, u, v in zip(NAMES[1:], on[1:], once[1:]):
        assert torch.equal(u, v), name
    dxm = once[0].reshape(n * t, din)[:nv * t].float()
    dx = torch.zeros(n * t, din, dtype=dtype)
    dx[:nv * t] = (dxm * mask).to(dtype)
    assert torch.equal(on[0], dx.reshape(n, t, din))
    # the keep bits are the mask's nonzeros
    assert torch.equal(keep, port.pack_bits(mask > 0))


def test_kernel_input_passes_x_through_without_the_bf16_mask():
    x = torch.randn(3, 4, 16)
    drop = port.dropout_config(3, 4, 8, KEEP, KEEP, SEED)
    xin, keep, drop_in = port.kernel_input(x, 2, drop)  # fp32: its kernels draw the mask
    assert xin.shape == (12, 16) and keep is None and drop_in == drop
    att_only = port.dropout_config(3, 4, 8, KEEP, 1.0, SEED)
    xin, keep, drop_in = port.kernel_input(x.bfloat16(), 2, att_only)
    assert xin.dtype == torch.bfloat16 and keep is None and drop_in == att_only
    with pytest.raises(ValueError, match="no kernel"):  # bf16 with the mask: the CUDA mask kernel
        port.kernel_input(x.bfloat16(), 2, drop)


def test_function_draws_the_mask_once_and_keeps_it_for_the_backward(monkeypatch):
    """NewsEncoderFunction's data flow with the kernels replaced by
    recorders: one emb_mask per forward, K1 on round(x * mask) without
    stream 0, and the backward on the saved masked x and keep bits with
    the call's full dropout."""
    n, t, din, heads, head_dim, a, nv = 5, 12, 64, 4, 16, 32, 4
    x, ws = _inputs(3, n, t, din, heads, head_dim, a, torch.bfloat16)
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=torch.bfloat16)
    calls = {"mask": [], "launch": [], "backward": []}

    def fake_mask(rows, width, drop, *, device, x=None, valid=None):
        calls["mask"].append(rows)
        return port.emb_mask_reference(rows, width, SEED, KEEP, x=x)

    def fake_launch(lib, xin, packed_, nv_, drop, *, n, t, nv_dev=None):
        calls["launch"].append((xin, drop))
        return torch.zeros(n, heads * head_dim)

    def fake_backward(xin, keep, packed_, g, n_, t_, nv_, drop, nv_dev=None):
        calls["backward"].append((xin, keep, drop, (n_, t_, nv_)))
        return tuple(torch.zeros_like(v) for v in [x] + ws)

    monkeypatch.setattr(port, "emb_mask", fake_mask)
    monkeypatch.setattr(port, "launch", fake_launch)
    monkeypatch.setattr(port, "_backward", fake_backward)
    monkeypatch.setattr(port, "_library", lambda: None)
    monkeypatch.setattr(port, "_packed_for", lambda *args: packed)
    xr = x.clone().requires_grad_(True)
    out = port.NewsEncoderFunction.apply(xr, *ws, packed, heads, torch.bfloat16, nv, KEEP, KEEP,
                                         SEED, None)
    out.sum().backward()
    assert calls["mask"] == [nv * t]
    assert len(calls["launch"]) == 1  # launch counts K1 itself
    xm, _ = port.emb_mask_reference(nv * t, din, SEED, KEEP, x=x.reshape(n * t, din))
    (k1_x, k1_drop), = calls["launch"]
    assert torch.equal(k1_x, xm) and k1_drop.thr_emb == 0 and k1_drop.thr_att != 0
    (b_x, b_keep, b_drop, shape), = calls["backward"]
    assert b_x is k1_x and shape == (n, t, nv)
    assert torch.equal(b_keep, port.pack_bits(
        philox.mask(SEED, philox.STREAM_EMB, nv * t, din, KEEP) > 0))
    assert b_drop == port.dropout_config(n, t, heads * head_dim, KEEP, KEEP, SEED)


def _smem(limit_stages):
    """A stand-in for the library's shared-memory count: stages past
    ``limit_stages`` do not fit."""
    return lambda s: 200_000 if s <= limit_stages else 240_000


@pytest.mark.parametrize("n,t,din,fit,forward,expect", [
    (24_064, 30, 1_024, 3, True, (3, 2)),    # the news tower of the NRMS step, K1
    (24_064, 30, 1_024, 3, False, (3, 1)),   # the same, K2's per-block kernel
    (16_384, 20, 400, 3, True, (3, 2)),      # its user tower: 7 k-tiles
    (24_064, 30, 1_024, 2, True, (2, 2)),    # shared memory for 2 stages only
    (2, 30, 1_024, 3, True, (3, 1)),         # one block: no cluster
    (4, 30, 1_024, 3, True, (3, 2)),         # two blocks
    (16_384, 20, 400, 2, False, (2, 1)),     # K2's per-block kernel, 2 stages
    (11, 12, 64, 3, True, (1, 2)),           # one k-tile: one stage
    (11, 12, 128, 3, True, (2, 2)),          # two k-tiles: two stages
    (9, 20, 136, 3, True, (3, 2)),           # a partial third k-tile
])
def test_qkv_plan_by_shape(n, t, din, fit, forward, expect):
    assert port.qkv_plan(n, t, din, _smem(fit), forward=forward) == expect


def test_qkv_plan_depends_on_the_shapes_alone():
    for args in ((24_064, 30, 1_024), (16_384, 20, 400), (3, 20, 64)):
        for forward in (True, False):
            plans = {port.qkv_plan(*args, _smem(3), forward=forward) for _ in range(3)}
            assert len(plans) == 1
            stages, cluster = plans.pop()
            nk = -(-args[2] // 64)
            assert (2 <= stages <= min(3, nk) or stages == nk == 1) and cluster in (1, 2)


def test_backward_phase_variants_are_distinct_builds():
    plain = _build._target("news_encoder_bwd")
    variants = {_build._target("news_encoder_bwd", flags)
                for flags in kernel_phases.BWD_VARIANTS.values()}
    assert len(variants) == len(kernel_phases.BWD_VARIANTS) and plain in variants


@pytest.mark.parametrize("n,t,din,heads,head_dim,a,n_valid,dropout", [
    (6, 12, 64, 4, 16, 32, None, None),
    (7, 20, 128, 20, 20, 200, 5, "rng"),
    (5, 30, 96, 2, 16, 32, 4, "mask"),
])
def test_block_kernel_reference_chains_to_the_plain_backward(n, t, din, heads, head_dim, a,
                                                             n_valid, dropout):
    """In fp32 (no rounding), the per-block kernel's plain version, taken
    through the products that follow it (dx = dqkv Wqkv^T, dWqkv = x^T
    dqkv, dW = round(o)^T round(dz), db and dq summed over blocks), gives
    the plain backward's gradients within 2e-5 of each one's scale: its
    max, and for db and dq at least max|dW| (they sum terms that cancel
    over each article, as chip_smoke.py's scales say)."""
    x, ws = _inputs(4, n, t, din, heads, head_dim, a, torch.float32)
    nv = n if n_valid is None else n_valid
    d = heads * head_dim
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((n, d), dtype=np.float32))
    g[nv:] = 0
    kw = dict(num_heads=heads, compute_dtype=torch.float32, n_valid=n_valid)
    if dropout == "rng":
        kw.update(keep_prob=KEEP, rng_seed=SEED)
    elif dropout == "mask":
        mask = np.random.default_rng(6).random((n, t, d)) < KEEP
        kw.update(keep_prob=KEEP, drop_mask=torch.from_numpy(mask.astype(np.float32)))
    ref = port.news_encoder_bwd_reference(x, *ws, g, **kw)
    packed = port.pack_weights(*ws, num_heads=heads, compute_dtype=torch.float32)
    drop = port.dropout_config(n, t, d, kw.get("keep_prob", 1.0), 1.0, kw.get("rng_seed"),
                               kw.get("drop_mask"))
    x2 = x.reshape(n * t, din)
    dqkv, o_c, dz_c, db_part, dq_part = port.bwd_core_reference(
        x2, packed, g, t=t, nv=nv, drop=drop, seed=SEED, keep_prob=KEEP)
    rows = nv * t
    p_cols = packed.wqkv.shape[1]
    assert dqkv.shape == (rows, p_cols) and o_c.shape == (rows, d)
    assert db_part.shape == (-(-nv // (64 // t)), a)
    dx = torch.zeros(n * t, din)
    dx[:rows] = dqkv @ packed.wqkv.T
    dwq, dwk, dwv = port.unpack_qkv(x2[:rows].T @ dqkv, heads, d)
    dw = o_c.T @ dz_c[:, :a]
    got = (dx.reshape(n, t, din), dwq, dwk, dwv, dw, db_part.sum(0), dq_part.sum(0).reshape(a, 1))
    dw_max = ref[4].abs().max().item()
    for name, u, v in zip(NAMES, got, ref):
        scale = max(v.abs().max().item(), dw_max if name in ("b_att", "q_att") else 0.0)
        assert (u - v).abs().max().item() <= 2e-5 * scale, name
