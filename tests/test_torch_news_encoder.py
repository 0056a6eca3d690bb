"""The port's fused news encoder (plain version, which the CUDA kernel is
held against on the card) equals the JAX package's Pallas kernel run in
interpret mode and its XLA reference, in fp32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.ops.news_encoder import fused_news_encoder as jax_fused
from ebnerd_tpu.ops.news_encoder import news_encoder_reference as jax_reference
from ebnerd_tpu_torch.ops import news_encoder as port

torch.set_num_threads(1)

SHAPES = [
    # n, t, din, heads, head_dim, a, block (JAX block_n)
    (10, 30, 256, 4, 32, 64, 4),     # uneven N vs block
    (8, 30, 128, 20, 20, 200, 8),    # NRMS head geometry (20 x 20)
    (5, 12, 64, 2, 16, 32, 2),
    (9, 30, 64, 20, 20, 200, 8),     # 20 x 20 at title length 30
    (7, 20, 400, 20, 20, 200, 8),    # 20 x 20 at history length 20 (user tower)
    (5, 50, 64, 2, 32, 300, 5),      # T 50 (history 50), A 300: the wide instance's shape
    (3, 33, 128, 2, 64, 300, 3),     # T 33, head width 64, A 300
]


def _inputs(seed, n, t, din, heads, head_dim, a):
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    x = rng.standard_normal((n, t, din), dtype=np.float32)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32) * 0.05
    return x, (mk(din, d), mk(din, d), mk(din, d), mk(d, a), mk(a), mk(a, 1))


@pytest.mark.parametrize("n,t,din,heads,head_dim,a,block", SHAPES)
def test_plain_matches_jax_kernel_and_reference(n, t, din, heads, head_dim, a, block):
    x, ws = _inputs(0, n, t, din, heads, head_dim, a)
    jx, jws = jnp.asarray(x), [jnp.asarray(w) for w in ws]
    kern = np.asarray(jax_fused(jx, *jws, num_heads=heads, block_n=block, interpret=True))
    ref = np.asarray(jax_reference(jx, *jws, num_heads=heads))
    out = port.fused_news_encoder(torch.from_numpy(x), *map(torch.from_numpy, ws),
                                  num_heads=heads)
    assert out.dtype == torch.float32 and out.shape == (n, heads * head_dim)
    np.testing.assert_allclose(out.numpy(), kern, atol=3e-5)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5)


@pytest.mark.parametrize("n_valid", [0, 3, 8])
def test_n_valid_rows_are_zero(n_valid):
    """Articles at or past n_valid are exactly 0; the rest equal the full
    computation. The JAX kernel zeroes whole blocks past n_valid, so rows
    of its blocks wholly past n_valid are 0 too."""
    n, t, din, heads, head_dim, a, block = 12, 30, 64, 4, 16, 32, 4
    x, ws = _inputs(1, n, t, din, heads, head_dim, a)
    jx, jws = jnp.asarray(x), [jnp.asarray(w) for w in ws]
    kern = np.asarray(jax_fused(jx, *jws, num_heads=heads, block_n=block, interpret=True,
                                n_valid=jnp.int32(n_valid)))
    out = port.fused_news_encoder(torch.from_numpy(x), *map(torch.from_numpy, ws),
                                  num_heads=heads, n_valid=n_valid).numpy()
    assert (out[n_valid:] == 0).all()
    np.testing.assert_allclose(out[:n_valid], kern[:n_valid], atol=3e-5)
    past = -(-n_valid // block) * block
    assert (kern[past:] == 0).all()


def test_bf16_rounding_points_match_jax_kernel():
    """In bf16 the plain version rounds where the TPU kernel does (operands
    of every product in bf16, fp32 accumulation), so it tracks the JAX
    kernel closely; the bound is a few bf16 ulps of the output scale."""
    n, t, din, heads, head_dim, a = 8, 30, 128, 20, 20, 200
    x, ws = _inputs(2, n, t, din, heads, head_dim, a)
    xb = x.astype(jnp.bfloat16)
    kern = np.asarray(jax_fused(jnp.asarray(xb), *[jnp.asarray(w) for w in ws],
                                num_heads=heads, block_n=8, interpret=True,
                                compute_dtype="bfloat16"))
    out = port.fused_news_encoder(torch.from_numpy(x).to(torch.bfloat16),
                                  *map(torch.from_numpy, ws), num_heads=heads,
                                  compute_dtype=torch.bfloat16).numpy()
    scale = np.abs(kern).max()
    assert np.abs(out - kern).max() <= 2e-2 * scale


@pytest.mark.parametrize("heads,head_dim", [(20, 20), (6, 20), (2, 16)])
def test_pack_qkv_layout(heads, head_dim):
    """Head-group panels of 256 columns: Q, K and V of gh heads each, zeros
    elsewhere (including the missing heads of a short last group)."""
    rng = np.random.default_rng(3)
    d = heads * head_dim
    ws = [torch.from_numpy(rng.standard_normal((16, d), dtype=np.float32)) for _ in range(3)]
    packed, gh = port.pack_qkv(*ws, heads, torch.float32)
    assert gh == 256 // (3 * head_dim)
    n_groups = -(-heads // gh)
    assert packed.shape == (16, n_groups * 256) and packed.is_contiguous()
    panels = packed.reshape(16, n_groups, 256)
    seen = torch.zeros_like(panels, dtype=torch.bool)
    for g in range(n_groups):
        for h in range(g * gh, min(heads, (g + 1) * gh)):
            for i, w in enumerate(ws):
                col = i * gh * head_dim + (h - g * gh) * head_dim
                torch.testing.assert_close(panels[:, g, col:col + head_dim],
                                           w[:, h * head_dim:(h + 1) * head_dim],
                                           rtol=0, atol=0)
                seen[:, g, col:col + head_dim] = True
    assert (panels[~seen] == 0).all()


def test_pack_weights_pads_and_checks():
    """The kernel's operands: QKV panels and W_att (zero columns up to a
    multiple of 16) in the compute dtype, b and q flat in fp32; a head
    width of 80 packs one head a panel, for the tiled route."""
    _, ws = _inputs(6, 3, 30, 64, 20, 20, 200)
    tw = [torch.from_numpy(w) for w in ws]
    p = port.pack_weights(*tw, num_heads=20, compute_dtype=torch.bfloat16)
    wqkv, gh = port.pack_qkv(*tw[:3], 20, torch.bfloat16)
    torch.testing.assert_close(p.wqkv, wqkv, rtol=0, atol=0)
    assert p.heads_per_group == gh == 4 and p.num_heads == 20
    assert p.w_att.shape == (400, 208) and p.w_att.dtype == torch.bfloat16
    torch.testing.assert_close(p.w_att[:, :200], tw[3].to(torch.bfloat16), rtol=0, atol=0)
    assert (p.w_att[:, 200:] == 0).all()
    assert p.b_att.dtype == p.q_att.dtype == torch.float32 and p.q_att.shape == (200,)
    torch.testing.assert_close(p.q_att, tw[5][:, 0], rtol=0, atol=0)
    wide = port.pack_weights(*tw, num_heads=5, compute_dtype=torch.float32)  # head_dim 80
    assert wide.heads_per_group == 1 and wide.wqkv.shape == (64, 5 * 256)
    for u, w in zip(port.unpack_qkv(wide.wqkv, 5, 400), tw[:3]):
        torch.testing.assert_close(u, w, rtol=0, atol=0)
    assert port.route(30, 80, 208) == "tiled"


def test_dropout_not_ported():
    """Dropout is ported now (Philox masks or an external mask); what the
    kernel cannot draw is refused: embedding dropout without a seed, and
    attention dropout with neither a mask nor a seed."""
    x, ws = _inputs(4, 2, 4, 8, 2, 4, 8)
    args = (torch.from_numpy(x), *map(torch.from_numpy, ws))
    with pytest.raises(ValueError, match="drop_mask or rng_seed"):
        port.fused_news_encoder(*args, num_heads=2, keep_prob=0.8)
    with pytest.raises(ValueError, match="needs rng_seed"):
        port.fused_news_encoder(*args, num_heads=2, emb_keep_prob=0.8)
    out = port.fused_news_encoder(*args, num_heads=2, keep_prob=0.8, rng_seed=torch.tensor([1]))
    assert out.shape == (2, 8) and torch.isfinite(out).all()


def test_cpu_call_does_not_count_launches():
    before = port.fused_news_encoder.launches
    x, ws = _inputs(5, 2, 4, 8, 2, 4, 8)
    port.fused_news_encoder(torch.from_numpy(x), *map(torch.from_numpy, ws), num_heads=2)
    assert port.fused_news_encoder.launches == before


@pytest.mark.parametrize("head_dim,a", [(40, 300), (64, 512), (40, 512), (64, 300), (20, 200)])
def test_pack_weights_takes_the_wide_domain(head_dim, a):
    """Head widths up to 64 and attention widths up to 512 are packed (W_att
    padded to a multiple of 16) for the instances; past them pack_weights
    packs for the tiled route (A 513 padded to 528)."""
    heads = 2
    _, ws = _inputs(7, 2, 4, 24, heads, head_dim, a)
    p = port.pack_weights(*map(torch.from_numpy, ws), num_heads=heads,
                          compute_dtype=torch.bfloat16)
    assert p.heads_per_group == 256 // (3 * head_dim)
    assert p.w_att.shape == (heads * head_dim, -(-a // 16) * 16) and (p.w_att[:, a:] == 0).all()
    assert port.route(4, head_dim, p.w_att.shape[1]) != "tiled"
    _, wide = _inputs(7, 2, 4, 24, heads, head_dim, 513)
    p = port.pack_weights(*map(torch.from_numpy, wide), num_heads=heads,
                          compute_dtype=torch.float32)
    assert p.w_att.shape == (heads * head_dim, 528) and (p.w_att[:, 513:] == 0).all()
    assert port.route(4, head_dim, p.w_att.shape[1]) == "tiled"


@pytest.mark.parametrize("t,d,heads,a,limit", [
    (1, 64, 2, 32, "narrow"), (64, 64, 2, 32, "tiled"), (50, 400, 20, 200, "tiled"),
    (33, 128, 2, 512, "tiled"), (64, 512, 8, 512, "tiled"), (20, 100, 10, 64, "narrow"),
    (0, 64, 2, 32, "T >= 1"), (65, 64, 2, 32, "tiled"),
    (30, 65, 1, 32, "tiled"), (30, 130, 2, 32, "tiled"),
    (30, 64, 2, 513, "tiled"), (30, 64, 3, 32, "not divisible"),
    (20, 128, 2, 32, "wide"), (32, 64, 2, 300, "wide"),
])
def test_check_shape_pins_the_domain(t, d, heads, a, limit):
    """The shape check both wrappers call before any launch takes every
    T >= 1, head width and attention width, and each shape its route: T,
    head widths and padded attention widths the instances took stay on
    them at T <= 32; past T 32, head width 64 or A 512 the tiled route
    takes it. What is left of the old limits: T >= 1, and heads that split
    D."""
    if limit in ("narrow", "wide", "tiled"):
        port.check_shape(d=d, num_heads=heads, a=a, t=t)
        assert port.route(t, d // heads, -(-a // 16) * 16) == limit
    else:
        with pytest.raises(ValueError, match=limit):
            port.check_shape(d=d, num_heads=heads, a=a, t=t)


@pytest.mark.parametrize("t", [64, 65, 50])
def test_both_wrappers_check_t_before_any_launch(t):
    """``_check_x``, which the forward and backward wrappers call before
    their first launch, passes T past 64 now and refuses T 0, naming the
    limit; past T 32 the tiled route takes the shape, and the wide
    instance, asked for, holds one article a block up to T 64."""
    _, ws = _inputs(8, 2, t, 16, 2, 8, 16)
    packed = port.pack_weights(*map(torch.from_numpy, ws), num_heads=2,
                               compute_dtype=torch.float32)
    port._check_x(torch.zeros(2, t, 16), packed)
    assert port.articles_per_block(t) == max(1, 64 // t)
    assert port.route(t, 8, 16) == "tiled"
    assert port.route(t, 8, 16, instance=True) == ("tiled" if t > 64 else "wide")
    with pytest.raises(ValueError, match="T >= 1"):
        port._check_x(torch.zeros(2, 0, 16), packed)
