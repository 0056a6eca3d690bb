"""The fp32 kernels' tensor-core product (3xTF32) in its plain version
(``tf32_matmul``, ``tf32_round``): held against float64, and the encoder on
it against the JAX package's fp32 fused encoder (its Pallas kernel in
interpret mode, as tests/ops/test_news_encoder.py runs it) at the CLI's
news geometry cut in N, within the JAX kernel tests' 3e-5 (outputs) and
5e-5 (gradients). One TF32 pass falls outside the card's fp32 checks (1e-4
of scale): why the kernels take three. And the rule that picks the fp32
stages, either side of its boundary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.ops.news_encoder import fused_news_encoder as jax_fused
from ebnerd_tpu.ops.news_encoder import news_encoder as jax_news_encoder
from ebnerd_tpu_torch.ops import news_encoder as port

torch.set_num_threads(1)

# the CLI's news geometry (train_newsrec.py: 20 x 20 heads, the 300-wide word table, title 30,
# attention 200) cut to a few articles
CLI = dict(n=4, t=30, din=300, heads=20, head_dim=20, a=200)
FP32_CHECK = 1e-4  # the card's fp32 checks: FP32_ATOL, FP32_GRAD_REL (chip_smoke.py)


def _inputs(seed, n, t, din, heads, head_dim, a):
    rng = np.random.default_rng(seed)
    d = heads * head_dim
    x = rng.standard_normal((n, t, din), dtype=np.float32)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32) * 0.05
    return x, (mk(din, d), mk(din, d), mk(din, d), mk(d, a), mk(a), mk(a, 1))


def _tf32_grid(v: np.ndarray) -> np.ndarray:
    """v (float64) rounded to 10 mantissa bits, ties away from zero."""
    _, e = np.frexp(v)  # |v| in [2^(e-1), 2^e): TF32 spacing 2^(e - 11)
    ulp = np.ldexp(1.0, e - 11)
    return np.sign(v) * np.floor(np.abs(v) / ulp + 0.5) * ulp


def test_tf32_round_is_rna_on_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
                        [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
                         0.0, -0.0, 2.0 ** -100]]).astype(np.float32)
    got = port.tf32_round(torch.from_numpy(v))
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(got.numpy(), _tf32_grid(v.astype(np.float64)).astype(np.float32))
    # ties go away from zero
    assert got[4096].item() == 1 + 2 ** -10 and got[4097].item() == -(1 + 2 ** -10)
    assert got[4098].item() == 1 + 2 ** -9 and got[4099].item() == 1.0


@pytest.mark.parametrize("m,k,n", [(CLI["n"] * CLI["t"], CLI["din"], 3 * 400), (64, 400, 208),
                                   (16, 20, 30), (30, 30, 20)])
def test_tf32_matmul_against_float64(m, k, n):
    """3xTF32 within 2e-6 of a float64 product's scale (an fp32 product's
    own error is about 5e-7 there); one pass falls outside 1e-4."""
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32) * 0.05
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(port.tf32_matmul(ta, tb).double().numpy() - ref).max()
    err1 = np.abs(port.tf32_matmul(ta, tb, passes=1).double().numpy() - ref).max()
    assert err3 <= 2e-6 * scale
    assert err1 > FP32_CHECK * scale


def test_tf32_matmul_gradients_against_float64():
    """Its gradients are 3xTF32 products too, summed over a broadcast
    operand's batch (x [N, T, Din] @ W [Din, D])."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 30, 300), dtype=np.float32)
    w = rng.standard_normal((300, 40), dtype=np.float32) * 0.05
    g = rng.standard_normal((3, 30, 40), dtype=np.float32)
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    dx, dw = torch.autograd.grad(port.tf32_matmul(tx, tw), (tx, tw), torch.from_numpy(g))
    x64, w64, g64 = (torch.from_numpy(v).double().requires_grad_(True) for v in (x, w, g))
    rx, rw = torch.autograd.grad(x64 @ w64, (x64, w64), g64)
    assert dw.shape == (300, 40) and dx.shape == x.shape
    for got, ref in ((dx, rx), (dw, rw)):
        assert (got.double() - ref).abs().max() <= 2e-6 * ref.abs().max()


def _jax_grads(x, ws, heads):
    dummy = jnp.ones((8, 128), jnp.float32)
    loss = lambda *a_: jnp.sum(jnp.sin(jax_news_encoder(*a_, dummy, None, heads, 4, True)))
    return jax.grad(loss, argnums=tuple(range(7)))(jnp.asarray(x), *map(jnp.asarray, ws))


def _port_grads(x, ws, heads, passes):
    ins = [torch.from_numpy(v).requires_grad_(True) for v in (x,) + ws]
    out = port.news_encoder_reference(*ins, num_heads=heads, tf32_passes=passes)
    return out.detach(), torch.autograd.grad(torch.sin(out).sum(), ins)


@pytest.fixture(scope="module")
def cli_case():
    x, ws = _inputs(0, **CLI)
    heads = CLI["heads"]
    jx, jws = jnp.asarray(x), [jnp.asarray(w) for w in ws]
    kern = np.asarray(jax_fused(jx, *jws, num_heads=heads, block_n=4, interpret=True))
    return x, ws, kern, [np.asarray(v) for v in _jax_grads(x, ws, heads)]


def test_tf32x3_encoder_matches_jax_fused_encoder(cli_case):
    x, ws, kern, jgrads = cli_case
    out, grads = _port_grads(x, ws, CLI["heads"], 3)
    np.testing.assert_allclose(out.numpy(), kern, atol=3e-5)
    for got, ref in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


def test_one_tf32_pass_falls_outside_the_fp32_checks(cli_case):
    """At the same inputs one TF32 pass per product leaves the encoder's
    output past the card's 1e-4 of its scale, and a gradient past it; three
    passes stay 10-100x inside."""
    x, ws, kern, jgrads = cli_case
    scale = np.abs(kern).max()
    out1, grads1 = _port_grads(x, ws, CLI["heads"], 1)
    out3, grads3 = _port_grads(x, ws, CLI["heads"], 3)
    assert np.abs(out1.numpy() - kern).max() > FP32_CHECK * scale
    assert np.abs(out3.numpy() - kern).max() < 1e-2 * FP32_CHECK * scale
    rel = lambda gs: max(np.abs(g.numpy() - r).max() / np.abs(r).max() for g, r in zip(gs, jgrads))
    assert rel(grads1) > FP32_CHECK
    assert rel(grads3) < 1e-1 * FP32_CHECK


@pytest.mark.parametrize("head_dim,want", [(4, "fma"), (7, "fma"), (8, "tf32x3"), (9, "tf32x3"),
                                           (20, "tf32x3"), (64, "tf32x3")])
def test_fp32_variant_either_side_of_its_boundary(head_dim, want):
    assert port.fp32_variant(head_dim) == want
    packed = port.pack_weights(*(torch.from_numpy(w) for w in _inputs(1, 2, 3, 16, 2, head_dim,
                                                                       8)[1]),
                               num_heads=2, compute_dtype=torch.float32)
    assert port._fp32_code(packed) == port._FP32_VARIANT[want]


def test_bf16_takes_no_fp32_variant():
    packed = port.pack_weights(*(torch.from_numpy(w) for w in _inputs(1, 2, 3, 16, 2, 20, 8)[1]),
                               num_heads=2, compute_dtype=torch.bfloat16)
    assert port._fp32_code(packed) == 0


def test_tf32_arguments_are_checked():
    x, ws = _inputs(2, 2, 4, 16, 2, 8, 8)
    args = [torch.from_numpy(v) for v in (x,) + ws]
    with pytest.raises(ValueError, match="passes"):
        port.tf32_matmul(args[0][0], args[1], passes=2)
    with pytest.raises(ValueError, match="fp32"):
        port.tf32_round(args[0].to(torch.bfloat16))
    with pytest.raises(ValueError, match="tf32_passes"):
        port.news_encoder_reference(*args, num_heads=2, compute_dtype=torch.bfloat16,
                                    tf32_passes=3)
    # passes 0 is the plain fp32 path, unchanged
    plain = port.news_encoder_reference(*args, num_heads=2)
    assert torch.equal(plain, port.news_encoder_reference(*args, num_heads=2, tf32_passes=0))
