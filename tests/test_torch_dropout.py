"""The seed-recompute dropout (``ops/dropout.py``) on the CPU, where the
wrapper takes its plain version: the contract ``tests/ops/test_prng_dropout.py``
pins for the TPU kernel (deterministic per seed, inverted-dropout
statistics, a backward that re-applies exactly the forward's mask, the
dtype kept), and what the CUDA kernel must share with it: the 64-bit seed
and the stream both change the mask, the mask does not depend on how a
tensor is split into chunks (element offsets), the counters' high word,
the 24-bit threshold, one fp32 product rounded once. The kernel is held
bit for bit against this plain version on the card (``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

from ebnerd_tpu_torch.ops import dropout, philox

torch.set_num_threads(1)

SEED = (0x5EED << 32) | 0x1234ABCD


def test_deterministic_per_seed():
    x = torch.ones(333, 70)
    a = dropout.prng_dropout(x, SEED, 0, 0.8)
    assert torch.equal(a, dropout.prng_dropout(x, SEED, 0, 0.8))
    assert not torch.equal(a, dropout.prng_dropout(x, SEED + 1, 0, 0.8))


def test_inverted_dropout_statistics():
    keep = 0.8
    y = dropout.prng_dropout(torch.ones(512, 257), 7, 0, keep).numpy()
    kept = y > 0
    assert abs(kept.mean() - keep) < 0.01
    np.testing.assert_allclose(y[kept], 1.0 / keep, rtol=1e-6)
    np.testing.assert_allclose(y.mean(), 1.0, atol=0.02)


def test_backward_reapplies_identical_mask():
    """grad(sum(dropout(x))) equals mask / keep: the mask the forward drew,
    regenerated from the seed (nothing saved but the seed, stream, keep)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(97, 33)).astype(np.float32))
    x.requires_grad_()
    keep = 0.7
    y = dropout.prng_dropout(x, 42, 3, keep)
    assert y.grad_fn is not None and not y.grad_fn.saved_tensors  # no mask kept
    y.sum().backward()
    mask_fwd = (y != 0).detach().numpy()
    np.testing.assert_array_equal(x.grad.numpy() != 0, mask_fwd)
    np.testing.assert_allclose(x.grad.numpy()[mask_fwd], 1.0 / keep, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dtype_kept_and_one_fp32_product_rounded_once(dtype):
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 128)).astype(np.float32))
    x = x.to(dtype)
    y = dropout.prng_dropout(x, 1, 0, 0.5)
    assert y.dtype == dtype
    inv = torch.tensor(1.0) / torch.tensor(0.5)
    m = dropout.keep_mask(x.numel(), 1, 0, 0.5).reshape(x.shape)
    want = torch.where(m, (x.float() * inv).to(dtype), torch.zeros((), dtype=dtype))
    assert torch.equal(y, want)


def test_seed_high_word_and_stream_change_the_mask():
    n = 4096
    a = dropout.keep_mask(n, SEED, 0, 0.8)
    assert torch.equal(a, dropout.keep_mask(n, SEED, 0, 0.8))
    assert not torch.equal(a, dropout.keep_mask(n, SEED ^ (1 << 40), 0, 0.8))  # high word only
    assert not torch.equal(a, dropout.keep_mask(n, SEED, 1, 0.8))
    assert not torch.equal(a, dropout.keep_mask(n, SEED, (1 << 32) - 1, 0.8))


def test_streams_differ_from_the_fused_encoders():
    """The fused encoder's stream-0 mask of the same seed (counter word 3
    is 0 there) is another mask: the two generators never share a counter."""
    width = 128
    enc = philox.mask(SEED, philox.STREAM_EMB, 8, width, 0.5) > 0
    ours = dropout.keep_mask(8 * width, SEED, 0, 0.5).reshape(8, width)
    assert not torch.equal(enc, ours)
    assert dropout.DROPOUT_TAG != 0


def test_mask_is_the_24_bit_threshold_of_the_counter_words():
    seed, stream, n, offset = (7 << 32) | 11, 5, 37, 6
    m = dropout.keep_mask(n, seed, stream, 0.5, offset)
    g = np.arange(offset, offset + n)
    c = g // 4
    ctr = torch.tensor(np.stack([c & 0xFFFFFFFF, c >> 32, np.full_like(c, stream),
                                 np.full_like(c, dropout.DROPOUT_TAG)], -1))
    bits = philox.philox4x32(ctr, (11, 7))[torch.arange(n), torch.from_numpy(g % 4)]
    np.testing.assert_array_equal(m.numpy(), ((bits >> 8) < (1 << 23)).numpy())


@pytest.mark.parametrize("keep", [0.8, 0.5, 0.1, 1.0 - 2 ** -24, 1.0])
def test_threshold_is_int_keep_times_2_to_the_24(keep):
    assert philox.threshold(keep) == int(keep * (1 << 24))
    m = dropout.keep_mask(20_000, 3, 0, keep)
    if keep == 1.0:
        assert bool(m.all())
    else:
        assert abs(m.float().mean().item() - keep) < 0.02


@pytest.mark.parametrize("cuts", [(1,), (7, 8), (3, 64, 65, 999), (4, 8, 12)])
def test_mask_does_not_depend_on_the_chunk_split(cuts):
    """Any split of a tensor into chunks, each with its element offset,
    regenerates the mask of the whole (the kernel launches NAML's
    encode_chunks this way)."""
    n = 1000
    whole = dropout.keep_mask(n, SEED, 2, 0.8)
    bounds = [0, *cuts, n]
    parts = [dropout.keep_mask(b - a, SEED, 2, 0.8, offset=a) for a, b in zip(bounds, bounds[1:])]
    assert torch.equal(torch.cat(parts), whole)
    x = torch.arange(n, dtype=torch.float32)
    y = torch.cat([dropout.dropout_reference(x[a:b], SEED, 2, 0.8, a)
                   for a, b in zip(bounds, bounds[1:])])
    assert torch.equal(y, dropout.dropout_reference(x, SEED, 2, 0.8))


def test_high_word_of_the_counter():
    """An offset past 2**34 elements puts the counter (index // 4) past 2**32:
    its high word is word 1 of the counter, so masks there differ from the
    same low word at offset 0."""
    off = (1 << 34) + 8
    hi = dropout.keep_mask(4096, SEED, 0, 0.5, offset=off)
    lo = dropout.keep_mask(4096, SEED, 0, 0.5, offset=8)
    assert not torch.equal(hi, lo)
    c = np.arange(off, off + 8) // 4
    assert (c >> 32 == 1).all()
    ctr = torch.tensor(np.stack([c & 0xFFFFFFFF, c >> 32, np.zeros_like(c),
                                 np.full_like(c, dropout.DROPOUT_TAG)], -1))
    bits = philox.philox4x32(ctr, philox.split_seed(SEED))[torch.arange(8), torch.arange(8) % 4]
    assert torch.equal(hi[:8], (bits >> 8) < philox.threshold(0.5))


def test_non_contiguous_input_and_gradient():
    """A transposed view (the conv encoders' output) drops out as its
    contiguous copy would: the mask follows the logical element order."""
    base = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 9, 5)).astype(np.float32))
    view = base.transpose(1, 2)
    assert not view.is_contiguous()
    y = dropout.prng_dropout(view, SEED, 1, 0.8)
    assert torch.equal(y, dropout.prng_dropout(view.contiguous(), SEED, 1, 0.8))
    leaf = view.clone().requires_grad_()
    (dropout.prng_dropout(leaf.transpose(1, 2), SEED, 1, 0.8) * 2).sum().backward()
    want = dropout.dropout_reference(torch.full((6, 9, 5), 2.0), SEED, 1, 0.8)
    assert torch.equal(leaf.grad, want.transpose(1, 2))


def test_keep_one_is_identity_without_a_launch():
    x = torch.randn(10, 10)
    before = dropout.dropout_apply.launches
    assert dropout.prng_dropout(x, 1, 0, 1.0) is x
    dropout.prng_dropout(x, 1, 0, 0.5)  # the plain version: not a launch either
    assert dropout.dropout_apply.launches == before


def test_arguments_are_checked():
    x = torch.ones(4)
    for keep in (0.0, 1.5):
        with pytest.raises(ValueError):
            dropout.prng_dropout(x, 1, 0, keep)
    with pytest.raises(ValueError):
        dropout.keep_mask(4, 1, 0, 0.5, offset=-1)
    with pytest.raises(ValueError):
        dropout.keep_mask(4, 1, 1 << 32, 0.5)
    with pytest.raises(ValueError):
        dropout.dropout_apply(torch.ones(4, device="meta"), 1, 0, 0.5)  # no kernel, no fallback
    assert dropout.keep_mask(0, 1, 0, 0.5).numel() == 0
