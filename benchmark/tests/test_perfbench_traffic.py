"""The made traffic: the same seed gives the same data, another seed
another draw of the same sizes, and the draws follow the stated law."""
import numpy as np
import torch

from benchmark import traffic

MIX = {"batch_size": 64, "npratio": 4, "history_size": 7, "articles": 300, "article_zipf": 1.07,
       "token_zipf": 1.07, "table_batches": 3, "article_id_base": 1000}
CFG = {"title_size": 5, "vocab_size": 1000}


def test_same_seed_same_data_other_seed_other_draws():
    a, b = traffic.make(MIX, CFG, 2**31 + 77), traffic.make(MIX, CFG, 2**31 + 77)
    c = traffic.make(MIX, CFG, 2**31 + 78)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == c[k].shape
    assert any(not np.array_equal(a[k], c[k]) for k in ("hist", "cand", "tokens", "labels"))


def test_shapes_and_ranges():
    d = traffic.make(MIX, CFG, 3)
    rows = MIX["table_batches"] * MIX["batch_size"]
    assert d["hist"].shape == (rows, 7) and d["cand"].shape == (rows, 5)
    assert d["tokens"].shape == (300, 5) and d["tokens"].max() < 1000
    assert 0 <= d["hist"].min() and d["hist"].max() < 300
    np.testing.assert_array_equal(d["labels"].sum(1), 1.0)
    np.testing.assert_array_equal(d["ids"], 1000 + np.arange(300))


def test_zipf_law():
    gen = torch.Generator().manual_seed(5)
    n, m, a = 50, 200_000, 1.07
    draws = traffic.zipf_indices(gen, n, (m,), a).numpy()
    counts = np.sort(np.bincount(draws, minlength=n))[::-1]
    p = np.arange(1, n + 1, dtype=np.float64) ** -a
    p /= p.sum()
    np.testing.assert_allclose(counts[:5] / m, p[:5], rtol=0.05)
