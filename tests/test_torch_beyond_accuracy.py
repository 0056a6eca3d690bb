"""The port's beyond-accuracy metrics and evaluation utilities
(``evaluation/beyond_accuracy.py``, ``evaluation/utils.py``) against the
JAX package's on the same inputs: every class and function, equal (the
same numpy code: equal to the last bit; 1e-12 allowed where a sum could be
reordered)."""
import numpy as np
import pytest

from ebnerd_tpu.evaluation import beyond_accuracy as jba
from ebnerd_tpu.evaluation import utils as ju
from ebnerd_tpu_torch.evaluation import beyond_accuracy as pba
from ebnerd_tpu_torch.evaluation import utils as pu

RNG = np.random.default_rng(0)
IDS = [f"a{i}" for i in range(30)]
LOOKUP = {
    i: {"vector": RNG.standard_normal(6), "score": float(RNG.random()),
        "pop": float(RNG.uniform(0.01, 1.0)), "cat": int(RNG.integers(0, 4)),
        "tags": list(RNG.integers(0, 5, RNG.integers(1, 3)))}
    for i in IDS
}
LISTS = [list(RNG.choice(IDS, k, replace=False)) for k in (1, 3, 5, 8, 2)]
LISTS.append(["missing", "a1", "a2"])


def close(j, p):
    """Equal within 1e-12, NaN equal, element by element."""
    j, p = np.asarray(j, dtype=np.float64), np.asarray(p, dtype=np.float64)
    assert j.shape == p.shape
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("pairwise", [None, "cosine"])
def test_low_level_metrics_match_jax(pairwise):
    fj = None if pairwise is None else jba.cosine_distances
    fp = None if pairwise is None else pba.cosine_distances
    for k in (1, 2, 7, 40):
        v = RNG.standard_normal((k, 8))
        v[0] = 0.0  # a zero vector: cosine similarity 0
        close(jba.intralist_diversity(v, fj), pba.intralist_diversity(v, fp))
        h = RNG.standard_normal((5, 8))
        close(jba.serendipity(v, h, fj), pba.serendipity(v, h, fp))
    close(jba.cosine_distances(v, h), pba.cosine_distances(v, h))
    r, cat = RNG.integers(0, 20, 15), np.arange(40)
    assert jba.coverage_count(r) == pba.coverage_count(r)
    assert jba.coverage_fraction(r, cat) == pba.coverage_fraction(r, cat)
    pops = RNG.uniform(0.01, 1, 9)
    close(jba.novelty(pops), pba.novelty(pops))
    for x in ([1], [1, 1, 1], [1, 2, 2, 3, 3, 3], list("abcabd")):
        close(jba.index_of_dispersion(x), pba.index_of_dispersion(x))


@pytest.mark.parametrize("pairwise", [None, "cosine"])
def test_classes_match_jax(pairwise):
    fj = None if pairwise is None else jba.cosine_distances
    fp = None if pairwise is None else pba.cosine_distances
    close(jba.IntralistDiversity()(LISTS, LOOKUP, "vector", fj),
          pba.IntralistDiversity()(LISTS, LOOKUP, "vector", fp))
    for n, cap in ((2, 20000), (3, 50)):  # exhaustive, then sampled combinations
        close(jba.IntralistDiversity()._candidate_diversity(IDS[:8], n, LOOKUP, "vector", fj,
                                                            max_number_combinations=cap, seed=4),
              pba.IntralistDiversity()._candidate_diversity(IDS[:8], n, LOOKUP, "vector", fp,
                                                            max_number_combinations=cap, seed=4))
    with pytest.raises(ValueError, match="cannot exceed"):
        pba.IntralistDiversity()._candidate_diversity(IDS[:3], 4, LOOKUP, "vector")
    hist = [list(RNG.choice(IDS, 4, replace=False)) for _ in LISTS]
    hist[2] = ["missing"]
    close(jba.Serendipity()(LISTS, hist, LOOKUP, "vector", fj),
          pba.Serendipity()(LISTS, hist, LOOKUP, "vector", fp))
    with pytest.raises(ValueError, match="do not match"):
        pba.Serendipity()(LISTS, hist[:-1], LOOKUP, "vector")


def test_distribution_coverage_sentiment_novelty_match_jax():
    flat = [i for r in LISTS[:5] for i in r]
    for key in ("cat", "tags"):
        assert jba.Distribution()(flat, LOOKUP, key) == pba.Distribution()(flat, LOOKUP, key)
    assert jba.Coverage()(flat, IDS) == pba.Coverage()(flat, IDS)
    assert jba.Coverage()(flat) == pba.Coverage()(flat)
    close(jba.Sentiment()(LISTS, LOOKUP, "score"), pba.Sentiment()(LISTS, LOOKUP, "score"))
    close(jba.Sentiment()._candidate_sentiment(IDS, 4, LOOKUP, "score"),
          pba.Sentiment()._candidate_sentiment(IDS, 4, LOOKUP, "score"))
    close(jba.Novelty()(LISTS, LOOKUP, "pop"), pba.Novelty()(LISTS, LOOKUP, "pop"))
    close(jba.Novelty()._candidate_novelty(IDS, 4, LOOKUP, "pop"),
          pba.Novelty()._candidate_novelty(IDS, 4, LOOKUP, "pop"))
    for cls in (pba.IntralistDiversity, pba.Distribution, pba.Sentiment, pba.Novelty):
        with pytest.raises(ValueError, match="not present"):
            args = (LISTS, LOOKUP, "nope")
            cls()(*args)
    names = [c().name for c in (pba.IntralistDiversity, pba.Distribution, pba.Coverage,
                                pba.Sentiment, pba.Serendipity, pba.Novelty)]
    assert names == [c().name for c in (jba.IntralistDiversity, jba.Distribution, jba.Coverage,
                                        jba.Sentiment, jba.Serendipity, jba.Novelty)]


def test_evaluation_utils_match_jax():
    y = RNG.random(12)
    assert np.array_equal(ju.convert_to_binary(y, 0.4), pu.convert_to_binary(y, 0.4))
    assert ju.is_iterable_nested_dtype([[1]], list) == pu.is_iterable_nested_dtype([[1]], list)
    assert ju.is_iterable_nested_dtype([1], list) == pu.is_iterable_nested_dtype([1], list)
    assert ju.compute_combinations(9, 4) == pu.compute_combinations(9, 4)
    m = RNG.standard_normal(10)
    for args in ((), (-3.0, 3.0), (None, None, -1, 1)):
        close(ju.scale_range(m, *args), pu.scale_range(m, *args))
    r = [np.array(LISTS[i][:3]) for i in range(5)]
    assert ju.compute_item_popularity_scores(r) == pu.compute_item_popularity_scores(r)
    assert ju.compute_item_popularity_scores([]) == pu.compute_item_popularity_scores([])
    items = ["x", "y", "x", "z"]
    assert (ju.compute_normalized_distribution(items)
            == pu.compute_normalized_distribution(items))
    w = np.array([0.1, 0.2, 0.3, 0.4])
    assert (ju.compute_normalized_distribution(items, w, {"q": 1.0})
            == pu.compute_normalized_distribution(items, w, {"q": 1.0}))
    assert ju.get_keys_in_dict(["a1", "zz"], LOOKUP) == pu.get_keys_in_dict(["a1", "zz"], LOOKUP)
    pu.check_key_in_all_nested_dicts(LOOKUP, "vector")
    with pytest.raises(ValueError, match="'nope' is not present"):
        pu.check_key_in_all_nested_dicts(LOOKUP, "nope")
