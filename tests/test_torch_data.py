"""The port's copies of the data layer (Ragged, Table, Lookup, EvalFeed)
give the JAX package's outputs bit for bit on the same inputs."""
import numpy as np
import pytest
import torch

from ebnerd_tpu import constants as c
from ebnerd_tpu.data.behaviors import create_binary_labels_column, ebnerd_from_path
from ebnerd_tpu.data.dataloader import EvalFeed as JaxEvalFeed
from ebnerd_tpu.data.lookup import Lookup as JaxLookup
from ebnerd_tpu.data.ragged import Ragged as JaxRagged
from ebnerd_tpu_torch import constants as pc
from ebnerd_tpu_torch.data import EvalFeed, Lookup, Ragged, Table

torch.set_num_threads(1)

H, T = 6, 10


def port_table(df) -> Table:
    return Table({n: Ragged(df[n].values, df[n].offsets) if isinstance(df[n], JaxRagged)
                  else np.asarray(df[n]) for n in df.columns})


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet

    path = tmp_path_factory.mktemp("torch_data") / "train"
    make_synthetic_ebnerd(path, n_users=40, n_articles=90, n_impressions=300, seed=11)
    df = create_binary_labels_column(ebnerd_from_path(path, history_size=H))
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    tokens = np.random.default_rng(2).integers(1, 500, (len(ids), T)).astype(np.int32)
    return df, ids, tokens


def test_constants_match():
    for name in dir(pc):
        if name.startswith("DEFAULT_"):
            assert getattr(pc, name) == getattr(c, name)


@pytest.mark.parametrize("batch_size,max_candidates,n_buckets,users", [
    (16, None, 4, False),
    (7, None, 1, True),
    (32, 64, 4, True),
])
def test_eval_feed_batches_equal_jax(split, batch_size, max_candidates, n_buckets, users):
    df, ids, tokens = split
    users_map = None
    if users:
        uniq = np.unique(np.asarray(df[c.DEFAULT_USER_COL]))
        users_map = {int(u): i for i, u in enumerate(uniq[::2])}  # half unseen
    kw = dict(history_size=H, batch_size=batch_size, max_candidates=max_candidates,
              n_buckets=n_buckets, user_mapping=users_map)
    jfeed = JaxEvalFeed(df, JaxLookup.from_values(ids, tokens), **kw)
    feed = EvalFeed(port_table(df), Lookup.from_values(ids, tokens), **kw)
    assert feed.width == jfeed.width and feed.bucket_widths == jfeed.bucket_widths
    assert len(feed) == len(jfeed) and feed.n_rows == jfeed.n_rows
    got, want = list(feed.batches()), list(jfeed.batches())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
    scores = np.random.default_rng(3).random((feed.n_rows, feed.width)).astype(np.float32)
    got_u, want_u = feed.unpad(scores), jfeed.unpad(scores)
    np.testing.assert_array_equal(got_u.values, want_u.values)
    np.testing.assert_array_equal(got_u.offsets, want_u.offsets)


def test_lookup_map_ids_equal_jax(split):
    _, ids, tokens = split
    rng = np.random.default_rng(4)
    query = np.concatenate([rng.choice(ids, 200), rng.integers(0, 10**7, 200)])
    got = Lookup.from_values(ids, tokens).map_ids(query)
    want = JaxLookup.from_values(ids, tokens).map_ids(query)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    lk = Lookup.from_values(ids, tokens)
    np.testing.assert_array_equal(lk.matrix, JaxLookup.from_values(ids, tokens).matrix)
    with pytest.raises(ValueError, match="duplicate"):
        Lookup.from_values(np.array([1, 1]), np.zeros((2, 3)))


@pytest.mark.parametrize("align", ["right", "left"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_ragged_to_padded_and_take_equal_jax(align, dtype):
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 100, rng.integers(0, 12)).astype(dtype) for _ in range(50)]
    got, want = Ragged.from_lists(rows, dtype), JaxRagged.from_lists(rows, dtype)
    for width in (1, 5, 16):
        gd, gm = got.to_padded(width, pad_value=0, align=align)
        wd, wm = want.to_padded(width, pad_value=0, align=align)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gm, wm)
        assert gd.dtype == wd.dtype
    idx = rng.integers(0, 50, 80)
    np.testing.assert_array_equal(got.take_rows(idx).values, want.take_rows(idx).values)
    np.testing.assert_array_equal(got.take_rows(idx).offsets, want.take_rows(idx).offsets)
    with pytest.raises(IndexError):
        got.take_rows([50])
