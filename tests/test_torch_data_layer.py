"""The port's data layer, its general utilities and the in-memory synthetic
split against the JAX package's, on the same inputs: seeded synthetic
splits (written by the JAX generator and read back) and hand-made edge
cases. Tables and ragged columns must be equal with their dtypes and
offsets; the samplers bit-equal under the same seed."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ebnerd_tpu import constants as c
from ebnerd_tpu.data import articles as ja
from ebnerd_tpu.data import behaviors as jb
from ebnerd_tpu.data import decay as jd
from ebnerd_tpu.data import descriptive as jdesc
from ebnerd_tpu.data import history as jh
from ebnerd_tpu.data import lookup as jl
from ebnerd_tpu.data import nlp as jn
from ebnerd_tpu.data import ops as jo
from ebnerd_tpu.data.ragged import Ragged as JRagged
from ebnerd_tpu.data.synthetic import make_synthetic_articles as j_articles
from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd as j_synthetic
from ebnerd_tpu.data.table import Table as JTable
from ebnerd_tpu.data.table import read_parquet as j_read
from ebnerd_tpu.utils import misc as jm
from ebnerd_tpu_torch.data import articles as pa_
from ebnerd_tpu_torch.data import behaviors as pb
from ebnerd_tpu_torch.data import decay as pd
from ebnerd_tpu_torch.data import descriptive as pdesc
from ebnerd_tpu_torch.data import history as ph
from ebnerd_tpu_torch.data import lookup as pl
from ebnerd_tpu_torch.data import nlp as pn
from ebnerd_tpu_torch.data import ops as po
from ebnerd_tpu_torch.data.ragged import Ragged as PRagged
from ebnerd_tpu_torch.data.synthetic import make_synthetic_articles as p_articles
from ebnerd_tpu_torch.data.synthetic import make_synthetic_ebnerd as p_synthetic
from ebnerd_tpu_torch.data.synthetic import synthetic_ebnerd_tables
from ebnerd_tpu_torch.data.table import Table as PTable
from ebnerd_tpu_torch.utils import misc as pm

torch.set_num_threads(1)

INVIEW, CLICKED = c.DEFAULT_INVIEW_ARTICLES_COL, c.DEFAULT_CLICKED_ARTICLES_COL


# -- conversion and comparison ------------------------------------------------

def to_port(x):
    if isinstance(x, JRagged):
        return PRagged(x.values, x.offsets)
    if isinstance(x, JTable):
        return PTable({k: to_port(x[k]) for k in x.columns})
    return x


def same(j, p, where="") -> None:
    """``p`` (port) equals ``j`` (JAX): tables column by column, ragged
    columns with their offsets, arrays with their dtypes (NaN equal)."""
    if isinstance(j, JTable):
        assert isinstance(p, PTable), where
        assert j.columns == p.columns, (where, j.columns, p.columns)
        for k in j.columns:
            same(j[k], p[k], f"{where}/{k}")
    elif isinstance(j, JRagged):
        assert isinstance(p, PRagged), where
        same(j.offsets, p.offsets, where + ".offsets")
        same(j.values, p.values, where + ".values")
    elif isinstance(j, np.ndarray):
        assert isinstance(p, np.ndarray) and j.dtype == p.dtype, (where, j.dtype, p)
        assert j.shape == p.shape, (where, j.shape, p.shape)
        assert np.array_equal(j, p, equal_nan=j.dtype.kind in "fc"), where
    elif isinstance(j, (tuple, list)):
        assert type(j) is type(p) and len(j) == len(p), where
        for i, (u, v) in enumerate(zip(j, p)):
            same(u, v, f"{where}[{i}]")
    elif isinstance(j, dict):
        assert list(j) == list(p), where
        for k in j:
            same(j[k], p[k], f"{where}[{k}]")
    elif isinstance(j, float) and np.isnan(j):
        assert np.isnan(p), where
    else:
        assert type(j) is type(p) and j == p, (where, j, p)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A seeded synthetic split as the JAX package reads it back, its joined
    behaviors (history 10) and its articles."""
    path = j_synthetic(tmp_path_factory.mktemp("dl") / "train", n_users=60, n_articles=150,
                       n_impressions=500, seed=5, test_set=True)
    df = jb.ebnerd_from_path(path, history_size=10)
    return path, df, j_read(path / "articles.parquet")


def _edge():
    """Impressions with empty and full negative pools, a row with no click
    and one with two clicks, duplicate users."""
    return JTable({
        c.DEFAULT_IMPRESSION_ID_COL: np.arange(1, 7, dtype=np.uint32),
        c.DEFAULT_USER_COL: np.array([7, 7, 3, 9, 3, 7], np.uint32),
        INVIEW: JRagged.from_lists([[1, 2, 3], [4], [5, 6, 7, 8], [9, 10], [11, 12, 13], [14]],
                                   dtype=np.int32),
        CLICKED: JRagged.from_lists([[2], [4], [5, 8], [], [13], [14]], dtype=np.int32),
    })


# -- ragged and lookup --------------------------------------------------------

RAGGED_CASES = {
    "lists": [[1, 2, 3], [], [4], [5, 6, 7, 8, 9], []],
    "empty_rows": [[], [], []],
    "none": [],
}


@pytest.mark.parametrize("case", list(RAGGED_CASES))
def test_ragged_methods_match_jax(case):
    rows = RAGGED_CASES[case]
    j = JRagged.from_lists(rows, dtype=np.int32)
    p = PRagged.from_lists(rows, dtype=np.int32)
    same(j, p)
    for n in (0, 1, 3, 100):
        same(j.tail(n), p.tail(n), f"tail {n}")
    other_rows = [[3, 1], [2], [], [9, 10, 5], [1]][:len(rows)]
    jo_, po_ = JRagged.from_lists(other_rows, dtype=np.int32), PRagged.from_lists(
        other_rows, dtype=np.int32)
    same(j.isin_per_row(jo_), p.isin_per_row(po_), "isin")
    same(j.concat_values(jo_), p.concat_values(po_), "concat")
    keep = np.arange(j.total) % 2 == 0
    same(j.filter_values(keep), p.filter_values(keep), "filter")
    same(j.explode_with_row_ids(), p.explode_with_row_ids(), "explode")
    same(j.shuffle_within_rows(np.random.default_rng(3)),
         p.shuffle_within_rows(np.random.default_rng(3)), "shuffle")
    dense = np.arange(12, dtype=np.int16).reshape(4, 3)
    same(JRagged.from_dense(dense), PRagged.from_dense(dense), "from_dense")
    with pytest.raises(ValueError, match="row counts"):
        p.isin_per_row(PRagged.from_lists([[1]] * (len(rows) + 1)))


def test_ragged_methods_on_a_split_match_jax(split, monkeypatch):
    _, df, _ = split
    hist = df[c.DEFAULT_HISTORY_ARTICLE_ID_COL]
    j, p = df[INVIEW], to_port(df[INVIEW])
    same(j.isin_per_row(df[CLICKED]), p.isin_per_row(to_port(df[CLICKED])))
    same(hist.tail(4), to_port(hist).tail(4))
    for align in ("left", "right"):
        same(j.to_padded(8, align=align), p.to_padded(8, align=align), align)
    # A value outside uint32: the native path answers as JAX's does, and
    # the numpy path (EBNERD_TPU_NO_NATIVE=1) refuses it, as JAX's does.
    neg, one = [[-1]], [[1]]
    same(JRagged.from_lists(neg).isin_per_row(JRagged.from_lists(one)),
         PRagged.from_lists(neg).isin_per_row(PRagged.from_lists(one)), "native isin")
    monkeypatch.setenv("EBNERD_TPU_NO_NATIVE", "1")
    with pytest.raises(ValueError, match="uint32"):
        PRagged.from_lists(neg).isin_per_row(PRagged.from_lists(one))
    with pytest.raises(ValueError, match="uint32"):
        JRagged.from_lists(neg).isin_per_row(JRagged.from_lists(one))


@pytest.mark.parametrize("rep", ["zeros", "mean"])
def test_lookup_functions_match_jax(split, rep):
    _, df, arts = split
    ids = np.asarray(arts[c.DEFAULT_ARTICLE_ID_COL])
    vals = np.random.default_rng(0).standard_normal((len(ids), 4)).astype(np.float32)
    jlk = jl.Lookup.from_values(ids, vals, rep)
    plk = pl.Lookup.from_values(ids, vals, rep)
    same(jl.map_list_article_id_to_value(df[INVIEW], jlk),
         pl.map_list_article_id_to_value(to_port(df[INVIEW]), plk))
    d = {int(i): v for i, v in zip(ids[::-1], vals[::-1])}
    same(jl.create_lookup_objects(d, rep), pl.create_lookup_objects(d, rep))
    with pytest.raises(ValueError, match="not a specified method"):
        pl.create_lookup_objects(d, "median")


# -- behaviors ------------------------------------------------------------------

def test_ebnerd_from_path_and_tables_match_jax(split):
    path, df, _ = split
    same(df, pb.ebnerd_from_path(path, history_size=10))
    history = j_read(path / "history.parquet")
    behaviors = j_read(path / "behaviors.parquet")
    same(df, pb.ebnerd_from_tables(to_port(behaviors), to_port(history), history_size=10))


@pytest.mark.parametrize("padding", [None, 0])
def test_truncate_and_join_match_jax(split, padding):
    path, _, _ = split
    hist = j_read(path / "history.parquet")
    col = c.DEFAULT_HISTORY_ARTICLE_ID_COL
    jt = jb.truncate_history(hist, col, 7, padding_value=padding)
    pt = pb.truncate_history(to_port(hist), col, 7, padding_value=padding)
    same(jt, pt)
    beh = j_read(path / "behaviors.parquet")
    # some users missing from the history: their rows get empty lists / zeros
    part = jt.take(np.arange(0, len(jt), 2))
    same(jb.join_history(beh, part), pb.join_history(to_port(beh), to_port(part)))


@pytest.mark.parametrize("source", ["split", "edge"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_labels_and_wu2019_match_jax_under_one_seed(split, source, shuffle):
    df = split[1] if source == "split" else _edge()
    same(jb.create_binary_labels_column(df, shuffle=shuffle, seed=11),
         pb.create_binary_labels_column(to_port(df), shuffle=shuffle, seed=11))
    # without replacement a pool shorter than npratio raises in both; the
    # split's rows with a long enough pool compare
    with pytest.raises(ValueError, match="larger sample"):
        jb.sampling_strategy_wu2019(df, 2, shuffle, False, seed=3)
    with pytest.raises(ValueError, match="larger sample"):
        pb.sampling_strategy_wu2019(to_port(df), 2, shuffle, False, seed=3)
    pooled = df.filter(df[INVIEW].lengths - df[CLICKED].lengths >= 2)
    for sub, npratio, repl in ((df, 4, True), (df, 1, True), (pooled, 2, False)):
        j = jb.sampling_strategy_wu2019(sub, npratio, shuffle, repl, seed=3)
        same(j, pb.sampling_strategy_wu2019(to_port(sub), npratio, shuffle, repl, seed=3),
             f"wu2019 {npratio} {repl}")
    j = jb.create_binary_labels_column(
        jb.sampling_strategy_wu2019(df, 4, shuffle=True, seed=42), shuffle=True, seed=42)
    p = pb.create_binary_labels_column(
        pb.sampling_strategy_wu2019(to_port(df), 4, shuffle=True, seed=42), shuffle=True, seed=42)
    same(j, p, "the CLI's train table")


@pytest.mark.parametrize("n,repl", [(3, True), (2, False), (1, False)])
def test_sample_article_ids_matches_jax(split, n, repl):
    df = jb.remove_positives_from_inview(split[1])
    if not repl:
        df = df.filter(df[INVIEW].lengths >= n)
    same(jb.sample_article_ids(df, n, repl, seed=9),
         pb.sample_article_ids(to_port(df), n, repl, seed=9))
    e = _edge()
    same(jb.sample_article_ids(e, 2, True, seed=1, empty_pool_value=-5),
         pb.sample_article_ids(to_port(e), 2, True, seed=1, empty_pool_value=-5))


def test_other_behaviors_functions_match_jax(split):
    _, df, _ = split
    pdf = to_port(df)
    same(jb.remove_positives_from_inview(df), pb.remove_positives_from_inview(pdf))
    for n in (None, 0, 3, 8):
        same(jb.filter_minimum_negative_samples(df, n), pb.filter_minimum_negative_samples(pdf, n))
    known = np.asarray(df[c.DEFAULT_USER_COL])[::3]
    same(jb.add_known_user_column(df, known), pb.add_known_user_column(pdf, known))
    scores = np.random.default_rng(0).random(df[INVIEW].total).astype(np.float64)
    same(jb.add_prediction_scores(df, scores), pb.add_prediction_scores(pdf, scores))
    rs = JRagged(scores, df[INVIEW].offsets)
    same(jb.add_prediction_scores(df, rs), pb.add_prediction_scores(pdf, to_port(rs)))
    with pytest.raises(ValueError, match="scores for"):
        pb.add_prediction_scores(pdf, scores[:-1])
    same(jb.unique_article_ids_in_behaviors(df), pb.unique_article_ids_in_behaviors(pdf))
    same(jb.create_user_id_to_int_mapping(df), pb.create_user_id_to_int_mapping(pdf))
    for n in (1, 2, 5):
        same(jb.down_sample_on_users(df, n, seed=4), pb.down_sample_on_users(pdf, n, seed=4))


# -- history, ops, decay, descriptive ------------------------------------------

def _log():
    rng = np.random.default_rng(2)
    n = 120
    items = rng.integers(1000, 1100, n)
    items[rng.random(n) < 0.1] = -1
    return JTable({
        c.DEFAULT_USER_COL: rng.integers(0, 12, n),
        c.DEFAULT_ARTICLE_ID_COL: items,
        c.DEFAULT_IMPRESSION_TIMESTAMP_COL: (np.datetime64("2023-02-01", "us")
                                             + rng.integers(0, 30 * 86400, n) * 1_000_000),
        c.DEFAULT_READ_TIME_COL: rng.exponential(20, n).astype(np.float32),
    })


@pytest.mark.parametrize("size", [None, 1, 4])
def test_history_builders_match_jax(size):
    log, cut = _log(), np.datetime64("2023-02-20", "us")
    if size is not None:
        same(jh.create_dynamic_history(log, size, null_value=-1),
             ph.create_dynamic_history(to_port(log), size, null_value=-1))
    same(jh.create_fixed_history(log, cut, size, null_value=-1),
         ph.create_fixed_history(to_port(log), cut, size, null_value=-1))
    same(jh.create_fixed_history_aggr_columns(log, cut, size, [c.DEFAULT_READ_TIME_COL],
                                              null_value=-1),
         ph.create_fixed_history_aggr_columns(to_port(log), cut, size,
                                              [c.DEFAULT_READ_TIME_COL], null_value=-1))


def test_ops_match_jax(split):
    _, df, _ = split
    pdf = to_port(df)
    hist = c.DEFAULT_HISTORY_ARTICLE_ID_COL
    same(jo.shuffle_rows(df, seed=3), po.shuffle_rows(pdf, seed=3))
    lab = jb.create_binary_labels_column(df)
    same(jo.shuffle_list_columns(lab, [INVIEW, c.DEFAULT_LABELS_COL], seed=2),
         po.shuffle_list_columns(to_port(lab), [INVIEW, c.DEFAULT_LABELS_COL], seed=2))
    same(jo.shuffle_list_columns(df, []), po.shuffle_list_columns(pdf, []))
    for frac, sh in ((0.3, True), (0.5, False)):
        same(jo.split_fraction(df, frac, seed=1, shuffle=sh),
             po.split_fraction(pdf, frac, seed=1, shuffle=sh))
    same(jo.split_in_n(df, 7), po.split_in_n(pdf, 7))
    dup = JRagged.from_lists([[3, 1, 3, 2, 1], [], [5, 5, 5]], dtype=np.int64)
    same(jo.keep_unique_values_in_list(dup), po.keep_unique_values_in_list(to_port(dup)))
    same(jo.keep_unique_values_in_list(df[hist]), po.keep_unique_values_in_list(to_port(df[hist])))
    allowed = np.unique(df[INVIEW].values)[::2]
    same(jo.filter_list_elements(df[INVIEW], allowed),
         po.filter_list_elements(to_port(df[INVIEW]), allowed))
    same(jo.remove_list_elements(df[INVIEW], allowed),
         po.remove_list_elements(to_port(df[INVIEW]), allowed))
    for n in (None, 3, 9):
        same(jo.filter_minimum_lengths_from_list(df, INVIEW, n),
             po.filter_minimum_lengths_from_list(pdf, INVIEW, n))
        same(jo.filter_maximum_lengths_from_list(df, INVIEW, n),
             po.filter_maximum_lengths_from_list(pdf, INVIEW, n))
    fl = JRagged.from_lists([[1.0, np.nan], [np.nan], [2.5]], dtype=np.float64)
    same(jo.drop_nulls_from_list(fl), po.drop_nulls_from_list(to_port(fl)))
    ob = JRagged(np.asarray(["a", None, "b"], dtype=object), np.array([0, 2, 3]))
    same(jo.drop_nulls_from_list(ob), po.drop_nulls_from_list(to_port(ob)))
    same(jo.drop_nulls_from_list(dup), po.drop_nulls_from_list(to_port(dup)))
    words = JRagged(np.asarray(["x", "y", "z"], dtype=object), np.array([0, 2, 2, 3]))
    same(jo.concat_list_str(words, "-"), po.concat_list_str(to_port(words), "-"))
    d = {"a": [1, 2], "b": [[1], [2, 3]]}
    same(jo.from_dict_to_table(d), po.from_dict_to_table(d))


def test_decay_and_descriptive_match_jax(split):
    path, df, _ = split
    for n in (1, 5, 10):
        for asc in (True, False):
            assert jd.linear_decay_weights(n, asc) == pd.linear_decay_weights(n, asc)
            assert (jd.exponential_decay_weights(n, 0.7, asc)
                    == pd.exponential_decay_weights(n, 0.7, asc))
    hist = c.DEFAULT_HISTORY_ARTICLE_ID_COL
    same(jd.add_decay_weights(df, hist), pd.add_decay_weights(to_port(df), hist))
    same(jd.add_decay_weights(df, hist, jd.exponential_decay_weights, False, lambda_factor=0.5),
         pd.add_decay_weights(to_port(df), hist, pd.exponential_decay_weights, False,
                              lambda_factor=0.5))
    same(jd.decay_weights_for_lengths(np.array([0, 2, 3]), jd.linear_decay_weights),
         pd.decay_weights_for_lengths(np.array([0, 2, 3]), pd.linear_decay_weights))
    h, w = np.ones((2, 3, 4), np.float32), np.arange(6, dtype=np.float32).reshape(2, 3)
    same(jd.apply_decay_dense(h, w), pd.apply_decay_dense(h, w))
    ht = pd.apply_decay_dense(torch.from_numpy(h), torch.from_numpy(w))
    assert torch.equal(ht, torch.from_numpy(jd.apply_decay_dense(h, w)))
    hist_t = j_read(path / "history.parquet")
    same(jdesc.min_max_impression_time_history(hist_t),
         pdesc.min_max_impression_time_history(to_port(hist_t)))
    same(jdesc.min_max_impression_time_behaviors(df),
         pdesc.min_max_impression_time_behaviors(to_port(df)))


# -- articles (without the tokenizer: test_torch_tokenizer.py) ---------------------

def test_article_functions_match_jax(split, tmp_path):
    _, _, arts = split
    parts = to_port(arts)
    cols = [c.DEFAULT_TITLE_COL, c.DEFAULT_SUBTITLE_COL]
    j_cat, p_cat = ja.concat_str_columns(arts, cols), pa_.concat_str_columns(parts, cols)
    same(j_cat, p_cat)
    for col in (c.DEFAULT_SENTIMENT_SCORE_COL, c.DEFAULT_SUBCATEGORY_COL):
        jmap = ja.create_article_id_to_value_mapping(arts, col)
        pmap = pa_.create_article_id_to_value_mapping(parts, col)
        assert list(jmap) == list(pmap)
        for k in jmap:
            same(np.asarray(jmap[k]), np.asarray(pmap[k]), f"{col}[{k}]")
    tok = np.random.default_rng(0).integers(0, 50, (len(arts), 6)).astype(np.int32)
    jt, pt = arts.with_columns(tok=JRagged.from_dense(tok)), parts.with_columns(
        tok=PRagged.from_dense(tok))
    for rep in ("zeros", "mean"):
        same(ja.build_token_lookup(jt, "tok", unknown_representation=rep).matrix,
             pa_.build_token_lookup(pt, "tok", unknown_representation=rep).matrix)
    same(ja.build_token_lookup(arts.with_columns(tok=tok), "tok").matrix,
         pa_.build_token_lookup(parts.with_columns(tok=tok), "tok").matrix)
    with pytest.raises(ValueError, match="fixed-width"):
        pa_.build_token_lookup(parts, c.DEFAULT_SUBCATEGORY_COL)
    for col, dt in ((c.DEFAULT_CATEGORY_COL, np.int32), (c.DEFAULT_SENTIMENT_SCORE_COL, None),
                    ("tok", np.float32)):
        jl_, pl_ = (ja.build_value_lookup(jt, col, dtype=dt),
                    pa_.build_value_lookup(pt, col, dtype=dt))
        same(jl_.ids, pl_.ids)
        same(jl_.matrix, pl_.matrix)
    for col, desc in ((c.DEFAULT_TOTAL_PAGEVIEWS_COL, True), (c.DEFAULT_TOTAL_READ_TIME_COL, False)):
        same(ja.create_sort_based_prediction_score(arts, col, desc),
             pa_.create_sort_based_prediction_score(parts, col, desc))
    # document embeddings from parquet, in another order than the articles
    from ebnerd_tpu.data.table import write_parquet

    ids = np.asarray(arts[c.DEFAULT_ARTICLE_ID_COL])[::-1]
    vecs = np.random.default_rng(1).standard_normal((len(ids), 3)).astype(np.float32)
    write_parquet(JTable({c.DEFAULT_ARTICLE_ID_COL: ids,
                          "document_vector": JRagged.from_dense(vecs)}), tmp_path / "emb.parquet")
    same(ja.load_article_id_embeddings(arts, tmp_path / "emb.parquet"),
         pa_.load_article_id_embeddings(parts, tmp_path / "emb.parquet"))


# -- synthetic -------------------------------------------------------------------

@pytest.mark.parametrize("test_set", [False, True])
def test_in_memory_synthetic_tables_equal_the_jax_parquet_round_trip(tmp_path, test_set):
    kw = dict(n_users=40, n_articles=90, n_impressions=300, seed=11, test_set=test_set)
    path = j_synthetic(tmp_path / "jax", **kw)
    history, behaviors, articles = synthetic_ebnerd_tables(**kw)
    for name, table in (("history", history), ("behaviors", behaviors), ("articles", articles)):
        same(j_read(path / f"{name}.parquet"), table, name)
    ppath = p_synthetic(tmp_path / "port", **kw)
    for name in ("history", "behaviors", "articles"):
        same(j_read(path / f"{name}.parquet"), to_port(j_read(ppath / f"{name}.parquet")), name)
    same(j_articles(np.random.default_rng(4), 20), p_articles(np.random.default_rng(4), 20))


# -- nlp ---------------------------------------------------------------------------

class _TinyEncoder(torch.nn.Module):
    """A stand-in for a Hugging Face encoder: word embeddings and a
    ``last_hidden_state``."""

    def __init__(self):
        super().__init__()
        self.embeddings = torch.nn.Module()
        self.embeddings.word_embeddings = torch.nn.Embedding(
            20, 6, _weight=torch.arange(120, dtype=torch.float32).reshape(20, 6) / 7)
        self.proj = torch.nn.Linear(6, 6)

    def forward(self, input_ids, attention_mask=None):
        class Out:
            pass

        out = Out()
        out.last_hidden_state = torch.tanh(self.proj(self.embeddings.word_embeddings(input_ids)))
        return out


class _TinyTokenizer:
    def __call__(self, texts, return_tensors=None, padding=True, truncation=True):
        ids = [[len(w) % 20 for w in t.split()] or [0] for t in texts]
        width = max(len(r) for r in ids)

        class Enc(dict):
            def to(self, device):
                return Enc({k: v.to(device) for k, v in self.items()})

        return Enc(input_ids=torch.tensor([r + [0] * (width - len(r)) for r in ids]))


def test_nlp_functions_match_jax():
    torch.manual_seed(0)
    model = _TinyEncoder()
    same(jn.get_transformers_word_embeddings(model), pn.get_transformers_word_embeddings(model))
    texts = ["a bb ccc", "dddd", "e ff", "ggg hh i jjjj", "k"]
    j = jn.generate_embeddings_with_transformers(model, _TinyTokenizer(), texts, batch_size=2,
                                                 device="cpu", disable_tqdm=True)
    p = pn.generate_embeddings_with_transformers(model, _TinyTokenizer(), texts, batch_size=2,
                                                 device="cpu", disable_tqdm=True)
    same(j, p)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_nlp_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pn.generate_embeddings_with_transformers(_TinyEncoder(), _TinyTokenizer(), ["a"])


# -- utils/misc --------------------------------------------------------------------

def test_misc_functions_match_jax(tmp_path):
    obj = {"a": 1, "b": {"c": [1, 2], "d": {"e": "x"}}, "t": np.datetime64("2023-01-01")}
    jm.write_json_file(obj, tmp_path / "j" / "o.json")
    pm.write_json_file(obj, tmp_path / "p" / "o.json")
    assert (tmp_path / "j" / "o.json").read_text() == (tmp_path / "p" / "o.json").read_text()
    assert pm.read_json_file(tmp_path / "j" / "o.json") == jm.read_json_file(tmp_path / "j" / "o.json")
    y = {"a": 1, "b": [1, 2]}
    pm.write_yaml_file(y, tmp_path / "y" / "o.yaml")
    assert pm.read_yaml_file(tmp_path / "y" / "o.yaml") == jm.read_yaml_file(
        tmp_path / "y" / "o.yaml") == y
    logs = []
    with pm.time_it("blk", log=logs.append):
        pass
    with pm.time_it("off", enable=False, log=logs.append):
        pass
    assert len(logs) == 1 and logs[0].startswith("blk: ")
    buf = io.StringIO()
    with redirect_stdout(buf), pm.time_it():
        pass
    assert buf.getvalue().startswith("block: ")
    for items, bs in ((range(7), 3), ([], 3), (range(4), 4)):
        assert list(pm.batch_items_generator(items, bs)) == list(jm.batch_items_generator(items, bs))
    assert pm.unnest_dictionary(obj) == jm.unnest_dictionary(obj)
    assert pm.unnest_dictionary(obj, sep="/") == jm.unnest_dictionary(obj, sep="/")
    assert pm.compute_npratio(3, 10) == jm.compute_npratio(3, 10)
    assert pm.convert_to_nested_list(range(7), 3) == jm.convert_to_nested_list(range(7), 3)
    assert len(pm.str_datetime_now()) == len(jm.str_datetime_now()) == 19

    class O:
        def __init__(self):
            self.x, self.y, self.f = 1, "s", lambda: 0

    assert pm.get_object_variables(O()) == jm.get_object_variables(O()) == {"x": 1, "y": "s"}
    assert pm.get_torch_device() == jm.get_torch_device()
    assert pm.get_torch_device(use_gpu=False) == jm.get_torch_device(use_gpu=False) == "cpu"
    assert pm.create_lookup_dict({1: 2}) == jm.create_lookup_dict({1: 2})
    m = np.arange(12).reshape(4, 3)
    same(jm.repeat_by_list_values_from_matrix([2, 0], m, [1, 3]),
         pm.repeat_by_list_values_from_matrix([2, 0], m, [1, 3]))
    assert json.loads(json.dumps(pm.unnest_dictionary({"a": {"b": 1}}))) == {"a.b": 1}
