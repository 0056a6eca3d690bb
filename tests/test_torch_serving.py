"""Port two-tower serving (ArticleIndex + TwoTowerScorer) gives the JAX
package's two-tower scores on one synthetic split for NRMS, LSTUR and
NAML, and equals the port's own full forward pass; both towers run in eval
mode whatever the model's mode (an index built after a training step
equals the eval-mode index bit for bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu import constants as c
from ebnerd_tpu.data.behaviors import create_binary_labels_column, ebnerd_from_path
from ebnerd_tpu.data.dataloader import EvalFeed as JaxEvalFeed
from ebnerd_tpu.data.lookup import Lookup as JaxLookup
from ebnerd_tpu.data.ragged import Ragged as JaxRagged
from ebnerd_tpu.models.config import HParamsNRMS as JaxHP
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.serving import ArticleIndex as JaxIndex
from ebnerd_tpu.serving import TwoTowerScorer as JaxScorer
from ebnerd_tpu_torch.bridge import load_nrms_params
from ebnerd_tpu_torch.data import EvalFeed, Lookup, Ragged, Table
from ebnerd_tpu_torch.models import NRMS, HParamsNRMS
from ebnerd_tpu_torch.serving import ArticleIndex, TwoTowerScorer, model_kind

torch.set_num_threads(1)

H, T, VOCAB, EMB = 5, 8, 150, 16
HP = dict(title_size=T, history_size=H, head_num=2, head_dim=8, attention_hidden_dim=16)


def port_table(df) -> Table:
    """The port's Table over the same numpy arrays / ragged offsets+values."""
    return Table({n: Ragged(df[n].values, df[n].offsets) if isinstance(df[n], JaxRagged)
                  else np.asarray(df[n]) for n in df.columns})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet

    path = tmp_path_factory.mktemp("torch_serving") / "train"
    make_synthetic_ebnerd(path, n_users=30, n_articles=60, n_impressions=150, seed=4)
    df = create_binary_labels_column(ebnerd_from_path(path, history_size=H))
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    tokens = np.random.default_rng(1).integers(1, VOCAB, (len(ids), T)).astype(np.int32)
    jlookup = JaxLookup.from_values(ids, tokens)
    jmodel = JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=EMB)
    dummy = {"hist_tokens": jnp.zeros((2, H, T), jnp.int32),
             "cand_tokens": jnp.zeros((2, 3, T), jnp.int32)}
    params = jmodel.init(jax.random.PRNGKey(0), dummy)["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    jfeed = JaxEvalFeed(df, jlookup, history_size=H, batch_size=16)
    jindex = JaxIndex(jmodel, {"params": params}, {"title": jlookup.matrix}, batch_size=16)
    ref = np.asarray(JaxScorer(jindex).score(jfeed).values)
    feed = EvalFeed(port_table(df), Lookup.from_values(ids, tokens), history_size=H,
                    batch_size=16)
    return feed, params, ref


def _port_model(params, fused):
    m = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB,
             use_fused_encoder=fused, device="cpu")
    return load_nrms_params(m, params)


@pytest.mark.parametrize("fused", [False, True])
def test_two_tower_matches_jax(setup, fused):
    feed, params, ref = setup
    model = _port_model(params, fused)
    index = ArticleIndex(model, {"title": feed.lookup.matrix}, batch_size=16, device="cpu")
    scores = TwoTowerScorer(index).score(feed)
    np.testing.assert_array_equal(scores.offsets, feed.inview.offsets)
    assert scores.values.shape == ref.shape and np.isfinite(scores.values).all()
    np.testing.assert_allclose(scores.values, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_two_tower_matches_full_forward(setup, fused):
    feed, params, _ = setup
    model = _port_model(params, fused)
    title = torch.from_numpy(feed.lookup.matrix).long()
    full = np.zeros((feed.n_rows, feed.width), np.float32)
    with torch.no_grad():
        for raw in feed.batches():
            batch = {"hist_tokens": title[torch.from_numpy(raw["hist_idx"]).long()],
                     "cand_tokens": title[torch.from_numpy(raw["cand_idx"]).long()]}
            s = torch.sigmoid(model(batch)).numpy()
            full[raw["rows"], : s.shape[1]] = s[: len(raw["rows"])]
    index = ArticleIndex(model, {"title": feed.lookup.matrix}, batch_size=16, device="cpu")
    tt = TwoTowerScorer(index).score(feed)
    np.testing.assert_allclose(tt.values, feed.unpad(full).values, rtol=1e-5, atol=1e-6)


def test_index_pads_last_chunk_with_row_zero(setup):
    feed, params, _ = setup
    model = _port_model(params, True)
    tables = {"title": feed.lookup.matrix}
    n_rows = feed.lookup.n_rows
    assert n_rows % 16  # the last chunk is partial
    vecs = ArticleIndex(model, tables, batch_size=16, device="cpu").build()
    whole = ArticleIndex(model, tables, batch_size=n_rows, device="cpu").build()
    assert vecs.shape == (n_rows, 16)
    torch.testing.assert_close(vecs, whole, rtol=1e-5, atol=1e-6)


def test_unsupported_family_and_device(setup):
    class NPA(torch.nn.Module):
        pass

    class Fastformer(torch.nn.Module):
        pass

    tables = {"title": np.zeros((2, T), np.int32)}
    assert model_kind(NPA()) is None
    with pytest.raises(ValueError, match="user-dependent"):
        ArticleIndex(NPA(), tables, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        ArticleIndex(Fastformer(), tables, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ArticleIndex(_port_model(setup[1], True), tables)


# ---- eval mode after training (C1) -----------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_index_after_a_training_step_equals_the_eval_index(setup, fused):
    """One Trainer step with dropout 0.2 leaves the model in training mode;
    the index and the scores built then equal those built in eval mode, bit
    for bit, and the model is back in training mode afterwards."""
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig

    feed, params, _ = setup
    model = load_nrms_params(NRMS(HParamsNRMS(**dict(HP, dropout=0.2)), vocab_size=VOCAB,
                                  word_emb_dim=EMB, use_fused_encoder=fused, device="cpu"), params)
    tables = {"title": feed.lookup.matrix}
    tr = Trainer(model, tables, token_batch, TrainerConfig(seed=0), device="cpu")
    rng = np.random.default_rng(9)
    n = feed.lookup.n_rows
    raw = {"hist_idx": rng.integers(0, n, (8, H)).astype(np.int32),
           "cand_idx": rng.integers(1, n, (8, 3)).astype(np.int32),
           "labels": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]}
    tr.train_step(raw)
    assert model.training
    index = ArticleIndex(model, tables, batch_size=16, device="cpu")
    vecs = index.build().clone()
    scores = TwoTowerScorer(index).score(feed).values
    assert model.training
    model.eval()
    eval_index = ArticleIndex(model, tables, batch_size=16, device="cpu")
    assert torch.equal(vecs, eval_index.build())
    np.testing.assert_array_equal(scores, TwoTowerScorer(eval_index).score(feed).values)


# ---- LSTUR and NAML ----------------------------------------------------------

CONV = dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12, dropout=0.0)
TB = 7


def _family(name, ids, n_users):
    """(JAX model, port model, value tables) of one family, the same weights."""
    from ebnerd_tpu.models import config as jax_config
    from ebnerd_tpu.models import newsrec as jax_newsrec
    from ebnerd_tpu_torch import bridge
    from ebnerd_tpu_torch.models import LSTUR, NAML, HParamsLSTUR, HParamsNAML

    rng = np.random.default_rng(2)
    n = len(ids) + 1
    tables = {"title": rng.integers(1, VOCAB, (n, T)).astype(np.int32),
              "body": rng.integers(1, VOCAB, (n, TB)).astype(np.int32),
              "cat": rng.integers(0, 5, n).astype(np.int32),
              "subcat": rng.integers(0, 6, n).astype(np.int32)}
    for t in tables.values():
        t[0] = 0
    tables["title"][4] = 0  # an article with an empty title: masked out of LSTUR's GRU
    tables["title"][6, 3:] = 0
    if name == "lstur":
        hp = dict(CONV, n_users=n_users, gru_unit=12, type="ini")
        jmodel = jax_newsrec.LSTUR(jax_config.HParamsLSTUR(**hp), vocab_size=VOCAB,
                                   word_emb_dim=EMB)
        dummy = {"hist_tokens": jnp.zeros((2, H, T), jnp.int32),
                 "cand_tokens": jnp.zeros((2, 3, T), jnp.int32),
                 "user_id": jnp.zeros((2,), jnp.int32)}
        port = LSTUR(HParamsLSTUR(**hp), vocab_size=VOCAB, word_emb_dim=EMB, prng_dropout=True,
                     device="cpu")
        load = bridge.load_lstur_params
    else:
        hp = dict(CONV, body_size=TB, vert_num=5, subvert_num=6)
        jmodel = jax_newsrec.NAML(jax_config.HParamsNAML(**hp), vocab_size=VOCAB,
                                  word_emb_dim=EMB)
        dummy = {f"{s}_{k}": jnp.zeros((2, w) + ((L,) if L else ()), jnp.int32)
                 for s, w in (("hist", H), ("cand", 3))
                 for k, L in (("tokens", T), ("body", TB), ("cat", 0), ("subcat", 0))}
        port = NAML(HParamsNAML(**hp), vocab_size=VOCAB, word_emb_dim=EMB, prng_dropout=True,
                    device="cpu")
        load = bridge.load_naml_params
    params = jmodel.init(jax.random.PRNGKey(0), dummy)["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    if name == "lstur":  # a non-zero long-term user embedding (zeros at init)
        params["user_embedding"]["embedding"] = (
            np.random.default_rng(3).standard_normal(params["user_embedding"]["embedding"].shape)
            .astype(np.float32) * 0.1)
    return jmodel, params, load(port, params), tables


@pytest.mark.parametrize("name", ["lstur", "naml"])
def test_conv_family_two_tower_matches_jax_and_full_forward(tmp_path, name):
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet
    from ebnerd_tpu_torch.models import builder_for

    path = make_synthetic_ebnerd(tmp_path / "d", n_users=20, n_articles=40, n_impressions=90,
                                 seed=5)
    df = create_binary_labels_column(ebnerd_from_path(path, history_size=H))
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    users = np.unique(np.asarray(df[c.DEFAULT_USER_COL]))
    umap = {int(u): i for i, u in enumerate(users[:-2])}  # 2 users unseen
    jmodel, params, model, tables = _family(name, ids, len(umap))
    model.train()  # serving switches to eval mode itself
    jfeed = JaxEvalFeed(df, JaxLookup.from_values(ids, tables["title"][1:]), history_size=H,
                        batch_size=16, user_mapping=umap)
    ref = np.asarray(JaxScorer(JaxIndex(jmodel, {"params": params}, tables, batch_size=16))
                     .score(jfeed).values)
    feed = EvalFeed(port_table(df), Lookup.from_values(ids, tables["title"][1:]), history_size=H,
                    batch_size=16, user_mapping=umap)
    index = ArticleIndex(model, tables, batch_size=16, device="cpu")
    scores = TwoTowerScorer(index).score(feed)
    assert model.training
    np.testing.assert_array_equal(scores.offsets, feed.inview.offsets)
    np.testing.assert_allclose(scores.values, ref, rtol=1e-5, atol=1e-6)

    builder = builder_for(name)
    dev_tables = {k: torch.from_numpy(v).long() for k, v in tables.items()}
    full = np.zeros((feed.n_rows, feed.width), np.float32)
    model.eval()
    with torch.no_grad():
        for raw in feed.batches():
            s = torch.sigmoid(model(builder(dev_tables, raw))).numpy()
            full[raw["rows"], : s.shape[1]] = s[: len(raw["rows"])]
    np.testing.assert_allclose(scores.values, feed.unpad(full).values, rtol=1e-5, atol=1e-6)
