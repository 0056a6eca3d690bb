"""Port two-tower serving (ArticleIndex + TwoTowerScorer) gives the JAX
package's two-tower scores on one synthetic split, and equals the port's
own full forward pass."""
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

    class LSTUR(torch.nn.Module):
        pass

    tables = {"title": np.zeros((2, T), np.int32)}
    assert model_kind(NPA()) is None
    with pytest.raises(ValueError, match="user-dependent"):
        ArticleIndex(NPA(), tables, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        ArticleIndex(LSTUR(), tables, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ArticleIndex(_port_model(setup[1], True), tables)
