"""The port's row-sparse word-embedding mode (``training/sparse_embed.py`` and
the Trainer's ``sparse_embedding``) against the JAX package's, fp32,
dropout 0, on the CPU: ``bucket_size`` and ``prep_sparse_batch`` bit-equal
(NRMS's title, NAML's title and body, per slot and before the article
dedup), ``rowwise_adam`` on one state (a pad id repeated while row 0 is
touched), three sparse Trainer steps of NRMS (dedup on and off), NAML,
LSTUR, NPA and Fastformer from one init through the bridge (table, both
moments and the rest), every configuration error; and within the port:
the first sparse step equals the dense step over the whole table, rows
skipped after being touched keep stale moments (LazyAdam), ``fit`` and
``score`` end to end, and resume from a sparse checkpoint bit-equal."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.models import config as jax_config
from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu.models import newsrec as jax_newsrec
from ebnerd_tpu.models.fastformer import Fastformer as JaxFastformer
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training import sparse_embed as jax_sparse
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.models import (LSTUR, NAML, NPA, NRMS, Fastformer, HParamsFastformer,
                                     HParamsLSTUR, HParamsNAML, HParamsNPA, HParamsNRMS,
                                     HParamsNRMSDocVec, NRMSDocVec, builder_for, token_batch)
from ebnerd_tpu_torch.training import Trainer, TrainerConfig, prep_dedup_batch
from ebnerd_tpu_torch.training import sparse_embed

torch.set_num_threads(1)

BS, H, K, T, TB, VOCAB, EMB, N_ART, N_USERS = 8, 5, 4, 6, 7, 60, 16, 30, 9
ATOL = 1e-5  # three Adam steps at lr 1e-4, fp32: only the summation order differs
HP = {
    "nrms": dict(title_size=T, history_size=H, head_num=2, head_dim=8, attention_hidden_dim=16),
    "lstur": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                  gru_unit=12, type="ini", n_users=N_USERS),
    "naml": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                 body_size=TB, vert_num=5, subvert_num=6),
    "npa": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                user_emb_dim=10, n_users=N_USERS),
    "fastformer": dict(n_layers=2, embedding_dim=16, n_heads=2, intermediate_dim=12,
                       max_position=32, title_size=T, history_size=H),
}
JAX = {"nrms": (jax_config.HParamsNRMS, jax_newsrec.NRMS),
       "lstur": (jax_config.HParamsLSTUR, jax_newsrec.LSTUR),
       "naml": (jax_config.HParamsNAML, jax_newsrec.NAML),
       "npa": (jax_config.HParamsNPA, jax_newsrec.NPA),
       "fastformer": (jax_config.HParamsFastformer, JaxFastformer)}
PORT = {"nrms": (HParamsNRMS, NRMS), "lstur": (HParamsLSTUR, LSTUR), "naml": (HParamsNAML, NAML),
        "npa": (HParamsNPA, NPA), "fastformer": (HParamsFastformer, Fastformer)}
STATE_DICT = {"nrms": bridge.nrms_state_dict, "lstur": bridge.lstur_state_dict,
              "naml": bridge.naml_state_dict, "npa": bridge.npa_state_dict,
              "fastformer": bridge.fastformer_state_dict}


def _tables(family="nrms"):
    rng = np.random.default_rng(1)
    tables = {"title": rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)}
    tables["title"][0] = 0
    tables["title"][5, 3:] = 0
    if family == "naml":
        tables["body"] = rng.integers(1, VOCAB, (N_ART + 1, TB)).astype(np.int32)
        tables["body"][0] = 0
        tables["cat"] = rng.integers(0, 5, N_ART + 1).astype(np.int32)
        tables["subcat"] = rng.integers(0, 6, N_ART + 1).astype(np.int32)
    return tables


def _raw(seed, users=False):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(1, N_ART + 1, (BS, K)).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    if users:
        raw["user_idx"] = rng.integers(0, N_USERS + 1, BS).astype(np.int32)
    return raw


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


def _loss(family):
    # Fastformer under the softmax CE: its user term cancels (ROADMAP C), so
    # those parameters would step on rounding noise; the log loss trains them
    return "log_loss" if family == "fastformer" else "cross_entropy_loss"


def _port_model(family, **kw):
    hp_cls, cls = PORT[family]
    extra = {} if family == "fastformer" else dict(word_emb_dim=EMB)
    if family in ("lstur", "npa", "naml"):
        extra["prng_dropout"] = True
    return cls(hp_cls(**dict(HP[family], dropout=0.0)), vocab_size=VOCAB, device="cpu",
               **extra, **kw)


def _jax_trainer(family, dedup=True, **cfg):
    hp_cls, cls = JAX[family]
    extra = {} if family == "fastformer" else dict(word_emb_dim=EMB)
    model = cls(hp_cls(**dict(HP[family], dropout=0.0)), vocab_size=VOCAB, **extra)
    return JaxTrainer(model, _tables(family), jax_inputs.builder_for(family),
                      JaxConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup,
                                loss=_loss(family), early_stopping_patience=None,
                                lr_patience=None, **cfg), log_fn=lambda s: None)


def _jax_sparse_steps(jtr, raws, dedup):
    """Three jitted JAX sparse steps; returns (initial params with the table,
    final params with the table, final table moments)."""
    jtr.init_state(raws[0])
    init = _tree(jtr._variables(jtr.state)["params"])
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    for raw in raws:
        r = jax_sparse.prep_sparse_batch(dict(raw), jtr._host_tables, jtr._sparse_tables, VOCAB,
                                         jtr.config.sparse_min_bucket)
        if dedup:
            r = jax_dedup.prep_dedup_batch(r, 512)
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(r), key)
    return init, _tree(jtr._variables(jtr.state)["params"]), (
        np.asarray(jtr.state.emb.m), np.asarray(jtr.state.emb.v))


def _port_trainer(family, params, dedup=True, **cfg):
    model = _port_model(family)
    model.load_state_dict(STATE_DICT[family](params), strict=True)
    return Trainer(model, _tables(family), builder_for(family),
                   TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup,
                                 loss=_loss(family), **cfg), device="cpu")


# ---- host prep -------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 8, 9, 4095, 4096, 4097, 85_000, 131_073])
def test_bucket_size_matches_jax(n):
    for minimum in (8, 4096):
        assert sparse_embed.bucket_size(n, minimum) == jax_sparse.bucket_size(n, minimum)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
@pytest.mark.parametrize("family", ["nrms", "naml"])
def test_prep_sparse_batch_bit_equal_to_jax(family, dedup, seed):
    """The port's host prep (vocabulary rows from the unique articles, then
    the article dedup) equals JAX's (every slot's tokens, then the dedup):
    every key, value and dtype; NAML's ids are title's and body's, its
    category tables are left alone."""
    tables = _tables(family)
    names = ("title", "body") if family == "naml" else ("title",)
    raw = _raw(seed)
    raw["hist_idx"][0] = 0  # a padded history
    want = jax_sparse.prep_sparse_batch(dict(raw), tables, names, VOCAB, min_bucket=8)
    got = sparse_embed.prep_sparse_batch(dict(raw), tables, names, VOCAB, min_bucket=8)
    if dedup:
        want, got = jax_dedup.prep_dedup_batch(want, 512), prep_dedup_batch(got, 512)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    idx = np.concatenate([raw["hist_idx"].ravel(), raw["cand_idx"].ravel()])
    touched = np.union1d(*[np.unique(tables[n][idx]) for n in names]) if family == "naml" \
        else np.unique(tables["title"][idx])
    n_valid = int(got["emb_valid"].sum())
    np.testing.assert_array_equal(got["emb_uniq"][:n_valid], touched)
    np.testing.assert_array_equal(got["emb_uniq"][got["emb_remap"][touched]], touched)


def test_trainer_host_prep_equals_jax_order():
    """The trainer's host preparation runs the sparse prep before the article
    dedup (which replaces hist_idx and cand_idx), as the JAX trainer does."""
    tr = _port_trainer("naml", _jax_sparse_params("naml"), sparse_embedding=True,
                       sparse_min_bucket=8)
    assert set(tr._sparse_tables) == {"title", "body"}
    raw = _raw(3)
    got = tr._prep_host(dict(raw))
    want = jax_dedup.prep_dedup_batch(jax_sparse.prep_sparse_batch(
        dict(raw), _tables("naml"), ("title", "body"), VOCAB, 8), 512)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ---- rowwise_adam ----------------------------------------------------------

def _adam_state(rng, v=12, e=5):
    table = rng.standard_normal((v, e)).astype(np.float32)
    m = rng.standard_normal((v, e)).astype(np.float32) * 0.01
    vv = rng.random((v, e)).astype(np.float32) * 1e-3
    return table, m, vv


@pytest.mark.parametrize("step", [1, 2, 7])
def test_rowwise_adam_matches_jax(step):
    """One row-wise update on the same state: JAX's bucket repeats the pad
    id 0 while row 0 is touched (its pads add masked zeros); the port, given
    the ids cut to the valid count as the trainer gives them, lands on the
    same table and moments (1e-7)."""
    rng = np.random.default_rng(step)
    table, m, v = _adam_state(rng)
    uniq = np.array([0, 2, 3, 7, 11, 0, 0, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    g = rng.standard_normal((8, 5)).astype(np.float32)
    g[5:] = rng.standard_normal((3, 5)) * 100  # pad slots' gradients must not leak
    st = jax_sparse.rowwise_adam(
        jax_sparse.SparseEmbedState(table=jnp.asarray(table), m=jnp.asarray(m),
                                    v=jnp.asarray(v)),
        jnp.asarray(uniq), jnp.asarray(valid), jnp.asarray(g), jnp.float32(1e-2),
        jnp.asarray(step, jnp.int32))
    want = [np.asarray(a) for a in (st.table, st.m, st.v)]
    ts, ms, vs = (torch.from_numpy(a.copy()) for a in (table, m, v))
    sparse_embed.rowwise_adam(ts, ms, vs, torch.from_numpy(uniq[:5]).long(),
                              torch.from_numpy(g[:5]), 1e-2, step)
    for got, ref, name in zip((ts, ms, vs), want, ("table", "m", "v")):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-7, rtol=0, err_msg=name)
    untouched = [1, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(ts.numpy()[untouched], table[untouched])
    assert np.abs(ts.numpy()[0] - table[0]).max() > 0  # row 0 moved, by its one real slot


def test_rowwise_adam_matches_the_formula():
    """The JAX test's hand-computed TF-style sparse Adam on a toy table."""
    table, m, v = torch.ones(4, 3), torch.zeros(4, 3), torch.zeros(4, 3)
    uniq = torch.tensor([1, 3])
    g = torch.tensor([[1.0], [2.0]]) * torch.ones(1, 3)
    lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    sparse_embed.rowwise_adam(table, m, v, uniq, g, lr, 1, b1, b2, eps)
    for row, gi in ((1, 1.0), (3, 2.0)):
        mm, vv = (1 - b1) * gi, (1 - b2) * gi * gi
        upd = lr * (mm / (1 - b1)) / (np.sqrt(vv / (1 - b2)) + eps)
        np.testing.assert_allclose(table[row].numpy(), 1.0 - upd, rtol=1e-6)
    assert torch.equal(table[0], torch.ones(3)) and torch.equal(m[0], torch.zeros(3))
    assert torch.equal(table[2], torch.ones(3))


# ---- the Trainer against JAX ----------------------------------------------

_PARAMS: dict = {}


def _jax_sparse_params(family):
    """The JAX init of ``family`` with its table (cached)."""
    if family not in _PARAMS:
        jtr = _jax_trainer(family, sparse_embedding=True, sparse_min_bucket=8)
        jtr.init_state(_raw(0, users=family in ("lstur", "npa")))
        _PARAMS[family] = _tree(jtr._variables(jtr.state)["params"])
    return _PARAMS[family]


@pytest.mark.parametrize("family,dedup", [("nrms", False), ("nrms", True), ("naml", True),
                                          ("lstur", True), ("npa", True), ("fastformer", True)],
                         ids=["nrms_per_slot", "nrms_dedup", "naml", "lstur", "npa", "fastformer"])
def test_sparse_trainer_three_steps_match_jax(family, dedup):
    """From one init (JAX's, with its table reinserted as ``_variables``
    does), three sparse steps leave the same table, table moments and other
    parameters in both packages."""
    raws = [_raw(10 + i, users=family in ("lstur", "npa")) for i in range(3)]
    jtr = _jax_trainer(family, dedup, sparse_embedding=True, sparse_min_bucket=8)
    init, want_params, (want_m, want_v) = _jax_sparse_steps(jtr, raws, dedup)
    want = STATE_DICT[family](want_params)
    tr = _port_trainer(family, init, dedup, sparse_embedding=True, sparse_min_bucket=8)
    assert tr.dedup is dedup and tr._emb_table is tr.model.word_embedding.embedding
    assert tr._emb_table.requires_grad  # left alone: the step gathers from it detached
    assert all(p is not tr._emb_table for g in tr.optimizer.param_groups for p in g["params"])
    for raw in raws:
        assert torch.isfinite(tr.train_step(dict(raw)))
        assert tr._emb_table.grad is None  # no dense [V, E] gradient, ever
    assert tr.step_count == 3
    np.testing.assert_allclose(tr._emb_m.numpy(), want_m, atol=ATOL, rtol=0, err_msg="m")
    np.testing.assert_allclose(tr._emb_v.numpy(), want_v, atol=ATOL, rtol=0, err_msg="v")
    start = STATE_DICT[family](init)
    for k, p in tr.model.state_dict().items():
        if family == "fastformer" and k.endswith(("query_att.bias", "key_att.bias")):
            # a bias shared by a head's tokens cancels in the softmax over
            # tokens; Adam steps on its rounding noise (test_torch_fastformer)
            for got in (p, want[k]):
                assert (got - start[k]).abs().max() <= 3 * 1e-4 * (1 + 1e-3), k
            continue
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def _nrms_trainer(sparse, lr=1e-2, **cfg):
    model = _port_model("nrms")
    model.load_state_dict(STATE_DICT["nrms"](_jax_sparse_params("nrms")), strict=True)
    return Trainer(model, _tables(), token_batch,
                   TrainerConfig(learning_rate=lr, seed=0, sparse_embedding=sparse,
                                 sparse_min_bucket=8, early_stopping_patience=None,
                                 lr_patience=None, **cfg), device="cpu")


def test_first_sparse_step_equals_the_dense_step():
    """From zero moments, step 1 of the sparse mode equals dense Adam over the
    whole table (untouched rows unchanged in both) and on every other
    parameter, with the same loss."""
    td, ts = _nrms_trainer(False), _nrms_trainer(True)
    raw = _raw(21)
    loss_d, loss_s = td.train_step(dict(raw)), ts.train_step(dict(raw))
    assert loss_d.item() == pytest.approx(loss_s.item(), abs=1e-6)
    np.testing.assert_allclose(ts.model.word_embedding.embedding.detach().numpy(),
                               td.model.word_embedding.embedding.detach().numpy(), atol=1e-6)
    prep = ts._prep_host(dict(raw))
    untouched = np.setdiff1d(np.arange(VOCAB), prep["emb_uniq"][:int(prep["emb_valid"].sum())])
    start = STATE_DICT["nrms"](_jax_sparse_params("nrms"))["word_embedding.embedding"].numpy()
    np.testing.assert_array_equal(
        ts.model.word_embedding.embedding.detach().numpy()[untouched], start[untouched])
    for k, p in td.model.state_dict().items():
        np.testing.assert_allclose(ts.model.state_dict()[k].numpy(), p.numpy(), atol=1e-6,
                                   err_msg=k)


def test_prepare_cuts_the_rows_to_the_valid_count():
    """The card gets the batch's touched ids only (no pad slot), and the
    token keys become slots into them."""
    tr = _nrms_trainer(True)
    raw = _raw(7)
    prep = tr._prep_host(dict(raw))
    n = int(prep["emb_valid"].sum())
    assert n < len(prep["emb_uniq"])  # the host bucket is padded
    batch = tr.prepare(dict(raw))
    np.testing.assert_array_equal(batch["emb_uniq"].numpy(), prep["emb_uniq"][:n])
    slots = batch["uniq_tokens"]
    assert 0 <= int(slots.min()) and int(slots.max()) < n
    np.testing.assert_array_equal(batch["emb_uniq"][slots].numpy(),
                                  _tables()["title"][prep["art_uniq"]])


def test_a_dense_trainer_after_a_sparse_one_trains_the_table():
    """The sparse mode leaves the table's ``requires_grad`` alone, so a
    dense trainer built later on the same model still updates it."""
    ts = _nrms_trainer(True)
    ts.train_step(_raw(8))
    assert ts.model.word_embedding.embedding.requires_grad
    td = Trainer(ts.model, _tables(), token_batch,
                 TrainerConfig(learning_rate=1e-2, seed=0), device="cpu")
    before = td.model.word_embedding.embedding.detach().clone()
    td.train_step(_raw(9))
    table = td.model.word_embedding.embedding
    assert table.grad is not None and (table.detach() - before).abs().max() > 0


def test_stale_moment_semantics_rows_skip_updates():
    """A row touched at step 1 and absent at step 2 does not move at step 2,
    and neither do its moments (LazyAdam); the dense mode moves it."""
    ts, td = _nrms_trainer(True), _nrms_trainer(False)
    b1 = _raw(5)
    b2 = {"hist_idx": np.ones((BS, H), np.int32), "cand_idx": np.ones((BS, K), np.int32),
          "labels": b1["labels"].copy()}  # only article 1: few rows touched
    for tr in (ts, td):
        tr.train_step(dict(b1))
    after1 = ts.model.word_embedding.embedding.detach().clone()
    m1 = ts._emb_m.clone()
    p2 = ts._prep_host(dict(b2))
    touched2 = p2["emb_uniq"][:int(p2["emb_valid"].sum())]
    for tr in (ts, td):
        tr.train_step(dict(b2))
    untouched = np.setdiff1d(np.arange(VOCAB), touched2)
    after2 = ts.model.word_embedding.embedding.detach()
    assert torch.equal(after2[untouched], after1[untouched])
    assert torch.equal(ts._emb_m[untouched], m1[untouched])
    assert (after2[touched2] - after1[touched2]).abs().max() > 0
    p1 = ts._prep_host(dict(b1))
    stale = np.setdiff1d(p1["emb_uniq"][:int(p1["emb_valid"].sum())], touched2)
    assert len(stale) > 0
    dense_after = td.model.word_embedding.embedding.detach()
    assert (dense_after[stale] - after1[stale]).abs().max() > 0  # dense decays and moves them


# ---- configuration errors --------------------------------------------------

def _docvec_case(mod):
    hp = (jax_config.HParamsNRMSDocVec if mod == "jax" else HParamsNRMSDocVec)(
        title_size=8, history_size=H, head_num=2, head_dim=4, attention_hidden_dim=8,
        newsencoder_units_per_layer=(8,))
    tables = {"docvec": np.random.default_rng(0).standard_normal((N_ART + 1, 8)).astype(np.float32)}
    if mod == "jax":
        return jax_newsrec.NRMSDocVec(hp), tables, jax_inputs.builder_for("nrms_docvec")
    return NRMSDocVec(hp, device="cpu"), tables, builder_for("nrms_docvec")


CONFIG_ERRORS = {
    "accumulation": dict(cfg=dict(accumulation_steps=2)),
    "scan_steps": dict(cfg=dict(scan_steps=2)),
    "l2": dict(cfg=dict(l2_regularization=1e-4)),
    "unmapped_table": dict(tables=lambda: dict(_tables(), extra=np.zeros((N_ART + 1, 3), np.int32))),
    "no_token_tables": dict(cfg=dict(sparse_token_tables={"body": ("hist_body",)})),
    "nrms_docvec": dict(docvec=True),
}


@pytest.mark.parametrize("case", list(CONFIG_ERRORS))
def test_config_errors_match_jax(case):
    spec = CONFIG_ERRORS[case]
    cfg = dict(sparse_embedding=True, **spec.get("cfg", {}))
    if spec.get("docvec"):
        (jm, jt, jb), (pm, pt, pb) = _docvec_case("jax"), _docvec_case("port")
    else:
        tables = spec.get("tables", _tables)()
        jm = JAX["nrms"][1](JAX["nrms"][0](**HP["nrms"]), vocab_size=VOCAB, word_emb_dim=EMB)
        jt, jb, pm, pt, pb = tables, jax_inputs.token_batch, _port_model("nrms"), tables, token_batch
    with pytest.raises(ValueError) as jerr:
        JaxTrainer(jm, jt, jb, JaxConfig(**cfg), log_fn=lambda s: None)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        Trainer(pm, pt, pb, TrainerConfig(**cfg), device="cpu")


def test_model_without_the_named_table_raises_as_jax():
    """A sparse_embed_param the model lacks: JAX raises when it initialises
    the state, the port when it builds the trainer, with the same message."""
    jtr = _jax_trainer("nrms", sparse_embedding=True, sparse_embed_param="words")
    with pytest.raises(ValueError) as jerr:
        jtr.init_state(_raw(0))
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        _nrms_trainer(True, sparse_embed_param="words")


@pytest.mark.parametrize("family,name", [("lstur", "user_embedding"), ("npa", "user_embedding"),
                                         ("naml", "vert_embedding"),
                                         ("fastformer", "position_embedding")])
def test_sparse_embed_param_takes_only_the_word_table(family, name):
    """Another table of the model would be gathered by vocabulary ids while
    the word table stayed dense: the port refuses it."""
    model = _port_model(family)
    assert isinstance(getattr(model, name).embedding, torch.nn.Parameter)
    with pytest.raises(ValueError, match="sparse_embed_param must be 'word_embedding'"):
        Trainer(model, _tables(family), builder_for(family),
                TrainerConfig(sparse_embedding=True, sparse_embed_param=name), device="cpu")


# ---- fit, score and resume -------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from ebnerd_tpu import constants as c
    from ebnerd_tpu.data.behaviors import (create_binary_labels_column, ebnerd_from_path,
                                           sampling_strategy_wu2019)
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet
    from ebnerd_tpu.data.ragged import Ragged as JaxRagged
    from ebnerd_tpu_torch.data import Ragged, Table

    def port_table(df):
        return Table({n: Ragged(df[n].values, df[n].offsets) if isinstance(df[n], JaxRagged)
                      else np.asarray(df[n]) for n in df.columns})

    path = make_synthetic_ebnerd(tmp_path_factory.mktemp("torch_sparse") / "d", n_users=30,
                                 n_articles=50, n_impressions=160, seed=11)
    df = ebnerd_from_path(path, history_size=H)
    train = create_binary_labels_column(sampling_strategy_wu2019(df, npratio=K - 1, shuffle=True,
                                                                 seed=2))
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    tokens = np.random.default_rng(0).integers(1, VOCAB, (len(ids), T)).astype(np.int32)
    return dict(train=port_table(train), val=port_table(create_binary_labels_column(df)),
                ids=ids, tokens=tokens)


def _fit_trainer(s, dropout=0.0):
    from ebnerd_tpu_torch.data import Lookup

    lookup = Lookup.from_values(s["ids"], s["tokens"])
    model = NRMS(HParamsNRMS(**dict(HP["nrms"], dropout=dropout)), vocab_size=VOCAB,
                 word_emb_dim=EMB, use_fused_encoder=True, device="cpu")
    tr = Trainer(model, {"title": lookup.matrix}, token_batch,
                 TrainerConfig(learning_rate=1e-2, seed=0, sparse_embedding=True,
                               sparse_min_bucket=8, early_stopping_patience=None,
                               lr_patience=None), device="cpu", log_fn=lambda m: None)
    return tr, lookup


def _feeds(s, lookup):
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.data import EvalFeed, NewsrecFeed

    return (NewsrecFeed(s["train"], lookup, history_size=H, batch_size=BS, seed=4),
            EvalFeed(s["val"], lookup, history_size=H, batch_size=16),
            s["val"][c.DEFAULT_LABELS_COL])


def test_sparse_fit_and_score_end_to_end(split):
    """fit with the host prep on the prefetch thread, validation through the
    in-place table; scores finite, two-tower equal to the full forward."""
    tr, lookup = _fit_trainer(split)
    train, val, labels = _feeds(split, lookup)
    start = tr.model.word_embedding.embedding.detach().clone()
    hist = tr.fit(train, val, labels, epochs=2)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) and 0 <= h["val_auc"] <= 1 for h in hist)
    assert not torch.equal(tr.model.word_embedding.embedding, start)
    assert tr._emb_table.grad is None
    two_tower = tr.score(val, two_tower=True)
    full = tr.score(val, two_tower=False)
    assert np.isfinite(two_tower.values).all()
    np.testing.assert_allclose(two_tower.values, full.values, atol=1e-6)


def test_sparse_resume_is_bit_equal(split, tmp_path):
    """A sparse run with dropout stopped after epoch 1 and resumed from its
    checkpoint equals an uninterrupted one bit for bit: table, moments, the
    other parameters and Adam's state; the best weights restore the table's
    moments too."""
    whole, lookup = _fit_trainer(split, dropout=0.2)
    train, val, labels = _feeds(split, lookup)
    whole.fit(train, val, labels, epochs=3, ckpt_dir=tmp_path / "whole")
    cut, _ = _fit_trainer(split, dropout=0.2)
    cut.fit(*_feeds(split, lookup), epochs=1, ckpt_dir=tmp_path / "cut")
    resumed, _ = _fit_trainer(split, dropout=0.2)
    resumed.fit(*_feeds(split, lookup), epochs=3, ckpt_dir=tmp_path / "cut", resume=True)
    assert resumed.history == whole.history
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert torch.equal(resumed._emb_m, whole._emb_m) and torch.equal(resumed._emb_v, whole._emb_v)
    best = torch.load(tmp_path / "whole" / "best" / "state.pt", weights_only=True)
    assert set(best["emb"]) == {"m", "v"} and best["emb"]["m"].shape == (VOCAB, EMB)
    for k, v in best["model"].items():  # fit ends on the best epoch's weights and moments
        assert torch.equal(whole.model.state_dict()[k], v), k
    assert torch.equal(whole._emb_m, best["emb"]["m"]) and torch.equal(whole._emb_v,
                                                                       best["emb"]["v"])


# ---- tools/embed_grad.py: its host parts (the timing needs the card) ---------

def _jax_script_function(name):
    """A function of ``scripts/bench_embed_grad2.py``, compiled alone (the
    script runs its benchmark when imported)."""
    import ast
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "bench_embed_grad2.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np, "V": 250_002}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns[name]


def test_embed_grad_tool_draws_dedups_and_counts_as_the_script():
    from ebnerd_tpu_torch.tools import embed_grad as eg

    m = 20_000
    ours = eg.zipf_tokens(np.random.default_rng(3), m)
    want = _jax_script_function("zipf_tokens")(np.random.default_rng(3), m)
    np.testing.assert_array_equal(ours, want)
    uniq, remap, _ = eg.host_dedup(ours)
    np.testing.assert_array_equal(uniq, np.unique(ours))
    np.testing.assert_array_equal(uniq[remap[ours]], ours)  # the slots address the rows
    e4, v = eg.E * 4, eg.V
    assert eg.bytes_moved("dense", m, 7) == m * 8 + m * e4 + 6 * v * e4
    assert eg.bytes_moved("dense_bf16_mu", m, 7) == m * 8 + m * e4 + 2 * v * eg.E * 10
    assert eg.bytes_moved("hostdedup", m, 7) == m * 8 + m * e4 + 6 * 7 * e4 + 7 * 8
    if not torch.cuda.is_available():
        assert eg.main([]) == 2


def test_a_batch_without_token_0_masks_its_smallest_id_as_jax_does():
    """The remap sends the smallest touched id to slot 0. When a batch holds
    no padding token (id 0), the models' ``tokens != 0`` masks then treat
    that id as padding: the sparse step's loss leaves the dense step's, in
    JAX and alike in the port (ROADMAP C, a Watch)."""
    tables = _tables("lstur")
    tables["title"] = np.random.default_rng(9).integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    raw = _raw(50, users=True)
    raw["hist_idx"] = np.maximum(raw["hist_idx"], 1)
    params = _jax_sparse_params("lstur")
    losses = {}
    for sparse in (False, True):
        jtr = JaxTrainer(JAX["lstur"][1](JAX["lstur"][0](**dict(HP["lstur"], dropout=0.0)),
                                         vocab_size=VOCAB, word_emb_dim=EMB),
                         tables, jax_inputs.builder_for("lstur"),
                         JaxConfig(learning_rate=1e-4, seed=0, sparse_embedding=sparse,
                                   sparse_min_bucket=8), log_fn=lambda s: None)
        jtr.init_state(raw)
        p = {k: v for k, v in params.items() if not (sparse and k == "word_embedding")}
        jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, p),
                                      opt_state=jtr.tx.init(p))
        if sparse:
            jtr.state = jtr.state.replace(emb=jax_sparse.SparseEmbedState.create(
                jnp.asarray(params["word_embedding"]["embedding"])))
        r = dict(raw)
        if sparse:
            r = jax_sparse.prep_sparse_batch(r, jtr._host_tables, jtr._sparse_tables, VOCAB, 8)
        r = jax_dedup.prep_dedup_batch(r, 512)
        _, jloss = jtr._train_step(jtr.state, jtr._put(r), jax.random.key(0, impl="rbg"))
        model = _port_model("lstur")
        model.load_state_dict(STATE_DICT["lstur"](params), strict=True)
        tr = Trainer(model, tables, builder_for("lstur"),
                     TrainerConfig(learning_rate=1e-4, seed=0, sparse_embedding=sparse,
                                   sparse_min_bucket=8), device="cpu")
        losses[sparse] = (float(jloss), tr.train_step(dict(raw)).item())
    assert abs(losses[True][0] - losses[False][0]) > 1e-4  # the mask moved in JAX
    for sparse in (False, True):
        assert losses[sparse][1] == pytest.approx(losses[sparse][0], abs=1e-5), sparse
