"""The port's NPA against the JAX package, fp32, dropout 0 in training mode:
``HParamsNPA``, ``PersonalizedAttentivePooling`` (its three methods and the
call, outputs and gradients), logits and every parameter gradient on the
per-slot and the (partial) dedup batch, the bridge's strict load, three
Trainer steps from one init, and ``Trainer.score`` (the full forward; NPA
has no two-tower serving). Within the port: dedup against per-slot,
``remat_encoder`` against the plain model with dropout on, and the four
dropout sites seeded by (seed, stream), eight seed-recompute launches per
step."""
import dataclasses
from unittest import mock

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
from ebnerd_tpu.models import config as jax_config
from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu.models.layers import PersonalizedAttentivePooling as JaxPAP
from ebnerd_tpu.models.newsrec import NPA as JaxNPA
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training import losses as jax_losses
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.data import EvalFeed, Lookup, Ragged, Table
from ebnerd_tpu_torch.models import NPA, HParamsNPA, builder_for, config, token_batch
from ebnerd_tpu_torch.models.layers import PersonalizedAttentivePooling
from ebnerd_tpu_torch.ops import dropout as k3
from ebnerd_tpu_torch.serving import ArticleIndex, model_kind
from ebnerd_tpu_torch.training import (Trainer, TrainerConfig, dedup_capable, losses,
                                       prep_dedup_batch)

torch.set_num_threads(1)

BS, H, K, T, VOCAB, EMB, N_ART, N_USERS = 8, 5, 4, 6, 60, 16, 30, 9
HP = dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12, user_emb_dim=10,
          n_users=N_USERS, dropout=0.0)
ATOL = 5e-5  # fp32: only the summation order differs
SEED = (0x5EED << 32) | 99


def _tables():
    rng = np.random.default_rng(1)
    title = rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    title[0] = 0
    title[3] = 0
    title[5, 2:] = 0
    return {"title": title}


def _raw(seed):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(1, N_ART + 1, (BS, K)).astype(np.int32),
           "user_idx": rng.integers(0, N_USERS + 1, BS).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["hist_idx"][0] = 0
    raw["hist_idx"][1, :2] = 3
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    return raw


def _jax_model(**kw):
    return JaxNPA(jax_config.HParamsNPA(**HP), vocab_size=VOCAB, word_emb_dim=EMB, **kw)


def _load(model, params):
    model.load_state_dict(bridge.npa_state_dict(params), strict=True)
    return model


def _port_model(dropout=0.0, **kw):
    return NPA(HParamsNPA(**dict(HP, dropout=dropout)), vocab_size=VOCAB, word_emb_dim=EMB,
               device="cpu", **kw)


def _jax_batch(dedup, seed=7):
    raw = _raw(seed)
    if dedup:
        raw = jax_dedup.prep_dedup_batch(raw, 256)
        raw.pop("n_uniq")
    tables = {k: jnp.asarray(v) for k, v in _tables().items()}
    batch = jax_inputs.token_batch(tables, {k: jnp.asarray(v) for k, v in raw.items()})
    return batch, raw["labels"]


def _port_batch(dedup, seed=7):
    raw = _raw(seed)
    if dedup:
        raw = prep_dedup_batch(raw, 256)
    tables = {k: torch.from_numpy(v).long() for k, v in _tables().items()}
    return token_batch(tables, raw), raw["labels"]


def _random_biases(tree, rng):
    """Non-zero biases and user embeddings (zeros at init), so their
    gradients and the personalized queries are exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_biases(v, rng)
        elif k in ("b", "bias") or (k == "embedding" and not v.any()):
            out[k] = (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
        else:
            out[k] = v
    return out


_PARAMS = {}


def _params():
    if not _PARAMS:
        batch, _ = _jax_batch(False)
        p = _jax_model().init(jax.random.PRNGKey(0), batch)["params"]
        p = jax.tree_util.tree_map(np.asarray, jax.device_get(p))
        _PARAMS["p"] = _random_biases(p, np.random.default_rng(2))
    return _PARAMS["p"]


def _jax_logits_grads(dedup):
    m = _jax_model()
    batch, labels = _jax_batch(dedup)

    def loss(p):
        logits = m.apply({"params": p}, batch, True, rngs={"dropout": jax.random.key(0)})
        return jax_losses.categorical_crossentropy(logits, jnp.asarray(labels)), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(_params())
    return np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads)


def _port_logits_grads(dedup, batch=None, dropout=0.0, **kw):
    model = _load(_port_model(dropout, **kw), _params()).train()
    b, labels = _port_batch(dedup)
    logits = model(b if batch is None else batch)
    losses.categorical_crossentropy(logits, torch.from_numpy(labels)).backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


# ---- config and the pooling layer ------------------------------------------

def test_hparams_fields_and_defaults_match_jax():
    ours, ref = config.HParamsNPA, jax_config.HParamsNPA
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert ours().to_dict() == ref().to_dict()


@pytest.mark.parametrize("part", ["drop_values", "project", "pool", "call"])
def test_personalized_pooling_matches_jax(part):
    """Each method and the call, output and the gradients of the values,
    the query and att_proj's weights (dropout 0 in training mode)."""
    rng = np.random.default_rng(4)
    n, l, d, a = 6, 5, 7, 4
    values = rng.standard_normal((n, l, d)).astype(np.float32)
    query = rng.standard_normal((n, a)).astype(np.float32)
    proj = np.tanh(rng.standard_normal((n, l, a))).astype(np.float32)
    jl = JaxPAP(a, 0.0)
    p = jl.init(jax.random.key(0), jnp.asarray(values), jnp.asarray(query))["params"]
    p = _random_biases(jax.tree_util.tree_map(np.asarray, p), rng)
    layer = PersonalizedAttentivePooling(d, a, 0.0, torch.float32, torch.device("cpu")).train()
    sd = {}
    bridge._dense(sd, "att_proj", p["att_proj"])
    layer.load_state_dict(sd, strict=True)

    jfn = {"drop_values": lambda m, v, q, pr: m.drop_values(v, True),
           "project": lambda m, v, q, pr: m.project(v),
           "pool": lambda m, v, q, pr: m.pool(v, pr, q),
           "call": lambda m, v, q, pr: m(v, q, True)}[part]
    tfn = {"drop_values": lambda v, q, pr: layer.drop_values(v, SEED, 2),
           "project": lambda v, q, pr: layer.project(v),
           "pool": lambda v, q, pr: layer.pool(v, pr, q),
           "call": lambda v, q, pr: layer(v, q, SEED, 2)}[part]
    ins = [jnp.asarray(x) for x in (values, query, proj)]
    ref, vjp = jax.vjp(lambda pp, v, q, pr: jl.apply({"params": pp}, v, q, pr, method=jfn,
                                                     rngs={"dropout": jax.random.key(0)}),
                       p, *ins)
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    g_p, *g_in = vjp(jnp.asarray(cot))
    tins = [torch.from_numpy(x).requires_grad_() for x in (values, query, proj)]
    out = tfn(*tins)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    for t, g in zip(tins, g_in):
        want = np.asarray(g)
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, atol=1e-5)
    want = {}
    bridge._dense(want, "att_proj", jax.tree_util.tree_map(np.asarray, g_p)["att_proj"])
    for k, prm in layer.named_parameters():
        got = prm.grad.numpy() if prm.grad is not None else np.zeros(prm.shape, np.float32)
        np.testing.assert_allclose(got, want[k].numpy(), atol=1e-5, err_msg=k)


def test_pool_broadcasts_the_query_over_slots():
    """A [B, 1, A] query pools [B, N, L, D] values as the query repeated per
    slot does (NPA computes each user's word query once)."""
    g = torch.Generator().manual_seed(0)
    v, p, q = (torch.randn(3, 4, 5, 6, generator=g), torch.randn(3, 4, 5, 2, generator=g),
               torch.randn(3, 2, generator=g))
    pool = PersonalizedAttentivePooling.pool
    torch.testing.assert_close(pool(v, p, q[:, None]),
                               pool(v, p, q[:, None].expand(3, 4, 2)), rtol=0, atol=0)


# ---- the model against JAX ---------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_logits_and_grads_match_jax(dedup):
    ref_logits, ref_grads = _jax_logits_grads(dedup)
    logits, grads = _port_logits_grads(dedup)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    want = bridge.npa_state_dict(ref_grads)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def test_per_slot_and_dedup_are_equal():
    l0, g0 = _port_logits_grads(False)
    l1, g1 = _port_logits_grads(True)
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-7)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7, msg=k)


def test_remat_equals_the_plain_model_with_dropout():
    """Dropout 0.2 on the seed-recompute dropout (its plain version here):
    the checkpointed prefix regenerates its masks."""
    batch = dict(_port_batch(True)[0], dropout_seed=SEED)
    l0, g0 = _port_logits_grads(True, batch, 0.2, prng_dropout=True)
    l1, g1 = _port_logits_grads(True, batch, 0.2, prng_dropout=True, remat_encoder=True)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-7)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_dropout_sites_are_seeded_by_seed_and_stream(dedup):
    """Four sites, streams 0-3 under the step's seed, each launched once
    forward and once backward (8 per step); the same seed repeats the
    logits, another (high word only) does not; eval mode applies none."""
    model = _load(_port_model(0.2, prng_dropout=True), _params()).train()
    batch, labels = _port_batch(dedup)
    calls = []
    real = k3.dropout_apply

    def spy(x, seed, stream, keep, offset=0):
        calls.append((seed, stream, tuple(x.shape)))
        return real(x, seed, stream, keep, offset)

    with mock.patch.object(k3, "dropout_apply", spy):
        logits = model(dict(batch, dropout_seed=SEED))
        losses.categorical_crossentropy(logits, torch.from_numpy(labels)).backward()
    assert [s for s, _, _ in calls] == [SEED] * 8
    assert sorted(st for _, st, _ in calls) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [st for _, st, _ in calls[:4]] == [0, 1, 2, 3]
    assert calls[3][2] == (BS, H, HP["filter_num"])  # the news pool's values, per slot
    assert torch.equal(logits, model(dict(batch, dropout_seed=SEED)))
    assert not torch.equal(logits, model(dict(batch, dropout_seed=SEED ^ (1 << 40))))
    model.eval()
    with mock.patch.object(k3, "dropout_apply", spy):
        model(dict(batch, dropout_seed=SEED))
    assert len(calls) == 8


# ---- dedup, bridge, serving ---------------------------------------------------

def test_dedup_capable_partial_and_no_two_tower():
    model = _port_model()
    assert dedup_capable(model) == (True, "")
    assert model_kind(model) is None
    with pytest.raises(ValueError, match="user-dependent"):
        ArticleIndex(model, _tables(), device="cpu")


def test_bridge_loads_strictly():
    params = _params()
    sd = bridge.npa_state_dict(params)
    model = _load(_port_model(), params)
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k
    missing = dict(sd)
    missing.pop("word_query.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        _port_model().load_state_dict(missing, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        _port_model().load_state_dict(dict(sd, extra=torch.zeros(1)), strict=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        _port_model().load_state_dict(dict(sd, **{"conv.weight": sd["conv.weight"].transpose(0, 2)}),
                                      strict=True)


# ---- trainer --------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_trainer_three_steps_match_jax(dedup):
    """From one init (JAX's, through the bridge), three Adam steps with
    dropout 0 leave the same parameters in both packages."""
    tables = _tables()
    jtr = JaxTrainer(_jax_model(), tables, jax_inputs.builder_for("npa"),
                     JaxConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup,
                               early_stopping_patience=None, lr_patience=None),
                     log_fn=lambda s: None)
    raws = [_raw(10 + i) for i in range(3)]
    jtr.init_state(raws[0])
    init = _random_biases(jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params)),
                          np.random.default_rng(5))
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, init),
                                  opt_state=jtr.tx.init(init))
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    for raw in raws:
        r = jax_dedup.prep_dedup_batch(dict(raw), 512) if dedup else dict(raw)
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(r), key)
    want = bridge.npa_state_dict(jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params)))

    model = _load(_port_model(prng_dropout=True), init)
    tr = Trainer(model, tables, builder_for("npa"),
                 TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup), device="cpu")
    assert tr.dedup is dedup
    for raw in raws:
        assert torch.isfinite(tr.train_step(dict(raw)))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_score_is_the_full_forward_and_matches_jax(tmp_path):
    """``Trainer.score`` on NPA runs the full forward (the towers raise) and
    gives JAX's ``Trainer.score``; user ids come from the feed's mapping,
    unseen users take row 0."""
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet

    path = make_synthetic_ebnerd(tmp_path / "d", n_users=12, n_articles=N_ART,
                                 n_impressions=40, seed=5)
    df = create_binary_labels_column(ebnerd_from_path(path, history_size=H))
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    title = _tables()["title"][1:len(ids) + 1]
    users = np.unique(np.asarray(df[c.DEFAULT_USER_COL]))
    umap = {int(u): i + 1 for i, u in enumerate(users[:N_USERS - 1])}
    params = _params()
    jtr = JaxTrainer(_jax_model(), {"title": JaxLookup.from_values(ids, title).matrix},
                     jax_inputs.builder_for("npa"), JaxConfig(seed=0), log_fn=lambda s: None)
    jtr.init_state(_raw(3))
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jfeed = JaxEvalFeed(df, JaxLookup.from_values(ids, title), history_size=H, batch_size=8,
                        user_mapping=umap)
    want = np.asarray(jtr.score(jfeed).values)

    table = Table({n: Ragged(df[n].values, df[n].offsets) if isinstance(df[n], JaxRagged)
                   else np.asarray(df[n]) for n in df.columns})
    lookup = Lookup.from_values(ids, title)
    feed = EvalFeed(table, lookup, history_size=H, batch_size=8, user_mapping=umap)
    model = _load(_port_model(0.2, prng_dropout=True), params).train()
    tr = Trainer(model, {"title": lookup.matrix}, builder_for("npa"), TrainerConfig(seed=0),
                 device="cpu")
    with pytest.raises(ValueError, match="two-tower"):
        tr.score(feed, two_tower=True)
    got = tr.score(feed)
    assert model.training  # restored after the eval-mode forward
    np.testing.assert_array_equal(got.offsets, feed.inview.offsets)
    np.testing.assert_allclose(got.values, want, rtol=1e-5, atol=1e-6)
