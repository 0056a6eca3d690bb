"""The port's BatchNorm article towers against the JAX package, fp32,
dropout 0 in training mode: ``HParamsNRMSDocVec``, ``WeightedBatchNorm``
(with and without row weights, pad rows at weight 0, 2-D and 3-D inputs,
the running stats after a training call, eval mode), NRMSDocVec and NRMS
with its dense stack (logits, every parameter gradient and the running
stats on the per-slot and the dedup batch), ``docvec_batch``, the bridges'
strict load (``params`` and ``batch_stats``), three Trainer steps with the
L2 term, and the running stats per micro-batch under gradient
accumulation. Within the port: dedup against per-slot, a float ``docvec``
table through ``Trainer`` and ``ArticleIndex`` unchanged, ``art_counts``
on the dedup batch, the BN buffers in the best-weight snapshot and in a
stopped-and-resumed fit (bit-equal), and two-tower scores against the
full forward."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu import constants as c
from ebnerd_tpu.data.behaviors import (create_binary_labels_column, ebnerd_from_path,
                                       sampling_strategy_wu2019)
from ebnerd_tpu.data.ragged import Ragged as JaxRagged
from ebnerd_tpu.models import config as jax_config
from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu.models.layers import WeightedBatchNorm as JaxWBN
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.models.newsrec import NRMSDocVec as JaxDocVec
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training import losses as jax_losses
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.data import EvalFeed, Lookup, NewsrecFeed, Ragged, Table
from ebnerd_tpu_torch.models import (NRMS, HParamsNRMS, HParamsNRMSDocVec, NRMSDocVec,
                                     builder_for, config, docvec_batch, token_batch)
from ebnerd_tpu_torch.models.layers import WeightedBatchNorm
from ebnerd_tpu_torch.serving import ArticleIndex, article_validity, model_kind
from ebnerd_tpu_torch.training import (CheckpointManager, Trainer, TrainerConfig, dedup_capable,
                                       losses, prep_dedup_batch)

torch.set_num_threads(1)

BS, H, K, T, DV, VOCAB, EMB, N_ART = 8, 5, 4, 6, 12, 60, 10, 30
HP = {
    "docvec": dict(title_size=DV, history_size=H, head_num=2, head_dim=4, attention_hidden_dim=6,
                   newsencoder_units_per_layer=(9, 7), dropout=0.0),
    # the stack's last width is the news vector's, which the dot with the
    # user vector (head_num * head_dim) needs
    "nrms_dense": dict(title_size=T, history_size=H, head_num=2, head_dim=4,
                       attention_hidden_dim=6, newsencoder_units_per_layer=(12, 8), dropout=0.0),
}
FAMILIES = list(HP)
ATOL = 5e-5


def _tables():
    rng = np.random.default_rng(1)
    title = rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    title[0] = 0
    title[5, 2:] = 0
    docvec = rng.standard_normal((N_ART + 1, DV)).astype(np.float32) * 1.7 + 0.3
    docvec[0] = 0.0
    return {"title": title, "docvec": docvec}


def _raw(seed):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(1, N_ART + 1, (BS, K)).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["hist_idx"][0] = 0
    raw["hist_idx"][1, :3] = 4  # a popular article: several slots
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    return raw


def _builder_name(family):
    return "nrms_docvec" if family == "docvec" else "nrms"


def _jax_model(family):
    if family == "docvec":
        return JaxDocVec(jax_config.HParamsNRMSDocVec(**HP[family]))
    return JaxNRMS(jax_config.HParamsNRMS(**HP[family]), vocab_size=VOCAB, word_emb_dim=EMB)


def _port_model(family, dropout=0.0, **kw):
    hp = dict(HP[family], dropout=dropout)
    if family == "docvec":
        return NRMSDocVec(HParamsNRMSDocVec(**hp), device="cpu", **kw)
    return NRMS(HParamsNRMS(**hp), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu", **kw)


def _state_dict(family, params, stats):
    return (bridge.nrms_docvec_state_dict if family == "docvec"
            else bridge.nrms_state_dict)(params, stats)


def _jax_batch(family, dedup, seed=7):
    raw = _raw(seed)
    if dedup:
        raw = jax_dedup.prep_dedup_batch(raw, 256)
        raw.pop("n_uniq")
    tables = {k: jnp.asarray(v) for k, v in _tables().items()}
    batch = jax_inputs.builder_for(_builder_name(family))(
        tables, {k: jnp.asarray(v) for k, v in raw.items()})
    return batch, raw["labels"]


def _port_batch(family, dedup, seed=7):
    raw = _raw(seed)
    if dedup:
        raw = prep_dedup_batch(raw, 256)
    tables = {"title": torch.from_numpy(_tables()["title"]).long(),
              "docvec": torch.from_numpy(_tables()["docvec"])}
    return builder_for(_builder_name(family))(tables, raw), raw["labels"]


def _random(tree, rng, stats=False):
    """Non-zero biases and BN parameters; running stats away from (0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random(v, rng, stats)
        elif k in ("b", "bias", "scale", "mean"):
            out[k] = ((1.0 if k == "scale" else 0.0)
                      + rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        elif k == "var":
            out[k] = (1.0 + rng.random(v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


_VARS = {}


def _variables(family):
    if family not in _VARS:
        batch, _ = _jax_batch(family, False)
        v = _jax_model(family).init(jax.random.PRNGKey(0), batch)
        v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
        rng = np.random.default_rng(2)
        params = _random(v["params"], rng)
        if "word_embedding" in params:
            # at Glorot scale the attention outputs barely vary, and the
            # stack's biased variance E[x**2] - mean**2 keeps few digits in
            # either package; words 10x wider give features that vary
            params["word_embedding"]["embedding"] = params["word_embedding"]["embedding"] * 10
        _VARS[family] = (params, _random(v["batch_stats"], rng, True))
    return _VARS[family]


def _load(family, model):
    model.load_state_dict(_state_dict(family, *_variables(family)), strict=True)
    return model


def _jax_step(family, dedup):
    m = _jax_model(family)
    params, stats = _variables(family)
    batch, labels = _jax_batch(family, dedup)

    def loss(p):
        logits, new = m.apply({"params": p, "batch_stats": stats}, batch, True,
                              rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        return jax_losses.categorical_crossentropy(logits, jnp.asarray(labels)), (logits, new)

    (_, (logits, new)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return np.asarray(logits), tree(grads), tree(new["batch_stats"])


def _port_step(family, dedup, batch=None, dropout=0.0):
    model = _load(family, _port_model(family, dropout)).train()
    b, labels = _port_batch(family, dedup)
    logits = model(b if batch is None else batch)
    losses.categorical_crossentropy(logits, torch.from_numpy(labels)).backward()
    bufs = {k: v.clone() for k, v in model.named_buffers()}
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}, bufs


# ---- config and the BN layer ------------------------------------------------

def test_hparams_fields_and_defaults_match_jax():
    ours, ref = config.HParamsNRMSDocVec, jax_config.HParamsNRMSDocVec
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert ours().to_dict() == ref().to_dict()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("shape", [(7, 5), (7, 4, 5)], ids=["2d", "3d"])
def test_weighted_batch_norm_matches_jax(shape, weighted):
    """Training mode: output, the gradients of x, scale and bias, and the
    running stats after the call; pad rows weigh 0 (their values do not
    reach the moments). Eval mode: the running stats."""
    rng = np.random.default_rng(len(shape) + 2 * weighted)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    w = None
    if weighted:
        w = np.array([3, 1, 0, 2, 5, 0, 1], np.float32)
        x[2] = x[5] = 9.0  # pad rows: weight 0, far from the others
    cot = rng.standard_normal(shape).astype(np.float32)
    feat = shape[-1]
    params = {"scale": (1.0 + rng.standard_normal(feat) * 0.3).astype(np.float32),
              "bias": (rng.standard_normal(feat) * 0.3).astype(np.float32)}
    stats = {"mean": (rng.standard_normal(feat) * 0.3).astype(np.float32),
             "var": (1.0 + rng.random(feat)).astype(np.float32)}
    wj = None if w is None else jnp.asarray(w)

    def run(p, xx):
        return JaxWBN(epsilon=1e-3).apply({"params": p, "batch_stats": stats}, xx, weights=wj,
                                          mutable=["batch_stats"])

    ref, new = run(params, jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, xx: run(p, xx)[0], params, jnp.asarray(x))
    g_p, g_x = vjp(jnp.asarray(cot))

    layer = WeightedBatchNorm(feat, torch.device("cpu")).train()
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, None if w is None else torch.from_numpy(w))
    assert out.dtype == torch.float32
    (out * torch.from_numpy(cot)).sum().backward()
    keep = slice(None) if w is None else np.flatnonzero(w)
    np.testing.assert_allclose(out.detach().numpy()[keep], np.asarray(ref)[keep], atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-6, rtol=1e-6)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(layer, k).grad.numpy(), np.asarray(g_p[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(layer, k).numpy(),
                                   np.asarray(new["batch_stats"][k]), atol=1e-6, err_msg=k)

    layer.eval()
    want = JaxWBN(use_running_average=True, epsilon=1e-3).apply(
        {"params": params, "batch_stats": jax.tree_util.tree_map(np.asarray, new["batch_stats"])},
        jnp.asarray(x))
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_weighted_moments_equal_the_repeated_rows():
    """Weights [3, 1, 0] give the moments of the rows repeated 3, 1, 0 times."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 5, generator=g)
    a, b = (WeightedBatchNorm(5, torch.device("cpu")).train() for _ in range(2))
    ya = a(x, torch.tensor([3.0, 1.0, 0.0]))
    yb = b(torch.cat([x[0:1], x[0:1], x[0:1], x[1:2]]))
    torch.testing.assert_close(ya[:2], yb[2:4], rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=1e-5, atol=1e-7)


# ---- the models against JAX --------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
@pytest.mark.parametrize("family", FAMILIES)
def test_logits_grads_and_stats_match_jax(family, dedup):
    ref_logits, ref_grads, ref_stats = _jax_step(family, dedup)
    logits, grads, bufs = _port_step(family, dedup)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    want = _state_dict(family, ref_grads, ref_stats)
    assert grads.keys() | bufs.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)
    for k, v in bufs.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_per_slot_and_dedup_are_equal(family):
    """Slot-count weights make the dedup path's BN moments, and so its
    logits, gradients and running stats, those of the per-slot path."""
    l0, g0, b0 = _port_step(family, False)
    l1, g1, b1 = _port_step(family, True)
    # fp32 rounding of the two summation orders: atol 1e-6 beside logits of ~1-5
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6, msg=k)
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], rtol=1e-5, atol=1e-6, msg=k)


def test_art_counts_reach_the_model_on_the_dedup_path():
    """The builders pass ``art_counts`` (pad rows 0) on; without them the
    dedup path's moments are unweighted and its logits differ."""
    raw = prep_dedup_batch(_raw(7), 256)
    batch, _ = _port_batch("docvec", True)
    assert torch.equal(batch["art_counts"], torch.from_numpy(raw["art_counts"]))
    assert batch["art_counts"].dtype == torch.float32
    tok = token_batch({"title": torch.from_numpy(_tables()["title"]).long()}, raw)
    assert torch.equal(tok["art_counts"], torch.from_numpy(raw["art_counts"]))
    model = _load("docvec", _port_model("docvec")).train()
    with torch.no_grad():
        weighted = model(batch)
        unweighted = model({k: v for k, v in batch.items() if k != "art_counts"})
    assert not torch.allclose(weighted, unweighted, atol=1e-3)


@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_docvec_batch_bit_equal_to_jax(dedup):
    raw = _raw(4)
    if dedup:
        raw = prep_dedup_batch(raw, 256)
    ref = jax_inputs.docvec_batch({k: jnp.asarray(v) for k, v in _tables().items()},
                                  {k: jnp.asarray(v) for k, v in raw.items() if k != "n_uniq"})
    ours = docvec_batch({"docvec": torch.from_numpy(_tables()["docvec"])}, raw)
    assert set(ours) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        got = np.asarray(ours[k]) if k == "art_n_uniq" else ours[k].numpy()
        np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=k)


def test_float_tables_stay_float_through_trainer_and_index():
    """The document vectors reach the model unchanged (integer tables
    become int64, float tables float32; nothing truncates them)."""
    tables = _tables()
    model = _port_model("docvec")
    tr = Trainer(model, tables, docvec_batch, TrainerConfig(seed=0), device="cpu")
    assert tr.tables["docvec"].dtype == torch.float32 and tr.tables["title"].dtype == torch.long
    assert torch.equal(tr.tables["docvec"], torch.from_numpy(tables["docvec"]))
    assert tr.dedup
    batch = tr.prepare(_raw(3))
    want = tables["docvec"][prep_dedup_batch(_raw(3), 512)["art_uniq"]]
    assert torch.equal(batch["uniq_vecs"], torch.from_numpy(want))
    index = ArticleIndex(model, tables, batch_size=8, device="cpu")
    assert torch.equal(index.tables["docvec"], torch.from_numpy(tables["docvec"]))
    with torch.no_grad():
        want = model.encode_news(torch.from_numpy(tables["docvec"]))
    torch.testing.assert_close(index.build(), want, rtol=1e-6, atol=1e-7)


def test_dedup_capable_and_fused_dense_stack_raises():
    for family in FAMILIES:
        assert dedup_capable(_port_model(family)) == (True, "")
    assert model_kind(_port_model("docvec")) == "nrmsdocvec"
    with pytest.raises(ValueError, match="dense stack"):
        NRMS(HParamsNRMS(**HP["nrms_dense"]), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu",
             use_fused_encoder=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_bridge_loads_strictly(family):
    params, stats = _variables(family)
    sd = _state_dict(family, params, stats)
    model = _load(family, _port_model(family))
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k
    missing = dict(sd)
    missing.pop("news_dense.bn_1.var")  # a running stat is part of the strict load
    with pytest.raises(RuntimeError, match="Missing"):
        _port_model(family).load_state_dict(missing, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        _port_model(family).load_state_dict(dict(sd, extra=torch.zeros(1)), strict=True)
    bad = dict(sd, **{"news_dense.l2_dense_0.weight": sd["news_dense.l2_dense_0.weight"].T})
    with pytest.raises(RuntimeError, match="size mismatch"):
        _port_model(family).load_state_dict(bad, strict=True)


# ---- trainer --------------------------------------------------------------

def _jax_trainer(family, tables, **cfg):
    jtr = JaxTrainer(_jax_model(family), tables, jax_inputs.builder_for(_builder_name(family)),
                     JaxConfig(**dict(dict(learning_rate=1e-4, seed=0, early_stopping_patience=None,
                                           lr_patience=None), **cfg)),
                     log_fn=lambda s: None)
    jtr.init_state(_raw(10))
    params, stats = _variables(family)
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                  batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                                  opt_state=jtr.tx.init(params))
    return jtr


def _jax_state(jtr, family):
    tree = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))
    return _state_dict(family, tree(jtr.state.params), tree(jtr.state.batch_stats))


@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_three_steps_match_jax(family, dedup):
    """From one init, three Adam steps with the L2 term on the dense stack's
    kernels leave the same parameters and running stats in both packages."""
    tables = _tables()
    jtr = _jax_trainer(family, tables, dedup_articles=dedup, l2_regularization=1e-2)
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    raws = [_raw(10 + i) for i in range(3)]
    for raw in raws:
        r = jax_dedup.prep_dedup_batch(dict(raw), 512) if dedup else dict(raw)
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(r), key)
    want = _jax_state(jtr, family)

    model = _load(family, _port_model(family))
    tr = Trainer(model, tables, builder_for(_builder_name(family)),
                 TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup,
                               l2_regularization=1e-2), device="cpu")
    assert tr.dedup is dedup
    for raw in raws:
        assert torch.isfinite(tr.train_step(dict(raw)))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_running_stats_update_every_micro_batch():
    """Under accumulation_steps=2 the BN buffers move on every micro-batch,
    as the JAX step returns new stats per micro-batch, while the parameters
    move only on the update; both equal JAX's after each micro-batch."""
    tables = _tables()
    jtr = _jax_trainer("docvec", tables, accumulation_steps=2, dedup_articles=True)
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    model = _load("docvec", _port_model("docvec"))
    tr = Trainer(model, tables, docvec_batch, TrainerConfig(seed=0, accumulation_steps=2),
                 device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        raw = _raw(20 + i)
        r = jax_dedup.prep_dedup_batch(dict(raw), 512)
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(r), key)
        tr.train_step(dict(raw))
        want, got = _jax_state(jtr, "docvec"), model.state_dict()
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=f"{i} {k}")
            moved = not torch.equal(v, before[k])
            assert moved == (k.endswith((".mean", ".var")) or i == 1), (i, k)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet

    path = make_synthetic_ebnerd(tmp_path_factory.mktemp("torch_docvec") / "d", n_users=20,
                                 n_articles=N_ART, n_impressions=90, seed=6)
    df = ebnerd_from_path(path, history_size=H)
    port = lambda d: Table({n: Ragged(d[n].values, d[n].offsets) if isinstance(d[n], JaxRagged)
                            else np.asarray(d[n]) for n in d.columns})
    train = port(create_binary_labels_column(
        sampling_strategy_wu2019(df, npratio=K - 1, shuffle=True, seed=1)))
    val = port(create_binary_labels_column(df))
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    lookup = Lookup.from_values(ids, _tables()["title"][1:len(ids) + 1])
    feeds = lambda: (NewsrecFeed(train, lookup, history_size=H, batch_size=BS, seed=4),
                     EvalFeed(val, lookup, history_size=H, batch_size=16),
                     val[c.DEFAULT_LABELS_COL])
    return feeds, {"docvec": _tables()["docvec"]}


def _fit_trainer(tables, dropout=0.2, **cfg):
    model = _load("docvec", _port_model("docvec", dropout))
    return Trainer(model, tables, docvec_batch,
                   TrainerConfig(**dict(dict(learning_rate=1e-2, seed=0, lr_patience=2,
                                             early_stopping_patience=None), **cfg)),
                   device="cpu", log_fn=lambda s: None)


def test_resume_is_bit_equal_with_the_running_stats(split, tmp_path):
    """A fit of NRMSDocVec (dropout 0.2) stopped after epoch 2 of 3 and
    resumed from its checkpoint ends bit-equal to an uninterrupted run,
    BN buffers included."""
    feeds, tables = split
    a = _fit_trainer(tables)
    hist_a = a.fit(*feeds(), epochs=3, steps_per_epoch=3, ckpt_dir=tmp_path / "a")
    b = _fit_trainer(tables)
    b.fit(*feeds(), epochs=2, steps_per_epoch=3, ckpt_dir=tmp_path / "b")
    del b
    c_ = _fit_trainer(tables)
    hist_c = c_.fit(*feeds(), epochs=3, steps_per_epoch=3, ckpt_dir=tmp_path / "b", resume=True)
    assert hist_c == hist_a
    bufs = dict(a.model.named_buffers())
    assert bufs and all(not torch.equal(v, torch.zeros_like(v)) for k, v in bufs.items()
                        if k.endswith(".mean"))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, c_.model.state_dict()[k]), k


def test_best_weight_restore_brings_back_the_running_stats(split, tmp_path):
    """The best-weight snapshot holds copies of the BN buffers: training on
    moves them, restoring the snapshot brings them back; after fit the
    model (buffers included) is the best checkpoint's."""
    feeds, tables = split
    tr = _fit_trainer(tables)
    snap = tr._snapshot()
    assert {k for k, _ in tr.model.named_buffers()} <= snap.keys()
    tr.train_step(next(iter(feeds()[0].epoch())))
    assert any(not torch.equal(v, snap[k]) for k, v in tr.model.named_buffers())
    tr.model.load_state_dict(snap)
    for k, v in tr.model.named_buffers():
        assert torch.equal(v, snap[k]), k

    tr = _fit_trainer(tables, learning_rate=0.3)
    tr.fit(*feeds(), epochs=3, steps_per_epoch=3, ckpt_dir=tmp_path)
    best = CheckpointManager(tmp_path).restore_best(tr)["model"]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_two_tower_scores_equal_the_full_forward(split):
    """NRMSDocVec serves from the ``docvec`` table (no validity mask); the
    two-tower scores equal ``Trainer.score(two_tower=False)``."""
    feeds, tables = split
    tr = _fit_trainer(tables)
    tr.train_step(next(iter(feeds()[0].epoch())))
    assert tr.model.training
    assert article_validity(tr.tables) is None
    val = feeds()[1]
    tt, full = tr.score(val, two_tower=True), tr.score(val, two_tower=False)
    np.testing.assert_array_equal(tt.offsets, val.inview.offsets)
    np.testing.assert_allclose(tt.values, full.values, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tr.score(val).values, tt.values)  # "auto" takes the towers
    assert tr.model.training
