"""The port's Fastformer and FastformerWu against the JAX package, fp32,
dropout 0 in training mode: ``HParamsFastformer``, ``FastSelfAttention``
and ``FastformerLayer`` with masked tokens (outputs and gradients),
Fastformer's logits and every parameter gradient on the per-slot and the
dedup batch, FastformerWu's logits, ``loss_and_logits`` and gradients,
Fastformer in bf16 (the dtype flow: fp32 LayerNorm outputs, bf16 Denses),
the bridges' strict load, three Trainer steps from one init, and two-tower
scores against the full forward and JAX's. Within the port: dedup against
per-slot, the five dropout sites seeded by (seed, stream) with ten
seed-recompute launches per step, and FastformerWu on generator masks."""
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
from ebnerd_tpu.models.fastformer import FastformerLayer as JaxLayer
from ebnerd_tpu.models.fastformer import Fastformer as JaxFastformer
from ebnerd_tpu.models.fastformer import FastformerWu as JaxWu
from ebnerd_tpu.models.fastformer import FastSelfAttention as JaxFSA
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training import losses as jax_losses
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.data import EvalFeed, Lookup, Ragged, Table
from ebnerd_tpu_torch.models import (Fastformer, FastformerWu, HParamsFastformer, builder_for,
                                     config, token_batch)
from ebnerd_tpu_torch.models.fastformer import FastformerLayer, FastSelfAttention
from ebnerd_tpu_torch.ops import dropout as k3
from ebnerd_tpu_torch.serving import model_kind
from ebnerd_tpu_torch.training import (Trainer, TrainerConfig, dedup_capable, losses,
                                       prep_dedup_batch)

torch.set_num_threads(1)

BS, H, K, T, VOCAB, EMB, N_ART = 8, 5, 4, 6, 60, 10, 30
HP = dict(n_layers=2, embedding_dim=16, n_heads=2, intermediate_dim=12, max_position=32,
          title_size=T, history_size=H, dropout=0.0)
ATOL = 5e-5
SEED = (0x5EED << 32) | 99
CPU = torch.device("cpu")


def _tables():
    rng = np.random.default_rng(1)
    title = rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    title[0] = 0
    title[3] = 0  # an article whose tokens are all padding
    title[5, 2:] = 0
    return {"title": title}


def _raw(seed):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(1, N_ART + 1, (BS, K)).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["hist_idx"][0, 1:] = 0
    raw["hist_idx"][1, :2] = 3
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    return raw


def _jax_model(dtype=jnp.float32):
    return JaxFastformer(jax_config.HParamsFastformer(**HP), vocab_size=VOCAB, word_emb_dim=EMB,
                         dtype=dtype)


def _port_model(dropout=0.0, dtype=torch.float32, **kw):
    return Fastformer(HParamsFastformer(**dict(HP, dropout=dropout)), vocab_size=VOCAB,
                      word_emb_dim=EMB, dtype=dtype, device="cpu", **kw)


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
    return token_batch({"title": torch.from_numpy(_tables()["title"]).long()}, raw), raw["labels"]


def _random(tree, rng, scale=0.3):
    """Non-zero biases, LayerNorm parameters away from (1, 0), and weights
    wide enough that the logits are of order 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random(v, rng, scale)
        elif k in ("b", "bias"):
            out[k] = (rng.standard_normal(v.shape) * scale).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + rng.standard_normal(v.shape) * scale).astype(np.float32)
        elif k in ("kernel", "embedding") and v.std() < 0.05:  # normal(0.02) inits
            out[k] = (v * 10).astype(np.float32)
        else:
            out[k] = v
    return out


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


_PARAMS = {}


def _params():
    if not _PARAMS:
        batch, _ = _jax_batch(False)
        p = _tree(_jax_model().init(jax.random.PRNGKey(0), batch)["params"])
        _PARAMS["p"] = _random(p, np.random.default_rng(2))
    return _PARAMS["p"]


def _load(model, params=None):
    sd = bridge.fastformer_state_dict(_params() if params is None else params)
    model.load_state_dict(sd, strict=True)
    return model


def _port_logits_grads(dedup, batch=None, **kw):
    model = _load(_port_model(**kw)).train()
    b, labels = _port_batch(dedup)
    logits = model(b if batch is None else batch)
    losses.categorical_crossentropy(logits, torch.from_numpy(labels)).backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


def _inputs(rng, n=5, l=7, d=16):
    x = rng.standard_normal((n, l, d)).astype(np.float32)
    mask = np.ones((n, l), np.float32)
    mask[0, 4:] = 0
    mask[2, 1:] = 0
    return x, ((1.0 - mask) * -1e4).astype(np.float32)


# ---- config and layers ----------------------------------------------------

def test_hparams_fields_and_defaults_match_jax():
    ours, ref = config.HParamsFastformer, jax_config.HParamsFastformer
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert ours().to_dict() == ref().to_dict()


@pytest.mark.parametrize("which", ["attention", "layer"])
def test_layer_matches_jax_with_masked_tokens(which):
    """Outputs and the gradients of x and of every parameter; padded tokens
    carry the -1e4 mask bias."""
    rng = np.random.default_rng(3)
    x, bias = _inputs(rng)
    if which == "attention":
        jl = JaxFSA(2, 8)
        layer = FastSelfAttention(16, 2, 8, torch.float32, CPU)
        run = lambda p, xx: jl.apply({"params": p}, xx, jnp.asarray(bias))
        fwd = lambda xx: layer(xx, torch.from_numpy(bias))
        to_sd = lambda sd, p: [bridge._dense(sd, n, d) for n, d in p.items()]
    else:
        jl = JaxLayer(2, 8, 12, 0.0)
        layer = FastformerLayer(2, 8, 12, 0.0, torch.float32, CPU).train()
        run = lambda p, xx: jl.apply({"params": p}, xx, jnp.asarray(bias), True)
        fwd = lambda xx: layer(xx, torch.from_numpy(bias), SEED)
        to_sd = lambda sd, p: bridge._fastformer_layer(sd, "", p)
    p = jl.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(bias),
                *([] if which == "attention" else [False]))["params"]
    p = _random(_tree(p), rng)
    sd = {}
    to_sd(sd, p)
    layer.load_state_dict(sd, strict=True)
    ref, vjp = jax.vjp(run, p, jnp.asarray(x))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    g_p, g_x = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out = fwd(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-5)
    want = {}
    to_sd(want, _tree(g_p))
    for k, prm in layer.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


# ---- the models against JAX ---------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_logits_and_grads_match_jax(dedup):
    m = _jax_model()
    batch, labels = _jax_batch(dedup)

    def loss(p):
        logits = m.apply({"params": p}, batch, True, rngs={"dropout": jax.random.key(0)})
        return jax_losses.categorical_crossentropy(logits, jnp.asarray(labels)), logits

    (_, ref_logits), ref_grads = jax.value_and_grad(loss, has_aux=True)(_params())
    logits, grads = _port_logits_grads(dedup)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    assert np.abs(np.asarray(ref_logits)).max() > 0.1
    want = bridge.fastformer_state_dict(_tree(ref_grads))
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def test_per_slot_and_dedup_are_equal():
    l0, g0 = _port_logits_grads(False)
    l1, g1 = _port_logits_grads(True)
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6, msg=k)


def test_bf16_logits_and_dtype_flow_match_jax():
    """bf16 compute: the LayerNorms return fp32, the Denses compute in bf16
    (so the logits are bf16, the article vectors fp32); the logits agree
    with JAX's on the CPU within 2e-2 of max|logit|."""
    batch, _ = _jax_batch(False)
    m = _jax_model(jnp.bfloat16)
    ref = m.apply({"params": _params()}, batch, False)
    ref_art = m.apply({"params": _params()}, batch["cand_tokens"][:, 0], False,
                      method=lambda mdl, tok, tr: mdl.encode_articles(tok, tr))
    model = _load(_port_model(dtype=torch.bfloat16))
    pb, _ = _port_batch(False)
    with torch.no_grad():
        got = model(pb)
        art = model.encode_articles(pb["cand_tokens"][:, 0])
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    assert str(art.dtype).replace("torch.", "") == str(ref_art.dtype) == "float32"
    ref, ref_art = np.asarray(ref, np.float32), np.asarray(ref_art, np.float32)
    assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
    assert np.abs(art.numpy() - ref_art).max() <= 2e-2 * np.abs(ref_art).max()


def test_dropout_sites_are_seeded_by_seed_and_stream():
    """Five sites at 2 layers (embedding 0; att_out 1, 3; ffn_out 2, 4),
    each launched once forward and once backward (10 per step), under the
    step's seed; in bf16 the embedding site is fp32 and the layer sites
    bf16. The same seed repeats the logits, another does not; eval mode
    applies none."""
    model = _load(_port_model(0.2, torch.bfloat16, prng_dropout=True)).train()
    batch, labels = _port_batch(True)
    calls = []
    real = k3.dropout_apply

    def spy(x, seed, stream, keep, offset=0):
        calls.append((seed, stream, x.dtype))
        return real(x, seed, stream, keep, offset)

    with mock.patch.object(k3, "dropout_apply", spy):
        logits = model(dict(batch, dropout_seed=SEED))
        losses.categorical_crossentropy(logits.float(), torch.from_numpy(labels)).backward()
    assert len(calls) == 10 and {s for s, _, _ in calls} == {SEED}
    assert [(st, dt) for _, st, dt in calls[:5]] == [
        (0, torch.float32), (1, torch.bfloat16), (2, torch.bfloat16), (3, torch.bfloat16),
        (4, torch.bfloat16)]
    assert sorted(st for _, st, _ in calls[5:]) == [0, 1, 2, 3, 4]
    assert torch.equal(logits, model(dict(batch, dropout_seed=SEED)))
    assert not torch.equal(logits, model(dict(batch, dropout_seed=SEED ^ (1 << 40))))
    model.eval()
    with mock.patch.object(k3, "dropout_apply", spy):
        model(dict(batch, dropout_seed=SEED))
    assert len(calls) == 10


# ---- FastformerWu -------------------------------------------------------------

def _wu_inputs():
    rng = np.random.default_rng(9)
    ids = rng.integers(1, VOCAB, (6, T)).astype(np.int32)
    ids[0, 3:] = 0
    return ids, rng.integers(0, 4, 6).astype(np.int32)


def test_fastformer_wu_matches_jax():
    """Logits, ``loss_and_logits`` and every parameter gradient of the loss."""
    ids, targets = _wu_inputs()
    jm = JaxWu(jax_config.HParamsFastformer(**HP), vocab_size=VOCAB)
    p = _random(_tree(jm.init(jax.random.key(0), jnp.asarray(ids))["params"]),
                np.random.default_rng(4))

    def loss(pp):
        return jm.apply({"params": pp}, jnp.asarray(ids), jnp.asarray(targets), True,
                        method=JaxWu.loss_and_logits, rngs={"dropout": jax.random.key(0)})

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(loss, has_aux=True)(p)
    model = _load(FastformerWu(HParamsFastformer(**HP), vocab_size=VOCAB, device="cpu"),
                  p).train()
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        np.testing.assert_allclose(model(ids_t).numpy(), np.asarray(ref_logits), atol=ATOL)
    got_loss, got_logits = model.loss_and_logits(ids_t, torch.from_numpy(targets))
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(ref_logits), atol=ATOL)
    np.testing.assert_allclose(got_loss.item(), float(ref_loss), rtol=1e-6)
    want = bridge.fastformer_state_dict(_tree(ref_grads))
    assert {k for k, _ in model.named_parameters()} == want.keys()
    for k, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def test_fastformer_wu_uses_generator_dropout_and_no_dedup():
    ids, targets = _wu_inputs()
    hp = HParamsFastformer(**dict(HP, dropout=0.2))
    model = FastformerWu(hp, vocab_size=VOCAB, device="cpu").train()
    ids_t = torch.from_numpy(ids).long()
    with mock.patch.object(k3, "dropout_apply", side_effect=AssertionError("kernel")):
        a = model(ids_t, SEED)
    assert torch.equal(a, model(ids_t, SEED))
    assert not torch.equal(a, model(ids_t, SEED + 1))
    assert dedup_capable(model) == (
        False, "unknown model family: no slot path implemented for article dedup")
    assert model_kind(model) is None


# ---- bridge, trainer, serving ---------------------------------------------------

def test_bridge_loads_strictly():
    params = _params()
    sd = bridge.fastformer_state_dict(params)
    model = _load(_port_model())
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k
    missing = dict(sd)
    missing.pop("layers.1.ffn_out.norm.scale")
    with pytest.raises(RuntimeError, match="Missing"):
        _port_model().load_state_dict(missing, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        _port_model().load_state_dict(dict(sd, extra=torch.zeros(1)), strict=True)
    bad = dict(sd, **{"embedding_transform.weight": sd["embedding_transform.weight"].T})
    with pytest.raises(RuntimeError, match="size mismatch"):
        _port_model().load_state_dict(bad, strict=True)
    # the classifier has no user pool and a 4-way head: the trees do not cross
    wu = FastformerWu(HParamsFastformer(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    with pytest.raises(RuntimeError):
        wu.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_trainer_three_steps_match_jax(dedup):
    """Three Adam steps from one init. The loss is the binary log loss: under
    the softmax cross-entropy over candidates the user term of the concat
    head is the same for every candidate and cancels, so the user pool and
    the head's user half get no gradient, and Adam steps on rounding noise."""
    tables = _tables()
    jtr = JaxTrainer(_jax_model(), tables, jax_inputs.builder_for("fastformer"),
                     JaxConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup, loss="log_loss",
                               early_stopping_patience=None, lr_patience=None),
                     log_fn=lambda s: None)
    raws = [_raw(10 + i) for i in range(3)]
    jtr.init_state(raws[0])
    init = _params()
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, init),
                                  opt_state=jtr.tx.init(init))
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    for raw in raws:
        r = jax_dedup.prep_dedup_batch(dict(raw), 512) if dedup else dict(raw)
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(r), key)
    want = bridge.fastformer_state_dict(_tree(jtr.state.params))

    model = _load(_port_model(prng_dropout=True), init)
    tr = Trainer(model, tables, builder_for("fastformer"),
                 TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup, loss="log_loss"),
                 device="cpu")
    assert tr.dedup is dedup
    for raw in raws:
        assert torch.isfinite(tr.train_step(dict(raw)))
    start = bridge.fastformer_state_dict(init)
    for k, p in model.state_dict().items():
        if k.endswith(("query_att.bias", "key_att.bias")):
            # a bias shared by every token of a head cancels in the softmax
            # over tokens: its gradient is 0 but for rounding, and Adam turns
            # that noise into steps of up to lr in either package
            for got in (p, want[k]):
                assert (got - start[k]).abs().max() <= 3 * 1e-4 * (1 + 1e-3), k
            continue
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_two_tower_equals_the_full_forward_and_jax(tmp_path):
    """The article index (eval mode, from the model left training) and the
    user tower's masked pooling and concat head give the full forward's
    scores and JAX's two-tower scores; an article with an empty title is
    masked out of the history as the full forward masks it."""
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet

    path = make_synthetic_ebnerd(tmp_path / "d", n_users=12, n_articles=N_ART,
                                 n_impressions=40, seed=5)
    df = create_binary_labels_column(ebnerd_from_path(path, history_size=H))
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    title = _tables()["title"][1:len(ids) + 1]
    jlookup = JaxLookup.from_values(ids, title)
    jtr = JaxTrainer(_jax_model(), {"title": jlookup.matrix}, jax_inputs.builder_for("fastformer"),
                     JaxConfig(seed=0), log_fn=lambda s: None)
    jtr.init_state(_raw(3))
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(jnp.asarray, _params()))
    want = np.asarray(jtr.score(JaxEvalFeed(df, jlookup, history_size=H, batch_size=8),
                                two_tower=True).values)

    table = Table({n: Ragged(df[n].values, df[n].offsets) if isinstance(df[n], JaxRagged)
                   else np.asarray(df[n]) for n in df.columns})
    lookup = Lookup.from_values(ids, title)
    feed = EvalFeed(table, lookup, history_size=H, batch_size=8)
    model = _load(_port_model(0.2, prng_dropout=True))
    tr = Trainer(model, {"title": lookup.matrix}, builder_for("fastformer"), TrainerConfig(seed=0),
                 device="cpu")
    tr.train_step(_raw(3))
    _load(model)  # back to the reference weights; the model stays in training mode
    assert model.training
    tr._art_cache = None
    tt, full = tr.score(feed, two_tower=True), tr.score(feed, two_tower=False)
    assert model.training
    np.testing.assert_array_equal(tt.offsets, feed.inview.offsets)
    np.testing.assert_allclose(tt.values, full.values, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.values, want, rtol=1e-5, atol=1e-6)
