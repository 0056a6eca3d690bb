"""The port's LSTUR and NAML against the JAX package, fp32, dropout 0 in
training mode: hparams, ``ConvEncoder`` (odd and even windows),
``MaskedGRU`` with masks and an initial state, logits and every parameter
gradient of LSTUR (ini, con) and NAML on per-slot and dedup batches,
``naml_batch``, the bridges' strict load, and three Trainer steps from one
init. Within the port: dedup against per-slot, ``remat_encoder`` and
``encode_chunks`` against the plain model (with dropout on, through the
seed-recompute dropout's plain version), and seeded dropout sites."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.models import config as jax_config
from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu.models.layers import ConvEncoder as JaxConv
from ebnerd_tpu.models.layers import MaskedGRU as JaxGRU
from ebnerd_tpu.models.newsrec import LSTUR as JaxLSTUR
from ebnerd_tpu.models.newsrec import NAML as JaxNAML
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training import losses as jax_losses
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.models import (LSTUR, NAML, HParamsLSTUR, HParamsNAML, builder_for,
                                     config, docvec_batch, naml_batch, token_batch)
from ebnerd_tpu_torch.models.layers import ConvEncoder, MaskedGRU
from ebnerd_tpu_torch.training import (Trainer, TrainerConfig, dedup_capable, losses,
                                       prep_dedup_batch)

torch.set_num_threads(1)

BS, H, K, T, TB, VOCAB, EMB, N_ART, N_USERS = 8, 5, 4, 6, 7, 60, 16, 30, 9
COMMON = dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12, dropout=0.0)
HP = {
    "lstur_ini": dict(COMMON, n_users=N_USERS, gru_unit=12, type="ini"),
    "lstur_con": dict(COMMON, n_users=N_USERS, gru_unit=12, type="con"),
    "naml": dict(COMMON, body_size=TB, vert_num=5, subvert_num=6),
}
FAMILIES = list(HP)
ATOL = 5e-5  # fp32, as tests/test_torch_training.py: only the summation order differs


def _tables():
    rng = np.random.default_rng(1)
    title = rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    body = rng.integers(1, VOCAB, (N_ART + 1, TB)).astype(np.int32)
    title[0] = body[0] = 0
    title[3] = 0  # an article whose tokens are all padding
    title[5, 2:] = 0
    return {"title": title, "body": body,
            "cat": rng.integers(0, 5, N_ART + 1).astype(np.int32),
            "subcat": rng.integers(0, 6, N_ART + 1).astype(np.int32)}


def _raw(seed):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(1, N_ART + 1, (BS, K)).astype(np.int32),
           "user_idx": rng.integers(0, N_USERS + 1, BS).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["hist_idx"][0] = 0  # a user with no history: every GRU step masked
    raw["hist_idx"][1, :2] = 3
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    return raw


def _jax_model(family, **kw):
    if family == "naml":
        return JaxNAML(jax_config.HParamsNAML(**HP[family]), vocab_size=VOCAB, word_emb_dim=EMB,
                       **kw)
    return JaxLSTUR(jax_config.HParamsLSTUR(**HP[family]), vocab_size=VOCAB, word_emb_dim=EMB,
                    **kw)


def _port_model(family, dropout=0.0, **kw):
    hp = dict(HP[family], dropout=dropout)
    if family == "naml":
        return NAML(HParamsNAML(**hp), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu", **kw)
    return LSTUR(HParamsLSTUR(**hp), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu", **kw)


def _state_dict(family, params):
    return (bridge.naml_state_dict if family == "naml" else bridge.lstur_state_dict)(params)


def _load(family, model, params):
    load = bridge.load_naml_params if family == "naml" else bridge.load_lstur_params
    return load(model, params)


def _name(family):
    return "naml" if family == "naml" else "lstur"


def _jax_batch(family, dedup, seed=7):
    raw = _raw(seed)
    if dedup:
        raw = jax_dedup.prep_dedup_batch(raw, 256)
        raw.pop("n_uniq")
    tables = {k: jnp.asarray(v) for k, v in _tables().items()}
    builder = jax_inputs.builder_for(_name(family))
    return builder(tables, {k: jnp.asarray(v) for k, v in raw.items()}), raw["labels"]


def _port_batch(family, dedup, seed=7):
    raw = _raw(seed)
    if dedup:
        raw = prep_dedup_batch(raw, 256)
    tables = {k: torch.from_numpy(v).long() for k, v in _tables().items()}
    return builder_for(_name(family))(tables, raw), raw["labels"]


def _random_biases(tree, rng):
    """Non-zero biases and user embeddings (zeros at init) so their
    gradients and the GRU's initial state are exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_biases(v, rng)
        elif k in ("b", "bias") or (k == "embedding" and not v.any()):
            out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = v
    return out


_PARAMS = {}


def _params(family):
    if family not in _PARAMS:
        batch, _ = _jax_batch(family, False)
        p = _jax_model(family).init(jax.random.PRNGKey(0), batch)["params"]
        p = jax.tree_util.tree_map(np.asarray, jax.device_get(p))
        _PARAMS[family] = _random_biases(p, np.random.default_rng(2))
    return _PARAMS[family]


_JAX_CACHE = {}


def _jax_logits_grads(family, dedup):
    key = (family, dedup)
    if key not in _JAX_CACHE:
        m = _jax_model(family)
        batch, labels = _jax_batch(family, dedup)

        def loss(p):
            logits = m.apply({"params": p}, batch, True, rngs={"dropout": jax.random.key(0)})
            return jax_losses.categorical_crossentropy(logits, jnp.asarray(labels)), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(_params(family))
        _JAX_CACHE[key] = (np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads))
    return _JAX_CACHE[key]


def _port_logits_grads(family, dedup, **kw):
    model = _load(family, _port_model(family, **kw), _params(family)).train()
    batch, labels = _port_batch(family, dedup)
    logits = model(batch)
    losses.categorical_crossentropy(logits, torch.from_numpy(labels)).backward()
    return logits.detach().numpy(), {k: p.grad for k, p in model.named_parameters()}


# ---- config and layers ----------------------------------------------------

@pytest.mark.parametrize("name", ["HParamsBase", "HParamsNRMS", "HParamsLSTUR", "HParamsNAML"])
def test_hparams_fields_and_defaults_match_jax(name):
    ours, ref = getattr(config, name), getattr(jax_config, name)
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert ours().to_dict() == ref().to_dict()


@pytest.mark.parametrize("window", [3, 4])
def test_conv_encoder_matches_jax(window):
    """SAME padding (flax pads (w - 1) // 2 on the left) and relu, output
    and the gradients of x and of the weights."""
    rng = np.random.default_rng(window)
    x = rng.standard_normal((5, 9, 7)).astype(np.float32)
    cot = rng.standard_normal((5, 9, 6)).astype(np.float32)
    jl = JaxConv(6, window)
    p = jl.init(jax.random.key(0), jnp.asarray(x))["params"]
    p = {"Conv_0": {"kernel": np.asarray(p["Conv_0"]["kernel"]),
                    "bias": rng.standard_normal(6).astype(np.float32) * 0.1}}
    ref, vjp = jax.vjp(lambda pp, xx: jl.apply({"params": pp}, xx), p, jnp.asarray(x))
    g_p, g_x = vjp(jnp.asarray(cot))

    layer = ConvEncoder(7, 6, window, torch.float32, torch.device("cpu"))
    sd = {}
    bridge._conv(sd, "c", p)
    layer.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-5)
    want = {}
    bridge._conv(want, "c", jax.tree_util.tree_map(np.asarray, g_p))
    np.testing.assert_allclose(layer.weight.grad.numpy(), want["c.weight"].numpy(), atol=1e-5)
    np.testing.assert_allclose(layer.bias.grad.numpy(), want["c.bias"].numpy(), atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
def test_masked_gru_matches_jax(with_state):
    """Masked steps keep the state; flax's GRUCell parameters, an initial
    state, and the gradients of x, the state and every gate weight."""
    rng = np.random.default_rng(3)
    b, steps, din, units = 6, 5, 7, 4
    x = rng.standard_normal((b, steps, din)).astype(np.float32)
    mask = (rng.random((b, steps)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    h0 = rng.standard_normal((b, units)).astype(np.float32) if with_state else None
    cot = rng.standard_normal((b, units)).astype(np.float32)
    jl = JaxGRU(units)
    p = jl.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    p = _random_biases(jax.tree_util.tree_map(np.asarray, p), rng)

    def run(pp, xx, hh):
        return jl.apply({"params": pp}, xx, jnp.asarray(mask), initial_state=hh)

    ref, vjp = jax.vjp(run, p, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    g_p, g_x, g_h = vjp(jnp.asarray(cot))

    layer = MaskedGRU(din, units, torch.device("cpu"))
    sd = {}
    for gate, dense in p["GRUCell_0"].items():
        bridge._dense(sd, "in_" if gate == "in" else gate, dense)
    layer.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    ht = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    out = layer(xt, torch.from_numpy(mask), ht)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(out.detach().numpy()[0], h0[0] if with_state else 0.0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-6)
    if with_state:
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(g_h), atol=1e-6)
    want = {}
    for gate, dense in jax.tree_util.tree_map(np.asarray, g_p)["GRUCell_0"].items():
        bridge._dense(want, "in_" if gate == "in" else gate, dense)
    for k, g in layer.named_parameters():
        np.testing.assert_allclose(g.grad.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)


# ---- models against JAX ---------------------------------------------------

@pytest.mark.parametrize("prng", [False, True], ids=["framework_dropout", "prng_dropout"])
@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
@pytest.mark.parametrize("family", FAMILIES)
def test_logits_and_grads_match_jax(family, dedup, prng):
    ref_logits, ref_grads = _jax_logits_grads(family, dedup)
    logits, grads = _port_logits_grads(family, dedup, prng_dropout=prng)
    np.testing.assert_allclose(logits, ref_logits, atol=ATOL)
    want = _state_dict(family, ref_grads)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_per_slot_and_dedup_grads_are_equal(family):
    logits_slot, slot = _port_logits_grads(family, False)
    logits_ded, ded = _port_logits_grads(family, True)
    np.testing.assert_allclose(logits_ded, logits_slot, rtol=1e-5, atol=1e-7)
    for k in slot:
        torch.testing.assert_close(ded[k], slot[k], rtol=1e-5, atol=1e-7, msg=k)


def _with_dropout(family, dedup):
    """A batch in training mode with dropout 0.2 on every site."""
    batch, labels = _port_batch(family, dedup)
    return dict(batch, dropout_seed=(0x5EED << 32) | 99), labels


@pytest.mark.parametrize("family,variant", [
    ("lstur_ini", "remat"), ("lstur_con", "remat"), ("naml", "remat"), ("naml", "chunks"),
    ("naml", "chunks_remat")])
def test_remat_and_encode_chunks_equal_the_plain_model(family, variant):
    """With dropout 0.2 from the seed-recompute dropout (its plain version
    here): the checkpointed encoder regenerates its masks, and chunks of the
    unique axis take the masks of the whole (row offsets), so logits and
    gradients equal the plain model's."""
    kw = {"remat": dict(remat_encoder=True), "chunks": dict(encode_chunks=4),
          "chunks_remat": dict(encode_chunks=4, remat_encoder=True)}[variant]
    batch, labels = _with_dropout(family, True)
    out = {}
    for name, extra in (("plain", {}), (variant, kw)):
        model = _port_model(family, dropout=0.2, prng_dropout=True, **extra)
        model = _load(family, model, _params(family)).train()
        logits = model(batch)
        losses.categorical_crossentropy(logits, torch.from_numpy(labels)).backward()
        out[name] = logits.detach(), {k: p.grad for k, p in model.named_parameters()}
    (l0, g0), (l1, g1) = out["plain"], out[variant]
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-7)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7, msg=k)


def test_encode_chunks_raises_on_the_per_slot_path_and_on_a_bad_split():
    model = _port_model("naml", encode_chunks=2).train()
    with pytest.raises(ValueError, match="dedup path only"):
        model(_port_batch("naml", False)[0])
    model = _port_model("naml", encode_chunks=3).train()
    with pytest.raises(ValueError, match="must divide"):
        model(_port_batch("naml", True)[0])  # a bucket of 256 rows


@pytest.mark.parametrize("family", FAMILIES)
def test_training_dropout_is_seeded_per_site(family):
    """Train mode with dropout: the same seed gives the same logits, another
    seed (high word only) others; eval mode applies none. Both dropout
    routes."""
    for prng in (False, True):
        model = _port_model(family, dropout=0.2, prng_dropout=prng)
        batch, _ = _port_batch(family, True)
        model.train()
        a = model(dict(batch, dropout_seed=3))
        assert torch.equal(a, model(dict(batch, dropout_seed=3)))
        assert not torch.equal(a, model(dict(batch, dropout_seed=(1 << 40) + 3)))
        model.eval()
        assert torch.equal(model(batch), model(dict(batch, dropout_seed=3)))


# ---- batches, dedup, bridge -----------------------------------------------

@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_naml_batch_bit_equal_to_jax(dedup):
    raw = _raw(4)
    if dedup:
        raw = prep_dedup_batch(raw, 256)
    ref = jax_inputs.naml_batch({k: jnp.asarray(v) for k, v in _tables().items()},
                                {k: jnp.asarray(v) for k, v in raw.items() if k != "n_uniq"})
    ours = naml_batch({k: torch.from_numpy(v).long() for k, v in _tables().items()}, raw)
    assert set(ours) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        got = np.asarray(ours[k]) if k == "art_n_uniq" else ours[k].numpy()
        np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=k)


def test_builder_for_and_dedup_capable():
    assert builder_for("NAML") is naml_batch
    for name in ("nrms", "lstur", "npa", "fastformer"):
        assert builder_for(name) is token_batch
    assert builder_for("nrms_docvec") is builder_for("NRMSDocVec") is docvec_batch
    with pytest.raises(ValueError):
        builder_for("bert")
    for family in FAMILIES:
        assert dedup_capable(_port_model(family)) == (True, "")


@pytest.mark.parametrize("family", FAMILIES)
def test_bridge_loads_strictly(family):
    params = _params(family)
    model = _load(family, _port_model(family), params)
    for k, v in _state_dict(family, params).items():
        assert torch.equal(model.state_dict()[k], v), k
    sd = _state_dict(family, params)
    missing = dict(sd)
    missing.pop(next(iter(missing)))
    with pytest.raises(RuntimeError, match="Missing"):
        _port_model(family).load_state_dict(missing, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        _port_model(family).load_state_dict(dict(sd, extra=torch.zeros(1)), strict=True)
    bad = dict(sd)
    k = next(k for k in bad if k.endswith("conv.weight"))
    bad[k] = bad[k].transpose(0, 2)
    with pytest.raises(RuntimeError, match="size mismatch"):
        _port_model(family).load_state_dict(bad, strict=True)
    other = "lstur_con" if family == "lstur_ini" else "lstur_ini"
    if family != "naml":  # ini and con trees differ by con_dense
        with pytest.raises(RuntimeError):
            _port_model(other).load_state_dict(sd, strict=True)


# ---- trainer --------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
@pytest.mark.parametrize("family", ["lstur_ini", "naml"])
def test_trainer_three_steps_match_jax(family, dedup):
    """From one init (JAX's, through the bridge), three Adam steps with
    dropout 0 leave the same parameters in both packages."""
    tables = _tables()
    jtr = JaxTrainer(_jax_model(family), tables, jax_inputs.builder_for(_name(family)),
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
    want = _state_dict(family, jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params)))

    model = _load(family, _port_model(family, prng_dropout=True), init)
    tr = Trainer(model, tables, builder_for(_name(family)),
                 TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup), device="cpu")
    assert tr.dedup is dedup
    for raw in raws:
        assert torch.isfinite(tr.train_step(dict(raw)))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
