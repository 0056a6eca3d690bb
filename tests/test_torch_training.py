"""The port's training slice against the JAX package, fp32, dropout 0:
host dedup and the training feed bit-equal, the losses, NRMS logits and
every parameter gradient on per-slot and dedup batches (port fused plain
version and unfused, against JAX unfused and fused in interpret mode), and
three Trainer steps from one init through the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu import constants as jc
from ebnerd_tpu.data.dataloader import NewsrecFeed as JaxFeed
from ebnerd_tpu.data.lookup import Lookup as JaxLookup
from ebnerd_tpu.data.ragged import Ragged as JaxRagged
from ebnerd_tpu.data.table import Table as JaxTable
from ebnerd_tpu.models.config import HParamsNRMS as JaxHP
from ebnerd_tpu.models.inputs import token_batch as jax_token_batch
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training import losses as jax_losses
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch.bridge import load_nrms_params, nrms_state_dict
from ebnerd_tpu_torch.data import Lookup, NewsrecFeed, Ragged, Table
from ebnerd_tpu_torch.models import NRMS, HParamsNRMS, token_batch
from ebnerd_tpu_torch.training import (Trainer, TrainerConfig, dedup_capable, losses,
                                       pad_dedup_to, prep_dedup_batch)
from ebnerd_tpu_torch.training import dedup as port_dedup

torch.set_num_threads(1)

BS, H, K, T, VOCAB, EMB, N_ART = 8, 5, 4, 6, 60, 16, 30
HP = dict(title_size=T, history_size=H, head_num=2, head_dim=8, attention_hidden_dim=16,
          dropout=0.0)


def _raw(seed):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(0, N_ART + 1, (BS, K)).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    return raw


def _title():
    tok = np.random.default_rng(1).integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    tok[0] = 0
    return tok


@pytest.fixture(scope="module")
def params():
    batch = jax_token_batch({"title": jnp.asarray(_title())},
                            {k: jnp.asarray(v) for k, v in _raw(0).items()})
    p = JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=EMB).init(
        jax.random.PRNGKey(0), batch)["params"]
    p = jax.tree_util.tree_map(np.asarray, jax.device_get(p))
    for tower in ("news_pool", "user_pool"):  # non-zero biases exercise db
        p[tower]["b"] = np.random.default_rng(2).standard_normal(16).astype(np.float32) * 0.1
    return p


# ---- host dedup and feed --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prep_dedup_batch_bit_equal_to_jax(seed):
    raw = _raw(seed)
    ours, ref = prep_dedup_batch(dict(raw), 256), jax_dedup.prep_dedup_batch(dict(raw), 256)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]), err_msg=k)
        assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype, k
    grown, grown_ref = pad_dedup_to(ours, 768), jax_dedup.pad_dedup_to(ref, 768)
    for k in grown_ref:
        np.testing.assert_array_equal(np.asarray(grown[k]), np.asarray(grown_ref[k]), err_msg=k)


@pytest.mark.parametrize("n", [1, 256, 257, 513, 16_001, 22_513, 400_000])
def test_dedup_bucket_matches_jax(n):
    for minimum in (8, 512):
        assert port_dedup.dedup_bucket(n, minimum) == jax_dedup.dedup_bucket(n, minimum)


def test_dedup_capable_nrms_only():
    """Every family the JAX package dedups dedups here (NPA partially);
    unknown families, FastformerWu among them, do not, with JAX's reason."""
    model = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    assert dedup_capable(model) == (True, "")
    for name in ("LSTUR", "NAML", "NPA", "Fastformer", "NRMSDocVec"):
        assert dedup_capable(type(name, (), {})()) == (True, "")
    for other in (object(), type("FastformerWu", (), {})()):
        assert dedup_capable(other) == jax_dedup.dedup_capable(other)
        assert dedup_capable(other)[0] is False


def _split(mod_ragged, mod_table, n_rows=37):
    rng = np.random.default_rng(3)
    inview = [rng.choice(np.arange(1, N_ART + 1), K, replace=False) for _ in range(n_rows)]
    hist = [rng.choice(np.arange(1, N_ART + 1), rng.integers(1, H + 3), replace=False)
            for _ in range(n_rows)]
    labels = [np.eye(K, dtype=np.int8)[rng.integers(0, K)] for _ in range(n_rows)]
    return mod_table({
        jc.DEFAULT_INVIEW_ARTICLES_COL: mod_ragged.from_lists(inview),
        jc.DEFAULT_HISTORY_ARTICLE_ID_COL: mod_ragged.from_lists(hist),
        jc.DEFAULT_LABELS_COL: mod_ragged.from_lists(labels),
    })


def test_newsrec_feed_bit_equal_to_jax():
    ids = np.arange(1, N_ART + 1, dtype=np.int64)
    ours = NewsrecFeed(_split(Ragged, Table), Lookup.from_values(ids, _title()[1:]),
                       history_size=H, batch_size=8, seed=5)
    ref = JaxFeed(_split(JaxRagged, JaxTable), JaxLookup.from_values(ids, _title()[1:]),
                  history_size=H, batch_size=8, seed=5)
    assert len(ours) == len(ref) == 4
    for _ in range(2):  # two epochs: the shuffle advances
        for b, r in zip(ours.epoch(), ref.epoch(), strict=True):
            assert b.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(b[k], r[k], err_msg=k)
                assert b[k].dtype == r[k].dtype
    for b, r in zip(ours.epoch(shuffle=False), ref.epoch(shuffle=False), strict=True):
        np.testing.assert_array_equal(b["cand_idx"], r["cand_idx"])


# ---- losses ---------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    for name in ("cross_entropy_loss", "log_loss"):
        ours = losses.loss_fn_for(name)(torch.from_numpy(logits), torch.from_numpy(labels))
        ref = jax_losses.loss_fn_for(name)(jnp.asarray(logits), jnp.asarray(labels))
        np.testing.assert_allclose(ours.item(), float(ref), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        losses.loss_fn_for("hinge")


def test_l2_penalty_sums_dense_stack_kernels_only():
    net = torch.nn.Module()
    net.l2_dense_0 = torch.nn.Linear(3, 2)
    net.other = torch.nn.Linear(3, 2)
    want = net.l2_dense_0.weight.square().sum()
    torch.testing.assert_close(losses.l2_penalty(net), want)
    model = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    assert losses.l2_penalty(model).item() == 0.0


# ---- NRMS logits and gradients ------------------------------------------

def _jax_batch(dedup):
    raw = _raw(7)
    if dedup:
        raw = jax_dedup.prep_dedup_batch(raw, 256)
        raw.pop("n_uniq")
    return jax_token_batch({"title": jnp.asarray(_title())},
                           {k: jnp.asarray(v) for k, v in raw.items()}), raw["labels"]


def _port_batch(dedup):
    raw = _raw(7)
    if dedup:
        raw = prep_dedup_batch(raw, 256)
    return token_batch({"title": torch.from_numpy(_title()).long()}, raw), raw["labels"]


_JAX_CACHE = {}


def _jax_logits_grads(params, jax_fused, dedup):
    key = (jax_fused, dedup)
    if key not in _JAX_CACHE:
        kw = dict(use_fused_encoder=True, fused_interpret=True) if jax_fused else {}
        m = JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=EMB, **kw)
        batch, labels = _jax_batch(dedup)

        def loss(p):
            logits = m.apply({"params": p}, batch, True, rngs={"dropout": jax.random.key(0)})
            return jax_losses.categorical_crossentropy(logits, jnp.asarray(labels)), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
        _JAX_CACHE[key] = (np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads))
    return _JAX_CACHE[key]


def _port_model(params, fused):
    m = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, use_fused_encoder=fused,
             device="cpu")
    return load_nrms_params(m, params)


def _port_logits_grads(params, fused, dedup):
    model = _port_model(params, fused).train()
    batch, labels = _port_batch(dedup)
    logits = model(batch)
    losses.categorical_crossentropy(logits, torch.from_numpy(labels)).backward()
    return logits.detach().numpy(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
@pytest.mark.parametrize("port_fused", [False, True], ids=["port_unfused", "port_fused"])
@pytest.mark.parametrize("jax_fused", [False, True], ids=["jax_unfused", "jax_fused"])
def test_logits_and_grads_match_jax(params, jax_fused, port_fused, dedup):
    ref_logits, ref_grads = _jax_logits_grads(params, jax_fused, dedup)
    logits, grads = _port_logits_grads(params, port_fused, dedup)
    np.testing.assert_allclose(logits, ref_logits, atol=5e-5)
    want = nrms_state_dict(ref_grads)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=5e-5, err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_per_slot_and_dedup_grads_are_equal(params, fused):
    _, slot = _port_logits_grads(params, fused, False)
    _, ded = _port_logits_grads(params, fused, True)
    for k in slot:
        torch.testing.assert_close(ded[k], slot[k], rtol=1e-5, atol=1e-7, msg=k)


def test_training_dropout_is_seeded():
    """In training mode both paths draw their masks from the step's seed:
    the same seed gives the same logits, another seed others; eval mode
    applies no dropout."""
    for fused in (False, True):
        model = NRMS(HParamsNRMS(**dict(HP, dropout=0.2)), vocab_size=VOCAB, word_emb_dim=EMB,
                     use_fused_encoder=fused, device="cpu")
        batch, _ = _port_batch(True)
        model.train()
        a = model(dict(batch, dropout_seed=3))
        assert torch.equal(a, model(dict(batch, dropout_seed=3)))
        assert not torch.equal(a, model(dict(batch, dropout_seed=(1 << 40) + 3)))
        model.eval()
        assert torch.equal(model(batch), model(dict(batch, dropout_seed=3)))


# ---- trainer --------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True], ids=["per_slot", "dedup"])
def test_trainer_three_steps_match_jax(dedup):
    """From one init (JAX init carried over by the bridge), three Adam
    steps with dropout 0 leave the same parameters in both packages."""
    title = _title()
    jmodel = JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=EMB)
    jtr = JaxTrainer(jmodel, {"title": title}, jax_token_batch,
                     JaxConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup,
                               early_stopping_patience=None, lr_patience=None),
                     log_fn=lambda s: None)
    raws = [_raw(10 + i) for i in range(3)]
    jtr.init_state(raws[0])
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params))
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    for raw in raws:
        r = jax_dedup.prep_dedup_batch(dict(raw), 512) if dedup else dict(raw)
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(r), key)
    want = nrms_state_dict(jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params)))

    model = load_nrms_params(NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB,
                                  device="cpu"), init)
    tr = Trainer(model, {"title": title}, token_batch,
                 TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=dedup), device="cpu")
    assert tr.dedup is dedup and tr.optimizer.param_groups[0]["lr"] == 1e-4
    for raw in raws:
        loss = tr.train_step(dict(raw))
        assert torch.isfinite(loss)
    assert tr.step_count == 3
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("field,value,item", [
    ("scan_steps", 4, "A5"), ("sparse_embedding", True, "A12"),
    ("adam_mu_dtype", "bfloat16", "A3")])
def test_unported_trainer_options_raise(field, value, item):
    model = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Trainer(model, {"title": _title()}, token_batch,
                TrainerConfig(**{field: value}), device="cpu")


def test_trainer_seeds_and_learning_rate():
    model = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    make = lambda: Trainer(model, {"title": _title()}, token_batch, TrainerConfig(seed=7),
                           device="cpu")
    a, b = make(), make()
    seeds = [a.next_seed() for _ in range(3)]
    assert seeds == [b.next_seed() for _ in range(3)] and len(set(seeds)) == 3
    assert max(seeds) >= 1 << 32  # 64-bit seeds
    group = a.optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (1e-4, (0.9, 0.999), 1e-8)  # optax's
    with pytest.raises(ValueError, match="optimizer"):
        Trainer(model, {"title": _title()}, token_batch, TrainerConfig(optimizer="sgd"),
                device="cpu")


def test_bf16_embedding_gradient_sums_duplicates_in_fp32():
    """A documented difference (ROADMAP C): in bf16 the JAX WordEmbed casts
    the table before the gather, so the gradients of a token's duplicates
    are summed in bf16; the port gathers first and casts after, so it sums
    them in fp32 (exactly the fp32 sum of the bf16 cotangents)."""
    from ebnerd_tpu.models.layers import WordEmbed as JaxWordEmbed
    from ebnerd_tpu_torch.models.layers import WordEmbed

    vocab, emb, n = 4, 8, 4096
    tokens = np.zeros(n, np.int32)  # one row, 4,096 duplicates
    cot = np.random.default_rng(11).standard_normal((n, emb)).astype(np.float32)
    cot_bf16 = torch.from_numpy(cot).to(torch.bfloat16)
    layer = WordEmbed(vocab, emb, torch.bfloat16, torch.device("cpu"))
    (layer(torch.from_numpy(tokens).long()) * cot_bf16).float().sum().backward()
    ours = layer.embedding.grad[0].numpy()
    exact = cot_bf16.double().sum(0).numpy()
    np.testing.assert_allclose(ours, exact, rtol=1e-6, atol=1e-4)  # an fp32 sum

    jl = JaxWordEmbed(vocab, emb, dtype=jnp.bfloat16)
    table = jl.init(jax.random.key(0), jnp.asarray(tokens))
    jcot = jnp.asarray(cot_bf16.float().numpy()).astype(jnp.bfloat16)
    g = jax.grad(lambda p: jnp.sum((jl.apply(p, jnp.asarray(tokens)) * jcot).astype(jnp.float32)))(
        table)["params"]["embedding"]
    theirs = np.asarray(g[0], np.float64)
    # bf16 accumulation rounds: far off the exact sum, the port's fp32 sum is not
    assert np.abs(theirs - exact).max() > 100 * np.abs(ours - exact).max()
    np.testing.assert_allclose(theirs, exact, rtol=0.2, atol=2.0)  # the same sum, bf16-rounded
