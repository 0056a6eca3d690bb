"""The port's ``TrainerConfig.scan_steps`` on the CPU (where its groups run
eagerly: the graphs are the card's), against its own ``scan_steps=1`` path
and the JAX trainer's ``scan_steps`` (``lax.scan``), fp32, small widths:
at dropout 0 ``fit`` with ``scan_steps=4`` over 6 steps (4 in a group, 2
single) keeps the per-step trajectory for all six families (NRMS dedup and
per slot, NRMSDocVec, LSTUR, NPA, NAML, Fastformer) and JAX's for NRMS and
NAML, with ``accumulation_steps=2`` too, within the tolerance of
``tests/training/test_trainer.py``'s scan test; a group padded to one
bucket keeps each batch's ``art_n_uniq`` and, with dropout, equals per-step
runs under the folded seeds; resume mid-run is bit-equal; the plain Philox
and K3 masks take a seed tensor (bit 63 set) as the int; the hand-written
Adam's device-count mode is bit-equal to optax."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ebnerd_tpu.models import config as jax_config
from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu.models import newsrec as jax_newsrec
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.models import (LSTUR, NAML, NPA, NRMS, Fastformer, HParamsFastformer,
                                     HParamsLSTUR, HParamsNAML, HParamsNPA, HParamsNRMS,
                                     HParamsNRMSDocVec, NRMSDocVec, builder_for)
from ebnerd_tpu_torch.models.layers import PrngDropout
from ebnerd_tpu_torch.ops import dropout as k3
from ebnerd_tpu_torch.ops import philox
from ebnerd_tpu_torch.training import Trainer, TrainerConfig, prep_dedup_batch
from ebnerd_tpu_torch.training.adam import Adam
from ebnerd_tpu_torch.training.trainer import step_seed

torch.set_num_threads(1)

BS, H, K, T, TB, VOCAB, EMB, N_ART, N_USERS, DV = 8, 5, 4, 6, 7, 60, 16, 30, 9, 8
RTOL, ATOL = 2e-5, 1e-6  # tests/training/test_trainer.py's scan test
STEPS = 6                # 4 in one group of scan_steps=4, then 2 single steps
HP = {
    "nrms": dict(title_size=T, history_size=H, head_num=2, head_dim=8, attention_hidden_dim=16),
    "nrms_docvec": dict(title_size=DV, history_size=H, head_num=2, head_dim=4,
                        attention_hidden_dim=6, newsencoder_units_per_layer=(8, 8)),
    "lstur": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                  gru_unit=12, type="ini", n_users=N_USERS),
    "naml": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                 body_size=TB, vert_num=5, subvert_num=6),
    "npa": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                user_emb_dim=10, n_users=N_USERS),
    "fastformer": dict(n_layers=2, embedding_dim=16, n_heads=2, intermediate_dim=12,
                       max_position=32, title_size=T, history_size=H),
}
PORT = {"nrms": (HParamsNRMS, NRMS), "nrms_docvec": (HParamsNRMSDocVec, NRMSDocVec),
        "lstur": (HParamsLSTUR, LSTUR), "naml": (HParamsNAML, NAML), "npa": (HParamsNPA, NPA),
        "fastformer": (HParamsFastformer, Fastformer)}
USERS = ("lstur", "npa")


def _tables(family):
    rng = np.random.default_rng(1)
    if family == "nrms_docvec":
        docvec = rng.standard_normal((N_ART + 1, DV)).astype(np.float32)
        docvec[0] = 0.0
        return {"docvec": docvec}
    tables = {"title": rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)}
    tables["title"][0] = 0
    if family == "naml":
        tables["body"] = rng.integers(1, VOCAB, (N_ART + 1, TB)).astype(np.int32)
        tables["body"][0] = 0
        tables["cat"] = rng.integers(0, 5, N_ART + 1).astype(np.int32)
        tables["subcat"] = rng.integers(0, 6, N_ART + 1).astype(np.int32)
    return tables


def _raw(seed, users=False, bs=BS, n_art=N_ART):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, n_art + 1, (bs, H)).astype(np.int32),
           "cand_idx": rng.integers(1, n_art + 1, (bs, K)).astype(np.int32),
           "labels": np.zeros((bs, K), np.float32)}
    raw["labels"][np.arange(bs), rng.integers(0, K, bs)] = 1.0
    if users:
        raw["user_idx"] = rng.integers(0, N_USERS + 1, bs).astype(np.int32)
    return raw


class _Feed:
    """The ``epoch()`` a trainer's ``fit`` reads: the same batches, in order."""

    def __init__(self, raws):
        self.raws = raws

    def epoch(self, shuffle=True, epoch=None):
        return iter([dict(r) for r in self.raws])


def _loss(family):
    # Fastformer's user term cancels under the softmax CE (ROADMAP C)
    return "log_loss" if family == "fastformer" else "cross_entropy_loss"


def _port_model(family, dropout=0.0, **kw):
    hp_cls, cls = PORT[family]
    extra = {} if family in ("fastformer", "nrms_docvec") else dict(word_emb_dim=EMB)
    if family in ("lstur", "npa", "naml"):
        extra["prng_dropout"] = True
    return cls(hp_cls(**dict(HP[family], dropout=dropout)), device="cpu", seed=0,
               **({} if family == "nrms_docvec" else dict(vocab_size=VOCAB)), **extra, **kw)


def _port_fit(family, scan_steps, dedup=True, model=None, raws=None, **cfg):
    model = _port_model(family) if model is None else model
    cfg = dict(dict(learning_rate=1e-3, seed=0, dedup_articles=dedup, loss=_loss(family),
                    early_stopping_patience=None, lr_patience=None), **cfg)
    tr = Trainer(model, _tables(family), builder_for(family),
                 TrainerConfig(scan_steps=scan_steps, **cfg), device="cpu", log_fn=lambda s: None)
    raws = raws or [_raw(10 + i, family in USERS) for i in range(STEPS)]
    tr.fit(_Feed(raws), epochs=1, steps_per_epoch=len(raws))
    return tr


def _close(got: dict, want: dict, skip=()):
    assert got.keys() == want.keys()
    for k in got:
        if k not in skip:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("family,dedup", [
    ("nrms", True), ("nrms", False), ("nrms_docvec", True), ("lstur", True), ("npa", True),
    ("naml", True), ("fastformer", True)],
    ids=["nrms_dedup", "nrms_per_slot", "nrms_docvec", "lstur", "npa", "naml", "fastformer"])
def test_scan_fit_keeps_the_per_step_trajectory(family, dedup):
    """Dropout 0: 4 steps in one group and 2 single keep the parameters (BN
    buffers included) of 6 single steps; one eager group on the CPU."""
    one, four = _port_fit(family, 1, dedup), _port_fit(family, 4, dedup)
    assert four.step_count == one.step_count == STEPS
    assert four.scan_stats["captures"] == four.scan_stats["replays"] == 0  # no graphs on the CPU
    _close(four.model.state_dict(), one.model.state_dict())
    assert len(four.history) == 1
    np.testing.assert_allclose(four.history[0]["loss"], one.history[0]["loss"], rtol=RTOL)


# ---- against JAX's lax.scan ---------------------------------------------------

_JAX = {"nrms": (jax_config.HParamsNRMS, jax_newsrec.NRMS),
        "naml": (jax_config.HParamsNAML, jax_newsrec.NAML)}
_STATE_DICT = {"nrms": bridge.nrms_state_dict, "naml": bridge.naml_state_dict}


def _jax_and_port(family, **cfg):
    """(JAX trainer after ``fit`` with scan_steps=4, the port's trainer after
    the same fit from JAX's init)."""
    hp_cls, cls = _JAX[family]
    model = cls(hp_cls(**dict(HP[family], dropout=0.0)), vocab_size=VOCAB, word_emb_dim=EMB)
    # lr 1e-4, as the port's other trainer tests against JAX: the pooling biases'
    # gradients cancel over each article's tokens, and Adam turns their
    # rounding (another summation order in each package) into steps of up to lr
    jcfg = dict(learning_rate=1e-4, seed=0, early_stopping_patience=None, lr_patience=None,
                scan_steps=4, **cfg)
    jtr = JaxTrainer(model, _tables(family), jax_inputs.builder_for(family), JaxConfig(**jcfg),
                     log_fn=lambda s: None)
    raws = [_raw(10 + i) for i in range(STEPS)]
    jtr.init_state(raws[0])
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params))
    jtr.fit(_Feed(raws), epochs=1, steps_per_epoch=STEPS)
    port = _port_model(family)
    port.load_state_dict(_STATE_DICT[family](init), strict=True)
    tr = _port_fit(family, 4, model=port, raws=raws, learning_rate=1e-4, **cfg)
    return jtr, tr


# NRMS's news-pool bias: its gradient nearly cancels over each article's
# tokens (datt sums to 0), so each package's summation order moves its Adam
# steps by up to 5e-6 at lr 1e-4 on the per-step path already; it is held to
# the port's other trainer tests' tolerance against JAX
# (tests/test_torch_training.py, tests/test_torch_sparse_embed.py: 1e-5)
_CANCELLING = {"news_pool.W.bias": 1e-5}


def _close_to_jax(got: dict, want: dict):
    _close(got, want, skip=tuple(_CANCELLING))
    for k, atol in ((k, a) for k, a in _CANCELLING.items() if k in got):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("family", ["nrms", "naml"])
def test_scan_fit_matches_jax(family):
    jtr, tr = _jax_and_port(family)
    want = _STATE_DICT[family](jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params)))
    assert int(jtr.state.step) == tr.step_count == STEPS
    _close_to_jax(tr.model.state_dict(), want)


def test_scan_with_accumulation_matches_jax():
    """accumulation_steps=2: the group's 4 micro-batches make 2 updates, the
    remainder's 2 one more (optax.MultiSteps in JAX)."""
    jtr, tr = _jax_and_port("nrms", accumulation_steps=2)
    want = bridge.nrms_state_dict(jax.tree_util.tree_map(np.asarray,
                                                         jax.device_get(jtr.state.params)))
    assert tr.step_count == STEPS and tr._micro == 0
    assert int(tr.optimizer.state[tr.model.news_pool.q.weight]["step"]) == STEPS // 2
    _close_to_jax(tr.model.state_dict(), want)


# ---- groups, buckets, seeds ----------------------------------------------------

MIN_BUCKET = 256


def _uneven_raws():
    """Four batches of 40 impressions whose dedup buckets differ: about 300
    unique articles of 1,000 (a bucket of 320), at most 61 of 60 (256)."""
    return [_raw(20 + i, bs=40, n_art=60 if i % 2 else 1000) for i in range(4)]


def test_a_group_is_padded_to_one_bucket_and_keeps_each_n_valid():
    raws = _uneven_raws()
    preps = [prep_dedup_batch(dict(r), MIN_BUCKET) for r in raws]
    assert len({p["art_uniq"].shape[0] for p in preps}) == 2
    tr = Trainer(_port_model("nrms"), _big_tables(), builder_for("nrms"),
                 TrainerConfig(scan_steps=4, dedup_min_bucket=MIN_BUCKET), device="cpu")
    group = tr.pack_group([dict(r) for r in raws])
    views = {k: torch.as_tensor(v) for k, v in _group_views(group).items()}
    bucket = max(p["art_uniq"].shape[0] for p in preps)
    assert group.n == 4 and tuple(views["art_uniq"].shape) == (4, bucket)
    for i, p in enumerate(preps):
        n = p["n_uniq"]
        assert int(views["art_n_uniq"][i, 0]) == n
        np.testing.assert_array_equal(views["art_uniq"][i, :n].numpy(), p["art_uniq"][:n])
        assert not views["art_uniq"][i, n:].any() and not views["art_counts"][i, n:].any()
        np.testing.assert_array_equal(views["hist_slot"][i].numpy(), p["hist_slot"])
    assert "n_uniq" not in views and views["seeds"].dtype == torch.int64


def _big_tables():
    t = np.random.default_rng(3).integers(1, VOCAB, (1001, T)).astype(np.int32)
    t[0] = 0
    return {"title": t}


def _group_views(group):
    from ebnerd_tpu_torch.training.trainer import _views

    return _views(group.host, group.layout)


def test_group_steps_equal_per_step_runs_under_the_folded_seeds():
    """The fused encoder's plain version with dropout 0.2: a group of four
    batches of two buckets, each step taking its own ``art_n_uniq`` and
    seed tensor, equals four single steps on each batch's own bucket with
    ``step_seed(group seed, count + i)`` as an int (the same masks)."""
    raws = _uneven_raws()
    make = lambda: Trainer(NRMS(HParamsNRMS(**dict(HP["nrms"], dropout=0.2)), vocab_size=VOCAB,
                                word_emb_dim=EMB, use_fused_encoder=True, device="cpu", seed=0),
                           _big_tables(), builder_for("nrms"),
                           TrainerConfig(learning_rate=1e-3, scan_steps=4, seed=5,
                                         dedup_min_bucket=MIN_BUCKET), device="cpu")
    scan, single = make(), make()
    losses = scan.run_group(scan.pack_group([dict(r) for r in raws]))
    group_seed = single.next_seed()
    want = [single._micro_step(dict(single.prepare(dict(r)),
                                    dropout_seed=step_seed(group_seed, i)))
            for i, r in enumerate(raws)]
    assert scan.step_count == single.step_count == 4
    np.testing.assert_allclose(losses.numpy(), torch.stack(want).numpy(), rtol=RTOL, atol=ATOL)
    _close(scan.model.state_dict(), single.model.state_dict())
    other = make()  # another group seed draws other masks
    other.next_seed()
    assert not torch.equal(other.run_group(other.pack_group([dict(r) for r in raws])), losses)


def test_step_seed_folds_the_group_seed_and_the_step():
    s = (1 << 63) | 12345
    seeds = [step_seed(s, i) for i in range(64)]
    assert len(set(seeds)) == 64 and all(0 <= v < 1 << 64 for v in seeds)
    assert any(v >= 1 << 63 for v in seeds)  # negative as int64: the split's sign case
    assert step_seed(s, 3) != step_seed(s ^ 1, 3)
    assert step_seed(0, 0) == 0xE220A8397B1DCDAF  # SplitMix64's first output from seed 0


def test_resume_mid_run_with_scan_steps_is_bit_equal(tmp_path):
    """Two epochs of 6 steps (a group and 2 single each) with the fused
    encoder's dropout: stopped after one and resumed, bit-equal to the
    uninterrupted run."""
    raws = [_raw(30 + i) for i in range(STEPS)]

    def run(epochs, ckpt, resume=False):
        tr = Trainer(NRMS(HParamsNRMS(**dict(HP["nrms"], dropout=0.2)), vocab_size=VOCAB,
                          word_emb_dim=EMB, use_fused_encoder=True, device="cpu", seed=0),
                     _tables("nrms"), builder_for("nrms"),
                     TrainerConfig(learning_rate=1e-3, scan_steps=4, seed=3,
                                   early_stopping_patience=None, lr_patience=None),
                     device="cpu", log_fn=lambda s: None)
        tr.fit(_Feed(raws), epochs=epochs, steps_per_epoch=STEPS, ckpt_dir=ckpt, resume=resume)
        return tr

    full = run(2, tmp_path / "full")
    run(1, tmp_path / "cut")
    resumed = run(2, tmp_path / "cut", resume=True)
    assert resumed.step_count == full.step_count == 2 * STEPS
    for k, v in full.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in full.history]


def test_log_every_reads_the_newest_step_of_a_group():
    logged = []

    class Logger:
        def log(self, name, value, step):
            logged.append((name, step, value))

        def log_dict(self, values, step):
            pass

    tr = Trainer(_port_model("nrms"), _tables("nrms"), builder_for("nrms"),
                 TrainerConfig(scan_steps=4, early_stopping_patience=None, lr_patience=None),
                 device="cpu", log_fn=lambda s: None)
    tr.fit(_Feed([_raw(10 + i) for i in range(STEPS)]), epochs=1, steps_per_epoch=STEPS,
           scalar_logger=Logger(), log_every_steps=2)
    # as JAX: once 2 steps have passed, the newest step's loss (the group's end, then step 6)
    assert [s for _, s, _ in logged] == [4, 6]


def test_scan_steps_below_one_and_sparse_raise():
    model = _port_model("nrms")
    with pytest.raises(ValueError, match="scan_steps"):
        Trainer(model, _tables("nrms"), builder_for("nrms"), TrainerConfig(scan_steps=0),
                device="cpu")
    with pytest.raises(ValueError, match="scan_steps == 1"):
        Trainer(model, _tables("nrms"), builder_for("nrms"),
                TrainerConfig(scan_steps=4, sparse_embedding=True), device="cpu")


# ---- seeds as tensors -------------------------------------------------------------

@pytest.mark.parametrize("seed", [(1 << 63) | 0x0123456789, (1 << 64) - 1, 0x5EED00001234ABCD],
                         ids=["bit63", "all_ones", "positive"])
def test_plain_philox_mask_takes_a_seed_tensor(seed):
    """A seed >= 2**63 is a negative int64: its words, and the masks of both
    streams, equal the Python int's."""
    t = torch.tensor(np.array([seed], np.uint64).view(np.int64)[0])
    lo, hi = philox.split_seed(t)
    assert (int(lo), int(hi)) == philox.split_seed(seed)
    for stream in (philox.STREAM_EMB, philox.STREAM_ATT):
        assert torch.equal(philox.mask(t, stream, 40, 24, 0.8),
                           philox.mask(seed, stream, 40, 24, 0.8))


def test_k3_plain_version_and_its_backward_take_a_seed_tensor():
    seed = (1 << 63) | 77
    t = torch.tensor(np.array([seed], np.uint64).view(np.int64)[0])
    x = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(0), requires_grad=True)
    y = k3.prng_dropout(x, t, 2, 0.8, offset=5)
    assert torch.equal(y, k3.dropout_reference(x.detach(), seed, 2, 0.8, offset=5))
    y.sum().backward()
    assert torch.equal(x.grad, k3.dropout_reference(torch.ones_like(x), seed, 2, 0.8, offset=5))


def test_tensor_seeds_put_the_generator_sites_on_the_kernel():
    """The scan path's seed tensor: NRMS's unfused masks come from the
    kernel's streams 0 and 1 (the per-step path's from one generator), a
    generator-seeded ``PrngDropout`` takes the kernel at its stream."""
    seed = 0x5EED00001234ABCD
    t = torch.tensor(seed)
    drop = PrngDropout(0.2, use_kernel=False).train()
    x = torch.ones(4, 6, 8)
    assert torch.equal(drop(x, t, 3, 2), k3.dropout_reference(x, seed, 3, 0.8, 2 * 48))
    assert not torch.equal(drop(x, seed, 3, 2), drop(x, t, 3, 2))
    model = NRMS(HParamsNRMS(**dict(HP["nrms"], dropout=0.2)), vocab_size=VOCAB,
                 word_emb_dim=EMB, device="cpu", seed=0).train()
    tokens = torch.as_tensor(_tables("nrms")["title"][1:9]).long()
    seen = []
    real = k3.dropout_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k3, "dropout_reference", lambda x_, s, stream, keep, offset=0:
                   seen.append(stream) or real(x_, s, stream, keep, offset))
        out = model.encode_news(tokens, seed=t)
    assert seen == [0, 1] and torch.isfinite(out).all()


def test_capturable_adam_is_bit_equal_to_optax():
    """The device-count Adam (fp32 count, bias corrections by fp32 pow on the
    parameter's device, a tensor learning rate) keeps optax's bits with the
    bf16 first moment, as the host-count Adam does."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 33)).astype(np.float32)
    grads = [rng.standard_normal((64, 33)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0, 1e-6, 0.3)]
    tx = optax.adam(1e-3, mu_dtype=jnp.bfloat16)
    p, st = jnp.asarray(p0), None
    st = tx.init(p)
    for g in grads:
        u, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, u)
    q = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Adam([q], lr=torch.tensor(1e-3), mu_dtype="bfloat16", capturable=True)
    for g in grads:
        q.grad = torch.from_numpy(g.copy())
        opt.step()
    assert opt.state[q]["step"].dtype == torch.float32 and int(opt.state[q]["step"]) == 5
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(p))
    np.testing.assert_array_equal(opt.state[q]["exp_avg"].float().numpy(),
                                  np.asarray(st[0].mu.astype(jnp.float32)))
    # a state saved by the host-count Adam loads into the device-count one and on
    host = Adam([torch.nn.Parameter(torch.from_numpy(p0.copy()))], lr=1e-3, mu_dtype="bfloat16")
    host.param_groups[0]["params"][0].grad = torch.from_numpy(grads[0].copy())
    host.step()
    opt2 = Adam([torch.nn.Parameter(torch.from_numpy(p0.copy()))], lr=torch.tensor(1e-3),
                mu_dtype="bfloat16", capturable=True)
    opt2.load_state_dict(host.state_dict())
    st2 = next(iter(opt2.state.values()))
    assert st2["step"].dtype == torch.float32 and int(st2["step"]) == 1
    assert st2["exp_avg"].dtype == torch.bfloat16 and opt2.param_groups[0]["capturable"]
