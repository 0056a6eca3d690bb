"""The port's ``Trainer.fit`` / ``score`` against the JAX package's on one
synthetic EB-NeRD split (``make_synthetic_ebnerd``), fp32, on the CPU:
per-epoch loss, val AUC and lr decisions with the plateau and early
stopping firing, the best-restored parameters, gradient accumulation
against one large batch and ``optax.MultiSteps``, two-tower scoring
against the full forward and JAX's ``Trainer.score``; and within the port:
checkpoints (full state, atomic saves, keep pruning from disk), a killed
and resumed run bit-equal to an uninterrupted one with dropout on, resume
from the epoch ``meta.json`` names, prefetch on and off bit-equal."""
import json

import jax
import numpy as np
import pytest
import torch

from ebnerd_tpu import constants as c
from ebnerd_tpu.data.behaviors import (create_binary_labels_column, ebnerd_from_path,
                                       sampling_strategy_wu2019)
from ebnerd_tpu.data.dataloader import EvalFeed as JaxEvalFeed
from ebnerd_tpu.data.dataloader import NewsrecFeed as JaxFeed
from ebnerd_tpu.data.lookup import Lookup as JaxLookup
from ebnerd_tpu.data.ragged import Ragged as JaxRagged
from ebnerd_tpu.models import config as jax_config
from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu.models import newsrec as jax_newsrec
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.data import EvalFeed, Lookup, NewsrecFeed, Ragged, Table
from ebnerd_tpu_torch.models import (LSTUR, NAML, NRMS, HParamsLSTUR, HParamsNAML, HParamsNRMS,
                                     builder_for)
from ebnerd_tpu_torch.training import (CheckpointManager, Trainer, TrainerConfig, latest_step,
                                       restore_checkpoint, save_checkpoint)
from ebnerd_tpu_torch.utils import ScalarLogger

torch.set_num_threads(1)

H, T, TB, VOCAB, EMB, NPRATIO, BS = 5, 6, 7, 100, 16, 3, 16
HP = {
    "nrms": dict(title_size=T, history_size=H, head_num=2, head_dim=8, attention_hidden_dim=16),
    "lstur": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                  gru_unit=12, type="ini"),
    "naml": dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12,
                 body_size=TB, vert_num=5, subvert_num=6),
}
# callbacks that fire within the run: the plateau after one epoch without a
# better val AUC, early stopping after two
CALLBACKS = dict(early_stopping_patience=2, lr_patience=1, lr_factor=0.5, min_lr=1e-5)
RTOL = 1e-5
PARAM_ATOL = 1e-5


def port_table(df) -> Table:
    return Table({n: Ragged(df[n].values, df[n].offsets) if isinstance(df[n], JaxRagged)
                  else np.asarray(df[n]) for n in df.columns})


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from ebnerd_tpu.data.synthetic import make_synthetic_ebnerd
    from ebnerd_tpu.data.table import read_parquet

    path = make_synthetic_ebnerd(tmp_path_factory.mktemp("torch_fit") / "d", n_users=30,
                                 n_articles=50, n_impressions=160, seed=3)
    df = ebnerd_from_path(path, history_size=H)
    train_df = create_binary_labels_column(
        sampling_strategy_wu2019(df, npratio=NPRATIO, shuffle=True, seed=1))
    val_df = create_binary_labels_column(df)
    ids = np.asarray(read_parquet(path / "articles.parquet")[c.DEFAULT_ARTICLE_ID_COL])
    rng = np.random.default_rng(0)
    tables = {"title": rng.integers(1, VOCAB, (len(ids) + 1, T)).astype(np.int32),
              "body": rng.integers(1, VOCAB, (len(ids) + 1, TB)).astype(np.int32),
              "cat": rng.integers(0, 5, len(ids) + 1).astype(np.int32),
              "subcat": rng.integers(0, 6, len(ids) + 1).astype(np.int32)}
    for t in tables.values():
        t[0] = 0
    tables["title"][7] = 0  # an article with an empty title
    users = np.unique(np.asarray(df[c.DEFAULT_USER_COL]))
    umap = {int(u): i for i, u in enumerate(users[:-3])}  # 3 users unseen
    return dict(train=train_df, val=val_df, ids=ids, tables=tables, umap=umap)


def _lookup(mod, s):
    return mod.from_values(s["ids"], s["tables"]["title"][1:])


def _jax_feeds(s, seed=4):
    lk = _lookup(JaxLookup, s)
    return (JaxFeed(s["train"], lk, history_size=H, batch_size=BS, seed=seed,
                    user_mapping=s["umap"]),
            JaxEvalFeed(s["val"], lk, history_size=H, batch_size=32, user_mapping=s["umap"]),
            s["val"][c.DEFAULT_LABELS_COL])


def _port_feeds(s, seed=4):
    lk = _lookup(Lookup, s)
    val = port_table(s["val"])
    return (NewsrecFeed(port_table(s["train"]), lk, history_size=H, batch_size=BS, seed=seed,
                        user_mapping=s["umap"]),
            EvalFeed(val, lk, history_size=H, batch_size=32, user_mapping=s["umap"]),
            val[c.DEFAULT_LABELS_COL])


def _hp(family, s, dropout):
    hp = dict(HP[family], dropout=dropout)
    if family == "lstur":
        hp["n_users"] = len(s["umap"])
    return hp


def _jax_trainer(family, s, cfg):
    hp = _hp(family, s, 0.0)
    cls = {"nrms": (jax_config.HParamsNRMS, jax_newsrec.NRMS),
           "lstur": (jax_config.HParamsLSTUR, jax_newsrec.LSTUR),
           "naml": (jax_config.HParamsNAML, jax_newsrec.NAML)}[family]
    model = cls[1](cls[0](**hp), vocab_size=VOCAB, word_emb_dim=EMB)
    tr = JaxTrainer(model, s["tables"], jax_inputs.builder_for(family), JaxConfig(**cfg),
                    log_fn=lambda m: None)
    feed = _jax_feeds(s)[0]
    tr.init_state(next(iter(feed.epoch(shuffle=False, epoch=0))))
    return tr


def _params(jtr) -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params))


def _state_dict(family, params):
    return {"nrms": bridge.nrms_state_dict, "lstur": bridge.lstur_state_dict,
            "naml": bridge.naml_state_dict}[family](params)


def _port_model(family, s, dropout=0.0, params=None, seed=0):
    hp = _hp(family, s, dropout)
    kw = dict(vocab_size=VOCAB, word_emb_dim=EMB, device="cpu", seed=seed)
    model = {"nrms": lambda: NRMS(HParamsNRMS(**hp), **kw),
             "lstur": lambda: LSTUR(HParamsLSTUR(**hp), prng_dropout=True, **kw),
             "naml": lambda: NAML(HParamsNAML(**hp), prng_dropout=True, **kw)}[family]()
    if params is not None:
        model.load_state_dict(_state_dict(family, params), strict=True)
    return model


def _port_trainer(family, s, cfg, dropout=0.0, params=None, **kw):
    model = _port_model(family, s, dropout, params)
    return Trainer(model, s["tables"], builder_for(family), TrainerConfig(**cfg), device="cpu",
                   log_fn=lambda m: None, **kw)


def _assert_params_close(model, want: dict, atol=PARAM_ATOL):
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=atol, err_msg=k)


# ---- fit against JAX ------------------------------------------------------

@pytest.mark.parametrize("family", ["nrms", "lstur"])
def test_fit_matches_jax(split, family):
    """Same init (JAX's, through the bridge), same batches, dropout 0: every
    epoch's loss, val AUC and lr equal JAX's, the plateau and early stopping
    fire at the same epochs, and the best-restored parameters agree."""
    cfg = dict(learning_rate=1e-4, seed=0, monitor_mode="min", **CALLBACKS)
    jtr = _jax_trainer(family, split, cfg)
    init = _params(jtr)
    want_hist = jtr.fit(*_jax_feeds(split), epochs=8, steps_per_epoch=2)
    tr = _port_trainer(family, split, cfg, params=init)
    hist = tr.fit(*_port_feeds(split), epochs=8, steps_per_epoch=2)

    assert len(hist) == len(want_hist) < 8  # early stopping fired
    assert hist[-1]["lr"] < hist[0]["lr"]  # so did the plateau
    for got, want in zip(hist, want_hist):
        assert got.keys() == want.keys() and got["epoch"] == want["epoch"]
        assert got["lr"] == pytest.approx(want["lr"], rel=RTOL)
        assert got["loss"] == pytest.approx(want["loss"], rel=RTOL)
        assert got["val_auc"] == pytest.approx(want["val_auc"], rel=RTOL)
    want_lr = float(jtr.state.hyperparams()["learning_rate"])  # after the last epoch's decision
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, rel=RTOL)
    assert tr.step_count == 2 * len(hist) == int(jtr.state.step)
    _assert_params_close(tr.model, _state_dict(family, _params(jtr)))


def test_fit_restores_the_best_weights(split):
    """With a diverging learning rate the first epoch stays the best one:
    fit returns its weights, not the last epoch's, and scores with them."""
    cfg = dict(learning_rate=5.0, seed=0, early_stopping_patience=None, lr_patience=None)
    tr = _port_trainer("nrms", split, cfg)
    feed, val, labels = _port_feeds(split)
    snapshots = []
    run_epoch = tr._run_epoch

    def spy(*a, **kw):
        out = run_epoch(*a, **kw)
        snapshots.append({k: v.clone() for k, v in tr.model.state_dict().items()})
        return out

    tr._run_epoch = spy
    hist = tr.fit(feed, val, labels, epochs=3, steps_per_epoch=2)
    best = int(np.argmax([h["val_auc"] for h in hist]))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, snapshots[best][k]), k
    fresh = _port_model("nrms", split)
    fresh.load_state_dict(snapshots[best])
    ref = Trainer(fresh, split["tables"], builder_for("nrms"), device="cpu")
    np.testing.assert_array_equal(tr.score(val).values, ref.score(val).values)


def test_accumulation_matches_one_large_batch_and_multisteps(split):
    """accumulation_steps=2 at batch 8 equals one step at batch 16 and
    JAX's optax.MultiSteps; Adam's count advances once per update."""
    cfg = dict(learning_rate=1e-4, seed=0, early_stopping_patience=None, lr_patience=None)
    feed = _port_feeds(split)[0]
    big = next(iter(feed.epoch(shuffle=False)))
    halves = [{k: v[i * 8:(i + 1) * 8] for k, v in big.items()} for i in range(2)]
    jtr = _jax_trainer("nrms", split, dict(cfg, accumulation_steps=2))
    init = _params(jtr)
    for raw in halves:
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(jax_dedup.prep_dedup_batch(dict(raw), 512)),
                                       jax.random.key(0, impl=jtr.config.rng_impl))
    want = _state_dict("nrms", _params(jtr))

    accum = _port_trainer("nrms", split, dict(cfg, accumulation_steps=2), params=init)
    for i, raw in enumerate(halves):
        accum.train_step(dict(raw))
        steps = [s["step"].item() for s in accum.optimizer.state_dict()["state"].values()]
        assert steps == ([] if i == 0 else [1.0] * len(steps))
    one = _port_trainer("nrms", split, cfg, params=init)
    one.train_step(dict(big))
    assert accum.step_count == 2 and one.step_count == 1
    for k, v in accum.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), one.model.state_dict()[k].numpy(),
                                   atol=PARAM_ATOL, err_msg=k)
    _assert_params_close(accum.model, want)


def test_accumulation_must_be_positive(split):
    with pytest.raises(ValueError, match="accumulation_steps"):
        _port_trainer("nrms", split, dict(accumulation_steps=0))


# ---- scoring --------------------------------------------------------------

@pytest.mark.parametrize("family", ["nrms", "lstur", "naml"])
def test_score_two_tower_equals_full_forward_and_jax(split, family):
    cfg = dict(seed=0)
    jtr = _jax_trainer(family, split, cfg)
    params = _params(jtr)
    jval = _jax_feeds(split)[1]
    want_tt = np.asarray(jtr.score(jval, two_tower=True).values)
    want_full = np.asarray(jtr.score(jval, two_tower=False).values)

    tr = _port_trainer(family, split, cfg, params=params)
    val = _port_feeds(split)[1]
    tt, full, auto = (tr.score(val, two_tower=True), tr.score(val, two_tower=False),
                      tr.score(val))
    np.testing.assert_array_equal(tt.offsets, val.inview.offsets)
    np.testing.assert_array_equal(auto.values, tt.values)  # "auto" takes the towers
    np.testing.assert_allclose(tt.values, full.values, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tt.values, want_tt, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(full.values, want_full, rtol=RTOL, atol=1e-6)


def test_score_runs_in_eval_mode_and_restores_training_mode(split):
    tr = _port_trainer("nrms", split, dict(seed=0), dropout=0.2)
    feed, val, _ = _port_feeds(split)
    tr.train_step(next(iter(feed.epoch())))
    assert tr.model.training
    first = tr.score(val, two_tower=False)
    assert tr.model.training
    np.testing.assert_array_equal(first.values, tr.score(val, two_tower=False).values)
    tr.model.eval()
    np.testing.assert_array_equal(first.values, tr.score(val, two_tower=False).values)
    assert not tr.model.training


def test_article_index_fresh_after_best_weight_restore(split):
    """The article vectors are cached on the step count, which the
    best-weight restore does not change: fit drops the cache, so two-tower
    scores after fit equal the full forward at the restored weights."""
    tr = _port_trainer("nrms", split, dict(learning_rate=5.0, seed=0,
                                           early_stopping_patience=None, lr_patience=None))
    hist = tr.fit(*_port_feeds(split), epochs=2, steps_per_epoch=2)
    assert hist[1]["val_auc"] != hist[0]["val_auc"]
    assert tr._art_cache is None
    val = _port_feeds(split)[1]
    tt = tr.score(val, two_tower=True)
    assert tr._art_cache is not None and tr._art_cache[0] == tr.step_count
    cached = tr._art_cache[1]
    tr.score(val, two_tower=True)
    assert tr._art_cache[1] is cached  # encoded once at fixed weights
    np.testing.assert_allclose(tt.values, tr.score(val, two_tower=False).values,
                               rtol=RTOL, atol=1e-6)


def test_scalar_logger_gets_step_and_epoch_scalars(split, tmp_path):
    tr = _port_trainer("nrms", split, dict(seed=0))
    with ScalarLogger(tmp_path, tensorboard=False) as log:
        tr.fit(*_port_feeds(split), epochs=2, steps_per_epoch=4, scalar_logger=log,
               log_every_steps=2)
    rows = [json.loads(line) for line in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows if r["tag"] == "train/loss_step"]
    assert steps == [2, 4, 6, 8]
    assert {r["tag"] for r in rows} == {"train/loss_step", "train/loss", "train/lr",
                                        "val/val_auc"}


# ---- prefetch ---------------------------------------------------------------

def test_prefetch_on_and_off_are_bit_equal(split):
    params = {}
    for depth in (0, 2):
        tr = _port_trainer("nrms", split, dict(seed=0, prefetch=depth), dropout=0.2)
        tr.fit(_port_feeds(split)[0], epochs=2, steps_per_epoch=3)
        params[depth] = tr.model.state_dict()
    for k, v in params[0].items():
        assert torch.equal(v, params[2][k]), k


def test_prefetch_forwards_a_worker_error(split):
    tr = _port_trainer("nrms", split, dict(seed=0, prefetch=2))
    feed = _port_feeds(split)[0]
    epoch = feed.epoch

    def broken(*a, **kw):
        for i, batch in enumerate(epoch(*a, **kw)):
            if i == 2:
                raise RuntimeError("feed failed")
            yield batch

    feed.epoch = broken
    with pytest.raises(RuntimeError, match="feed failed"):
        tr.fit(feed, epochs=1)
    assert tr.step_count == 2


# ---- checkpoints and resume -----------------------------------------------

def _resume_cfg():
    return dict(learning_rate=1e-2, seed=0, early_stopping_patience=None, lr_patience=2,
                lr_factor=0.5)


def test_resume_is_bit_equal_to_an_uninterrupted_run(split, tmp_path):
    """Killed after epoch 2 of 4 and resumed into a fresh Trainer (dropout
    0.2): the same history and bit-equal final (best-restored) parameters."""
    a = _port_trainer("nrms", split, _resume_cfg(), dropout=0.2)
    hist_a = a.fit(*_port_feeds(split), epochs=4, steps_per_epoch=3, ckpt_dir=tmp_path / "a")
    b = _port_trainer("nrms", split, _resume_cfg(), dropout=0.2)
    b.fit(*_port_feeds(split), epochs=2, steps_per_epoch=3, ckpt_dir=tmp_path / "b")
    del b
    c_ = _port_trainer("nrms", split, _resume_cfg(), dropout=0.2)
    hist_c = c_.fit(*_port_feeds(split), epochs=4, steps_per_epoch=3, ckpt_dir=tmp_path / "b",
                    resume=True)
    assert hist_c == hist_a
    assert c_.step_count == a.step_count == 12
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, c_.model.state_dict()[k]), k
    meta = json.loads((tmp_path / "b" / "meta.json").read_text())
    assert meta["epoch"] == 3 and meta["history"] == hist_a


def test_resume_uses_the_epoch_meta_names(split, tmp_path):
    """A kill between the state save and the meta write leaves a newer
    step directory; resume restores the epoch meta.json names and goes on
    exactly as a run without the kill."""
    ref = _port_trainer("nrms", split, _resume_cfg(), dropout=0.2)
    want = ref.fit(*_port_feeds(split), epochs=3, steps_per_epoch=2)
    tr = _port_trainer("nrms", split, _resume_cfg(), dropout=0.2)
    tr.fit(*_port_feeds(split), epochs=2, steps_per_epoch=2, ckpt_dir=tmp_path)
    tr.train_step(next(iter(_port_feeds(split)[0].epoch())))
    save_checkpoint(tr, tmp_path, step=7)  # the orphan
    assert json.loads((tmp_path / "meta.json").read_text())["epoch"] == 1
    tr2 = _port_trainer("nrms", split, _resume_cfg(), dropout=0.2)
    hist = tr2.fit(*_port_feeds(split), epochs=3, steps_per_epoch=2, ckpt_dir=tmp_path,
                   resume=True)
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    assert hist == want
    for k, v in ref.model.state_dict().items():
        assert torch.equal(v, tr2.model.state_dict()[k]), k


def test_resume_without_meta_starts_from_scratch(split, tmp_path):
    want = _port_trainer("nrms", split, _resume_cfg()).fit(*_port_feeds(split), epochs=1,
                                                            steps_per_epoch=2)
    hist = _port_trainer("nrms", split, _resume_cfg()).fit(
        *_port_feeds(split), epochs=1, steps_per_epoch=2, ckpt_dir=tmp_path, resume=True)
    assert hist == want


def test_checkpoint_round_trips_the_full_state(split, tmp_path):
    tr = _port_trainer("nrms", split, dict(seed=0, accumulation_steps=2), dropout=0.2)
    feed = _port_feeds(split)[0]
    batches = list(feed.epoch(shuffle=False))
    for raw in batches[:3]:  # an odd count: one micro-batch waits for the next update
        tr.train_step(dict(raw))
    tr._set_lr(3e-4)
    save_checkpoint(tr, tmp_path, step=3)
    assert latest_step(tmp_path) == 3
    other = _port_trainer("nrms", split, dict(seed=5, accumulation_steps=2), dropout=0.2)
    other.load_state_dict(restore_checkpoint(other, tmp_path, step=3))
    assert other.step_count == 3 and other._micro == 1
    assert other.optimizer.param_groups[0]["lr"] == 3e-4
    assert other.next_seed() == tr.next_seed()
    for raw in batches[3:5]:
        tr.train_step(dict(raw))
        other.train_step(dict(raw))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k]), k
    for a, b in zip(tr.optimizer.state_dict()["state"].values(),
                    other.optimizer.state_dict()["state"].values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_manager_keeps_three_seeded_from_disk_and_ignores_temporaries(split, tmp_path):
    tr = _port_trainer("nrms", split, dict(seed=0))
    mgr = CheckpointManager(tmp_path)
    for s in (1, 2):
        mgr.save_step(tr, s)
    (tmp_path / ".tmp-step_9-x").mkdir()  # a save cut short
    (tmp_path / ".tmp-step_9-x" / "state.pt").write_bytes(b"partial")
    (tmp_path / "step_x").mkdir()
    assert latest_step(tmp_path) == 2
    again = CheckpointManager(tmp_path)  # a resumed process
    assert again._saved_steps == [1, 2]
    for s in (3, 4):
        again.save_step(tr, s)
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_")) == [
        "step_2", "step_3", "step_4", "step_x"]
    assert latest_step(tmp_path) == 4
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp-") and p.name != ".tmp-step_9-x"]
    tr.train_step(next(iter(_port_feeds(split)[0].epoch())))
    again.save_step(tr, 4)  # overwrite in place
    state, step = again.restore_latest(tr)
    assert step == 4 and state["step"] == 1
    again.save_best(tr)
    assert again.restore_best(tr)["step"] == 1
    assert CheckpointManager(tmp_path / "absent").restore_latest(tr) == (None, None)
