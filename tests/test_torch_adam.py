"""The port's hand-written Adam (``training/adam.py``) and the Trainer's
``adam_mu_dtype`` against optax and the JAX trainer, on the CPU: one
optimizer on identical gradients bit-equal to ``optax.adam`` with a bf16
first moment (fp32: to the last bit but for rounding of the bias
correction's power), agreement with ``torch.optim.Adam`` without
``mu_dtype``, three Trainer steps against JAX's
``TrainerConfig(adam_mu_dtype="bfloat16")`` (with accumulation steps 2
as well), the stored first moment within one bf16 ulp of JAX's, resume
bit-equal, and the sparse mode's table moments kept in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ebnerd_tpu.models.config import HParamsNRMS as JaxHP
from ebnerd_tpu.models.inputs import token_batch as jax_token_batch
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch.bridge import load_nrms_params, nrms_state_dict
from ebnerd_tpu_torch.models import NRMS, HParamsNRMS, token_batch
from ebnerd_tpu_torch.training import Trainer, TrainerConfig
from ebnerd_tpu_torch.training.adam import Adam, mu_dtype_of

torch.set_num_threads(1)

BS, H, K, T, VOCAB, EMB, N_ART = 8, 5, 4, 6, 60, 16, 30
HP = dict(title_size=T, history_size=H, head_num=2, head_dim=8, attention_hidden_dim=16,
          dropout=0.0)
# gradients of very different scales (1e-6 is near eps, where Adam amplifies rounding)
SCALES = (1.0, 1e-3, 10.0, 1e-6, 0.3)


def _grads(seed=0, shape=(64, 33)):
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal(shape).astype(np.float32)
    return p0, [rng.standard_normal(shape).astype(np.float32) * s for s in SCALES]


def _optax_run(p0, grads, mu_dtype, lr=1e-3):
    tx = optax.adam(lr, mu_dtype=mu_dtype)
    p = jnp.asarray(p0)
    state = tx.init(p)
    for g in grads:
        u, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, u)
    return (np.asarray(p), np.asarray(state[0].mu.astype(jnp.float32)),
            np.asarray(state[0].nu), state[0].mu.dtype)


def _port_run(p0, grads, mu_dtype, lr=1e-3):
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Adam([p], lr=lr, mu_dtype=mu_dtype)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    st = opt.state[p]
    return p.detach().numpy(), st["exp_avg"], st["exp_avg_sq"].numpy(), opt


def test_bf16_first_moment_bit_equal_to_optax():
    """Same gradients: parameters, the stored bf16 first moment and the fp32
    second moment equal optax's bit for bit (b1 * m is a bf16 product, the
    update comes from the fp32 sum, the moment is rounded to nearest even)."""
    p0, grads = _grads()
    want_p, want_mu, want_nu, mu_dt = _optax_run(p0, grads, "bfloat16")
    got_p, got_mu, got_nu, _ = _port_run(p0, grads, "bfloat16")
    assert mu_dt == jnp.bfloat16 and got_mu.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_mu.float().numpy(), want_mu)
    np.testing.assert_array_equal(got_nu, want_nu)


def test_b1_times_m_rounds_in_bf16():
    """The product that makes the bf16 moment differ from an fp32-scalar
    product: 0.9 rounds to bf16 first, as flax's weak-typed scalar does."""
    m = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    m = m.to(torch.bfloat16)
    want = np.asarray((0.9 * jnp.asarray(m.float().numpy()).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    np.testing.assert_array_equal((m * torch.tensor(0.9, dtype=torch.bfloat16)).float().numpy(),
                                  want)
    assert not np.array_equal((m * 0.9).float().numpy(), want)  # the Python scalar's fp32 product


def test_fp32_first_moment_matches_optax():
    """Without mu_dtype the moments equal optax's bit for bit; a parameter
    may differ in its last bit (the bias correction's fp32 power)."""
    p0, grads = _grads(2)
    want_p, want_mu, want_nu, _ = _optax_run(p0, grads, None)
    got_p, got_mu, got_nu, _ = _port_run(p0, grads, None)
    assert got_mu.dtype == torch.float32
    np.testing.assert_array_equal(got_mu.numpy(), want_mu)
    np.testing.assert_array_equal(got_nu, want_nu)
    np.testing.assert_allclose(got_p, want_p, rtol=2e-7, atol=0)


def test_without_mu_dtype_agrees_with_torch_adam():
    """The same algorithm as ``torch.optim.Adam`` (optax's defaults), not
    the same rounding: torch folds both bias corrections into one step size
    in double precision and moves m by ``lerp_``. At lr 1e-4 over gradients
    from 1e-6 to 10 the parameters differ by the rounding of p itself (one
    fp32 ulp: 1.2e-7 at |p| in [1, 2)) plus the updates' own rounding
    (3e-8 at most here, where the 1e-6 gradients meet eps)."""
    p0, grads = _grads(3)
    got_p, *_ = _port_run(p0, grads, None, lr=1e-4)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([p], lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    want = p.detach().numpy()
    assert (np.abs(got_p - want) <= np.spacing(np.abs(want)) + 5e-8).all()


def test_mu_dtype_names_and_the_default_optimizer():
    assert mu_dtype_of(None) is None and mu_dtype_of("bfloat16") is torch.bfloat16
    assert mu_dtype_of(torch.float16) is torch.float16
    with pytest.raises(ValueError, match="mu_dtype"):
        mu_dtype_of("int8")
    model = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    default = Trainer(model, {"title": _title()}, token_batch, TrainerConfig(), device="cpu")
    assert type(default.optimizer) is torch.optim.Adam
    bf16 = Trainer(model, {"title": _title()}, token_batch,
                   TrainerConfig(adam_mu_dtype="bfloat16"), device="cpu")
    assert type(bf16.optimizer) is Adam and bf16.optimizer.mu_dtype is torch.bfloat16
    with pytest.raises(ValueError, match="mu_dtype"):
        Trainer(model, {"title": _title()}, token_batch, TrainerConfig(adam_mu_dtype="int8"),
                device="cpu")


def test_parameters_without_a_gradient_are_skipped():
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(3))
    opt = Adam([a, b], lr=0.1, mu_dtype="bfloat16")
    a.grad = torch.ones(3)
    opt.step()
    assert torch.equal(b, torch.ones(3)) and b not in opt.state
    assert opt.state[a]["step"] == 1 and not torch.equal(a, torch.ones(3))


# ---- the Trainer against JAX ---------------------------------------------

def _title():
    tok = np.random.default_rng(1).integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    tok[0] = 0
    return tok


def _raw(seed):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(0, N_ART + 1, (BS, K)).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    return raw


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("accumulation", [1, 2])
def test_trainer_bf16_first_moment_matches_jax(accumulation):
    """Three optimizer updates (accumulation 2: of two micro-batches each)
    with a bf16 first moment from one init: parameters within 1e-5 of JAX's.
    The stored first moment is within one bf16 ulp of JAX's after the first
    update (the gradients differ by fp32 rounding, which can move a rounding
    of m by one unit); each later update adds one ulp, at the larger of the
    old and the new moment (b1 * m rounds in bf16 before the sum, which may
    cancel), to the 0.9 times the earlier difference that b1 * m carries on
    (``bound``). An absolute 1e-10
    covers the pooling biases, whose gradients cancel to ~1e-9 and are
    rounding noise in both packages (ROADMAP C)."""
    title = _title()
    cfg = dict(learning_rate=1e-4, seed=0, adam_mu_dtype="bfloat16",
               accumulation_steps=accumulation)
    jtr = JaxTrainer(JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=EMB), {"title": title},
                     jax_token_batch, JaxConfig(early_stopping_patience=None, lr_patience=None,
                                                **cfg), log_fn=lambda s: None)
    raws = [_raw(10 + i) for i in range(3 * accumulation)]
    jtr.init_state(raws[0])
    init = _tree(jtr.state.params)
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    model = load_nrms_params(NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB,
                                  device="cpu"), init)
    tr = Trainer(model, {"title": title}, token_batch, TrainerConfig(**cfg), device="cpu")
    bound, prev = None, None
    for i, raw in enumerate(raws):
        jtr.state, _ = jtr._train_step(jtr.state, jtr._put(jax_dedup.prep_dedup_batch(
            dict(raw), 512)), key)
        assert torch.isfinite(tr.train_step(dict(raw)))
        if (i + 1) % accumulation:
            continue
        inner = jtr.state.opt_state.inner_opt_state if accumulation > 1 else jtr.state.opt_state
        want_mu = nrms_state_dict(_tree(jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), inner.inner_state[0].mu)))
        top = {k: np.abs(v.numpy()) if prev is None else np.maximum(np.abs(v.numpy()),
                                                                    np.abs(prev[k].numpy()))
               for k, v in want_mu.items()}
        ulp = {k: _bf16_ulp(v) + 1e-10 for k, v in top.items()}
        bound = ulp if bound is None else {k: ulp[k] + 0.9 * bound[k] for k in ulp}
        prev = want_mu
        for k, p in model.named_parameters():
            mu = tr.optimizer.state[p]["exp_avg"]
            assert mu.dtype == torch.bfloat16, k
            assert (np.abs(mu.float().numpy() - want_mu[k].numpy()) <= bound[k]).all(), (i, k)
    want = nrms_state_dict(_tree(jtr.state.params))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        assert tr.optimizer.state[p]["step"] == 3, k


def test_bf16_first_moment_resume_is_bit_equal(tmp_path):
    """Two steps, a checkpoint, a fresh trainer restored from it, two more
    steps: bit-equal to four uninterrupted steps; the restored first moment
    is still bf16."""
    from ebnerd_tpu_torch.training import restore_checkpoint, save_checkpoint

    def make():
        model = NRMS(HParamsNRMS(**dict(HP, dropout=0.2)), vocab_size=VOCAB, word_emb_dim=EMB,
                     use_fused_encoder=True, device="cpu")
        return Trainer(model, {"title": _title()}, token_batch,
                       TrainerConfig(learning_rate=1e-3, seed=3, adam_mu_dtype="bfloat16"),
                       device="cpu")

    raws = [_raw(30 + i) for i in range(4)]
    whole = make()
    for raw in raws:
        whole.train_step(dict(raw))
    cut = make()
    for raw in raws[:2]:
        cut.train_step(dict(raw))
    save_checkpoint(cut, tmp_path, step=2)
    resumed = make()
    resumed.load_state_dict(restore_checkpoint(resumed, tmp_path, step=2))
    for p in resumed.model.parameters():
        assert resumed.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16
    for raw in raws[2:]:
        resumed.train_step(dict(raw))
    for (k, a), b in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), k
        sa, sb = whole.optimizer.state[a], resumed.optimizer.state[b]
        assert sa["step"] == sb["step"] == 4
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(sa["exp_avg_sq"],
                                                                         sb["exp_avg_sq"])


def test_sparse_mode_keeps_the_table_moments_fp32():
    """Under the sparse mode the word table's moments stay fp32 whatever
    adam_mu_dtype is (JAX's ``SparseEmbedState``); the other parameters'
    first moments take mu_dtype."""
    model = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    tr = Trainer(model, {"title": _title()}, token_batch,
                 TrainerConfig(sparse_embedding=True, sparse_min_bucket=8,
                               adam_mu_dtype="bfloat16"), device="cpu")
    tr.train_step(_raw(40))
    assert tr._emb_m.dtype == torch.float32 and tr._emb_m.abs().sum() > 0
    assert all(tr.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16
               for p in model.parameters() if p is not tr._emb_table)
    assert tr._emb_table not in tr.optimizer.state
