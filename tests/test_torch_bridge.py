"""The bridge in both directions, every variant of the six families at narrow
widths: JAX -> port -> JAX and port -> JAX -> port bit for bit (the tree's
structure, every leaf's dtype, shape and bits, with ``batch_stats`` where
there is one), the exported tree against the one JAX's ``init`` gives, a
port model trained three Trainer steps scored by JAX's ``apply`` as by its
own forward (exported from the trainer's state and from a checkpoint on
disk), and a block of a row-sharded word table refused."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.models import config as jc
from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu.models.fastformer import Fastformer as JaxFastformer
from ebnerd_tpu.models.fastformer import FastformerWu as JaxWu
from ebnerd_tpu.models.newsrec import LSTUR as JaxLSTUR
from ebnerd_tpu.models.newsrec import NAML as JaxNAML
from ebnerd_tpu.models.newsrec import NPA as JaxNPA
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.models.newsrec import NRMSDocVec as JaxDocVec
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch.models import (LSTUR, NAML, NPA, NRMS, Fastformer, FastformerWu,
                                     HParamsFastformer, HParamsLSTUR, HParamsNAML, HParamsNPA,
                                     HParamsNRMS, HParamsNRMSDocVec, NRMSDocVec, builder_for)
from ebnerd_tpu_torch.training import Trainer, TrainerConfig
from ebnerd_tpu_torch.training.checkpoint import save_checkpoint

torch.set_num_threads(1)

BS, H, K, T, TB, DV, VOCAB, EMB, N_ART, N_USERS = 8, 5, 4, 6, 7, 12, 60, 16, 30, 9
ATOL = 3e-5  # the forward tolerance of tests/ops/test_news_encoder.py
ATT = dict(title_size=T, history_size=H, head_num=2, head_dim=4, attention_hidden_dim=6,
           dropout=0.0)
CONV = dict(title_size=T, history_size=H, attention_hidden_dim=8, filter_num=12, dropout=0.0)
FF = dict(n_layers=2, embedding_dim=16, n_heads=2, intermediate_dim=12, max_position=32,
          title_size=T, history_size=H, dropout=0.0)
WORDS = dict(vocab_size=VOCAB, word_emb_dim=EMB)

# name: (JAX module, port module, builder, port -> JAX, JAX -> port)
VARIANTS = {
    "nrms": (lambda: JaxNRMS(jc.HParamsNRMS(**ATT), **WORDS),
             lambda: NRMS(HParamsNRMS(**ATT), **WORDS, device="cpu"), "nrms",
             bridge.nrms_params, bridge.nrms_state_dict),
    "nrms_dense": (
        lambda: JaxNRMS(jc.HParamsNRMS(**ATT, newsencoder_units_per_layer=(12, 8)), **WORDS),
        lambda: NRMS(HParamsNRMS(**ATT, newsencoder_units_per_layer=(12, 8)), **WORDS,
                     device="cpu"), "nrms", bridge.nrms_params, bridge.nrms_state_dict),
    "nrms_docvec": (
        lambda: JaxDocVec(jc.HParamsNRMSDocVec(**dict(ATT, title_size=DV),
                                               newsencoder_units_per_layer=(9, 7))),
        lambda: NRMSDocVec(HParamsNRMSDocVec(**dict(ATT, title_size=DV),
                                             newsencoder_units_per_layer=(9, 7)), device="cpu"),
        "nrms_docvec", bridge.nrms_docvec_params, bridge.nrms_docvec_state_dict),
    **{f"lstur_{kind}": (
        (lambda kind=kind: JaxLSTUR(jc.HParamsLSTUR(**CONV, n_users=N_USERS, gru_unit=12,
                                                    type=kind), **WORDS)),
        (lambda kind=kind: LSTUR(HParamsLSTUR(**CONV, n_users=N_USERS, gru_unit=12, type=kind),
                                 **WORDS, device="cpu")),
        "lstur", bridge.lstur_params, bridge.lstur_state_dict) for kind in ("ini", "con")},
    "npa": (lambda: JaxNPA(jc.HParamsNPA(**CONV, user_emb_dim=10, n_users=N_USERS), **WORDS),
            lambda: NPA(HParamsNPA(**CONV, user_emb_dim=10, n_users=N_USERS), **WORDS,
                        device="cpu"), "npa", bridge.npa_params, bridge.npa_state_dict),
    "naml": (lambda: JaxNAML(jc.HParamsNAML(**CONV, body_size=TB, vert_num=5, subvert_num=6),
                             **WORDS),
             lambda: NAML(HParamsNAML(**CONV, body_size=TB, vert_num=5, subvert_num=6), **WORDS,
                          device="cpu"), "naml", bridge.naml_params, bridge.naml_state_dict),
    "fastformer": (lambda: JaxFastformer(jc.HParamsFastformer(**FF), **WORDS),
                   lambda: Fastformer(HParamsFastformer(**FF), **WORDS, device="cpu"),
                   "fastformer", bridge.fastformer_params, bridge.fastformer_state_dict),
    "fastformer_wu": (lambda: JaxWu(jc.HParamsFastformer(**FF), vocab_size=VOCAB),
                      lambda: FastformerWu(HParamsFastformer(**FF), vocab_size=VOCAB,
                                           device="cpu"),
                      None, bridge.fastformer_params, bridge.fastformer_state_dict),
}
TRAINED = ["nrms", "nrms_docvec", "lstur_ini", "npa", "naml", "fastformer"]


def _tables():
    rng = np.random.default_rng(1)
    title = rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)
    body = rng.integers(1, VOCAB, (N_ART + 1, TB)).astype(np.int32)
    title[0] = body[0] = 0
    title[5, 2:] = 0
    docvec = rng.standard_normal((N_ART + 1, DV)).astype(np.float32)
    docvec[0] = 0.0
    return {"title": title, "body": body, "docvec": docvec,
            "cat": rng.integers(0, 5, N_ART + 1).astype(np.int32),
            "subcat": rng.integers(0, 6, N_ART + 1).astype(np.int32)}


def _raw(seed):
    rng = np.random.default_rng(seed)
    raw = {"hist_idx": rng.integers(0, N_ART + 1, (BS, H)).astype(np.int32),
           "cand_idx": rng.integers(1, N_ART + 1, (BS, K)).astype(np.int32),
           "user_idx": rng.integers(0, N_USERS + 1, BS).astype(np.int32),
           "labels": np.zeros((BS, K), np.float32)}
    raw["hist_idx"][0, 2:] = 0
    raw["labels"][np.arange(BS), rng.integers(0, K, BS)] = 1.0
    return raw


def _jax_batch(builder, raw):
    tables = {k: jnp.asarray(v) for k, v in _tables().items()}
    return jax_inputs.builder_for(builder)(tables, {k: jnp.asarray(v) for k, v in raw.items()})


def _port_batch(builder, raw):
    tables = {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
              for k, v in _tables().items()}
    return builder_for(builder)(tables, raw)


def _wu_ids():
    ids = np.random.default_rng(9).integers(1, VOCAB, (6, T)).astype(np.int32)
    ids[0, 3:] = 0
    return ids


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


_INIT = {}


def _jax_variables(name):
    """JAX ``init``'s variables, every leaf drawn anew from a seed (biases,
    BN statistics and zero-initialised tables included)."""
    if name not in _INIT:
        jmodel, _, builder, _, _ = VARIANTS[name]
        arg = jnp.asarray(_wu_ids()) if builder is None else _jax_batch(builder, _raw(7))
        variables = _tree(jmodel().init(jax.random.PRNGKey(0), arg))
        rng = np.random.default_rng(3)
        drawn = jax.tree_util.tree_map(
            lambda v: (rng.standard_normal(v.shape) * 0.3).astype(np.float32), variables)
        if "batch_stats" in drawn:  # variances stay positive
            drawn["batch_stats"] = jax.tree_util.tree_map(lambda v: np.abs(v) + 0.5,
                                                          drawn["batch_stats"])
        _INIT[name] = drawn
    return _INIT[name]


def _args(variables):
    """The arguments of a family's ``*_state_dict``: ``(params,)`` or
    ``(params, batch_stats)``."""
    if "batch_stats" in variables:
        return variables["params"], variables["batch_stats"]
    return (variables["params"],)


def _export(name, state):
    """port -> JAX as ``_args`` gives it, for every variant."""
    out = VARIANTS[name][3](state)
    if isinstance(out, tuple):
        return out if out[1] is not None else out[:1]
    return (out,)


def _same_trees(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32 == w.dtype, path
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=str(path))


def _same_states(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, k
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), k


@pytest.mark.parametrize("name", list(VARIANTS))
def test_jax_to_port_to_jax_is_bit_exact(name):
    variables = _jax_variables(name)
    model = VARIANTS[name][1]()
    model.load_state_dict(VARIANTS[name][4](*_args(variables)), strict=True)
    back = _export(name, model.state_dict())
    want = _args(variables)
    assert len(back) == len(want)
    for g, w in zip(back, want):
        _same_trees(g, w)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_port_to_jax_to_port_is_bit_exact_and_gives_the_init_tree(name):
    """A port model's own weights (every tensor drawn anew) leave as JAX's
    ``init`` tree, with its nesting, names, shapes and dtype, and come back
    bit for bit; the export shares no memory with the model."""
    torch.manual_seed(5)
    model = VARIANTS[name][1]()
    with torch.no_grad():
        for k, t in model.state_dict().items():
            t.copy_(torch.rand_like(t) + 0.5 if k.endswith(".var") else torch.randn_like(t))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    exported = _export(name, model)
    init = _args(_jax_variables(name))
    assert len(exported) == len(init)
    for e, i in zip(exported, init):
        assert jax.tree_util.tree_structure(e) == jax.tree_util.tree_structure(i)
        for a, b in zip(jax.tree_util.tree_leaves(e), jax.tree_util.tree_leaves(i)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    back = VARIANTS[name][4](*exported)
    _same_states(back, state)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(1.0)
    _same_states(VARIANTS[name][4](*exported), state)


def _train_three_steps(name):
    _, port_model, builder, _, _ = VARIANTS[name]
    torch.manual_seed(11)
    model = port_model()
    tr = Trainer(model, _tables(), builder_for(builder),
                 TrainerConfig(learning_rate=1e-2, seed=0), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(3):
        assert torch.isfinite(tr.train_step(_raw(20 + i)))
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert "word_embedding.embedding" in moved or name == "nrms_docvec"
    assert len(moved) > len(before) // 2
    return tr


@pytest.mark.parametrize("source", ["trainer_state", "checkpoint"])
@pytest.mark.parametrize("name", TRAINED)
def test_jax_apply_scores_a_trained_port_model_as_the_port_does(name, source, tmp_path):
    """Three fp32 Trainer steps at dropout 0, then JAX's ``apply`` on the
    exported tree (eval mode: BN by its running statistics) gives the
    port's eval logits within 3e-5."""
    tr = _train_three_steps(name)
    if source == "trainer_state":
        state = tr.state_dict()["model"]
    else:
        path = save_checkpoint(tr, tmp_path, step=3)
        state = torch.load(path / "state.pt", weights_only=True)["model"]
    jmodel, _, builder, _, _ = VARIANTS[name]
    exported = _export(name, state)
    variables = {"params": exported[0]}
    if len(exported) == 2:
        variables["batch_stats"] = exported[1]
    raw = _raw(40)
    ref = np.asarray(jmodel().apply(variables, _jax_batch(builder, raw), False))
    tr.model.eval()
    with torch.no_grad():
        got = tr.model(_port_batch(builder, raw)).numpy()
    assert got.shape == ref.shape == (BS, K)
    assert np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["nrms", "lstur_con", "npa", "naml", "fastformer"])
def test_a_block_of_a_row_sharded_word_table_raises(name):
    """A model whose word table keeps a block of its rows (``WordEmbed.shard_``)
    exports only whole: its own ``state_dict`` raises naming the whole shape,
    passed as the model or with ``vocab_size``."""
    model = VARIANTS[name][1]()
    model.word_embedding.shard_(types.SimpleNamespace(rows=lambda n: slice(n // 2, n)))
    whole = f"\\[{VOCAB}, {EMB}\\]"
    with pytest.raises(ValueError, match=whole):
        VARIANTS[name][3](model)
    with pytest.raises(ValueError, match=whole):
        VARIANTS[name][3](model.state_dict(), vocab_size=VOCAB)
