"""Port NRMS, loaded with a JAX params tree through the bridge, gives the
JAX NRMS's logits on the same per-slot batch: fused and unfused, fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.models.config import HParamsNRMS as JaxHP
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu_torch.bridge import load_nrms_params, nrms_state_dict
from ebnerd_tpu_torch.models import NRMS, HParamsNRMS
from ebnerd_tpu_torch.ops.news_encoder import pack_qkv

torch.set_num_threads(1)

B, H, K, T, VOCAB, EMB = 3, 5, 4, 8, 150, 32
HP = dict(title_size=T, history_size=H, head_num=4, head_dim=8, attention_hidden_dim=16)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, VOCAB, (B, H, T)).astype(np.int32)
    hist[0, :2] = 0  # padded history slots: all-zero titles
    cand = rng.integers(1, VOCAB, (B, K, T)).astype(np.int32)
    batch = {"hist_tokens": hist, "cand_tokens": cand}
    jmodel = JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=EMB)
    params = jmodel.init(jax.random.PRNGKey(0),
                         {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    # non-zero pooling bias so its transpose/bias mapping is exercised
    for tower in ("news_pool", "user_pool"):
        params[tower]["b"] = rng.standard_normal(params[tower]["b"].shape).astype(np.float32) * 0.1
    return batch, params


def _jax_logits(batch, params, fused):
    kw = dict(use_fused_encoder=True, fused_interpret=True) if fused else {}
    m = JaxNRMS(JaxHP(**HP), vocab_size=VOCAB, word_emb_dim=EMB, **kw)
    return np.asarray(m.apply({"params": params},
                              {k: jnp.asarray(v) for k, v in batch.items()}, False))


def _port(params, fused):
    m = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB,
             use_fused_encoder=fused, device="cpu")
    return load_nrms_params(m, params)


@pytest.mark.parametrize("port_fused", [False, True])
@pytest.mark.parametrize("jax_fused", [False, True])
def test_logits_match_jax(case, port_fused, jax_fused):
    batch, params = case
    ref = _jax_logits(batch, params, jax_fused)
    model = _port(params, port_fused)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert out.shape == (B, K)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_bridge_is_strict_and_transposes(case):
    _, params = case
    sd = nrms_state_dict(params)
    np.testing.assert_array_equal(sd["news_self_att.WQ.weight"].numpy(),
                                  params["news_self_att"]["WQ"].T)
    np.testing.assert_array_equal(sd["user_pool.q.weight"].numpy(),
                                  params["user_pool"]["q"].T)
    bad = dict(params, news_pool=dict(params["news_pool"], W=params["news_pool"]["W"].T))
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_nrms_params(_port(params, True), bad)


def test_packed_weights_kept_until_a_parameter_changes(case):
    """Each tower's weights are packed for the kernel once, and again after
    a parameter changes in place (as loading weights does)."""
    _, params = case
    model = _port(params, True)
    news = model.packed_weights("news", torch.float32)
    assert model.packed_weights("news", torch.float32) is news
    assert model.packed_weights("user", torch.float32) is not news
    wqkv, _ = pack_qkv(*model._tower_weights("news")[:3], HP["head_num"], torch.float32)
    torch.testing.assert_close(news.wqkv, wqkv, rtol=0, atol=0)
    with torch.no_grad():
        model.news_pool.W.bias.add_(1.0)
    again = model.packed_weights("news", torch.float32)
    assert again is not news
    np.testing.assert_allclose(again.b_att.numpy(), params["news_pool"]["b"] + 1.0, rtol=1e-6)
    assert model.packed_weights("news", torch.bfloat16).wqkv.dtype == torch.bfloat16


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB)


def test_unported_paths_raise():
    """The fused kernel takes no dense stack (the unfused model does, see
    tests/test_torch_docvec.py); the dedup batch gives the per-slot logits."""
    with pytest.raises(ValueError, match="dense stack"):
        NRMS(HParamsNRMS(**HP, newsencoder_units_per_layer=(8,)), vocab_size=VOCAB,
             word_emb_dim=EMB, device="cpu", use_fused_encoder=True)
    NRMS(HParamsNRMS(**HP, newsencoder_units_per_layer=(8,)), vocab_size=VOCAB,
         word_emb_dim=EMB, device="cpu")
    with pytest.raises(ValueError, match="transposed_self_att"):
        NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu",
             use_fused_encoder=True, transposed_self_att=True)
    m = NRMS(HParamsNRMS(**HP), vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
    tokens = torch.randint(1, VOCAB, (3, T), generator=torch.Generator().manual_seed(0))
    slots = {"hist_slot": torch.tensor([[0, 1, 2, 0, 1]]), "cand_slot": torch.tensor([[2, 1, 0, 0]])}
    with torch.no_grad():
        ded = m(dict(slots, uniq_tokens=tokens, art_n_uniq=3))
        per_slot = m({"hist_tokens": tokens[slots["hist_slot"]],
                      "cand_tokens": tokens[slots["cand_slot"]]})
    torch.testing.assert_close(ded, per_slot, rtol=0, atol=1e-6)


H50 = dict(HP, history_size=50)


def test_fused_nrms_at_history_50_matches_jax():
    """NRMS with the fused encoder at history 50 (the user tower's kernels
    at T 50, the wide instance on the card), bridged weights: the port's
    logits and every parameter's gradient under sum(logits * c) equal the
    JAX fused NRMS's, its kernels run in interpret mode (logits to 1e-5,
    gradients to 5e-5)."""
    rng = np.random.default_rng(5)
    hist = rng.integers(0, VOCAB, (B, 50, T)).astype(np.int32)
    hist[0, :7] = 0  # padded history slots
    cand = rng.integers(1, VOCAB, (B, K, T)).astype(np.int32)
    batch = {"hist_tokens": hist, "cand_tokens": cand}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxNRMS(JaxHP(**H50), vocab_size=VOCAB, word_emb_dim=EMB, use_fused_encoder=True,
                     fused_interpret=True)
    params = jmodel.init(jax.random.PRNGKey(1), jbatch)["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    for tower in ("news_pool", "user_pool"):
        params[tower]["b"] = rng.standard_normal(params[tower]["b"].shape).astype(np.float32) * 0.1
    c = rng.standard_normal((B, K)).astype(np.float32)
    loss = lambda p: jnp.sum(jmodel.apply({"params": p}, jbatch, False) * c)
    ref = np.asarray(jmodel.apply({"params": params}, jbatch, False))
    jgrads = nrms_state_dict(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    model = NRMS(HParamsNRMS(**H50), vocab_size=VOCAB, word_emb_dim=EMB, use_fused_encoder=True,
                 device="cpu")
    model = load_nrms_params(model, params)
    out = model({k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    (out * torch.from_numpy(c)).sum().backward()
    grads = dict(model.named_parameters())
    assert set(grads) == set(jgrads)
    for k, r in jgrads.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), r.numpy(), atol=5e-5, err_msg=k)
