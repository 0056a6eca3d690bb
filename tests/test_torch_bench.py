"""The port's training bench makes the same data as the repo's bench.py
(Zipf token table and article draws from the same seeds) and counts the
same FLOPs; it parses the optimizer knobs, pads the sparse mode's steps to
one row bucket, and refuses to run without a card."""
import numpy as np
import pytest
import torch

import bench as jax_bench
from ebnerd_tpu_torch import bench

torch.set_num_threads(1)


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
def test_batches_equal_bench_py(dist):
    ours = bench.batches(2, 2, 64, bench.N_ARTICLES + 1, dist)
    ref = jax_bench._batches(2, 2, 64, jax_bench.N_ARTICLES + 1, dist)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert ours[k].dtype == ref[k].dtype


def test_token_table_equals_bench_py():
    np.testing.assert_array_equal(bench.token_table(np.random.default_rng(0), "zipf"),
                                  jax_bench._token_table(np.random.default_rng(0), "zipf"))


def test_flops_formula_equals_bench_py():
    assert bench.flops_per_impression(1.0, False) == jax_bench.model_flops_per_impression()
    frac = 0.055
    k = jax_bench.NPRATIO + 1
    slots = jax_bench.HISTORY + k
    want = 3.0 * (frac * slots * jax_bench._article_flops() + jax_bench._user_flops() + k * 400 * 2)
    assert bench.flops_per_impression(frac, True) == pytest.approx(want, rel=1e-12)


def test_bf16_peak_by_part():
    assert bench.bf16_peak("NVIDIA H100 80GB HBM3") == ("SXM", 989e12)
    assert bench.bf16_peak("NVIDIA H100 PCIe")[0] == "PCIe"
    assert bench.bf16_peak("NVIDIA H100 NVL")[0] == "NVL"


def test_unported_knobs_raise_and_no_card_refuses(monkeypatch, capsys):
    """BENCH_SPARSE and BENCH_MU_DTYPE (ported now) parse; a dtype the
    hand-written Adam does not take raises; without a card the bench refuses
    whatever the knobs."""
    assert bench.optimizer_knobs({}) == (False, None)
    assert bench.optimizer_knobs({"BENCH_SPARSE": "1", "BENCH_MU_DTYPE": "bfloat16"}) == (
        True, "bfloat16")
    assert bench.optimizer_knobs({"BENCH_SPARSE": "0", "BENCH_MU_DTYPE": ""}) == (False, None)
    with pytest.raises(ValueError, match="mu_dtype"):
        bench.optimizer_knobs({"BENCH_MU_DTYPE": "int8"})
    monkeypatch.setenv("BENCH_SPARSE", "1")
    monkeypatch.setenv("BENCH_MU_DTYPE", "bfloat16")
    if not torch.cuda.is_available():
        assert bench.main() == 2
        assert "needs a CUDA card" in capsys.readouterr().err


def test_user_rows_leave_the_article_draws_alone():
    """LSTUR's batches add user rows in [0, n_users) after the article draws,
    so LSTUR and NAML (and NRMS) see the same articles from one seed."""
    plain = bench.batches(3, 2, 64, bench.N_ARTICLES + 1)
    users = bench.batches(3, 2, 64, bench.N_ARTICLES + 1, n_users=bench.N_USERS)
    for k in plain:
        np.testing.assert_array_equal(users[k], plain[k], err_msg=k)
    assert users["user_idx"].shape == (2, 64) and users["user_idx"].dtype == np.int32
    assert 0 <= users["user_idx"].min() and users["user_idx"].max() < bench.N_USERS


def test_body_table_and_unknown_family(monkeypatch):
    body = bench.token_table(np.random.default_rng(0), "uniform", bench.BODY)
    assert body.shape == (bench.N_ARTICLES + 1, bench.BODY)
    monkeypatch.setenv("BENCH_MODEL", "fastformerwu")
    with pytest.raises(ValueError, match="BENCH_MODEL"):
        bench.main()


@pytest.mark.parametrize("name", ["npa", "fastformer", "nrms_docvec"])
def test_new_families_are_bench_models(monkeypatch, capsys, name):
    """BENCH_MODEL takes every family; without a card main() refuses after
    the name is accepted."""
    assert name in bench.FAMILIES
    monkeypatch.setenv("BENCH_MODEL", name)
    if not torch.cuda.is_available():
        assert bench.main() == 2
        assert "needs a CUDA card" in capsys.readouterr().err


def test_nrms_docvec_family_reads_a_float_docvec_table():
    from ebnerd_tpu_torch.models import HParamsNRMSDocVec, NRMSDocVec, docvec_batch

    model, tables, builder, n_users = bench.make_family("nrms_docvec", torch.float32, 0.2,
                                                        device="cpu")
    assert isinstance(model, NRMSDocVec) and model.hparams == HParamsNRMSDocVec(dropout=0.2)
    assert builder is docvec_batch and n_users == 0 and list(tables) == ["docvec"]
    assert tables["docvec"].shape == (bench.N_ARTICLES + 1, bench.DOCVEC)
    assert tables["docvec"].dtype == np.float32
    with pytest.raises(ValueError, match="BENCH_MODEL"):
        bench.make_family("fastformerwu", torch.float32, 0.2, device="cpu")
