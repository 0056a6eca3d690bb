"""The port's training bench makes the same data as the repo's bench.py
(Zipf token table and article draws from the same seeds) and counts the
same FLOPs; it refuses the options it does not port, and refuses to run
without a card."""
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
    monkeypatch.setenv("BENCH_SPARSE", "1")
    with pytest.raises(NotImplementedError, match="A12"):
        bench.main()
    monkeypatch.setenv("BENCH_SPARSE", "0")
    monkeypatch.setenv("BENCH_MU_DTYPE", "bfloat16")
    with pytest.raises(NotImplementedError, match="A3"):
        bench.main()
    monkeypatch.delenv("BENCH_MU_DTYPE")
    if not torch.cuda.is_available():
        assert bench.main() == 2
        assert "needs a CUDA card" in capsys.readouterr().err
