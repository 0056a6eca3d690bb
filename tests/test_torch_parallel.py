"""The port's data-parallel training (``ebnerd_tpu_torch/parallel``,
``Trainer(mesh=...)``) against the JAX package's mesh helpers and against
one process: two CPU processes joined by gloo train, score, checkpoint and
resume as one process does (``tools/dryrun_multihost.py``, the counterpart
of ``tests/parallel/test_multihost.py``); the row-sparse mode and
NRMSDocVec's BN moments under two processes equal one process's
(``tests/torch_parallel_worker.py``). Each multi-process test runs under
its own timeout."""
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ebnerd_tpu.parallel import distributed as jax_dist
from ebnerd_tpu.parallel import mesh as jax_mesh
from ebnerd_tpu_torch.models.config import HParamsNRMS
from ebnerd_tpu_torch.models.inputs import token_batch
from ebnerd_tpu_torch.models.newsrec import NRMS
from ebnerd_tpu_torch.parallel import distributed as dist
from ebnerd_tpu_torch.parallel import mesh as port_mesh
from ebnerd_tpu_torch.training.trainer import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
TIMEOUT = 240


@pytest.mark.parametrize("n_rows", [1, 7, 8, 103, 16384])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_host_shard_rows_matches_jax(n_rows, count):
    for pi in range(count):
        assert (port_mesh.host_shard_rows(n_rows, pi, count)
                == jax_mesh.host_shard_rows(n_rows, pi, count))


@pytest.mark.parametrize("data", [1, 2, 3])
def test_shard_batch_keeps_the_rows_jax_assigns(data):
    """Each process's ``shard_batch`` rows are the rows JAX's multi-process
    ``shard_batch`` feeds that process (``host_shard_rows``); scalars pass."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((11, 3)).astype(np.float32),
             "y": np.arange(11, dtype=np.int32), "n": 7}
    for rank in range(data):
        out = port_mesh.shard_batch(batch, port_mesh.Mesh(data=data, rank=rank))
        rows = jax_mesh.host_shard_rows(11, rank, data)
        np.testing.assert_array_equal(out["x"], batch["x"][rows])
        np.testing.assert_array_equal(out["y"], batch["y"][rows])
        assert out["n"] == 7


def test_single_process_helpers_match_jax():
    """No process group: one process, every row, and the same info keys."""
    assert dist.local_device_slice(10) == jax_dist.local_device_slice(10) == slice(0, 10)
    assert not dist.is_distributed() and not jax_dist.is_distributed()
    info, jinfo = dist.process_info(), jax_dist.process_info()
    assert set(jinfo) <= set(info)  # one device per process: the device counts differ
    assert (info["process_index"], info["process_count"]) == (jinfo["process_index"],
                                                              jinfo["process_count"])
    assert info["local_devices"] == info["global_devices"] == 1
    mesh = port_mesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")
    assert not mesh.active
    t = torch.arange(4.0)
    port_mesh.all_reduce_sum_([t], mesh)  # the identity without a group
    assert torch.equal(t, torch.arange(4.0))
    with pytest.raises(ValueError, match="processes"):
        port_mesh.make_mesh(data=2)
    np.testing.assert_array_equal(port_mesh.put_replicated(np.arange(3), mesh, device="cpu").numpy(),
                                  np.arange(3))
    assert port_mesh.replicated(mesh).rows(5) == slice(0, 5)


def test_put_replicated_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """JAX places the array on the mesh's accelerators; the port's default
    is the card, so without one it raises ``resolve_device``'s error
    rather than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_mesh.put_replicated(np.arange(3), port_mesh.make_mesh())


def test_initialize_is_a_no_op_without_a_job_and_raises_on_half_a_job(monkeypatch):
    monkeypatch.delenv("EBNERD_COORDINATOR", raising=False)
    dist.initialize()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="process_id"):
        dist.initialize("localhost:1", num_processes=2)
    monkeypatch.setenv("EBNERD_COORDINATOR", "localhost:1")  # read as JAX reads it
    with pytest.raises(ValueError, match="process_id"):
        dist.initialize(num_processes=2)
    assert not torch.distributed.is_initialized()


def _tiny_trainer(**kw):
    hp = HParamsNRMS(title_size=6, history_size=4, head_num=2, head_dim=4,
                     attention_hidden_dim=8)
    model = NRMS(hp, vocab_size=64, word_emb_dim=8, device="cpu")
    table = np.random.default_rng(0).integers(1, 64, (20, 6)).astype(np.int32)
    cfg = kw.pop("config", TrainerConfig())
    return Trainer(model, {"title": table}, token_batch, cfg, device="cpu",
                   log_fn=lambda s: None, **kw)


def test_a_model_axis_of_one_leaves_the_data_axis_as_it_was():
    """``make_mesh(model=1)`` is the data-axis mesh: no subgroups, ranks on
    the data axis, the batch split by rank, a table sharding of every row;
    and the model-axis specs on such a mesh shard nothing: three steps
    bit-equal to the trainer without them."""
    mesh = port_mesh.make_mesh(model=1)
    assert mesh == port_mesh.make_mesh() == port_mesh.Mesh(data=1, model=1, rank=0)
    assert mesh.group("data") is None and mesh.group("model") is None
    for rank in range(3):
        m = port_mesh.Mesh(data=3, rank=rank)
        assert (m.data_index, m.model_index) == (rank, 0)
        assert port_mesh.data_sharding(m).rows(11) == port_mesh.host_shard_rows(11, rank, 3)
        assert port_mesh.table_sharding(m).rows(11) == slice(0, 11)
    rng = np.random.default_rng(1)
    batches = [{"hist_idx": rng.integers(0, 20, (6, 4)).astype(np.int32),
                "cand_idx": rng.integers(0, 20, (6, 3)).astype(np.int32),
                "labels": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]}
               for _ in range(3)]
    a = _tiny_trainer(mesh=mesh)
    b = _tiny_trainer(mesh=mesh, table_specs={"title": "model"},
                      param_specs={"word_embedding": "model"})
    assert isinstance(b.tables["title"], torch.Tensor) and not b._sharded
    la = [a.train_step(dict(x)) for x in batches]
    lb = [b.train_step(dict(x)) for x in batches]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name


def test_scan_steps_over_processes_take_the_per_step_path():
    """As JAX's ``use_scan = n_scan > 1 and jax.process_count() == 1``: a
    mesh of one process groups the steps (its trainer takes the scan path),
    a mesh over several runs each step on its own and refuses a group."""
    one = _tiny_trainer(mesh=port_mesh.make_mesh(), config=TrainerConfig(scan_steps=2))
    assert one._scan
    two = _tiny_trainer(mesh=port_mesh.Mesh(data=2, rank=0), config=TrainerConfig(scan_steps=2))
    assert not two._scan
    with pytest.raises(ValueError, match="one process only"):
        two.run_group(two.pack_group([{"hist_idx": np.zeros((4, 4), np.int32),
                                       "cand_idx": np.ones((4, 3), np.int32),
                                       "labels": np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]}] * 2))


def test_mesh_of_one_process_equals_no_mesh():
    """A one-process mesh takes every row, weights nothing and reduces
    nothing: three steps bit-equal to the trainer without a mesh."""
    rng = np.random.default_rng(1)
    batches = [{"hist_idx": rng.integers(0, 20, (6, 4)).astype(np.int32),
                "cand_idx": rng.integers(0, 20, (6, 3)).astype(np.int32),
                "labels": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]}
               for _ in range(3)]
    a, b = _tiny_trainer(), _tiny_trainer(mesh=port_mesh.make_mesh())
    la = [a.train_step(dict(x)) for x in batches]
    lb = [b.train_step(dict(x)) for x in batches]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_case(case: str, tmp_path: Path, world: int) -> dict:
    out = tmp_path / f"{case}_{world}.npz"
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(r), str(world), str(port),
                               str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("case", ["sparse", "bn_slot", "bn_dedup"])
def test_two_processes_equal_one(case, tmp_path):
    """Three steps on a (data=2) mesh over gloo against one process: the
    losses, every parameter and buffer (BN running stats among them) and,
    in the sparse mode, the word table's moments. ``bn_slot`` splits a
    batch of 7 rows unevenly (4 and 3) and accumulates 2 micro-batches; its
    BN moments are summed over the processes."""
    one, two = _run_case(case, tmp_path, 1), _run_case(case, tmp_path, 2)
    assert set(one) == set(two)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5, atol=1e-6)
    # the word table and its moments to JAX's test_sparse_dp_mesh_matches_single_device's
    # 1e-5; every other tensor to 1e-4, a hundredth of one Adam step at lr 1e-2: splitting
    # the batch changes the order of each gradient's sum, and Adam scales a gradient that
    # is only rounding noise (the user pool's bias shifts every history score alike, so its
    # gradient cancels) up to a step of up to lr
    tight = ("p:word_embedding.embedding", "emb_m", "emb_v")
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-5 if k in tight else 1e-4,
                                   err_msg=k)
    if case.startswith("bn"):  # the running stats moved, and moved alike
        stats = [k for k in one if k.startswith("b:") and k.endswith((".mean", ".var"))]
        assert stats and any(np.abs(one[k]).max() > 0 for k in stats if k.endswith(".mean"))


def test_scan_steps_over_two_processes_equal_per_step(tmp_path):
    """``fit`` with scan_steps=2 on a (data=2) mesh over gloo runs every step
    on its own, as JAX over several processes: 6 steps with dropout 0.2,
    bit-equal to scan_steps=1 on the same mesh (losses, parameters,
    buffers)."""
    one, two = _run_case("scan1", tmp_path, 2), _run_case("scan2", tmp_path, 2)
    assert set(one) == set(two)
    for k in one:
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)


def test_dryrun_multihost_two_processes_match_one():
    proc = subprocess.run([sys.executable, "-m", "ebnerd_tpu_torch.tools.dryrun_multihost",
                           "--device", "cpu"], capture_output=True, text=True, timeout=TIMEOUT,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "[dryrun_multihost] ok" in proc.stdout
    assert "losses match" in proc.stdout
