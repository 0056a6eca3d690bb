"""The port's model axis (``parallel/mesh.py``, ``Trainer(table_specs=,
param_specs=)``, ``WordEmbed.shard_``, whole-tensor checkpoints) against
the JAX package's ``make_mesh``, ``table_sharding`` and ``Trainer`` on the
conftest's 8 CPU devices, and against one process: gloo processes on the
CPU (``tests/torch_mesh_model_worker.py``, ``tools/dryrun_multihost.py``,
``tools/dryrun_multichip.py``), each multi-process test under its own
timeout."""
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ebnerd_tpu.models.config import HParamsNRMS as JaxHP
from ebnerd_tpu.models.inputs import token_batch as jax_token_batch
from ebnerd_tpu.models.newsrec import NRMS as JaxNRMS
from ebnerd_tpu.parallel import mesh as jax_mesh
from ebnerd_tpu.training import dedup as jax_dedup
from ebnerd_tpu.training.trainer import Trainer as JaxTrainer
from ebnerd_tpu.training.trainer import TrainerConfig as JaxConfig
from ebnerd_tpu_torch.models.config import HParamsNRMS
from ebnerd_tpu_torch.models.inputs import token_batch
from ebnerd_tpu_torch.models.layers import WordEmbed
from ebnerd_tpu_torch.models.newsrec import NRMS
from ebnerd_tpu_torch.parallel import mesh as port_mesh
from ebnerd_tpu_torch.training.trainer import Trainer, TrainerConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_model_worker as worker  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(worker.__file__)
TIMEOUT = 240


@pytest.mark.parametrize("data,model", [(None, 1), (None, 2), (4, 2), (2, 4), (1, 8), (8, 1),
                                        (3, 2), (None, 3), (2, 2)])
def test_mesh_shape_and_ranks_match_jax(data, model):
    """The shape of a mesh over 8 processes, its refusals, and each rank's
    (data_index, model_index): the place of device ``rank`` in JAX's
    ``mesh.devices``."""
    devices = jax.devices()[:8]
    try:
        jm = jax_mesh.make_mesh(data=data, model=model, devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError) as port_error:
            port_mesh.mesh_shape(8, data, model)
        assert str(port_error.value) == str(e).replace("devices", "processes")
        return
    shape = port_mesh.mesh_shape(8, data, model)
    assert shape == jm.devices.shape
    where = {d.id: tuple(int(i) for i in np.argwhere(jm.devices == d)[0])
             for d in jm.devices.flat}
    for rank in range(8):
        m = port_mesh.Mesh(*shape, rank=rank)
        assert (m.data_index, m.model_index) == where[devices[rank].id]


@pytest.mark.parametrize("shape", [(40, 6), (64, 16)])
@pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
def test_table_sharding_rows_match_jax(shape, data, model):
    jm = jax_mesh.make_mesh(data=data, model=model, devices=jax.devices()[:8])
    want = NamedSharding(jm, P("model")).devices_indices_map(shape)
    assert want == jax_mesh.table_sharding(jm).devices_indices_map(shape)
    for rank, device in enumerate(jax.devices()[:8]):
        s = port_mesh.table_sharding(port_mesh.Mesh(data, model, rank))
        assert s.rows(shape[0]) == want[device][0]
        assert s.shard_shape(shape) == (shape[0] // model,) + shape[1:]


def test_table_sharding_refuses_an_uneven_split_as_jax_does():
    jm = jax_mesh.make_mesh(data=4, model=2, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as jax_error:
        jax_mesh.table_sharding(jm).devices_indices_map((41, 6))
    with pytest.raises(ValueError) as port_error:
        port_mesh.table_sharding(port_mesh.Mesh(4, 2, 0)).shard_shape((41, 6))
    tail = str(jax_error.value).split(" implies ", 1)[1]
    assert str(port_error.value).split(" implies ", 1)[1] == tail


@pytest.mark.parametrize("rank", [0, 1])
def test_a_sharded_word_table_loads_the_whole_matrix_into_its_block(rank):
    """``load_``, ``load_state_dict`` (the bridge's path) and a block-shaped
    state each leave this process's rows; no group is needed for it."""
    sharding = port_mesh.table_sharding(port_mesh.Mesh(1, 2, rank))
    whole = torch.arange(40.0 * 3).reshape(40, 3)
    emb = WordEmbed(40, 3, torch.float32, torch.device("cpu"))
    emb.shard_(sharding)
    emb.shard_(sharding)  # once sharded, it stays so
    rows = sharding.rows(40)
    assert emb.embedding.shape == (20, 3) and rows == slice(20 * rank, 20 * rank + 20)
    emb.load_(whole.numpy())
    assert torch.equal(emb.embedding, whole[rows])
    emb.load_state_dict({"embedding": whole + 1})
    assert torch.equal(emb.embedding, whole[rows] + 1)
    emb.load_state_dict({"embedding": whole[rows] + 2})
    assert torch.equal(emb.embedding, whole[rows] + 2)
    with pytest.raises(ValueError, match="embedding shape"):
        emb.load_(whole[:30])
    with pytest.raises(ValueError, match="sharded by"):
        emb.shard_(port_mesh.table_sharding(port_mesh.Mesh(1, 2, 1 - rank)))


@pytest.mark.parametrize("name", ["news_self_att.WQ", "user_pool/W"])
def test_param_specs_naming_a_parameter_no_gather_reads_raises(name):
    model = NRMS(HParamsNRMS(**worker.HP), vocab_size=worker.VOCAB, word_emb_dim=worker.EMB,
                 device="cpu")
    with pytest.raises(ValueError, match=r"param_specs: (news_self_att\.WQ|user_pool\.W)\."
                                         r"weight is read by no gather"):
        Trainer(model, {"title": worker.title_table()}, token_batch, TrainerConfig(),
                device="cpu", param_specs={name: "model"})
    with pytest.raises(ValueError, match="only sharding is the model axis"):
        Trainer(model, {"title": worker.title_table()}, token_batch, TrainerConfig(),
                device="cpu", table_specs={"title": "data"})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(case: str, world: int, tmp_path: Path) -> None:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), case, str(r), str(world), str(port),
                               str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _load(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gather_equals_the_whole_table(world, tmp_path):
    """The word table's sharded gather against ``F.embedding`` on the whole
    table (forward bit-equal, each block's gradient the whole gradient's
    rows; fp32 and bf16: asserted in the worker), and ``ShardedTable`` on
    JAX's ``test_sharded_table_gather_matches_replicated`` case against
    JAX's sharded and replicated gathers."""
    _run("gather", world, tmp_path)
    jm = jax_mesh.make_mesh(data=4, model=2, devices=jax.devices()[:8])
    table = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    idx = np.random.default_rng(0).integers(0, 64, (32, 5)).astype(np.int32)
    gather = jax.jit(lambda t, i: t[i].sum(axis=-1))
    sharded = gather(jax.device_put(table, jax_mesh.table_sharding(jm)),
                     jax.device_put(idx, jax_mesh.data_sharding(jm)))
    replicated = gather(jax.device_put(table, jax_mesh.replicated(jm)), idx)
    got = _load(tmp_path / "gather.npz")["sums"]
    np.testing.assert_array_equal(got, np.asarray(sharded))
    np.testing.assert_array_equal(got, np.asarray(replicated))


def test_nrms_steps_on_a_2x2_mesh_match_jax(tmp_path):
    """Three NRMS steps (dedup, dropout 0) of JAX's Trainer on a (data=2,
    model=2) CPU mesh with ``title`` and ``word_embedding`` row-sharded,
    against the port on 4 processes from the bridged JAX init: losses within
    1e-5 relative."""
    jm = jax_mesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    title = worker.title_table()
    raws = worker.batches(3, bs=8, seed=11)
    jtr = JaxTrainer(JaxNRMS(JaxHP(**worker.HP, dropout=0.0), vocab_size=worker.VOCAB,
                             word_emb_dim=worker.EMB),
                     {"title": title}, jax_token_batch,
                     JaxConfig(learning_rate=1e-4, seed=0, dedup_articles=True,
                               early_stopping_patience=None, lr_patience=None),
                     mesh=jm, table_specs={"title": P("model")},
                     param_specs={"word_embedding": P("model")}, log_fn=lambda s: None)
    jtr.init_state(raws[0])
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jtr.state.params))
    key = jax.random.key(0, impl=jtr.config.rng_impl)
    want = []
    for raw in raws:
        jtr.state, loss = jtr._train_step(jtr.state, jtr._put(
            jax_dedup.prep_dedup_batch(dict(raw), 512)), key)
        want.append(float(loss))
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)
    walk("p", init)
    np.savez(tmp_path / "jax_in.npz", title=title, **flat,
             **{f"b{i}/{k}": v for i, r in enumerate(raws) for k, v in r.items()})
    _run("jax_nrms", 4, tmp_path)
    got = _load(tmp_path / "jax_nrms.npz")["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_checkpoints_move_between_one_process_and_a_2x2_mesh(tmp_path):
    """A one-process checkpoint restored on (data=2, model=2): each process
    cuts its block, and the state gathered back is the file's, bit for bit
    (asserted in the worker); its next two steps within 1e-5 of the one
    process's. The (2, 2) checkpoint restored on one process: bit-equal to
    the (2, 2) state, gathered; the next step's loss within 1e-5."""
    _run("ckpt_one", 1, tmp_path)
    _run("ckpt_mesh", 4, tmp_path)
    _run("ckpt_back", 1, tmp_path)
    one, mesh, back = (_load(tmp_path / f"ckpt_{n}.npz") for n in ("one", "mesh", "back"))
    np.testing.assert_allclose(mesh["losses"][:2], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(back["loss"], mesh["losses"][2], rtol=1e-5)
    state_keys = [k for k in mesh if k != "losses"]
    assert sorted(state_keys) == sorted(k for k in back if k != "loss")
    assert mesh["p:word_embedding.embedding"].shape == (worker.VOCAB, worker.EMB)
    for k in state_keys:
        np.testing.assert_array_equal(back[k], mesh[k], err_msg=k)


def test_sparse_mode_keeps_the_word_table_whole_and_equals_one_process(tmp_path):
    """``param_specs={"word_embedding": "model"}`` in the sparse mode: the
    table and its moments stay whole on every process (asserted in the
    worker), as JAX keeps them; three steps on (2, 2) equal one process's
    (losses 1e-5 relative; the word table and its moments 1e-5; the other
    parameters 1e-4, as ``tests/test_torch_parallel.py`` holds them)."""
    _run("sparse", 1, tmp_path)
    _run("sparse", 4, tmp_path)
    one, four = _load(tmp_path / "sparse_1.npz"), _load(tmp_path / "sparse_4.npz")
    assert one.keys() == four.keys()
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=1e-5)
    tight = ("p:word_embedding.embedding", "emb_m", "emb_v")
    for k in one:
        np.testing.assert_allclose(four[k], one[k], rtol=1e-5, atol=1e-5 if k in tight else 1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("tool", ["dryrun_multihost", "dryrun_multichip"])
def test_dryrun_tools_on_a_2x2_mesh_match_one_process(tool):
    """``tools/dryrun_multihost.py --data 2 --model 2`` (fit, score, resume
    against one process, JAX's tolerances) and ``tools/dryrun_multichip.py
    --data 2 --model 2`` (the four trainers finite, the dense NRMS trainer
    within 1e-5 of one process), both asserting in the tool."""
    proc = subprocess.run([sys.executable, "-m", f"ebnerd_tpu_torch.tools.{tool}", "--device",
                           "cpu", "--data", "2", "--model", "2"], capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert f"[{tool}] ok" in proc.stdout and "'data': 2, 'model': 2" in proc.stdout
