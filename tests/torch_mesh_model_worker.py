"""One process of a model-axis check for ``tests/test_torch_mesh_model.py``
(imports torch and the port only; not collected by pytest).

  python tests/torch_mesh_model_worker.py CASE RANK WORLD PORT DIR

WORLD 1 runs without a mesh (the one-process reference); WORLD > 1 joins a
gloo group on localhost:PORT and runs on a (data=WORLD // 2, model=2) mesh.
Inputs and outputs are files in DIR; rank 0 writes the outputs.

Cases:
  gather      the sharded gather (``WordEmbed.shard_``, fp32 and bf16)
              against the whole table, asserted here; ``ShardedTable`` on
              JAX's test_sharded_table_gather_matches_replicated case ->
              gather.npz
  jax_nrms    NRMS, dedup, dropout 0, ``title`` and ``word_embedding``
              sharded, the bridged JAX init and batches of jax_in.npz, 3
              steps -> jax_nrms.npz (losses)
  ckpt_one    NRMS, dedup, dropout 0.2: 2 steps, checkpoint "one" (step 2),
              2 more steps -> ckpt_one.npz (losses of steps 3-4)
  ckpt_mesh   a fresh trainer restores "one" (its gathered state bit-equal
              to the file's, asserted here), steps 3-4, checkpoint "mesh"
              (step 4), step 5 -> ckpt_mesh.npz (losses, gathered state)
  ckpt_back   one process restores "mesh", step 5 -> ckpt_back.npz (state
              before step 5, its loss)
  sparse      NRMS, the row-sparse word table under ``param_specs``
              (whole on every process, asserted here), ``title`` sharded,
              dropout 0.2, 3 steps -> sparse_<WORLD>.npz (losses, state)
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ebnerd_tpu_torch.bridge import load_nrms_params  # noqa: E402
from ebnerd_tpu_torch.models.config import HParamsNRMS  # noqa: E402
from ebnerd_tpu_torch.models.inputs import token_batch  # noqa: E402
from ebnerd_tpu_torch.models.layers import WordEmbed  # noqa: E402
from ebnerd_tpu_torch.models.newsrec import NRMS  # noqa: E402
from ebnerd_tpu_torch.parallel import distributed as dist  # noqa: E402
from ebnerd_tpu_torch.parallel.mesh import (ShardedTable, make_mesh,  # noqa: E402
                                            table_sharding)
from ebnerd_tpu_torch.training import restore_checkpoint, save_checkpoint  # noqa: E402
from ebnerd_tpu_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402

H, T, K = 4, 6, 3
VOCAB, EMB, N_ART = 64, 16, 40  # both even: model=2 splits them
HP = dict(title_size=T, history_size=H, head_num=2, head_dim=8, attention_hidden_dim=16)
SPECS = dict(table_specs={"title": "model"}, param_specs={"word_embedding": "model"})


def batches(n: int, bs: int = 8, seed: int = 20) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = np.zeros((bs, K), np.float32)
        labels[np.arange(bs), rng.integers(0, K, bs)] = 1.0
        out.append({"hist_idx": rng.integers(0, N_ART, (bs, H)).astype(np.int32),
                    "cand_idx": rng.integers(0, N_ART, (bs, K)).astype(np.int32),
                    "labels": labels})
    return out


def title_table() -> np.ndarray:
    return np.random.default_rng(6).integers(0, VOCAB, (N_ART, T)).astype(np.int32)


def trainer(mesh, dropout: float = 0.0, **cfg) -> Trainer:
    model = NRMS(HParamsNRMS(**HP, dropout=dropout), vocab_size=VOCAB, word_emb_dim=EMB,
                 device="cpu")
    return Trainer(model, {"title": title_table()}, token_batch,
                   TrainerConfig(learning_rate=1e-2, seed=0, dedup_min_bucket=8,
                                 sparse_min_bucket=8, **cfg),
                   device="cpu", mesh=mesh, log_fn=lambda s: None, **SPECS)


def flat_state(state: dict) -> dict:
    """Copies of the state's parameters (p:) and Adam moments (o:index:name)."""
    out = {f"p:{k}": np.array(v) for k, v in state["model"].items()}
    for i, s in state["optimizer"]["state"].items():
        out.update({f"o:{i}:{k}": np.array(v) for k, v in s.items() if k != "step"})
    return out


def assert_same_state(a: dict, b: dict) -> None:
    fa, fb = flat_state(a), flat_state(b)
    assert fa.keys() == fb.keys(), (sorted(fa), sorted(fb))
    for k in fa:
        assert fa[k].shape == fb[k].shape and np.array_equal(fa[k], fb[k]), k


def case_gather(mesh, out: Path) -> None:
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((VOCAB, EMB)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, VOCAB, (16, 5)))
    w = torch.from_numpy(rng.standard_normal((16, 5, EMB)).astype(np.float32))
    sharding = table_sharding(mesh)
    rows = sharding.rows(VOCAB)
    for dtype in (torch.float32, torch.bfloat16):
        whole = WordEmbed(VOCAB, EMB, dtype, torch.device("cpu"))
        part = WordEmbed(VOCAB, EMB, dtype, torch.device("cpu"))
        part.shard_(sharding)
        whole.load_(table)
        part.load_(table)
        assert part.embedding.shape == (VOCAB // mesh.model, EMB)
        a, b = whole(ids), part(ids)
        assert a.dtype == b.dtype == dtype and torch.equal(a, b), dtype
        (a.float() * w).sum().backward()
        (b.float() * w).sum().backward()
        assert torch.equal(part.embedding.grad, whole.embedding.grad[rows]), dtype
    # JAX's test_sharded_table_gather_matches_replicated, and an integer table
    jt = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (32, 5)).astype(np.int32))
    got = ShardedTable(torch.from_numpy(jt[sharding.rows(64)]), jt.shape, sharding)[idx].sum(-1)
    tokens = title_table()
    ints = ShardedTable(torch.from_numpy(tokens[sharding.rows(N_ART)]).long(), tokens.shape,
                        sharding)[idx.long() % N_ART]
    assert torch.equal(ints, torch.from_numpy(tokens).long()[idx.long() % N_ART])
    if mesh.rank == 0:
        np.savez(out / "gather.npz", sums=got.numpy())


def case_jax_nrms(mesh, out: Path) -> None:
    with np.load(out / "jax_in.npz") as f:
        params: dict = {}
        for key in (k for k in f.files if k.startswith("p/")):
            node = params
            *path, leaf = key.split("/")[1:]
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
        raws = [{k: f[f"b{i}/{k}"] for k in ("hist_idx", "cand_idx", "labels")}
                for i in range(3)]
        title = f["title"]
    model = NRMS(HParamsNRMS(**HP, dropout=0.0), vocab_size=VOCAB, word_emb_dim=EMB,
                 device="cpu")
    tr = Trainer(model, {"title": title}, token_batch,
                 TrainerConfig(learning_rate=1e-4, seed=0, dedup_articles=True),
                 device="cpu", mesh=mesh, log_fn=lambda s: None, **SPECS)
    load_nrms_params(tr.model, params)  # the whole JAX matrix into the sharded table
    losses = [float(tr.train_step(dict(r))) for r in raws]
    if mesh.rank == 0:
        np.savez(out / "jax_nrms.npz", losses=np.asarray(losses))


def case_ckpt(case: str, mesh, out: Path) -> None:
    tr = trainer(mesh, dropout=0.2, dedup_articles=True)
    bs = batches(5)
    writes = mesh is None or mesh.rank == 0
    if case == "ckpt_one":
        for b in bs[:2]:
            tr.train_step(dict(b))
        save_checkpoint(tr, out / "one", step=2)
        losses = [float(tr.train_step(dict(b))) for b in bs[2:4]]
        np.savez(out / "ckpt_one.npz", losses=np.asarray(losses))
    elif case == "ckpt_mesh":
        saved = restore_checkpoint(tr, out / "one", step=2)
        tr.load_state_dict(saved)
        assert tr.model.word_embedding.embedding.shape == (VOCAB // 2, EMB)
        assert_same_state(tr.state_dict(), saved)  # cut on restore, gathered again: the file's
        losses = [float(tr.train_step(dict(b))) for b in bs[2:4]]
        save_checkpoint(tr, out / "mesh", step=4)
        state = flat_state(tr.state_dict())
        losses.append(float(tr.train_step(dict(bs[4]))))
        if writes:
            np.savez(out / "ckpt_mesh.npz", losses=np.asarray(losses), **state)
    else:
        tr.load_state_dict(restore_checkpoint(tr, out / "mesh", step=4))
        state = flat_state(tr.state_dict())
        loss = float(tr.train_step(dict(bs[4])))
        np.savez(out / "ckpt_back.npz", loss=np.asarray(loss), **state)


def case_sparse(mesh, out: Path) -> None:
    tr = trainer(mesh, dropout=0.2, sparse_embedding=True)
    assert tr.model.word_embedding.embedding.shape == (VOCAB, EMB)  # whole, as in JAX
    assert tr.model.word_embedding.sharding is None and not tr._sharded
    losses = [float(tr.train_step(dict(b))) for b in batches(3)]
    if mesh is None or mesh.rank == 0:
        state = {f"p:{k}": v.detach().numpy() for k, v in tr.model.named_parameters()}
        np.savez(out / f"sparse_{1 if mesh is None else mesh.data * mesh.model}.npz",
                 losses=np.asarray(losses), emb_m=tr._emb_m.numpy(), emb_v=tr._emb_v.numpy(),
                 **state)


def main(case: str, rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    mesh = None
    if world > 1:
        dist.initialize(f"localhost:{port}", world, rank, device="cpu")
        mesh = make_mesh(model=2)
    out = Path(out)
    if case == "gather":
        case_gather(mesh, out)
    elif case == "jax_nrms":
        case_jax_nrms(mesh, out)
    elif case.startswith("ckpt"):
        case_ckpt(case, mesh, out)
    else:
        case_sparse(mesh, out)
    dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
