"""One process of a data-parallel check for ``tests/test_torch_parallel.py``
(imports torch and the port only; not collected by pytest).

  python tests/torch_parallel_worker.py CASE RANK WORLD PORT OUT

WORLD 1 trains without a mesh (the one-process reference); WORLD > 1 joins
a gloo group on localhost:PORT and trains on a (data=WORLD, model=1) mesh.
Rank 0 writes the losses, parameters and buffers to OUT (``.npz``).

Cases (3 Adam steps each, random index batches from one seed):
  sparse      NRMS, row-sparse word table, dedup, dropout 0.2, batch 8
  bn_slot     NRMSDocVec (BN stack), per slot, dropout 0, batch 7 (uneven
              shards: 4 and 3 rows), accumulation over 2 micro-batches
  bn_dedup    NRMSDocVec, dedup (slot-count BN weights), dropout 0.2, batch 8
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ebnerd_tpu_torch.models.config import HParamsNRMS, HParamsNRMSDocVec  # noqa: E402
from ebnerd_tpu_torch.models.inputs import docvec_batch, token_batch  # noqa: E402
from ebnerd_tpu_torch.models.newsrec import NRMS, NRMSDocVec  # noqa: E402
from ebnerd_tpu_torch.parallel import distributed as dist  # noqa: E402
from ebnerd_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from ebnerd_tpu_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402

H, T, K = 4, 6, 3
VOCAB, EMB, N_ART, DV = 64, 16, 40, 16
STEPS = 3


def _batches(bs: int, n: int):
    rng = np.random.default_rng(20)
    out = []
    for _ in range(n):
        labels = np.zeros((bs, K), np.float32)
        labels[np.arange(bs), rng.integers(0, K, bs)] = 1.0
        out.append({"hist_idx": rng.integers(0, N_ART + 1, (bs, H)).astype(np.int32),
                    "cand_idx": rng.integers(0, N_ART + 1, (bs, K)).astype(np.int32),
                    "labels": labels})
    return out


def _trainer(case: str, mesh):
    rng = np.random.default_rng(6)
    if case == "sparse":
        hp = HParamsNRMS(title_size=T, history_size=H, head_num=2, head_dim=8,
                         attention_hidden_dim=16, dropout=0.2)
        model = NRMS(hp, vocab_size=VOCAB, word_emb_dim=EMB, device="cpu")
        table = {"title": rng.integers(0, VOCAB, (N_ART + 1, T)).astype(np.int32)}
        cfg = TrainerConfig(learning_rate=1e-2, seed=0, sparse_embedding=True,
                            sparse_min_bucket=8)
        return Trainer(model, table, token_batch, cfg, device="cpu", mesh=mesh,
                       log_fn=lambda s: None), 8, 1
    hp = HParamsNRMSDocVec(title_size=DV, history_size=H, head_num=2, head_dim=4,
                           attention_hidden_dim=8, newsencoder_units_per_layer=(16, 16),
                           dropout=0.0 if case == "bn_slot" else 0.2)
    model = NRMSDocVec(hp, device="cpu")
    table = {"docvec": rng.standard_normal((N_ART + 1, DV)).astype(np.float32)}
    slot = case == "bn_slot"
    cfg = TrainerConfig(learning_rate=1e-2, seed=0, dedup_articles=not slot,
                        dedup_min_bucket=8, accumulation_steps=2 if slot else 1,
                        l2_regularization=1e-4)
    return (Trainer(model, table, docvec_batch, cfg, device="cpu", mesh=mesh,
                    log_fn=lambda s: None), 7 if slot else 8, cfg.accumulation_steps)


def main(case: str, rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    mesh = None
    if world > 1:
        dist.initialize(f"localhost:{port}", world, rank, device="cpu")
        mesh = make_mesh()
    trainer, bs, accum = _trainer(case, mesh)
    losses = [float(trainer.train_step(b)) for b in _batches(bs, STEPS * accum)]
    if rank == 0:
        state = {f"p:{k}": v.detach().numpy() for k, v in trainer.model.named_parameters()}
        state.update({f"b:{k}": v.numpy() for k, v in trainer.model.named_buffers()})
        if trainer._sparse:
            state["emb_m"], state["emb_v"] = trainer._emb_m.numpy(), trainer._emb_v.numpy()
        np.savez(out, losses=np.asarray(losses), **state)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
