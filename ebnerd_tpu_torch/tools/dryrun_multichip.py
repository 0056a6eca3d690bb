"""Four trainers on a (data, model) mesh of processes (the port's counterpart
of ``__graft_entry__.dryrun_multichip``).

On ``data * model`` processes joined by ``torch.distributed`` (gloo: they
may share one card or the CPU), on the synthetic split of
``tools/dryrun_multihost.py`` (batch 2 * data, as JAX's), each trainer fits
1 epoch of 2 steps and then scores every validation impression:

  dense   NRMS, dedup, the ``title`` table and ``word_embedding``
          row-sharded over ``model``;
  sparse  NRMS with the row-sparse word table (whole on every process),
          dedup, on the data axis;
  fused   NRMS on the fused encoder (K1 and K2 on the card, their plain
          versions on the CPU), dedup;
  naml    NAML multi-view, ``title`` and ``body`` row-sharded, and
          ``word_embedding``, dedup, ``remat_encoder``, ``encode_chunks=2``,
          the seed-recompute dropout (K3 on the card).

Every trainer's losses and scores must be finite. The dense trainer also
runs in one process, and the mesh's losses and scores must agree with its
within 1e-5 (relative).

Run: python -m ebnerd_tpu_torch.tools.dryrun_multichip --device cpu
     [--data 2 --model 2]
(the default device is the card).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..data.dataloader import EvalFeed, NewsrecFeed
from ..data.behaviors import create_binary_labels_column
from ..models.config import HParamsNAML, HParamsNRMS
from ..models.inputs import naml_batch, token_batch
from ..models.newsrec import NAML, NRMS
from ..training.trainer import Trainer, TrainerConfig
from .dryrun_multihost import H, T, VOCAB, free_port, join, launch, tiny_split

EPOCHS, STEPS = 1, 2
SHARDED = {"title": "model"}
WORDS = {"word_embedding": "model"}


def _trainers(dev, mesh, lookup, rng, which):
    """(name, trainer) of each of the four trainers in ``which``."""
    cfg = dict(learning_rate=1e-3, early_stopping_patience=None, lr_patience=None, seed=0)

    def nrms(**kw):
        hp = HParamsNRMS(title_size=T, history_size=H, head_num=2, head_dim=4,
                         attention_hidden_dim=8)
        return NRMS(hp, vocab_size=VOCAB, word_emb_dim=8, device=dev, **kw)

    title = {"title": lookup.matrix}
    if "dense" in which:
        yield "dense", Trainer(nrms(), title, token_batch, TrainerConfig(**cfg), device=dev,
                               mesh=mesh, table_specs=SHARDED, param_specs=WORDS,
                               log_fn=lambda s: None)
    if "sparse" in which:
        yield "sparse", Trainer(nrms(), title, token_batch,
                                TrainerConfig(**cfg, sparse_embedding=True, sparse_min_bucket=8),
                                device=dev, mesh=mesh, log_fn=lambda s: None)
    if "fused" in which:
        yield "fused", Trainer(nrms(use_fused_encoder=True), title, token_batch,
                               TrainerConfig(**cfg, dedup_articles=True, dedup_min_bucket=8),
                               device=dev, mesh=mesh, log_fn=lambda s: None)
    if "naml" in which:
        n_rows = lookup.matrix.shape[0]
        tables = {"title": lookup.matrix,
                  "body": rng.integers(1, VOCAB, (n_rows, T + 2)).astype(np.int32),
                  "cat": rng.integers(0, 5, n_rows).astype(np.int32),
                  "subcat": rng.integers(0, 9, n_rows).astype(np.int32)}
        naml = NAML(HParamsNAML(title_size=T, body_size=T + 2, history_size=H, filter_num=8,
                                window_size=3, attention_hidden_dim=8, vert_num=5,
                                subvert_num=9),
                    vocab_size=VOCAB, word_emb_dim=8, remat_encoder=True, encode_chunks=2,
                    prng_dropout=True, device=dev)
        yield "naml", Trainer(naml, tables, naml_batch,
                              TrainerConfig(**cfg, dedup_articles=True, dedup_min_bucket=8),
                              device=dev, mesh=mesh, table_specs=dict(SHARDED, body="model"),
                              param_specs=WORDS, log_fn=lambda s: None)


def run_worker(process_id: int, num_processes: int, port: int, out_path: str, device: str,
               backend: str, data: int, model_axis: int, which: tuple) -> None:
    """One process: ``which`` trainers on the (data, model_axis) mesh (no
    mesh in one process), each on the global batch of 2 * data rows."""
    dev, mesh = join(process_id, num_processes, port, device, backend, model_axis)
    df, train_df, lookup = tiny_split()
    bs = 2 * data
    feed = NewsrecFeed(train_df, lookup, history_size=H, batch_size=bs)
    val_feed = EvalFeed(create_binary_labels_column(df), lookup, history_size=H, batch_size=bs)
    out = {"mesh": mesh.shape if mesh is not None else None}
    for name, trainer in _trainers(dev, mesh, lookup, np.random.default_rng(0), which):
        trainer.fit(feed, epochs=EPOCHS, steps_per_epoch=STEPS)
        out[name] = {"losses": [h["loss"] for h in trainer.history],
                     "scores": np.asarray(trainer.score(val_feed).values, np.float64).tolist()}
    if process_id == 0:
        Path(out_path).write_text(json.dumps(out))


def _worker_cmd(i: int, n: int, port: int, out: Path, a, which: str) -> list:
    return [sys.executable, "-m", "ebnerd_tpu_torch.tools.dryrun_multichip", "--worker", str(i),
            "--num", str(n), "--port", str(port), "--out", str(out), "--device", a.device,
            "--backend", a.backend, "--data", str(a.data), "--model", str(a.model),
            "--which", which]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--num", type=int, default=1)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--which", default="dense,sparse,fused,naml",
                    help="the trainers to run, comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo",
                    help="gloo: the processes may share one card or the CPU")
    a = ap.parse_args(argv)
    if a.worker is not None:
        run_worker(a.worker, a.num, a.port, a.out, a.device, a.backend, a.data, a.model,
                   tuple(a.which.split(",")))
        return 0
    resolve_device(a.device)
    n, names = a.data * a.model, a.which.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        ref_out, mesh_out = Path(tmp) / "ref.json", Path(tmp) / "mesh.json"
        if "dense" in names:
            launch(lambda i: _worker_cmd(0, 1, 0, ref_out, a, "dense"), 1)
        port = free_port()
        launch(lambda i: _worker_cmd(i, n, port, mesh_out, a, a.which), n)
        got = json.loads(mesh_out.read_text())
        ref = json.loads(ref_out.read_text()) if "dense" in names else None
    if got["mesh"] != {"data": a.data, "model": a.model}:
        raise SystemExit(f"mesh {got['mesh']}")
    for name in names:
        if not all(np.isfinite(got[name][k]).all() for k in ("losses", "scores")):
            raise SystemExit(f"[dryrun_multichip] {name}: non-finite losses or scores")
    if ref is not None:
        np.testing.assert_allclose(got["dense"]["losses"], ref["dense"]["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["dense"]["scores"], ref["dense"]["scores"], rtol=1e-5)
    print(f"[dryrun_multichip] ok: mesh={got['mesh']} ({n} processes, {a.backend}, {a.device}), "
          f"{EPOCHS} epoch x {STEPS} steps + scoring ran ({', '.join(names)})"
          + (f"; dense losses {got['dense']['losses']} match one process's "
             f"{ref['dense']['losses']}" if ref is not None else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
