"""Multi-process data-parallel training, checked against one process (the
port's counterpart of ``scripts/dryrun_multihost.py``).

Runs the same tiny NRMS job twice: once in one process, then in two
processes joined by ``torch.distributed`` (``parallel/distributed.py``) on
a (data=2, model=1) mesh. The job: the synthetic split (16 users, 39
articles, 64 impressions, history 4, title 6, npratio 3, vocabulary 64),
batch 8, 2 epochs of 4 steps through ``Trainer.fit`` with a checkpoint
each epoch, validation scores of every impression (``Trainer.score``),
then a fresh trainer that resumes from the checkpoint and trains a third
epoch. It asserts the JAX script's tolerances: the epoch losses (rtol
1e-5, atol 1e-6), the mean validation score (rtol 1e-5), the first 8
scores (rtol 1e-4, atol 1e-6) and the resumed epoch's loss (rtol 1e-5,
atol 1e-6). The model axis is ROADMAP A11b, so the mesh is (2, 1) where
JAX's is (4, 2).

Run: python -m ebnerd_tpu_torch.tools.dryrun_multihost --device cpu
(the default device is the card; two processes there share it over gloo,
since NCCL takes one process per card).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import constants as c
from .. import resolve_device
from ..data.behaviors import (create_binary_labels_column, ebnerd_from_tables,
                              sampling_strategy_wu2019)
from ..data.dataloader import EvalFeed, NewsrecFeed
from ..data.lookup import Lookup
from ..data.synthetic import synthetic_ebnerd_tables
from ..models.config import HParamsNRMS
from ..models.inputs import token_batch
from ..models.newsrec import NRMS
from ..parallel import distributed as dist
from ..parallel.mesh import make_mesh
from ..training.trainer import Trainer, TrainerConfig

STEPS = 4
EPOCHS = 2
H, T, NPRATIO, VOCAB, BS = 4, 6, 3, 64, 8
PACKAGE_PARENT = Path(__file__).resolve().parents[2]


def run_worker(process_id: int, num_processes: int, port: int, out_path: str,
               device: str, backend: str) -> None:
    torch.set_num_threads(1)
    dev = resolve_device(device)
    if num_processes > 1:
        dist.initialize(f"localhost:{port}", num_processes, process_id, device=dev,
                        backend=backend)
        assert dist.process_info()["process_count"] == num_processes, dist.process_info()
    mesh = make_mesh()

    history, behaviors, articles = synthetic_ebnerd_tables(n_users=16, n_articles=39,
                                                           n_impressions=64, seed=0)
    df = ebnerd_from_tables(behaviors, history, history_size=H)
    train_df = create_binary_labels_column(
        sampling_strategy_wu2019(df, npratio=NPRATIO, shuffle=True, seed=1))
    ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
    rng = np.random.default_rng(0)
    lookup = Lookup.from_values(ids, rng.integers(1, VOCAB, (len(ids), T)).astype(np.int32))

    hp = HParamsNRMS(title_size=T, history_size=H, head_num=2, head_dim=4,
                     attention_hidden_dim=8)
    model = NRMS(hp, vocab_size=VOCAB, word_emb_dim=8, device=dev)
    cfg = TrainerConfig(learning_rate=1e-3, early_stopping_patience=None, lr_patience=None,
                        seed=0)

    def trainer():
        return Trainer(model, {"title": lookup.matrix}, token_batch, cfg, device=dev, mesh=mesh,
                       log_fn=lambda s: None)

    first = trainer()
    feed = NewsrecFeed(train_df, lookup, history_size=H, batch_size=BS, seed=3)
    ckpt_dir = Path(out_path).parent / "ckpt"
    first.fit(feed, epochs=EPOCHS, steps_per_epoch=STEPS, ckpt_dir=ckpt_dir)

    val_feed = EvalFeed(create_binary_labels_column(df), lookup, history_size=H, batch_size=BS)
    score_vals = np.asarray(first.score(val_feed).values, np.float64)

    # resume across the processes: a fresh trainer restores the epoch
    # checkpoint process 0 wrote and trains one more epoch
    resumed = trainer()
    resumed.fit(feed, epochs=EPOCHS + 1, steps_per_epoch=STEPS, ckpt_dir=ckpt_dir, resume=True)
    assert resumed.history[:EPOCHS] == first.history, "resume lost history"

    if process_id == 0:
        Path(out_path).write_text(json.dumps({
            "process_count": dist.process_info()["process_count"],
            "mesh": mesh.shape,
            "losses": [h["loss"] for h in first.history],
            "val_scores_mean": float(score_vals.mean()),
            "val_scores_head": [round(float(x), 6) for x in score_vals[:8]],
            "resumed_loss": float(resumed.history[-1]["loss"]),
        }))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_cmd(i: int, n: int, port: int, out: Path, a) -> list:
    return [sys.executable, "-m", "ebnerd_tpu_torch.tools.dryrun_multihost", "--worker", str(i),
            "--num", str(n), "--port", str(port), "--out", str(out), "--device", a.device,
            "--backend", a.backend]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--num", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo",
                    help="gloo: both processes may share one card or the CPU")
    a = ap.parse_args(argv)
    if a.worker is not None:
        run_worker(a.worker, a.num, a.port, a.out, a.device, a.backend)
        return 0
    resolve_device(a.device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(PACKAGE_PARENT)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ref_out = tmp / "ref" / "result.json"
        ref_out.parent.mkdir()
        subprocess.run(_worker_cmd(0, 1, 0, ref_out, a), check=True, env=env, timeout=900)

        port = _free_port()
        dist_out = tmp / "dist" / "result.json"
        dist_out.parent.mkdir()
        procs = [subprocess.Popen(_worker_cmd(i, a.num, port, dist_out, a), env=env)
                 for i in range(a.num)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            raise SystemExit(f"worker exit codes {rcs}")

        ref = json.loads(ref_out.read_text())
        got = json.loads(dist_out.read_text())
    assert got["process_count"] == a.num, got
    np.testing.assert_allclose(ref["losses"], got["losses"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref["val_scores_mean"], got["val_scores_mean"], rtol=1e-5)
    np.testing.assert_allclose(ref["val_scores_head"], got["val_scores_head"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ref["resumed_loss"], got["resumed_loss"], rtol=1e-5, atol=1e-6)
    print(f"[dryrun_multihost] ok: {a.num} processes ({a.backend}, {a.device}), "
          f"mesh={got['mesh']}, {EPOCHS} epochs x {STEPS} steps; losses match single-process "
          f"run: {got['losses']}; val scores match (mean {got['val_scores_mean']:.6f}); "
          f"checkpoint resume across {a.num} processes matches "
          f"(loss {got['resumed_loss']:.6f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
