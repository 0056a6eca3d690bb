"""History-length sensitivity study (the port of
``examples/history_length_study.py``, after the reference's
``examples/reproducibility_scripts/ebnerd_nrms_doc_hist.py``): train
NRMSDocVec once at ``--history_size``, then evaluate the AUC at every history
truncation length of ``--sweep`` and write ``auc_history_length.json``.

``--synthetic`` builds the JAX example's synthetic train and validation
splits in memory (no pyarrow); ``--data_path`` and
``--document_embeddings`` read parquet (pyarrow, when called).

  python -m ebnerd_tpu_torch.examples.history_length_study --synthetic --epochs 1 \\
      --sweep 1 2 4 8 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .. import constants as c
from ..data.behaviors import (
    create_binary_labels_column,
    ebnerd_from_tables,
    sampling_strategy_wu2019,
)
from ..data.dataloader import EvalFeed, NewsrecFeed
from ..data.lookup import Lookup
from ..evaluation.ranking import per_impression_auc
from ..models.config import HParamsNRMSDocVec
from ..models.inputs import docvec_batch
from ..models.newsrec import NRMSDocVec
from ..training.trainer import Trainer, TrainerConfig


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--datasplit", type=str, default="ebnerd_small")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--document_embeddings", type=str, default=None)
    p.add_argument("--history_size", type=int, default=20)
    p.add_argument("--sweep", type=int, nargs="+",
                   default=[1, 2, 3, 5, 10, 15, 20, 30, 40, 50])
    p.add_argument("--npratio", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--docvec_dim", type=int, default=128)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_dir", type=str, default="ebnerd_predictions/hist_study")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_splits(args):
    """(train split, validation split, articles); a split is (behaviors,
    history) to join at a history length."""
    if args.synthetic:
        from ..data.synthetic import synthetic_ebnerd_tables

        h_tr, b_tr, articles = synthetic_ebnerd_tables(
            n_users=150, n_articles=400, n_impressions=2000, seed=args.seed)
        h_va, b_va, _ = synthetic_ebnerd_tables(
            n_users=150, n_articles=400, n_impressions=600, seed=args.seed + 1)
        return (b_tr, h_tr), (b_va, h_va), articles
    from ..data.table import read_parquet

    split = Path(args.data_path).expanduser() / args.datasplit

    def read(name):
        return (read_parquet(split / name / "behaviors.parquet"),
                read_parquet(split / name / "history.parquet"))

    return read("train"), read("validation"), read_parquet(split / "articles.parquet")


def joined(split, history_size: int):
    behaviors, history = split
    return ebnerd_from_tables(behaviors, history, history_size=history_size)


def setup(args):
    """(trainer, lookup, train split, validation split): the document-vector
    lookup (``--document_embeddings`` or standard normals from the seed) and
    NRMSDocVec's trainer at ``--history_size``, untrained."""
    rng = np.random.default_rng(args.seed)
    train, val, articles = load_splits(args)
    ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
    if args.document_embeddings:
        from ..data.articles import build_value_lookup, load_article_id_embeddings

        articles = load_article_id_embeddings(articles, args.document_embeddings)
        lookup = build_value_lookup(articles, "document_vector", dtype=np.float32)
        dv_dim = lookup.matrix.shape[1]
    else:
        dv_dim = args.docvec_dim
        lookup = Lookup.from_values(
            ids, rng.standard_normal((len(ids), dv_dim)).astype(np.float32))
    hp = HParamsNRMSDocVec(title_size=dv_dim, history_size=args.history_size,
                           head_num=8, head_dim=16,
                           newsencoder_units_per_layer=(128, 128))
    trainer = Trainer(NRMSDocVec(hp, device=args.device), {"docvec": lookup.matrix},
                      docvec_batch, TrainerConfig(learning_rate=1e-4, seed=args.seed),
                      device=args.device)
    return trainer, lookup, train, val


def fit(trainer, lookup, train, args) -> None:
    df_train = create_binary_labels_column(
        sampling_strategy_wu2019(joined(train, args.history_size),
                                 npratio=args.npratio, shuffle=True, seed=args.seed),
        shuffle=True, seed=args.seed)
    trainer.fit(NewsrecFeed(df_train, lookup, history_size=args.history_size,
                            batch_size=args.bs, seed=args.seed),
                epochs=args.epochs)


def sweep(trainer, lookup, val, args) -> dict:
    """{history length: mean per-impression AUC} on the validation split."""
    aucs = {}
    for h in args.sweep:
        df_val = create_binary_labels_column(joined(val, h))
        feed = EvalFeed(df_val, lookup, history_size=h, batch_size=args.bs)
        scores = trainer.score(feed)
        auc = float(np.nanmean(per_impression_auc(df_val[c.DEFAULT_LABELS_COL], scores)))
        aucs[h] = auc
        print(f"history {h:>3}: AUC {auc:.4f}")
    return aucs


def main(argv=None) -> dict:
    args = get_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    trainer, lookup, train, val = setup(args)
    fit(trainer, lookup, train, args)
    aucs = sweep(trainer, lookup, val, args)
    (out / "auc_history_length.json").write_text(json.dumps(aucs, indent=2))
    return aucs


if __name__ == "__main__":
    main()
