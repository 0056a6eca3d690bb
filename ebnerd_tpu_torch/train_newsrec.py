#!/usr/bin/env python
"""Training, evaluation and submission CLI for every model family: the port
of ``examples/train_newsrec.py`` (the same flags and defaults, plus
``--device``).

  python -m ebnerd_tpu_torch.train_newsrec --model nrms --synthetic --epochs 2
  python -m ebnerd_tpu_torch.train_newsrec --model nrms --synthetic --device cpu --debug
  python -m ebnerd_tpu_torch.train_newsrec --model nrms --data_path ~/ebnerd_data \
      --datasplit ebnerd_small --epochs 5 --bs_train 32

It runs on the card (``--device cuda``, the default) and raises without one
unless ``--device cpu`` is passed. ``--synthetic`` builds its splits in
memory and tokenizes with ``data.articles.VocabTokenizer`` over the
corpus's words, so it needs neither pyarrow nor transformers; unlike the
JAX CLI it writes no parquet files under ``<out_dir>/synthetic``.
``--data_path``, ``--run_test`` (its chunks are parquet),
``--document_embeddings`` and a ``--transformer_model_name`` other than
``local`` read or write parquet or load a Hugging Face model, and import
pyarrow or transformers when they do.

Data layout (EB-NeRD): <data_path>/<datasplit>/{train,validation}/
{behaviors,history}.parquet and <data_path>/<datasplit>/articles.parquet;
the test split lives under <data_path>/ebnerd_testset/test.

Outputs under ``--out_dir``: ``args.json``, ``logs/`` (scalars),
``checkpoints/``, ``results.json`` (AUC, MRR, NDCG@5, NDCG@10,
``train_seconds``, ``impressions_per_sec``), ``<model>_predictions.zip``
for the validation split and, with ``--run_test``,
``<model>_test_predictions.zip``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import constants as c
from . import resolve_device
from .data.articles import (
    VocabTokenizer,
    build_token_lookup,
    build_value_lookup,
    concat_str_columns,
    convert_text2encoding_with_transformers,
    load_article_id_embeddings,
)
from .data.behaviors import (
    create_binary_labels_column,
    create_user_id_to_int_mapping,
    ebnerd_from_path,
    ebnerd_from_tables,
    sampling_strategy_wu2019,
)
from .data.dataloader import EvalFeed, NewsrecFeed
from .data.lookup import Lookup
from .data.synthetic import synthetic_ebnerd_tables
from .data.table import read_parquet
from .evaluation.protocols import AucScore, MetricEvaluator, MrrScore, NdcgScore
from .models import config as mcfg
from .models.fastformer import Fastformer
from .models.inputs import builder_for
from .models.newsrec import LSTUR, NAML, NPA, NRMS, NRMSDocVec
from .training.trainer import Trainer, TrainerConfig
from .utils.logging import ScalarLogger
from .utils.submission import rank_ragged_scores, write_submission_file

__all__ = ["MODELS", "get_args", "build_article_artifacts", "build_model", "main"]

MODELS = ("nrms", "nrms_docvec", "lstur", "npa", "naml", "fastformer")
# the synthetic splits: (n_impressions, seed offset) of train, validation and test
_SYNTHETIC = {"train": (3000, 0), "validation": (800, 1), "test": (600, 2)}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=MODELS, default="nrms")
    p.add_argument("--data_path", type=str, default=None,
                   help="EB-NeRD root; omit with --synthetic")
    p.add_argument("--datasplit", type=str, default="ebnerd_small")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic split in memory (no dataset needed)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug", action="store_true", help="tiny fractions, 1 epoch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs without a card")
    # data
    p.add_argument("--history_size", type=int, default=20)
    p.add_argument("--npratio", type=int, default=4)
    p.add_argument("--max_title_length", type=int, default=30)
    p.add_argument("--train_fraction", type=float, default=1.0)
    p.add_argument("--transformer_model_name", type=str,
                   default="FacebookAI/xlm-roberta-large")
    p.add_argument("--document_embeddings", type=str, default=None,
                   help="parquet with per-article docvecs (nrms_docvec)")
    # training
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--bs_train", type=int, default=32)
    p.add_argument("--bs_test", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--loss", type=str, default="cross_entropy_loss")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--sparse_embedding", action="store_true",
                   help="host-deduped row-sparse word-embedding updates "
                        "(LazyAdam-style row-sparse semantics — a deliberate "
                        "deviation; training/sparse_embed.py)")
    p.add_argument("--prng_dropout", action="store_true",
                   help="seed-recompute dropout kernel (K3) for LSTUR, NPA and NAML")
    p.add_argument("--remat_encoder", action="store_true",
                   help="recompute the article encoder in the backward (memory lever "
                        "for catalogue-scale batches)")
    p.add_argument("--encode_chunks", type=int, default=1,
                   help="NAML: encode unique articles in N chunks "
                        "(with --remat_encoder bounds encoder memory ~1/N)")
    p.add_argument("--use_fused_encoder", action="store_true",
                   help="fused attention+pooling kernels (K1, K2; nrms only)")
    p.add_argument("--no_two_tower_eval", action="store_true",
                   help="score val/test with the full forward pass instead "
                        "of the precomputed article index (serving.py)")
    p.add_argument("--no_dedup", action="store_true",
                   help="disable train-time unique-article dedup encoding "
                        "(training/dedup.py; default on for all models "
                        "with user-independent news encoders)")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="persist the full trainer state per epoch + best weights "
                        "here (default: <out_dir>/checkpoints)")
    p.add_argument("--no_ckpt", action="store_true",
                   help="disable disk checkpointing entirely")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from --ckpt_dir "
                        "(restores the trainer state, callback state, seed stream)")
    # model dims
    p.add_argument("--head_num", type=int, default=None)
    p.add_argument("--head_dim", type=int, default=None)
    p.add_argument("--attention_hidden_dim", type=int, default=200)
    # test inference
    p.add_argument("--run_test", action="store_true")
    p.add_argument("--n_chunks_test", type=int, default=10)
    p.add_argument("--out_dir", type=str, default="ebnerd_predictions")
    return p.parse_args(argv)


def _synthetic_split(name: str, seed: int, history_size: int):
    """(behaviors joined with history, articles) of one synthetic split,
    built in memory with the JAX CLI's sizes and seeds."""
    n_impressions, offset = _SYNTHETIC[name]
    history, behaviors, articles = synthetic_ebnerd_tables(
        n_users=200, n_articles=500, n_impressions=n_impressions, seed=seed + offset,
        test_set=name == "test")
    return ebnerd_from_tables(behaviors, history, history_size=history_size), articles


def build_article_artifacts(args, articles, word_emb_dim):
    """Token lookup (+ per-model side tables) + optional word-emb init."""
    tables = {}
    word2vec = None
    if args.synthetic or args.transformer_model_name == "local":
        # no download: a word-level vocabulary over the corpus's title words
        vocab = sorted({w for t in np.asarray(articles[c.DEFAULT_TITLE_COL])
                        for w in str(t).split()})
        vp = Path(args.out_dir) / "vocab.txt"
        vp.parent.mkdir(parents=True, exist_ok=True)
        vp.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + vocab))
        tokenizer = VocabTokenizer(vp)
        vocab_size = tokenizer.vocab_size
    else:
        from transformers import AutoModel, AutoTokenizer

        from .data.nlp import get_transformers_word_embeddings

        tokenizer = AutoTokenizer.from_pretrained(args.transformer_model_name)
        model = AutoModel.from_pretrained(args.transformer_model_name)
        word2vec = get_transformers_word_embeddings(model)
        vocab_size, word_emb_dim = word2vec.shape
    articles, cat_col = concat_str_columns(
        articles, [c.DEFAULT_TITLE_COL, c.DEFAULT_SUBTITLE_COL]
    )
    articles, tok_col = convert_text2encoding_with_transformers(
        articles, tokenizer, cat_col, max_length=args.max_title_length
    )
    lookup = build_token_lookup(articles, tok_col)
    tables["title"] = lookup.matrix
    if args.model == "naml":
        articles, body_col = convert_text2encoding_with_transformers(
            articles, tokenizer, c.DEFAULT_BODY_COL,
            max_length=mcfg.DEFAULT_BODY_SIZE,
        )
        tables["body"] = build_token_lookup(articles, body_col).matrix
        tables["cat"] = build_value_lookup(
            articles, c.DEFAULT_CATEGORY_COL, dtype=np.int32
        ).matrix[:, 0]
        sub = articles[c.DEFAULT_SUBCATEGORY_COL]
        first_sub = np.zeros(len(articles), np.int32)
        lengths = sub.lengths
        first_sub[lengths > 0] = sub.values[sub.offsets[:-1][lengths > 0]]
        tables["subcat"] = np.concatenate([[0], first_sub]).astype(np.int32)
    return lookup, tables, word2vec, vocab_size, word_emb_dim


def build_model(args, vocab_size, word_emb_dim, word2vec, n_users):
    """The family's module on ``args.device``, its parameters drawn from
    ``args.seed``; ``word2vec`` (pretrained word vectors) becomes the word
    table's initial values, where the JAX CLI passes it."""
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    common = dict(vocab_size=vocab_size, word_emb_dim=word_emb_dim, word_emb_init=word2vec,
                  dtype=dtype, device=device, seed=args.seed)
    hd = {}
    if args.head_num:
        hd["head_num"] = args.head_num
    if args.head_dim:
        hd["head_dim"] = args.head_dim
    base = dict(title_size=args.max_title_length, history_size=args.history_size,
                dropout=args.dropout, learning_rate=args.learning_rate,
                loss=args.loss, attention_hidden_dim=args.attention_hidden_dim)
    if args.model == "nrms":
        return NRMS(mcfg.HParamsNRMS(**base, **hd), **common,
                    use_fused_encoder=args.use_fused_encoder)
    if args.model == "nrms_docvec":
        hp = mcfg.HParamsNRMSDocVec(
            **{**base, "title_size": mcfg.DEFAULT_DOCUMENT_SIZE}, **hd
        )
        return NRMSDocVec(hp, dtype=dtype, device=device, seed=args.seed)
    if args.model == "lstur":
        return LSTUR(mcfg.HParamsLSTUR(**base, n_users=n_users), **common,
                     prng_dropout=args.prng_dropout,
                     remat_encoder=args.remat_encoder)
    if args.model == "npa":
        return NPA(mcfg.HParamsNPA(**base, n_users=n_users), **common,
                   prng_dropout=args.prng_dropout,
                   remat_encoder=args.remat_encoder)
    if args.model == "naml":
        return NAML(mcfg.HParamsNAML(**base), **common,
                    prng_dropout=args.prng_dropout,
                    remat_encoder=args.remat_encoder,
                    encode_chunks=args.encode_chunks)
    if args.model == "fastformer":
        # as the JAX CLI: no pretrained init and no prng_dropout for Fastformer
        hp = mcfg.HParamsFastformer(history_size=args.history_size,
                                    title_size=args.max_title_length,
                                    dropout=args.dropout,
                                    learning_rate=args.learning_rate)
        return Fastformer(hp, vocab_size=vocab_size, word_emb_dim=word_emb_dim, dtype=dtype,
                          device=device, seed=args.seed)
    raise ValueError(args.model)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    if args.debug:
        args.epochs = 1
        args.train_fraction = min(args.train_fraction, 0.2)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    # -- data ----------------------------------------------------------------
    if args.synthetic:
        df_train, articles = _synthetic_split("train", args.seed, args.history_size)
        df_val, _ = _synthetic_split("validation", args.seed, args.history_size)
    else:
        split = Path(args.data_path).expanduser() / args.datasplit
        articles = read_parquet(split / "articles.parquet")
        df_train = ebnerd_from_path(split / "train", history_size=args.history_size)
        df_val = ebnerd_from_path(split / "validation", history_size=args.history_size)
    if args.train_fraction < 1.0:
        df_train = df_train.sample_fraction(args.train_fraction, rng)
    df_train = create_binary_labels_column(
        sampling_strategy_wu2019(df_train, npratio=args.npratio, shuffle=True,
                                 seed=args.seed),
        shuffle=True, seed=args.seed,
    )
    df_val = create_binary_labels_column(df_val)

    # -- artifacts -----------------------------------------------------------
    word_emb_dim = 300
    if args.model == "nrms_docvec":
        if args.document_embeddings:
            articles = load_article_id_embeddings(articles, args.document_embeddings)
            lookup = build_value_lookup(articles, "document_vector",
                                        dtype=np.float32)
        else:  # synthetic docvecs
            ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
            vecs = rng.standard_normal(
                (len(ids), mcfg.DEFAULT_DOCUMENT_SIZE)).astype(np.float32)
            lookup = Lookup.from_values(ids, vecs)
        tables, word2vec, vocab_size = {"docvec": lookup.matrix}, None, 0
    else:
        lookup, tables, word2vec, vocab_size, word_emb_dim = \
            build_article_artifacts(args, articles, word_emb_dim)

    user_mapping = None
    if args.model in ("lstur", "npa"):
        user_mapping = create_user_id_to_int_mapping(df_train)

    # -- feeds + trainer -----------------------------------------------------
    train_feed = NewsrecFeed(df_train, lookup, history_size=args.history_size,
                             batch_size=args.bs_train,
                             user_mapping=user_mapping, seed=args.seed)
    val_feed = EvalFeed(df_val, lookup, history_size=args.history_size,
                        batch_size=args.bs_test, user_mapping=user_mapping)
    n_users = len(user_mapping) if user_mapping else 1
    model = build_model(args, vocab_size, word_emb_dim, word2vec, n_users)
    # the reference attaches L2 kernel regularization to the docvec dense
    # stack (nrms_docvec.py:110-116)
    l2 = mcfg.HParamsNRMSDocVec().newsencoder_l2_regularization \
        if args.model == "nrms_docvec" else 0.0
    trainer = Trainer(
        model, tables, builder_for(args.model),
        TrainerConfig(learning_rate=args.learning_rate, loss=args.loss,
                      l2_regularization=l2, seed=args.seed,
                      sparse_embedding=args.sparse_embedding,
                      dedup_articles=False if args.no_dedup else "auto",
                      two_tower_eval=False if args.no_two_tower_eval else "auto"),
        device=device,
    )
    (out_dir / "args.json").write_text(json.dumps(vars(args), indent=2, default=str))

    ckpt_dir = None if args.no_ckpt else (args.ckpt_dir or str(out_dir / "checkpoints"))
    t0 = time.perf_counter()
    with ScalarLogger(out_dir / "logs") as logger:
        trainer.fit(train_feed, val_feed, df_val[c.DEFAULT_LABELS_COL],
                    epochs=args.epochs, scalar_logger=logger,
                    ckpt_dir=ckpt_dir, resume=args.resume)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.perf_counter() - t0

    # -- final eval ----------------------------------------------------------
    # Trainer.score routes through the two-tower article index whenever the
    # news encoder is user-independent (serving.py); NPA and
    # --no_two_tower_eval use the full forward pass
    scorer = trainer
    scores = scorer.score(val_feed)
    ev = MetricEvaluator(
        labels=df_val[c.DEFAULT_LABELS_COL], predictions=scores,
        metric_functions=[AucScore(), MrrScore(), NdcgScore(5), NdcgScore(10)],
    ).evaluate()
    print(ev)
    results = {k: float(v) for k, v in ev.evaluations.items()}
    results["train_seconds"] = train_time
    results["impressions_per_sec"] = len(df_train) * args.epochs / train_time
    (out_dir / "results.json").write_text(json.dumps(results, indent=2))

    # -- submission on the validation split (test flow needs the hidden set) --
    ranks = rank_ragged_scores(scores)
    write_submission_file(
        np.asarray(df_val[c.DEFAULT_IMPRESSION_ID_COL]), ranks,
        out_dir / "predictions.txt",
        filename_zip=f"{args.model}_predictions.zip",
    )
    if args.run_test:
        from .training.inference import assemble_submission, chunked_score

        if args.synthetic:
            df_test, _ = _synthetic_split("test", args.seed, args.history_size)
        else:
            test_path = Path(args.data_path).expanduser() / "ebnerd_testset" / "test"
            df_test = ebnerd_from_path(test_path, history_size=args.history_size)
        # score the ~250-candidate beyond-accuracy rows separately so the
        # normal rows don't pad to the BA bucket width (the reference also
        # splits on is_beyond_accuracy, ebnerd_nrms.py:284-285)
        if c.DEFAULT_IS_BEYOND_ACCURACY_COL in df_test:
            ba_mask = np.asarray(df_test[c.DEFAULT_IS_BEYOND_ACCURACY_COL])
            splits = [("wo_ba", df_test.filter(~ba_mask), args.n_chunks_test),
                      ("w_ba", df_test.filter(ba_mask), 1)]
        else:
            splits = [("all", df_test, args.n_chunks_test)]
        parts = [
            chunked_score(scorer, part, lookup,
                          history_size=args.history_size,
                          batch_size=args.bs_test, n_chunks=n_chunks,
                          out_dir=out_dir / f"test_chunks_{name}",
                          user_mapping=user_mapping)
            for name, part, n_chunks in splits if len(part)
        ]
        # reassemble wo_ba + w_ba chunk results into the original impression
        # order and write the one uploadable zip (reference:
        # ebnerd_nrms.py:352-364)
        test_ids = np.asarray(df_test[c.DEFAULT_IMPRESSION_ID_COL])
        test_ranks = assemble_submission(parts, test_ids)
        write_submission_file(
            test_ids, test_ranks, out_dir / "test_predictions.txt",
            filename_zip=f"{args.model}_test_predictions.zip",
        )
        print(f"[submission] {out_dir / (args.model + '_test_predictions.zip')} "
              f"({len(test_ids)} impressions)")
    return results


if __name__ == "__main__":
    main()
