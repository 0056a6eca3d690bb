"""Accuracy check of the port on the toy topic-signal split (the port's half
of ``scripts/parity_train.py`` for its three recorded entries).

The split is the script's ``make_signal_dataset`` (vocabulary 2,000 x 64,
title 12, history 10, npratio 4, 400 articles in 10 topics, 6,000 training
and 1,500 validation impressions) and ``make_docvec_dataset`` (64-wide
document vectors: topic centroid + noise), numpy copies here. Each entry
trains 3 epochs at batch 64, lr 1e-3, with seeds 42 and 7, as the
script's ``train_ours*`` do: one ``np.random.default_rng(seed)``
permutation per epoch, only whole batches, the validation split scored by
the model's eval forward in chunks of 500 after each epoch.

  nrms         NRMS fp32, unfused, token matrices per slot (dropout 0.2)
  nrms_dedup   NRMS fp32 through the article index and the unique-article
               dedup (bucket >= 64), dropout 0.2
  nrms_docvec  NRMSDocVec with its BN stack (64, 64), L2 1e-4, per slot

The gate is the script's ``_verdict``, applied to every seed: |final AUC -
the reference's final AUC| <= max(2 x seed spread, 0.02), against the
reference curves recorded in ``PARITY_TRAIN.json``.

Run: python -m ebnerd_tpu_torch.tools.parity_train [--only nrms ...]
     [--device cuda] [--out build/parity_train.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..models.config import HParamsNRMS, HParamsNRMSDocVec
from ..models.inputs import token_batch
from ..models.newsrec import NRMS, NRMSDocVec
from ..serving import eval_mode
from ..training.trainer import Trainer, TrainerConfig
from .parity_headline import auc_from_probs, verdict

# the toy split's widths (scripts/parity_train.py:41-47)
VOCAB, EMB = 2_000, 64
N_TOPICS, WORDS_PER_TOPIC = 10, 150
H, T, NPRATIO, K = 10, 12, 4, 5
HEADS, HEAD_DIM, ATT = 8, 8, 32
N_ARTICLES, N_TRAIN, N_VAL = 400, 6_000, 1_500
EPOCHS, BATCH, LR = 3, 64, 1e-3
TOPIC_CLICK_P = 0.8
DOCVEC_DIM = 64
VAL_CHUNK = 500
SEEDS = (42, 7)

# PARITY_TRAIN.json[entry]["reference_val_auc"]: the TF/Keras reference's
# curves on these splits (nrms_dedup reuses nrms's)
REFERENCE_VAL_AUC = {"nrms": (0.8445, 0.9025, 0.909),
                     "nrms_dedup": (0.8445, 0.9025, 0.909),
                     "nrms_docvec": (0.8878, 0.8917, 0.8882)}
ENTRIES = tuple(REFERENCE_VAL_AUC)


def _impression_rows(rng, art_topic, n):
    """The script's per-impression draws: history and candidate article
    indices [n, H], [n, K] and labels [n, K]."""
    user_topic = rng.integers(0, N_TOPICS, n)
    his = np.zeros((n, H), np.int64)
    cand = np.zeros((n, K), np.int64)
    labels = np.zeros((n, K), np.float32)
    for i in range(n):
        ut = user_topic[i]
        on_topic = np.flatnonzero(art_topic == ut)
        off_topic = np.flatnonzero(art_topic != ut)
        n_on = rng.binomial(H, 0.8)
        his[i] = np.concatenate([rng.choice(on_topic, n_on), rng.choice(off_topic, H - n_on)])
        neg = rng.choice(off_topic, NPRATIO, replace=False)
        pos_pool = on_topic if rng.random() < TOPIC_CLICK_P else off_topic
        pos = rng.choice(pos_pool)
        order = rng.permutation(K)
        cand[i] = np.concatenate([neg, [pos]])[order]
        labels[i, np.flatnonzero(order == NPRATIO)[0]] = 1.0
    return his, cand, labels


def make_signal_dataset(seed: int, return_indices: bool = False):
    """``scripts/parity_train.py`` ``make_signal_dataset``: train and val as
    (hist tokens, cand tokens, labels); with ``return_indices`` also the
    article token table and the train split as (hist_idx, cand_idx,
    labels)."""
    rng = np.random.default_rng(seed)
    art_topic = rng.integers(0, N_TOPICS, N_ARTICLES)
    common_lo = N_TOPICS * WORDS_PER_TOPIC + 1
    tokens = np.zeros((N_ARTICLES, T), np.int32)
    for a in range(N_ARTICLES):
        lo = 1 + art_topic[a] * WORDS_PER_TOPIC
        topic_words = rng.integers(lo, lo + WORDS_PER_TOPIC, T)
        common = rng.integers(common_lo, VOCAB, T)
        use_topic = rng.random(T) < 0.67
        tokens[a] = np.where(use_topic, topic_words, common)

    def impressions(n):
        his, cand, labels = _impression_rows(rng, art_topic, n)
        return tokens[his], tokens[cand], labels, his, cand

    t_his, t_cand, t_y, t_hidx, t_cidx = impressions(N_TRAIN)
    v_his, v_cand, v_y, _, _ = impressions(N_VAL)
    train, val = (t_his, t_cand, t_y), (v_his, v_cand, v_y)
    if return_indices:
        return train, val, tokens, (t_hidx, t_cidx, t_y)
    return train, val


def make_docvec_dataset(seed: int, dv: int = DOCVEC_DIM):
    """``scripts/parity_train.py`` ``make_docvec_dataset``: train and val as
    (hist vectors, cand vectors, labels)."""
    rng = np.random.default_rng(seed)
    art_topic = rng.integers(0, N_TOPICS, N_ARTICLES)
    centroids = rng.standard_normal((N_TOPICS, dv)).astype(np.float32)
    docvecs = (centroids[art_topic]
               + 0.7 * rng.standard_normal((N_ARTICLES, dv))).astype(np.float32)

    def impressions(n):
        his, cand, labels = _impression_rows(rng, art_topic, n)
        return docvecs[his], docvecs[cand], labels

    return impressions(N_TRAIN), impressions(N_VAL)


def make_w2v() -> np.ndarray:
    """The toy word table [VOCAB, EMB] (``main``'s, from seed 1)."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((VOCAB, EMB)) * 0.1).astype(np.float32)


def _dense_builder(keys):
    """A batch builder for batches that carry their model inputs whole (the
    script's identity builder): each of ``keys`` goes to the device."""
    def builder(tables, raw):
        dev = next(iter(tables.values())).device
        return {k: torch.as_tensor(raw[k]).to(dev, torch.long if raw[k].dtype.kind in "iu"
                                              else torch.float32) for k in keys}
    return builder


@torch.no_grad()
def _score(model, hist, cand, keys, device) -> np.ndarray:
    out = []
    with eval_mode(model):
        for s in range(0, hist.shape[0], VAL_CHUNK):
            batch = {}
            for k, v in zip(keys, (hist[s:s + VAL_CHUNK], cand[s:s + VAL_CHUNK])):
                t = torch.as_tensor(v)
                batch[k] = t.to(device, torch.long if not t.is_floating_point() else torch.float32)
            out.append(torch.sigmoid(model(batch)).float().cpu().numpy())
    return np.concatenate(out)


def train_entry(entry: str, seed: int, device="cuda", data=None, epochs: int = EPOCHS,
                log=print) -> dict:
    """One seed of one entry; ``data`` is the entry's split when given (it
    is made otherwise). Returns the AUC per epoch and the seconds."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if entry == "nrms_docvec":
        (his, cand, y), (vh, vc, vy) = data if data is not None else make_docvec_dataset(0)
        hp = HParamsNRMSDocVec(title_size=DOCVEC_DIM, history_size=H, head_num=HEADS,
                               head_dim=HEAD_DIM, attention_hidden_dim=ATT,
                               newsencoder_units_per_layer=(64, 64))
        model = NRMSDocVec(hp, device=dev, seed=seed)
        keys = ("hist_vecs", "cand_vecs")
        trainer = Trainer(model, {"docvec": np.zeros((1, DOCVEC_DIM), np.float32)},
                          _dense_builder(keys),
                          TrainerConfig(learning_rate=LR, seed=seed,
                                        l2_regularization=hp.newsencoder_l2_regularization),
                          device=dev, log_fn=lambda s: None)
    else:
        if data is None:
            data = make_signal_dataset(0, return_indices=True) + (make_w2v(),)
        (his, cand, y), (vh, vc, vy), table, (hidx, cidx, _), w2v = data
        hp = HParamsNRMS(title_size=T, history_size=H, head_num=HEADS, head_dim=HEAD_DIM,
                         attention_hidden_dim=ATT)
        model = NRMS(hp, vocab_size=VOCAB, word_emb_dim=EMB, device=dev, seed=seed,
                     word_emb_init=w2v)
        keys = ("hist_tokens", "cand_tokens")
        if entry == "nrms":
            trainer = Trainer(model, {"title": np.zeros((1, T), np.int32)}, _dense_builder(keys),
                              TrainerConfig(learning_rate=LR, seed=seed), device=dev,
                              log_fn=lambda s: None)
        elif entry == "nrms_dedup":
            his, cand = hidx, cidx
            trainer = Trainer(model, {"title": table}, token_batch,
                              TrainerConfig(learning_rate=LR, seed=seed, dedup_articles=True,
                                            dedup_min_bucket=64),
                              device=dev, log_fn=lambda s: None)
        else:
            raise ValueError(f"unknown entry {entry!r}; one of {ENTRIES}")
    batch_keys = ("hist_idx", "cand_idx") if entry == "nrms_dedup" else keys
    rng = np.random.default_rng(seed)
    n_total = his.shape[0]
    aucs = []
    for ep in range(epochs):
        order = rng.permutation(n_total)
        for s in range(0, n_total - BATCH + 1, BATCH):
            idx = order[s:s + BATCH]
            trainer.train_step({batch_keys[0]: his[idx], batch_keys[1]: cand[idx],
                                "labels": y[idx]})
        aucs.append(auc_from_probs(_score(model, vh, vc, keys, dev), vy))
        log(f"[parity_train {entry} seed{seed}] epoch {ep}: val AUC {aucs[-1]:.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
    return {"val_auc": aucs, "seed": seed, "epochs": epochs, "batch": BATCH, "lr": LR,
            "seconds": time.perf_counter() - t0}


def run_all(entries=ENTRIES, seeds=SEEDS, device="cuda", log=print) -> dict:
    """Every entry with every seed, and its verdict against the recorded
    reference curve."""
    signal = make_signal_dataset(0, return_indices=True) + (make_w2v(),)
    docvec = make_docvec_dataset(0)
    runs, verdicts = {}, {}
    for entry in entries:
        data = docvec if entry == "nrms_docvec" else signal
        runs[entry] = {f"seed{s}": train_entry(entry, s, device, data, log=log) for s in seeds}
        ref = REFERENCE_VAL_AUC[entry]
        verdicts[entry] = dict(verdict({entry: runs[entry]}, ref[-1])[entry],
                               reference_val_auc=list(ref))
    return {"runs": runs, "verdict": verdicts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=ENTRIES, default=list(ENTRIES))
    ap.add_argument("--seeds", nargs="+", type=int, default=list(SEEDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/parity_train.json")
    a = ap.parse_args(argv)
    resolve_device(a.device)  # no card: raise before the split is made
    result = run_all(a.only, a.seeds, a.device)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    for name, v in result["verdict"].items():
        print(f"{name}: reference {v['reference_final_auc']:.4f} finals {v['final_auc']} "
              f"tolerance {v['tolerance']:.4f} -> {'PASS' if v['pass'] else 'FAIL'}")
    return 0 if all(v["pass"] for v in result["verdict"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
