"""Accuracy check of the port's full NRMS training path at the headline
widths (the port's half of ``scripts/parity_headline.py``, its ``run_ours``).

The split is the script's synthetic topic-signal split at NRMS's widths
(``make_dataset`` and ``make_w2v``, numpy copies here): vocabulary 30,000 x
256, title 30, history 20, npratio 4, 4,000 articles in 20 topics, 32,768
training and 8,192 validation impressions. The model is NRMS with 20 x 20
heads, attention 200 and dropout 0.2, bf16 and fused, its word table the
w2v matrix; the trainer is ``Trainer`` with the article dedup at a fixed
bucket of 4,096, and each step goes through ``Trainer.train_step``: host
dedup, then the fused encoder's forward and recompute backward with their
in-kernel dropout on the card. As in the script: one
``np.random.default_rng(seed)`` permutation per epoch, only whole batches,
lr = 1e-4 * sqrt(bs / 64). After each epoch the validation split is scored
by the model's eval forward in chunks of 2,048 impressions and the AUC is
the mean over impressions of ``per_impression_auc``.

The gate is the script's ``run_verdict`` rule, applied to every seed:
|final AUC - 0.8972| <= max(2 x seed spread, 0.02), where 0.8972 is the
reference's final AUC (``PARITY_TRAIN.json`` ``headline_reference``). The
dropout streams differ from JAX's (ROADMAP C), so only the final AUC is
held, not the curve.

Run: python -m ebnerd_tpu_torch.tools.parity_headline [--runs 4096:8 16384:24]
     [--seeds 42 7] [--device cuda] [--out build/parity_headline.json]
Prints one line per epoch and one per run, writes the curves, seconds and
verdict to ``--out``, and exits 1 when a run misses the gate.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.ragged import Ragged
from ..evaluation.ranking import per_impression_auc
from ..models.config import HParamsNRMS
from ..models.inputs import token_batch
from ..models.newsrec import NRMS
from ..ops import kernel_counters
from ..serving import eval_mode
from ..training.trainer import Trainer, TrainerConfig

# the split's widths (scripts/parity_headline.py:56-65)
VOCAB, EMB = 30_000, 256
T, H, NPRATIO, K = 30, 20, 4, 5
HEADS, HEAD_DIM, ATT = 20, 20, 200
DROPOUT = 0.2
N_TOPICS, PER_TOPIC, WORDS_PER_TOPIC = 20, 200, 600
N_ARTICLES = N_TOPICS * PER_TOPIC          # 4000; table row 0 = padding
N_TRAIN, N_VAL = 32_768, 8_192
REF_BS, REF_LR = 64, 1e-4
TOPIC_CLICK_P = 0.8
BUCKET = 4096                              # fixed dedup bucket (>= N_ARTICLES)
VAL_CHUNK = 2048

# PARITY_TRAIN.json["headline_reference"]["val_auc"][-1]: the TF/Keras
# reference's final AUC on this split (bs 64, lr 1e-4, 4 epochs)
HEADLINE_REFERENCE_AUC = 0.8972
# the recorded configurations: (batch, epochs)
RUNS = ((4096, 8), (16384, 24))
SEEDS = (42, 7)


def make_dataset(seed: int = 0):
    """The topic-signal split (``scripts/parity_headline.py`` ``make_dataset``,
    the same draws in the same order): (tokens [N+1, T] int32 with row 0 the
    padding, train = (hist_idx, cand_idx, labels), val = the same)."""
    rng = np.random.default_rng(seed)
    art_ids = rng.permutation(np.arange(1, N_ARTICLES + 1)).astype(np.int32)
    topic_mat = art_ids.reshape(N_TOPICS, PER_TOPIC)
    common_lo = N_TOPICS * WORDS_PER_TOPIC + 1
    tokens = np.zeros((N_ARTICLES + 1, T), np.int32)
    topic_of = np.zeros(N_ARTICLES + 1, np.int32)
    for t in range(N_TOPICS):
        topic_of[topic_mat[t]] = t
    lo = 1 + topic_of[1:, None] * WORDS_PER_TOPIC
    topic_words = lo + rng.integers(0, WORDS_PER_TOPIC, (N_ARTICLES, T))
    common = rng.integers(common_lo, VOCAB, (N_ARTICLES, T))
    use_topic = rng.random((N_ARTICLES, T)) < 0.67
    tokens[1:] = np.where(use_topic, topic_words, common).astype(np.int32)

    def impressions(n):
        ut = rng.integers(0, N_TOPICS, n)
        on = rng.random((n, H)) < 0.8
        other = (ut[:, None] + rng.integers(1, N_TOPICS, (n, H))) % N_TOPICS
        h_topic = np.where(on, ut[:, None], other)
        hist = topic_mat[h_topic, rng.integers(0, PER_TOPIC, (n, H))]
        neg_t = (ut[:, None] + rng.integers(1, N_TOPICS, (n, NPRATIO))) % N_TOPICS
        neg = topic_mat[neg_t, rng.integers(0, PER_TOPIC, (n, NPRATIO))]
        pos_on = rng.random(n) < TOPIC_CLICK_P
        pos_t = np.where(pos_on, ut, (ut + rng.integers(1, N_TOPICS, n)) % N_TOPICS)
        pos = topic_mat[pos_t, rng.integers(0, PER_TOPIC, n)]
        cand = np.concatenate([neg, pos[:, None]], axis=1)
        order = rng.permuted(np.tile(np.arange(K), (n, 1)), axis=1)
        cand = np.take_along_axis(cand, order, axis=1)
        labels = (order == NPRATIO).astype(np.float32)
        return hist.astype(np.int32), cand.astype(np.int32), labels

    train = impressions(N_TRAIN)
    val = impressions(N_VAL)
    return tokens, train, val


def make_w2v(seed: int = 1) -> np.ndarray:
    """The pretrained word table of the split [VOCAB, EMB] (``make_w2v``)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((VOCAB, EMB)) * 0.1).astype(np.float32)


def auc_from_probs(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mean over impressions of the per-impression AUC of dense [n, K]
    scores (``auc_from_probs``)."""
    r_scores = Ragged.from_dense(np.asarray(probs, np.float32))
    r_labels = Ragged.from_dense(np.asarray(labels, np.float32))
    return float(np.nanmean(per_impression_auc(r_labels, r_scores)))


def learning_rate(bs: int) -> float:
    """The sqrt rule of the recorded runs: 1e-4 * sqrt(bs / 64)."""
    return REF_LR * math.sqrt(bs / REF_BS)


def _launches() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


@torch.no_grad()
def score_tokens(model, hist_tokens: np.ndarray, cand_tokens: np.ndarray, device,
                 chunk: int) -> np.ndarray:
    """Sigmoid scores [n, K] of the model's eval forward over token
    matrices, ``chunk`` impressions at a time."""
    out = []
    with eval_mode(model):
        for s in range(0, hist_tokens.shape[0], chunk):
            batch = {"hist_tokens": torch.as_tensor(hist_tokens[s:s + chunk]).to(device, torch.long),
                     "cand_tokens": torch.as_tensor(cand_tokens[s:s + chunk]).to(device, torch.long)}
            out.append(torch.sigmoid(model(batch)).float().cpu().numpy())
    return np.concatenate(out)


def run(bs: int, seed: int, epochs: int, device="cuda", data=None,
        steps_per_epoch: int | None = None, n_val: int | None = None,
        log=print) -> dict:
    """One recorded run: ``epochs`` epochs at batch ``bs`` with ``seed``
    (the model's init, the epoch permutations and the dropout seeds).
    ``data`` is ``(make_dataset(), make_w2v())`` when given; a smoke run
    may cut the steps per epoch and the validation impressions. Returns
    the AUC and mean loss per epoch, the seconds (training, scoring) and
    each kernel's launches per training step."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    (tokens, (th, tc, ty), (vh, vc, vy)), w2v = data if data is not None else (
        make_dataset(), make_w2v())
    if n_val is not None:
        vh, vc, vy = vh[:n_val], vc[:n_val], vy[:n_val]
    lr = learning_rate(bs)
    hp = HParamsNRMS(title_size=T, history_size=H, head_num=HEADS, head_dim=HEAD_DIM,
                     attention_hidden_dim=ATT, dropout=DROPOUT)
    model = NRMS(hp, vocab_size=VOCAB, word_emb_dim=EMB, dtype=torch.bfloat16,
                 use_fused_encoder=True, device=dev, seed=seed, word_emb_init=w2v)
    trainer = Trainer(model, {"title": tokens}, token_batch,
                      TrainerConfig(learning_rate=lr, seed=seed, dedup_articles=True,
                                    dedup_min_bucket=BUCKET),
                      device=dev, log_fn=lambda s: None)
    vht, vct = tokens[vh], tokens[vc]
    rng = np.random.default_rng(seed)
    n_total = th.shape[0]
    aucs, losses, steps = [], [], 0
    launches = dict.fromkeys(kernel_counters(), 0)
    train_s = score_s = 0.0
    tag = f"[parity_headline bs{bs} lr{lr:g} seed{seed}]"
    for ep in range(epochs):
        order = rng.permutation(n_total)
        starts = range(0, n_total - bs + 1, bs)
        if steps_per_epoch is not None:
            starts = starts[:steps_per_epoch]
        before = _launches()
        t1 = time.perf_counter()
        ep_losses = []
        for s in starts:
            idx = order[s:s + bs]
            ep_losses.append(trainer.train_step({"hist_idx": th[idx], "cand_idx": tc[idx],
                                                 "labels": ty[idx]}))
        loss = float(torch.stack(ep_losses).mean())  # synchronises
        train_s += time.perf_counter() - t1
        after = _launches()
        for name in launches:
            launches[name] += after[name] - before[name]
        steps += len(ep_losses)
        t1 = time.perf_counter()
        probs = score_tokens(model, vht, vct, dev, VAL_CHUNK)
        score_s += time.perf_counter() - t1
        aucs.append(auc_from_probs(probs, vy))
        losses.append(loss)
        log(f"{tag} epoch {ep}: val AUC {aucs[-1]:.4f} loss {loss:.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
    return {"val_auc": aucs, "loss": losses, "lr": lr, "batch": bs, "epochs": epochs,
            "seed": seed, "steps": steps, "train_s": train_s, "score_s": score_s,
            "seconds": time.perf_counter() - t0,
            "launches_per_step": {k: v / max(steps, 1) for k, v in launches.items()}}


def verdict(runs: dict, reference: float = HEADLINE_REFERENCE_AUC) -> dict:
    """The gate per configuration: ``runs`` maps a configuration's name to
    {seed: run}; every seed's final AUC must lie within max(2 x spread,
    0.02) of ``reference``, spread being the seeds' max - min final AUC."""
    out = {}
    for name, by_seed in runs.items():
        finals = {s: r["val_auc"][-1] for s, r in by_seed.items()}
        spread = max(finals.values()) - min(finals.values()) if len(finals) > 1 else 0.0
        tol = max(2 * spread, 0.02)
        gaps = {s: abs(f - reference) for s, f in finals.items()}
        out[name] = {"reference_final_auc": reference, "final_auc": finals, "gap": gaps,
                     "seed_spread": spread, "tolerance": tol,
                     "pass": all(g <= tol for g in gaps.values())}
    return out


def run_all(runs=RUNS, seeds=SEEDS, device="cuda", log=print) -> dict:
    """Every (batch, epochs) of ``runs`` with every seed, and the verdict."""
    data = (make_dataset(), make_w2v())
    results = {f"nrms_fused_bf16_bs{bs}": {f"seed{s}": run(bs, s, ep, device, data, log=log)
                                            for s in seeds}
               for bs, ep in runs}
    return {"runs": results, "verdict": verdict(results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", default=[f"{b}:{e}" for b, e in RUNS],
                    help="batch:epochs of each configuration")
    ap.add_argument("--seeds", nargs="+", type=int, default=list(SEEDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/parity_headline.json")
    a = ap.parse_args(argv)
    resolve_device(a.device)  # no card: raise before the split is made
    runs = tuple(tuple(int(x) for x in r.split(":")) for r in a.runs)
    result = run_all(runs, a.seeds, a.device)
    if a.device != "cpu":
        result["device"] = torch.cuda.get_device_name(resolve_device(a.device))
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    for name, v in result["verdict"].items():
        print(f"{name}: reference {v['reference_final_auc']:.4f} finals {v['final_auc']} "
              f"tolerance {v['tolerance']:.4f} -> {'PASS' if v['pass'] else 'FAIL'}")
    return 0 if all(v["pass"] for v in result["verdict"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
