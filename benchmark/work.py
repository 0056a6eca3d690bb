"""The model's work, counted from a cell's shapes and the batch itself,
whatever implements it: floating-point operations of the model's own
products and the bytes of each call's inputs and outputs, each counted
once. The forward is counted once, the backward as twice the forward; no
recompute and no extra passes of any implementation (3xTF32's among them)
are counted. ``article_flops``, ``user_flops`` and ``step_flops`` are the
port's ``bench.py`` count, with the history as an argument.

Peaks are ``peaks.json``'s: the card's dense tensor rate for the compute
dtype and its memory bandwidth.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = Path(__file__).resolve().parent / "peaks.json"
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def peaks(card: str) -> dict:
    """The peaks of the card called ``card``: the first entry of
    ``peaks.json`` whose ``match`` is in the name, else its default."""
    table = json.loads(PEAKS.read_text())
    for entry in table["cards"]:
        if entry["match"] in card:
            return entry
    return next(e for e in table["cards"] if e["match"] == table["default"])


def dims(cfg: dict, mix: dict) -> dict:
    return {"t": cfg["title_size"], "e": cfg["word_emb_dim"], "h": mix["history_size"],
            "d": cfg["head_num"] * cfg["head_dim"], "heads": cfg["head_num"],
            "a": cfg["attention_hidden_dim"], "k": mix["npratio"] + 1,
            "dtype": cfg["compute_dtype"], "es": ITEMSIZE[cfg["compute_dtype"]]}


def encoder_fwd_flops(t: int, din: int, d: int, a: int) -> float:
    """One article (or user) through the encoder, forward: the QKV
    products, the attention's two products, the pooling's two."""
    return 3 * t * din * d * 2 + 2 * t * t * d * 2 + t * d * a * 2 + t * a * 2


def article_flops(x: dict) -> float:
    return encoder_fwd_flops(x["t"], x["e"], x["d"], x["a"])


def user_flops(x: dict) -> float:
    return encoder_fwd_flops(x["h"], x["d"], x["d"], x["a"])


def n_unique(batch: dict) -> int:
    """The batch's valid unique articles, by the benchmark's own
    ``np.unique`` over its history and candidate slots."""
    return len(np.unique(np.concatenate([np.asarray(batch["hist_idx"]).reshape(-1),
                                         np.asarray(batch["cand_idx"]).reshape(-1)])))


def step_flops(x: dict, batch_rows: int, uniq: int) -> float:
    """A training step's model FLOPs: forward x 3 (the backward twice the
    forward) over the unique articles, the users and the logits."""
    return 3.0 * (uniq * article_flops(x) + batch_rows * user_flops(x)
                  + batch_rows * x["k"] * x["d"] * 2)


def encoder_calls(n: int, t: int, din: int, d: int, a: int, es: int) -> list:
    """[(flops, bytes) forward, (flops, bytes) backward] of one encoder call
    over n items. Forward: x [n, t, din] and the weights in, [n, d] fp32
    out. Backward: x, the weights and the cotangent [n, d] fp32 in, dx and
    the weights' gradients (fp32) out."""
    weights = 3 * din * d + d * a + 2 * a
    x_bytes = n * t * din * es
    fwd = (n * encoder_fwd_flops(t, din, d, a), x_bytes + weights * es + n * d * 4)
    bwd = (2.0 * fwd[0], 2 * x_bytes + weights * es + n * d * 4 + weights * 4)
    return [fwd, bwd]


def attention_calls(n: int, t: int, d: int, es: int) -> list:
    """[(flops, bytes) forward, (flops, bytes) backward] of the attention
    (the scores and their product with V) over n items of t rows: forward
    Q, K, V in and O out; backward Q, K, V and dO in, dQ, dK and dV out."""
    fwd = n * 2 * t * t * d * 2
    return [(fwd, n * t * d * es * 4), (2.0 * fwd, n * t * d * es * 7)]


def least_s(calls: list, dtype: str, peak: dict) -> float:
    """The least time of ``calls``: for each, the larger of its operations
    over the dtype's peak and its bytes over the bandwidth."""
    return sum(max(f / peak["flops"][dtype], b / peak["bytes_per_s"]) for f, b in calls)


def encoder_least_s(x: dict, batch_rows: int, uniq: int, peak: dict) -> float:
    """The encoder's least time in one step: both towers, forward and
    backward (the news tower over the batch's unique articles)."""
    calls = (encoder_calls(uniq, x["t"], x["e"], x["d"], x["a"], x["es"])
             + encoder_calls(batch_rows, x["h"], x["d"], x["d"], x["a"], x["es"]))
    return least_s(calls, x["dtype"], peak)


def user_attention_least_s(x: dict, batch_rows: int, peak: dict) -> float:
    """The user tower's attention, forward and backward, at its least."""
    return least_s(attention_calls(batch_rows, x["h"], x["d"], x["es"]), x["dtype"], peak)
