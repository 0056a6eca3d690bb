"""Host-deduped row-sparse word-embedding updates and row-wise Adam
(counterpart of ``ebnerd_tpu/training/sparse_embed.py``, with its names).

The word table ([V, E] fp32; xlm-roberta-large: 250,002 x 1,024) is the
largest parameter. Its dense update writes a [V, E] gradient and sweeps
Adam over the table and both moments on every step, however few rows the
batch touches. The sparse mode touches only the batch's rows:

  host:    the batch's articles -> unique vocabulary ids [C] (zero-padded
           to a size bucket) + a [V] -> slot remap, so the model embeds
           compact slots (``prep_sparse_batch``, on the prefetch thread)
  device:  gather those rows of the table, differentiate w.r.t. the
           compact rows, row-wise Adam on them and write them back
           (``rowwise_adam``); the [V, E] parameter gets no gradient.

Semantics (the JAX module's, kept exactly): untouched rows keep stale
Adam moments and receive no update (LazyAdam-style row-sparse Adam). The
reference's Keras Adam decays every row's moments and updates every row,
as dense Adam on a zero-filled gradient does; the dense default
(``TrainerConfig.sparse_embedding=False``) is the reference-parity path.
From zero moments the two agree until a row is touched at one step and
skipped at a later one.

Whether this mode is faster than the dense sweep depends on the card and
the token statistics; the H100's numbers are in ``PERF.md``, measured by
``tools/embed_grad.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["TOKEN_KEYS_BY_TABLE", "bucket_size", "prep_sparse_batch", "rowwise_adam"]

# table name -> batch keys (builder outputs) whose values are token ids
# embedded through the shared word table (models/inputs.py); the uniq_*
# keys are the article-deduped variants (training/dedup.py)
TOKEN_KEYS_BY_TABLE = {
    "title": ("hist_tokens", "cand_tokens", "uniq_tokens"),
    "body": ("hist_body", "cand_body", "uniq_body"),
}


def bucket_size(n: int, minimum: int = 4096) -> int:
    """Next power-of-two multiple of ``minimum`` at or above ``n``."""
    c = minimum
    while c < n:
        c *= 2
    return c


def prep_sparse_batch(raw: dict, host_tables: dict, table_names: Sequence[str],
                      vocab_size: int, min_bucket: int = 4096) -> dict:
    """Host dedup of the vocabulary rows an index batch touches; attaches

      emb_uniq  [C] int32  touched row ids, ascending, zero-padded to a size bucket
      emb_valid [C] f32    1 for real entries, 0 for pad
      emb_remap [V] int32  vocab id -> compact slot (defined on touched ids)

    to a copy of ``raw``. The touched set is computed from the batch's
    unique articles (``hist_idx`` and ``cand_idx``), whose tokens are the
    same set as the tokens of all the slots: the result equals the JAX
    function's, which reads every slot's tokens, bit for bit."""
    idx = np.concatenate([np.asarray(raw["hist_idx"]).ravel(),
                          np.asarray(raw["cand_idx"]).ravel()])
    n_rows = len(host_tables[table_names[0]])
    art_seen = np.zeros(n_rows, dtype=bool)
    art_seen[idx] = True
    arts = np.flatnonzero(art_seen)
    seen = np.zeros(vocab_size, dtype=bool)
    for name in table_names:
        seen[host_tables[name][arts].ravel()] = True
    uniq = np.flatnonzero(seen).astype(np.int32)
    c = bucket_size(len(uniq), min_bucket)
    uniq_pad = np.zeros(c, np.int32)
    uniq_pad[: len(uniq)] = uniq
    valid = np.zeros(c, np.float32)
    valid[: len(uniq)] = 1.0
    remap = np.zeros(vocab_size, np.int32)
    remap[uniq] = np.arange(len(uniq), dtype=np.int32)
    out = dict(raw)
    out["emb_uniq"] = uniq_pad
    out["emb_valid"] = valid
    out["emb_remap"] = remap
    return out


@torch.no_grad()
def rowwise_adam(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, uniq: torch.Tensor,
                 g_rows: torch.Tensor, lr: float, step: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam update of the rows ``uniq`` of ``table`` and its moments
    ``m`` and ``v`` ([V, E] fp32), in place, with the JAX function's
    formula and order of operations. ``g_rows`` [C, E] is the gradient of
    the compact rows, ``step`` the 1-based update count (optax's count
    after its increment), ``lr`` the learning rate.

    ``uniq`` holds the real ids only: the caller cuts ``prep_sparse_batch``'s
    zero-padded bucket to its valid count, which the host knows, so no pad
    slot reaches the card. That gives the JAX function's result, whose pads
    add masked zeros. Every write is an ``index_add_`` of a delta all the
    same, never a copy, whose order on a repeated index is unspecified."""
    rows_m = m.index_select(0, uniq)
    rows_v = v.index_select(0, uniq)
    g32 = g_rows.float()
    m_new = rows_m * b1 + g32 * (1.0 - b1)
    v_new = rows_v * b2 + g32 * (1.0 - b2) * g32
    # bias corrections in fp32, as the JAX function computes b ** t
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    upd = (m_new / bc1).mul_(np.float32(lr)).div_((v_new / bc2).sqrt_().add_(eps))
    table.index_add_(0, uniq, upd.neg_())
    m.index_add_(0, uniq, m_new.sub_(rows_m))
    v.index_add_(0, uniq, v_new.sub_(rows_v))
