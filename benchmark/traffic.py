"""The one traffic generator: a mix's parameters (a file under
``traffic/``) and a seed -> the made behaviors and articles.

A training mix is a closed loop: the trainer takes the next batch when it
has finished the last. The behaviors are ``table_batches`` x
``batch_size`` impressions, each with ``history_size`` clicked articles
and ``npratio`` + 1 candidates of which one, at a random position, is the
click. Article popularity is Zipf(``article_zipf``) over a shuffled
order of ranks, and so are the title tokens over the vocabulary
(``token_zipf``), as the port's ``bench.py`` draws them (``zipf_indices``,
``token_table``). Draws come from the truncated Zipf law itself by its
inverse distribution function (the law that ``bench.py``'s rejection of
ranks past the table samples), on the device from a ``torch.Generator``
seeded with the run's seed: 18 M draws take seconds on the host.

Every seed gets the same sizes; only the draws differ. The same seed on
the same kind of device gives the same data.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["zipf_indices", "token_table", "make"]


def zipf_indices(gen: torch.Generator, n: int, shape: tuple, a: float) -> torch.Tensor:
    """Draws from [0, n) with Zipf(a) popularity (P(rank k) proportional to
    k ** -a, k = 1..n) over a shuffled rank order; int32 on the generator's
    device."""
    dev = gen.device
    cdf = torch.cumsum(torch.arange(1, n + 1, dtype=torch.float64, device=dev) ** -a, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(shape, dtype=torch.float64, generator=gen, device=dev)
    ranks = torch.searchsorted(cdf, u, right=True).clamp_max_(n - 1)
    return torch.randperm(n, generator=gen, device=dev).to(torch.int32)[ranks]


def token_table(gen: torch.Generator, n_articles: int, width: int, vocab: int,
                a: float) -> torch.Tensor:
    """[n_articles, width] title tokens, Zipf(a) over a shuffled vocabulary."""
    return zipf_indices(gen, vocab, (n_articles, width), a)


def make(mix: dict, cfg: dict, seed: int, device="cpu") -> dict:
    """The made data of one run, as numpy arrays: ``ids`` [articles] int64
    article ids, ``tokens`` [articles, T] int32, ``hist`` [R, H] and
    ``cand`` [R, K] int32 article indices (positions in ``ids``),
    ``labels`` [R, K] float32 one-hot. Drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    n = mix["articles"]
    k = mix["npratio"] + 1
    rows = mix["table_batches"] * mix["batch_size"]
    tokens = token_table(gen, n, cfg["title_size"], cfg["vocab_size"], mix["token_zipf"])
    hist = zipf_indices(gen, n, (rows, mix["history_size"]), mix["article_zipf"])
    cand = zipf_indices(gen, n, (rows, k), mix["article_zipf"])
    labels = torch.zeros((rows, k), dtype=torch.float32, device=device)
    labels[torch.arange(rows, device=device),
           torch.randint(0, k, (rows,), generator=gen, device=device)] = 1.0
    ids = mix["article_id_base"] + np.arange(n, dtype=np.int64)
    return {"ids": ids, "tokens": tokens.cpu().numpy(), "hist": hist.cpu().numpy(),
            "cand": cand.cpu().numpy(), "labels": labels.cpu().numpy()}
