"""The system under test for NRMS training: the port's ``Trainer.fit`` on
``NRMS(..., use_fused_encoder=True)``, with host dedup, dense
``torch.optim.Adam``, no validation and no checkpoint, fed by the port's
``NewsrecFeed`` over a behaviors ``Table`` of the made data.

``Stream`` hands ``fit`` the feed's epochs one after another, so that one
call to ``fit`` (``epochs=1``) trains until a deadline or for a number of
batches: the prefetch thread's dedup, ``prepare``'s copies, the step and
Adam run as the CLI runs them.

The benchmark's weights replace the model's own at set-up; ``LEAVES``
maps the model's parameters to the reference's names and layouts.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

# model parameter -> (reference name, transposed): the reference keeps x @ W layouts
LEAVES = {}
for _tower in ("news", "user"):
    LEAVES.update({f"{_tower}_self_att.WQ.weight": (f"{_tower}.wq", True),
                   f"{_tower}_self_att.WK.weight": (f"{_tower}.wk", True),
                   f"{_tower}_self_att.WV.weight": (f"{_tower}.wv", True),
                   f"{_tower}_pool.W.weight": (f"{_tower}.w", True),
                   f"{_tower}_pool.W.bias": (f"{_tower}.b", False),
                   f"{_tower}_pool.q.weight": (f"{_tower}.q", False)})
LEAVES["word_embedding.embedding"] = ("emb", False)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Stream:
    """A training feed for ``Trainer.fit``: ``epoch()`` yields the feed's
    batches, its epochs one after another, until ``limit`` batches have
    been yielded or the host clock passes ``deadline`` (whichever is set).
    ``yielded`` counts them; ``kept``, when a list, keeps each batch."""

    def __init__(self, feed):
        self.feed = feed
        self._epoch = 0
        self._it = iter(())
        self.limit: Optional[int] = None
        self.deadline: Optional[float] = None
        self.yielded = 0
        self.kept: Optional[list] = None

    def _next(self) -> dict:
        while True:
            batch = next(self._it, None)
            if batch is not None:
                return batch
            self._it = self.feed.epoch(epoch=self._epoch)
            self._epoch += 1

    def epoch(self, shuffle: bool = True, epoch: Optional[int] = None):
        n = 0
        while ((self.limit is None or n < self.limit)
               and (self.deadline is None or time.perf_counter() < self.deadline)):
            batch = self._next()
            n += 1
            self.yielded += 1
            if self.kept is not None:
                self.kept.append(batch)
            yield batch


class NrmsFit:
    """The port's NRMS trainer for one cell and seed, built from the made
    ``data`` and ``weights`` (the reference's names)."""

    def __init__(self, cfg: dict, mix: dict, data: dict, weights: dict, trainer_seed: int,
                 feed_seed: int, device, log=lambda s: None):
        from ebnerd_tpu_torch.data.dataloader import NewsrecFeed
        from ebnerd_tpu_torch.data.lookup import Lookup
        from ebnerd_tpu_torch.data.ragged import Ragged
        from ebnerd_tpu_torch.data.table import Table
        from ebnerd_tpu_torch.models import NRMS, HParamsNRMS, token_batch
        from ebnerd_tpu_torch.training import Trainer, TrainerConfig

        t = time.perf_counter()
        self.laps = {}  # set-up stage -> host seconds
        self.batch_size = mix["batch_size"]
        hp = HParamsNRMS(title_size=cfg["title_size"], history_size=mix["history_size"],
                         dropout=cfg["dropout"], learning_rate=cfg["learning_rate"],
                         head_num=cfg["head_num"], head_dim=cfg["head_dim"],
                         attention_hidden_dim=cfg["attention_hidden_dim"])
        model = NRMS(hp, vocab_size=cfg["vocab_size"], word_emb_dim=cfg["word_emb_dim"],
                     dtype=DTYPES[cfg["compute_dtype"]], use_fused_encoder=True, device=device)
        self.params = dict(model.named_parameters())
        if set(self.params) != set(LEAVES):
            raise ValueError(f"NRMS's parameters {sorted(self.params)} are not {sorted(LEAVES)}")
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(self._port_layout(name, weights).reshape(p.shape))
        t = self._lap("model", t)
        lookup = Lookup.from_values(data["ids"], data["tokens"])
        ids = data["ids"]
        table = Table({
            "article_id_fixed": Ragged.from_dense(ids[data["hist"]]),
            "article_ids_inview": Ragged.from_dense(ids[data["cand"]]),
            "labels": Ragged.from_dense(data["labels"].astype(np.int8)),
        })
        feed = NewsrecFeed(table, lookup, history_size=mix["history_size"],
                           batch_size=self.batch_size, seed=feed_seed)
        self.stream = Stream(feed)
        t = self._lap("feed", t)
        self.trainer = Trainer(model, {"title": lookup.matrix}, token_batch,
                               TrainerConfig(learning_rate=cfg["learning_rate"],
                                             seed=trainer_seed, dedup_articles=True),
                               device=device, log_fn=log)
        self._lap("trainer", t)

    def _lap(self, stage: str, t: float) -> float:
        now = time.perf_counter()
        self.laps[stage] = now - t
        return now

    @staticmethod
    def _port_layout(name: str, weights: dict) -> torch.Tensor:
        ref, transposed = LEAVES[name]
        return weights[ref].T if transposed else weights[ref]

    def fit(self, limit: Optional[int] = None, deadline: Optional[float] = None) -> float:
        """One ``fit`` call over the next ``limit`` batches or until
        ``deadline``; returns its mean loss (reading it synchronises)."""
        self.stream.limit, self.stream.deadline = limit, deadline
        self.trainer.fit(self.stream, epochs=1)
        return float(self.trainer.history[-1]["loss"])

    def first_steps(self, weights: dict, steps: int = 3) -> dict:
        """Drive the first ``steps`` steps through ``fit``, one batch a
        call, and read what the reference is compared on: each step's loss,
        each weight's first gradient as Adam got it (its first moment after
        one step over 1 - beta1), and each weight's change after the last
        step, by the reference's names. A weight the optimizer holds no
        moment for got no gradient: it reads 0."""
        opt = self.trainer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        losses, grad_norms = [], {}
        for i in range(steps):
            losses.append(self.fit(limit=1))
            if i == 0:
                grad_norms = {LEAVES[n][0]: float(opt.state[p]["exp_avg"].norm() / (1.0 - beta1))
                              if "exp_avg" in opt.state[p] else 0.0
                              for n, p in self.params.items()}
        with torch.no_grad():
            change = {LEAVES[n][0]: float((p - self._port_layout(n, weights)).norm())
                      for n, p in self.params.items()}
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    def window(self, seconds: float) -> dict:
        """Train through one ``fit`` call until ``seconds`` have passed on the
        host clock (the batches the prefetch thread holds then run too);
        ``fit`` returns once its mean loss is read, which synchronises."""
        n0 = self.stream.yielded
        t0 = time.perf_counter()
        loss = self.fit(deadline=t0 + seconds)
        dt = time.perf_counter() - t0
        steps = self.stream.yielded - n0
        return {"start": t0, "seconds": dt, "steps": steps, "finite": bool(np.isfinite(loss)),
                "metrics": {"train_imp_s": steps * self.batch_size / dt}}

    def instrument(self, host_spans: dict) -> None:
        """For a traced window: the host clock around each host dedup
        (``Trainer._prep_host``, on the prefetch thread) into
        ``host_spans["dedup"]``, host ranges ``fit.prepare`` and ``fit.step``
        around the main thread's calls, and the window's batches kept."""
        trainer = self.trainer
        prep, prepare, step = trainer._prep_host, trainer.prepare, trainer.step
        spans = host_spans.setdefault("dedup", [])

        def timed_prep(raw):
            t = time.perf_counter()
            out = prep(raw)
            spans.append(time.perf_counter() - t)
            return out

        def ranged(name, fn):
            def call(arg):
                with torch.profiler.record_function(name):
                    return fn(arg)
            return call

        trainer._prep_host = timed_prep
        trainer.prepare = ranged("fit.prepare", prepare)
        trainer.step = ranged("fit.step", step)
        self.stream.kept = []


System = NrmsFit
