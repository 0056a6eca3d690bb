"""Training loop with the reference's callback semantics (counterpart of
``TrainerConfig`` and ``Trainer`` in ``ebnerd_tpu/training/trainer.py``).

One step: host dedup of the index batch (when on), the batch build on the
device (``models/inputs.py``), the model's logits in training mode, the
loss (+ optional L2), ``backward()`` and dense Adam. Adam uses optax's
defaults, betas (0.9, 0.999) and eps 1e-8; the learning rate lives in the
optimizer's ``param_groups``, the counterpart of the JAX trainer's
injected hyperparameter. Dropout masks come from one 64-bit seed per
step, drawn from a generator seeded with ``config.seed``.
``accumulation_steps`` = k averages the gradients of k micro-batches into
one Adam update, as ``optax.MultiSteps`` does; Adam's count advances per
update.

``fit`` runs epochs of steps (host dedup ``config.prefetch`` batches ahead
on a worker thread), scores the validation feed after each epoch, keeps
the best weights by val AUC, stops early and lowers the learning rate on
a plateau, checkpoints and resumes (``training/checkpoint.py``), and
restores the best weights at the end. ``score`` runs the full forward or
the two towers of ``serving.py``, in eval mode.

Not ported yet: ``scan_steps`` (ROADMAP A5), row-sparse embeddings (A12)
and a bf16 Adam first moment (A3, A5); ``rng_impl`` chooses XLA's random
bit generator and has no counterpart.
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.dataloader import EvalFeed, NewsrecFeed
from ..data.ragged import Ragged
from ..evaluation.ranking import per_impression_auc
from ..models.inputs import device_tables
from ..serving import ScoreWindow, article_validity, encode_corpus, eval_mode, model_kind
from ..serving import two_tower_scores
from .checkpoint import CheckpointManager, restore_checkpoint
from .dedup import dedup_capable, prep_dedup_batch
from .losses import l2_penalty, loss_fn_for

__all__ = ["Trainer", "TrainerConfig"]


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    loss: str = "cross_entropy_loss"
    optimizer: str = "adam"
    l2_regularization: float = 0.0
    # callbacks (reference defaults: ebnerd_nrms.py:216-237)
    early_stopping_patience: Optional[int] = 4
    monitor_mode: str = "max"  # val_auc
    lr_factor: float = 0.2
    lr_patience: Optional[int] = 2
    min_lr: float = 1e-6
    seed: int = 42
    # apply the optimizer every N micro-batches, on their mean gradient
    accumulation_steps: int = 1
    # batches host-deduped ahead of the running step on a worker thread
    prefetch: int = 2
    # N steps per dispatch (ROADMAP A5)
    scan_steps: int = 1
    # eval path: "auto" scores through the two towers of serving.py when
    # the family has them; True forces them; False runs the full forward
    two_tower_eval: Any = "auto"
    # row-sparse word-embedding updates (ROADMAP A12)
    sparse_embedding: bool = False
    # train-time unique-article dedup (training/dedup.py): "auto" = on
    # whenever dedup_capable(model) says so; True forces; False per slot
    dedup_articles: Any = "auto"
    dedup_min_bucket: int = 512
    # dtype of Adam's first moment; None = fp32 (ROADMAP A3, A5)
    adam_mu_dtype: Optional[str] = None


_UNPORTED = (("scan_steps", 1, "A5"), ("sparse_embedding", False, "A12"),
             ("adam_mu_dtype", None, "A3, A5"))
# batch entries read on the host, never copied to the device
_HOST_KEYS = ("n_uniq", "art_n_uniq", "rows", "n_valid")


def _pinned(raw: dict) -> dict:
    """The batch's arrays in pinned host memory, so the step's copies to
    the card run without blocking the host."""
    return {k: torch.from_numpy(v).pin_memory()
            if isinstance(v, np.ndarray) and k not in _HOST_KEYS else v
            for k, v in raw.items()}


def _prefetched(items, depth: int):
    """Run the generator ``items`` ``depth`` items ahead on a worker
    thread. An exception in the worker is raised here, in order; a
    consumer that stops early stops the worker."""
    if depth <= 0:
        yield from items
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def worker():
        try:
            for item in items:
                # bounded put with a stop check, so a consumer that bails
                # mid-epoch does not leave this thread blocked forever
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer's thread
            q.put((done, e))
            return
        q.put((done, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                break
            yield item
    finally:
        stop.set()
        while not q.empty():  # release staged batches
            try:
                q.get_nowait()
            except queue.Empty:
                break


class Trainer:
    """Trains and scores one newsrec model.

    Args:
      model: an ``nn.Module`` whose ``forward(batch)`` returns [B, K]
        logits (``models/newsrec.py``), its parameters on ``device``.
      tables: dict of value tables (numpy or tensors), moved to ``device``
        once (``models/inputs.py`` convention).
      batch_builder: gathers model inputs from tables + an index batch.
      log_fn: where ``fit`` reports each epoch.
    """

    def __init__(self, model: torch.nn.Module, tables: dict, batch_builder,
                 config: TrainerConfig = TrainerConfig(), device="cuda",
                 log_fn: Callable[[str], None] = print):
        for name, default, item in _UNPORTED:
            if getattr(config, name) != default:
                raise NotImplementedError(
                    f"TrainerConfig.{name}={getattr(config, name)!r} is not ported yet "
                    f"(ROADMAP {item})")
        if config.optimizer != "adam":
            raise ValueError(f"this optimizer not defined {config.optimizer}")
        if config.accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {config.accumulation_steps}")
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.builder = batch_builder
        self.log = log_fn
        self.tables = device_tables(tables, self.device)
        dedup_ok, why = dedup_capable(model)
        if config.dedup_articles is True and not dedup_ok:
            raise ValueError(f"dedup_articles: {type(model).__name__}: {why}")
        self.dedup = dedup_ok if config.dedup_articles == "auto" else bool(config.dedup_articles)
        self.loss_fn = loss_fn_for(config.loss)
        self.optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.seeds = torch.Generator().manual_seed(config.seed)
        self.step_count = 0
        self._micro = 0  # micro-batches accumulated toward the next update
        self._art_cache: Optional[tuple] = None  # (step_count, article vectors)
        self.history: list[dict[str, float]] = []

    # -- state ------------------------------------------------------------

    def state_dict(self) -> dict:
        """Everything a resumed run needs: parameters, optimizer state, step
        count, the seed generator and any partly accumulated gradients."""
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "step": self.step_count, "seeds": self.seeds.get_state(), "micro": self._micro}
        if self._micro:
            state["grads"] = {k: p.grad for k, p in self.model.named_parameters()
                              if p.grad is not None}
        return state

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        opt = state["optimizer"]
        # Adam keeps its step count on the CPU (not capturable, not fused)
        opt = dict(opt, state={i: {k: v.cpu() if k == "step" else v for k, v in s.items()}
                               for i, s in opt["state"].items()})
        self.optimizer.load_state_dict(opt)
        self.step_count = int(state["step"])
        self.seeds.set_state(state["seeds"].cpu())
        self._micro = int(state.get("micro", 0))
        grads = state.get("grads", {})
        for k, p in self.model.named_parameters():
            p.grad = grads[k].to(p.device).clone() if k in grads else None
        self._art_cache = None

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _snapshot(self) -> dict:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    # -- steps ------------------------------------------------------------

    def next_seed(self) -> int:
        """The next step's 64-bit dropout seed."""
        lo, hi = torch.randint(0, 1 << 32, (2,), generator=self.seeds).tolist()
        return (hi << 32) | lo

    def prepare(self, raw: dict) -> dict:
        """Host dedup (when on) and the batch build on the device: an index
        batch (numpy arrays or host tensors) -> the model batch plus
        ``labels`` on the device."""
        if self.dedup and "hist_idx" in raw:
            raw = prep_dedup_batch(raw, self.config.dedup_min_bucket)
        batch = self.builder(self.tables, raw)
        labels = raw["labels"]
        labels = labels if isinstance(labels, torch.Tensor) else torch.as_tensor(np.asarray(labels))
        batch["labels"] = labels.to(self.device, torch.float32, non_blocking=True)
        return batch

    def step(self, batch: dict) -> torch.Tensor:
        """One micro-batch on a prepared batch; the optimizer steps every
        ``accumulation_steps`` of them, on their mean gradient. Returns the
        loss (a device scalar: reading it synchronises)."""
        self.model.train()
        k = self.config.accumulation_steps
        if self._micro == 0:
            self.optimizer.zero_grad(set_to_none=True)
        batch = dict(batch, dropout_seed=self.next_seed())
        logits = self.model(batch)
        loss = self.loss_fn(logits, batch["labels"])
        if self.config.l2_regularization:
            loss = loss + self.config.l2_regularization * l2_penalty(self.model)
        (loss / k if k > 1 else loss).backward()
        self._micro += 1
        if self._micro == k:
            self.optimizer.step()
            self._micro = 0
        self.step_count += 1
        return loss.detach()

    def train_step(self, raw: dict) -> torch.Tensor:
        """``step(prepare(raw))``."""
        return self.step(self.prepare(raw))

    # -- loops ------------------------------------------------------------

    def _run_epoch(self, train_feed: NewsrecFeed, steps_per_epoch: Optional[int],
                   epoch: Optional[int] = None, scalar_logger=None,
                   log_every: Optional[int] = None) -> list[torch.Tensor]:
        """One epoch of train steps; the host dedup (and pinning, on the
        card) runs ``config.prefetch`` batches ahead on a worker thread,
        and the copies to the card are issued by ``prepare`` on the stream
        that runs the step. ``epoch`` pins the feed's shuffle order (resume
        support); ``scalar_logger`` + ``log_every`` emit a
        ``train/loss_step`` scalar every N steps (each one synchronises)."""
        it = train_feed.epoch() if epoch is None else train_feed.epoch(epoch=epoch)
        if steps_per_epoch is not None:
            it = itertools.islice(it, steps_per_epoch)
        step0 = self.step_count
        pin = self.device.type == "cuda"

        def work():
            for raw in it:
                if self.dedup:
                    raw = prep_dedup_batch(raw, self.config.dedup_min_bucket)
                yield _pinned(raw) if pin else raw

        losses: list[torch.Tensor] = []
        for raw in _prefetched(work(), self.config.prefetch):
            losses.append(self.step(self.prepare(raw)))
            if scalar_logger is not None and log_every and len(losses) % log_every == 0:
                scalar_logger.log("train/loss_step", float(losses[-1]),
                                  step=step0 + len(losses))
        return losses

    def _resume(self, ckpt_dir: Path, mgr: CheckpointManager):
        """(start epoch, best metric, best weights, es_wait, lr_wait, lr)
        from ``meta.json`` and the checkpoint of the epoch it names, or
        None when there is nothing to resume from."""
        meta_path = ckpt_dir / "meta.json"
        if not meta_path.exists():
            return None
        # restore the epoch META names (not the newest on disk): a kill
        # between the state save and the meta write leaves a newer state
        # with stale callback metadata; the previous pair is consistent
        meta = json.loads(meta_path.read_text())
        epoch = int(meta["epoch"])
        if not (ckpt_dir / f"step_{epoch}").exists():
            self.log(f"[trainer] resume: step_{epoch} missing; starting from scratch")
            return None
        self.load_state_dict(restore_checkpoint(self, ckpt_dir, step=epoch))
        best_metric = float(meta["best_metric"])
        lr = float(meta["lr"])
        self.history = list(meta["history"])
        self._set_lr(lr)
        self.seeds.set_state(torch.tensor(meta["seeds"], dtype=torch.uint8))
        best = None
        if np.isfinite(best_metric) and (ckpt_dir / "best").exists():
            best = mgr.restore_best(self)["model"]
        self.log(f"[trainer] resumed from epoch {epoch} (next: {epoch + 1}, "
                 f"best {best_metric:.5f})")
        return epoch + 1, best_metric, best, int(meta["es_wait"]), int(meta["lr_wait"]), lr

    def fit(self, train_feed: NewsrecFeed, val_feed: Optional[EvalFeed] = None,
            val_labels: Optional[Ragged] = None, epochs: int = 1,
            steps_per_epoch: Optional[int] = None, scalar_logger=None, ckpt_dir=None,
            resume: bool = False, log_every_steps: int = 50) -> list[dict[str, float]]:
        """Epoch loop with val-AUC monitoring, best-weights restore, early
        stopping and LR plateau reduction (the JAX ``Trainer.fit``).

        ``ckpt_dir`` saves the full state after every epoch (``step_<epoch>``,
        the newest 3 kept), a ``best`` checkpoint at every improvement, and
        then ``meta.json`` with the callback state (epoch, best metric,
        patience counters, lr, history, the seed generator). ``resume=True``
        continues from the epoch ``meta.json`` names, exactly as an
        uninterrupted run would: same shuffle order, dropout seeds and
        callback decisions."""
        cfg = self.config
        best_metric = -np.inf if cfg.monitor_mode == "max" else np.inf
        best = self._snapshot()
        es_wait = lr_wait = 0
        lr = cfg.learning_rate
        start_epoch = 0
        mgr = None
        if ckpt_dir is not None:
            ckpt_dir = Path(ckpt_dir)
            mgr = CheckpointManager(ckpt_dir)
            resumed = self._resume(ckpt_dir, mgr) if resume else None
            if resumed is not None:
                start_epoch, best_metric, best_r, es_wait, lr_wait, lr = resumed
                best = best_r if best_r is not None else self._snapshot()

        validate = val_feed is not None and val_labels is not None
        for epoch in range(start_epoch, epochs):
            losses = self._run_epoch(train_feed, steps_per_epoch, epoch=epoch,
                                     scalar_logger=scalar_logger, log_every=log_every_steps)
            mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            record = {"epoch": epoch, "loss": mean_loss, "lr": lr}
            stop = False
            if validate:
                scores = self.score(val_feed)
                # single-class impressions have no AUC (NaN) and are skipped,
                # as the JAX trainer does
                val_auc = float(np.nanmean(per_impression_auc(val_labels, scores)))
                record["val_auc"] = val_auc
                better = val_auc > best_metric if cfg.monitor_mode == "max" else val_auc < best_metric
                if better:
                    best_metric, es_wait, lr_wait = val_auc, 0, 0
                    best = self._snapshot()
                    if mgr is not None:
                        mgr.save_best(self)
                else:
                    es_wait += 1
                    lr_wait += 1
                    if cfg.lr_patience is not None and lr_wait >= cfg.lr_patience:
                        lr = max(lr * cfg.lr_factor, cfg.min_lr)
                        self._set_lr(lr)
                        lr_wait = 0
                        self.log(f"[trainer] reduce lr -> {lr:g}")
                    if (cfg.early_stopping_patience is not None
                            and es_wait >= cfg.early_stopping_patience):
                        stop = True
            self.history.append(record)
            if mgr is not None:
                # the state first, then its metadata: a kill between the
                # two resumes from the previous consistent pair
                mgr.save_step(self, epoch)
                (ckpt_dir / "meta.json").write_text(json.dumps({
                    "epoch": epoch, "best_metric": float(best_metric), "es_wait": es_wait,
                    "lr_wait": lr_wait, "lr": lr, "history": self.history,
                    "seeds": self.seeds.get_state().tolist()}))
            if scalar_logger is not None:
                scalar_logger.log_dict(
                    {f"val/{k}" if k.startswith("val") else f"train/{k}": v
                     for k, v in record.items() if k != "epoch"}, step=epoch)
            self.log(f"[trainer] {record}")
            if stop:
                self.log("[trainer] early stopping; restoring best weights")
                break
        if validate:
            self.model.load_state_dict(best)
            # the step count is unchanged by the restore, so the step-keyed
            # article vectors would pair final-epoch articles with
            # best-epoch user towers
            self._art_cache = None
        return self.history

    # -- scoring ----------------------------------------------------------

    def score(self, feed: EvalFeed, two_tower=None) -> Ragged:
        """Sigmoid scores aligned with the feed's inview lists, in eval mode,
        at most ``serving.EVAL_WINDOW`` batches in flight.

        With ``two_tower`` (default: ``config.two_tower_eval``) the corpus is
        encoded once through the article tower and impressions are scored by
        the user tower (``serving.py``): the same logits as the full forward."""
        if two_tower is None:
            two_tower = self.config.two_tower_eval
        supported = model_kind(self.model) is not None
        if two_tower is True and not supported:
            raise ValueError(f"{type(self.model).__name__} does not support two-tower scoring")
        if supported if two_tower == "auto" else bool(two_tower):
            return two_tower_scores(self.model, self._article_index(),
                                    article_validity(self.tables), feed)
        window = ScoreWindow(np.zeros((feed.n_rows, feed.width), np.float32))
        with eval_mode(self.model), torch.no_grad():
            for raw in feed.batches():
                window.push(raw["rows"], torch.sigmoid(self.model(self.builder(self.tables, raw)))
                            .float())
        return feed.unpad(window.drain())

    def _article_index(self) -> torch.Tensor:
        """The [V+1, D] corpus encoding at the current parameters, cached on
        the step count so repeated ``score()`` calls at fixed parameters
        (chunked test inference) encode the corpus once."""
        if self._art_cache is not None and self._art_cache[0] == self.step_count:
            return self._art_cache[1]
        vecs = encode_corpus(self.model, self.tables, 4096)
        self._art_cache = (self.step_count, vecs)
        return vecs
