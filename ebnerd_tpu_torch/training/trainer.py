"""Training loop with the reference's callback semantics (counterpart of
``TrainerConfig`` and ``Trainer`` in ``ebnerd_tpu/training/trainer.py``).

One step: host dedup of the index batch (when on), the batch build on the
device (``models/inputs.py``), the model's logits in training mode, the
loss (+ optional L2), ``backward()`` and dense Adam. Adam uses optax's
defaults, betas (0.9, 0.999) and eps 1e-8; the learning rate lives in the
optimizer's ``param_groups``, the counterpart of the JAX trainer's
injected hyperparameter. ``adam_mu_dtype`` (e.g. "bfloat16") keeps Adam's
first moment in that dtype (``training/adam.py``, optax's ``mu_dtype``);
None keeps ``torch.optim.Adam``. Dropout masks come from one 64-bit seed
per step, drawn from a generator seeded with ``config.seed``.
``accumulation_steps`` = k averages the gradients of k micro-batches into
one Adam update, as ``optax.MultiSteps`` does; Adam's count advances per
update.

``sparse_embedding`` updates only the word-table rows a batch touches
(``training/sparse_embed.py``; LazyAdam semantics, the JAX trainer's):
the host finds the batch's vocabulary rows before the article dedup, the
token keys are remapped to slots on the device, the step gathers those
rows of the table into a leaf the model embeds from (``WordEmbed``'s
``rows``, gathered from the detached table), and after the dense
optimizer ``rowwise_adam`` updates them and the table's own moments
(fp32, whatever ``adam_mu_dtype`` is) in place at the same learning rate.
The table is always the model's ``word_embedding``; it gets no gradient
and is outside the dense optimizer; it stays in the model's state, and
``state_dict`` carries its moments.

``fit`` runs epochs of steps (host dedup ``config.prefetch`` batches ahead
on a worker thread), scores the validation feed after each epoch, keeps
the best weights by val AUC, stops early and lowers the learning rate on
a plateau, checkpoints and resumes (``training/checkpoint.py``), and
restores the best weights at the end. ``score`` runs the full forward or
the two towers of ``serving.py``, in eval mode.

``scan_steps`` = N (the JAX trainer's ``lax.scan`` of N steps in one
dispatch) runs groups of N batches. The prefetch thread does their host
prep, pads the group to one dedup bucket (``pad_dedup_to``) and packs it
into one buffer (pinned on the card; ``pack_group``). ``run_group`` draws
one 64-bit seed per group; step i of the group takes ``step_seed(seed,
step_count + i)`` (JAX folds its group key with the step count). The
group, seeds included, goes to the card in one copy, into static buffers;
the N steps (batch build, forward, loss, backward, Adam, BN buffers) then
run as one ``torch.cuda.CUDAGraph`` replay, their losses coming back as
one [N] tensor. The kernels read each step's seed and ``art_n_uniq`` from
those buffers (``ops/``), so one graph serves every group of its bucket.
Graphs are cached by (bucket layout, accumulation phase) and share one
memory pool; the first group of a key runs eagerly on a side stream (the
warm-up: kernel builds, library set-up, gradient buffers and optimizer
state), the second is captured, and every later one replays. A step that
cannot be captured raises with the reason; nothing falls back to eager
steps. On the scan path Adam keeps its step count and the learning rate
on the card (``capturable``), and a dropout site that a
per-step run draws from a ``torch.Generator`` takes the seed-recompute
kernel. With ``accumulation_steps`` > 1 a gradient outlives a group, so
the graphs hold the gradient buffers, zeroed in place (else each step's
backward makes them, in the graphs' pool). On the CPU the same grouped
steps run eagerly: there are no graphs there. A group shorter than N (an epoch's remainder) runs per step,
as in JAX.

``mesh`` (``parallel/mesh.py``, the JAX trainer's ``mesh`` on its data
axis) trains data-parallel over processes, one device each. Every process
passes the same global batch and keeps its contiguous rows of it after the
host prep (``host_shard_rows``); the dedup and sparse side values
(``art_*``, ``emb_*``) are whole-batch values and stay whole, as JAX's
``_put`` replicates them. So every process encodes the batch's whole
unique-article bucket with the step's seed: the masks and the moments of
``WeightedBatchNorm`` are one process's, and the slot gathers read only the
process's impression rows. The unique articles' vectors average their
cotangent over the processes in the backward
(``parallel.mesh.average_cotangent``), so the article tower's backward (the
fused encoder's, in bf16) runs on the whole batch's cotangent / processes
on every process, not on a part of it. Each process weights its loss by
its share of the global batch (rows / global rows), so the sum over
processes is the global mean, and one all-reduce a step sums the gradients
(the sparse mode's row gradients among them) and the weighted losses
before the optimizer: the update is one process's update on the global
batch. On the
per-slot path (no dedup) the BN moments are summed over the processes
(``WeightedBatchNorm.sum_moments``); its dropout masks are drawn per
process (ROADMAP C). Process 0 starts everyone from its parameters and
writes the checkpoints; every process resumes from them. ``score`` scores
each process's rows of every batch and sums the processes' disjoint score
rows. ``scan_steps`` > 1 raises under a mesh, and ``table_specs`` /
``param_specs`` (the model axis) raise naming ROADMAP A11b.

``rng_impl`` chooses XLA's random bit generator and has no counterpart.
"""
from __future__ import annotations

import itertools
import json
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.dataloader import EvalFeed, NewsrecFeed
from ..data.ragged import Ragged
from ..evaluation.ranking import per_impression_auc
from ..models.inputs import device_tables
from ..models.layers import WeightedBatchNorm
from ..ops import kernel_counters
from ..parallel.mesh import (all_reduce_sum, all_reduce_sum_, average_cotangent, barrier,
                             broadcast_, host_shard_rows)
from ..serving import ScoreWindow, article_validity, encode_corpus, eval_mode, model_kind
from ..serving import two_tower_scores
from .adam import Adam
from .checkpoint import CheckpointManager, restore_checkpoint
from .dedup import dedup_capable, pad_dedup_to, prep_dedup_batch
from .losses import l2_penalty, loss_fn_for
from .sparse_embed import TOKEN_KEYS_BY_TABLE, prep_sparse_batch, rowwise_adam

__all__ = ["Trainer", "TrainerConfig", "ScanGroup", "step_seed"]


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
    # row-sparse word-embedding updates (sparse_embed.py): LazyAdam-style,
    # a deliberate deviation from the reference's dense-decay Adam; the
    # table is the model's word_embedding, the one value sparse_embed_param
    # takes (kept for the JAX config's fields)
    sparse_embedding: bool = False
    sparse_embed_param: str = "word_embedding"
    # the host arrays' row bucket (prep_sparse_batch); the card gets the
    # valid count
    sparse_min_bucket: int = 4096
    # table name -> batch keys holding word-token ids (None =
    # sparse_embed.TOKEN_KEYS_BY_TABLE); a 2-D integer table not covered
    # makes sparse mode raise, as its ids would remap to slot 0
    sparse_token_tables: Optional[dict] = None
    # train-time unique-article dedup (training/dedup.py): "auto" = on
    # whenever dedup_capable(model) says so; True forces; False per slot
    dedup_articles: Any = "auto"
    dedup_min_bucket: int = 512
    # dtype of Adam's first moment (optax mu_dtype, e.g. "bfloat16");
    # None = fp32, the reference-parity numerics
    adam_mu_dtype: Optional[str] = None


# batch entries read on the host, never copied to the device (a scan
# group carries art_n_uniq to the device: the kernels read it there)
_HOST_KEYS = ("n_uniq", "art_n_uniq", "rows", "n_valid", "shard")
_GROUP_HOST_KEYS = ("n_uniq", "rows", "n_valid")
_M64 = (1 << 64) - 1
_ALIGN = 64  # bytes: every array of a packed group starts on this boundary


def step_seed(group_seed: int, step: int) -> int:
    """The dropout seed of the step with count ``step`` in a scan group that
    drew ``group_seed`` (the counterpart of JAX's ``fold_in(key, step)``):
    SplitMix64's finaliser of ``group_seed + (step + 1) * 0x9E3779B97F4A7C15``
    mod 2**64, an int in [0, 2**64)."""
    z = (group_seed + (step + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class ScanGroup(NamedTuple):
    """N host-prepped batches packed for one copy (``Trainer.pack_group``):
    ``host`` is one uint8 buffer (pinned for the card) holding every array
    stacked on a new leading axis, plus ``seeds`` [N] int64 (written by
    ``run_group``); ``layout`` is ((key, numpy dtype, shape, byte offset),
    ...), the graphs' cache key with the accumulation phase. A group runs
    once: ``run_group`` writes its seeds into ``host`` and copies it
    without waiting."""
    layout: tuple
    host: torch.Tensor
    n: int


def _views(buf: torch.Tensor, layout: tuple) -> dict:
    """Typed views of a packed group's buffer (host or device), by key."""
    out = {}
    for key, dt, shape, off in layout:
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        out[key] = buf[off:off + nbytes].view(tdt).view(shape)
    return out


class _Graph:
    """One captured scan group: its static input buffer and views, the
    graph (None until the key's second group), its [N] losses, and the
    launches of each kernel recorded into it."""

    def __init__(self, static: torch.Tensor, layout: tuple):
        self.static, self.views = static, _views(static, layout)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.losses: Optional[torch.Tensor] = None
        self.launches: dict = {}


def _host_array(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


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


class _RowShard:
    """An ``EvalFeed`` whose batches carry this process's rows of each batch
    (``host_shard_rows`` of the padded batch); ``unpad`` first sums the
    processes' score matrices, whose written rows are disjoint (exact: the
    other processes' entries are 0), then unpads the whole."""

    def __init__(self, feed: EvalFeed, trainer: "Trainer"):
        self.feed, self.trainer = feed, trainer
        self.n_rows, self.width = feed.n_rows, feed.width

    def batches(self):
        mesh = self.trainer.mesh
        for raw in self.feed.batches():
            n = len(raw["hist_idx"])
            rows = host_shard_rows(n, mesh.rank, mesh.data)
            out = {k: v[rows] if isinstance(v, np.ndarray) and k != "rows" else v
                   for k, v in raw.items()}
            out["rows"] = raw["rows"][rows]  # the valid rows among this process's
            out["n_valid"] = len(out["rows"])
            yield out

    def unpad(self, scores: np.ndarray) -> Ragged:
        t = torch.from_numpy(scores).to(self.trainer.device)
        all_reduce_sum_([t], self.trainer.mesh)
        return self.feed.unpad(t.cpu().numpy())


class Trainer:
    """Trains and scores one newsrec model.

    Args:
      model: an ``nn.Module`` whose ``forward(batch)`` returns [B, K]
        logits (``models/newsrec.py``), its parameters on ``device``.
      tables: dict of value tables (numpy or tensors), moved to ``device``
        once (``models/inputs.py`` convention).
      batch_builder: gathers model inputs from tables + an index batch.
      mesh: optional ``parallel.mesh.Mesh`` for data parallelism over
        processes (see the module docstring); ``table_specs`` and
        ``param_specs``, the JAX trainer's model-axis sharding, raise.
      log_fn: where ``fit`` reports each epoch.
    """

    def __init__(self, model: torch.nn.Module, tables: dict, batch_builder,
                 config: TrainerConfig = TrainerConfig(), device="cuda",
                 log_fn: Callable[[str], None] = print, mesh=None,
                 table_specs: Optional[dict] = None, param_specs: Optional[dict] = None):
        if table_specs or param_specs:
            raise NotImplementedError("table_specs / param_specs: row-sharding tables and "
                                      "parameters over the mesh's model axis is not ported "
                                      "(ROADMAP A11b)")
        if mesh is not None and config.scan_steps > 1:
            raise ValueError("scan_steps > 1 under a mesh is not ported: a group's steps run as "
                             "one CUDA graph, which the gradient all-reduce is not captured "
                             "in; use scan_steps=1")
        self.config = config
        self.mesh = mesh
        self._sparse = bool(config.sparse_embedding)
        if self._sparse:
            self._sparse_setup(model, tables)
        if config.scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {config.scan_steps}")
        if config.optimizer != "adam":
            raise ValueError(f"this optimizer not defined {config.optimizer}")
        if config.accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {config.accumulation_steps}")
        self.device = resolve_device(device)
        self.model = model
        self.builder = batch_builder
        self.log = log_fn
        self.tables = device_tables(tables, self.device)
        dedup_ok, why = dedup_capable(model)
        if config.dedup_articles is True and not dedup_ok:
            raise ValueError(f"dedup_articles: {type(model).__name__}: {why}")
        self.dedup = dedup_ok if config.dedup_articles == "auto" else bool(config.dedup_articles)
        self.loss_fn = loss_fn_for(config.loss)
        if self._sparse:  # the table's moments live here
            self._emb_m = torch.zeros_like(self._emb_table, dtype=torch.float32)
            self._emb_v = torch.zeros_like(self._emb_table, dtype=torch.float32)
        params = [p for p in model.parameters()
                  if not (self._sparse and p is self._emb_table)]
        self._scan = config.scan_steps > 1
        # on the card the scan path's steps are graphed: Adam's count and the
        # learning rate live there (a 0-dim tensor that _set_lr fills)
        graphed = self._scan and self.device.type == "cuda"
        lr = (torch.tensor(config.learning_rate, dtype=torch.float32, device=self.device)
              if graphed else config.learning_rate)
        if config.adam_mu_dtype is None:
            self.optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                              capturable=graphed)
        else:
            self.optimizer = Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  mu_dtype=config.adam_mu_dtype, capturable=graphed)
        self._graphs: dict = {}  # (layout, accumulation phase) -> _Graph
        self._pool = None        # the graphs' shared memory pool
        # the scan path's record: groups run eagerly, captures and their
        # seconds, replays, and each kernel's launches in the replays
        self.scan_stats = {"eager_groups": 0, "captures": 0, "capture_s": 0.0, "replays": 0,
                           "launches": {}}
        self.seeds = torch.Generator().manual_seed(config.seed)
        self._bns = [m for m in model.modules() if isinstance(m, WeightedBatchNorm)]
        if mesh is not None:  # everyone starts from process 0's parameters and buffers
            with torch.no_grad():
                broadcast_(list(model.parameters()) + list(model.buffers()), mesh)
        self.step_count = 0
        self._micro = 0  # micro-batches accumulated toward the next update
        self._art_cache: Optional[tuple] = None  # (step_count, article vectors)
        self.history: list[dict[str, float]] = []

    def _sparse_setup(self, model: torch.nn.Module, tables: dict) -> None:
        """Validate the sparse mode as the JAX trainer does; keep host
        copies of the token tables (for the host dedup) and the word
        table's parameter."""
        cfg = self.config
        if cfg.accumulation_steps > 1 or cfg.scan_steps > 1:
            raise ValueError("sparse_embedding requires accumulation_steps == 1 and "
                             "scan_steps == 1 (per-batch unique-row sets)")
        if cfg.l2_regularization:
            raise ValueError("sparse_embedding + l2_regularization unsupported: the "
                             "penalty would only see the batch's touched rows")
        words = getattr(model, "word_embedding", None)
        if words is None:
            raise ValueError("sparse_embedding needs model.vocab_size")
        self._vocab_size = int(words.embedding.shape[0])
        keys_map = (cfg.sparse_token_tables if cfg.sparse_token_tables is not None
                    else TOKEN_KEYS_BY_TABLE)
        host = {k: _host_array(v) for k, v in tables.items()}
        # every 2-D integer table feeds word tokens through the shared
        # table; one missing from the map would have its ids remapped to
        # slot 0 silently (wrong rows, mis-routed gradients)
        unmapped = [k for k, v in host.items()
                    if v.ndim == 2 and np.issubdtype(v.dtype, np.integer) and k not in keys_map]
        if unmapped:
            raise ValueError(f"sparse_embedding: token table(s) {unmapped} not in the "
                             "token-keys map; pass TrainerConfig.sparse_token_tables "
                             "covering them")
        self._host_tables = {k: v for k, v in host.items() if k in keys_map}
        self._sparse_tables = tuple(self._host_tables)
        if not self._sparse_tables:
            raise ValueError("sparse_embedding: no token tables found")
        self._token_keys = tuple(key for name in self._sparse_tables for key in keys_map[name])
        name = cfg.sparse_embed_param
        if not isinstance(getattr(getattr(model, name, None), "embedding", None),
                          torch.nn.Parameter):
            raise ValueError(f"sparse_embedding: model has no top-level "
                             f"'{name}' param collection")
        if name != "word_embedding":
            # the tokens are vocabulary ids: only the word table embeds them
            raise ValueError(f"sparse_embedding: sparse_embed_param must be "
                             f"'word_embedding' (the table the tokens index); got '{name}'")
        self._emb_table = words.embedding

    # -- state ------------------------------------------------------------

    def state_dict(self) -> dict:
        """Everything a resumed run needs: parameters, optimizer state, step
        count, the seed generator, any partly accumulated gradients and, in
        sparse mode, the word table's moments (``emb``)."""
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "step": self.step_count, "seeds": self.seeds.get_state(), "micro": self._micro}
        if self._micro:
            state["grads"] = {k: p.grad for k, p in self.model.named_parameters()
                              if p.grad is not None}
        if self._sparse:
            state["emb"] = {"m": self._emb_m, "v": self._emb_v}
        return state

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        opt = state["optimizer"]
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        capturable = any(g.get("capturable") for g in self.optimizer.param_groups)
        if not capturable:  # torch.optim.Adam keeps its step count on the CPU (not capturable)
            opt = dict(opt, state={i: {k: v.cpu() if k == "step" and isinstance(v, torch.Tensor)
                                       else v for k, v in s.items()}
                                   for i, s in opt["state"].items()})
        self.optimizer.load_state_dict(opt)
        for group, lr in zip(self.optimizer.param_groups, lrs):
            # keep this trainer's learning-rate object (a graphed step reads the tensor)
            value, group["lr"] = group["lr"], lr
            self._fill_lr(group, float(value))
        self.drop_graphs()  # the optimizer's state tensors are new objects
        self._load_emb(state.get("emb"))
        self.step_count = int(state["step"])
        self.seeds.set_state(state["seeds"].cpu())
        self._micro = int(state.get("micro", 0))
        grads = state.get("grads", {})
        for k, p in self.model.named_parameters():
            p.grad = grads[k].to(p.device).clone() if k in grads else None
        self._art_cache = None

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            self._fill_lr(group, lr)

    @staticmethod
    def _fill_lr(group: dict, lr: float) -> None:
        """A group's learning rate: filled in place when it is a tensor (the
        graphed steps read it there), else replaced."""
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr

    def _snapshot(self) -> dict:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def _emb_snapshot(self) -> Optional[dict]:
        """The sparse mode's table moments (copies), else None."""
        if not self._sparse:
            return None
        return {"m": self._emb_m.clone(), "v": self._emb_v.clone()}

    def _load_emb(self, emb: Optional[dict]) -> None:
        if self._sparse and emb is not None:
            self._emb_m.copy_(emb["m"])
            self._emb_v.copy_(emb["v"])

    # -- steps ------------------------------------------------------------

    def next_seed(self) -> int:
        """The next step's 64-bit dropout seed."""
        lo, hi = torch.randint(0, 1 << 32, (2,), generator=self.seeds).tolist()
        return (hi << 32) | lo

    def _prep_host(self, raw: dict) -> dict:
        """The host-side preparation of an index batch: the sparse mode's
        vocabulary rows first (they read ``hist_idx``/``cand_idx``), then
        the article dedup, which replaces them with slots."""
        if self._sparse and "emb_uniq" not in raw:
            raw = prep_sparse_batch(raw, self._host_tables, self._sparse_tables,
                                    self._vocab_size, self.config.sparse_min_bucket)
        if self.dedup and "hist_idx" in raw:
            raw = prep_dedup_batch(raw, self.config.dedup_min_bucket)
        if self.mesh is not None and "shard" not in raw:
            raw = self._shard(raw)
        return raw

    def _shard(self, raw: dict) -> dict:
        """This process's rows of a host-prepped global batch; the dedup and
        sparse side values (``art_*``, ``emb_*``) and scalars stay whole.
        ``shard`` = (this process's rows, the global rows)."""
        n = len(raw["labels"])
        rows = host_shard_rows(n, self.mesh.rank, self.mesh.data)
        if rows.stop <= rows.start:
            raise ValueError(f"a global batch of {n} rows leaves process {self.mesh.rank} of "
                             f"{self.mesh.data} without rows")
        out = {k: v if k.startswith(("art_", "emb_")) or getattr(v, "ndim", 0) == 0 else v[rows]
               for k, v in raw.items()}
        out["shard"] = (rows.stop - rows.start, n)
        return out

    def prepare(self, raw: dict) -> dict:
        """Host preparation (``_prep_host``, unless done) and the batch build
        on the device: an index batch (numpy arrays or host tensors) -> the
        model batch plus ``labels`` on the device. In sparse mode the token
        keys become slots into the batch's rows, whose ids go along as
        ``emb_uniq`` (cut to the valid count, which the host knows)."""
        raw = self._prep_host(raw)
        batch = self.builder(self.tables, raw)
        if self._sparse:
            n = int(np.count_nonzero(_host_array(raw["emb_valid"])))
            batch["emb_uniq"] = torch.as_tensor(raw["emb_uniq"][:n]).to(
                self.device, torch.long, non_blocking=True)
            remap = torch.as_tensor(raw["emb_remap"]).to(self.device, torch.long,
                                                         non_blocking=True)
            for k in self._token_keys:
                if k in batch:
                    batch[k] = remap[batch[k]]
        labels = raw["labels"]
        labels = labels if isinstance(labels, torch.Tensor) else torch.as_tensor(np.asarray(labels))
        batch["labels"] = labels.to(self.device, torch.float32, non_blocking=True)
        if "shard" in raw:
            batch["shard"] = raw["shard"]
        return batch

    def step(self, batch: dict) -> torch.Tensor:
        """One micro-batch on a prepared batch; the optimizer steps every
        ``accumulation_steps`` of them, on their mean gradient. Returns the
        loss (a device scalar: reading it synchronises)."""
        return self._micro_step(dict(batch, dropout_seed=self.next_seed()))

    def _micro_step(self, batch: dict) -> torch.Tensor:
        """``step`` on a batch that carries its ``dropout_seed``."""
        self.model.train()
        k = self.config.accumulation_steps
        if self._micro == 0:
            # with accumulation on the scan path, a gradient outlives a graph
            # (a group may end inside an update): the graphs then hold its
            # buffers, zeroed in place; else each step's backward makes them
            self.optimizer.zero_grad(set_to_none=not (self._scan and k > 1))
        rows = None
        if self._sparse:  # the batch's word rows, a leaf the model embeds from
            rows = self._emb_table.detach().index_select(0, batch["emb_uniq"]).requires_grad_()
            batch["emb_rows"] = rows
        sync = []  # the per-slot path under a mesh: BN moments over every process's rows
        if self.mesh is not None and self.mesh.data > 1:
            if "hist_slot" in batch:  # dedup: the article tower sees every process's slots
                batch["art_cotangent"] = partial(average_cotangent, mesh=self.mesh)
            else:
                sync = self._bns
        for bn in sync:
            bn.sum_moments = partial(all_reduce_sum, mesh=self.mesh)
        try:
            logits = self.model(batch)
        finally:
            for bn in sync:
                bn.sum_moments = None
        loss = self.loss_fn(logits, batch["labels"])
        if self.config.l2_regularization:
            loss = loss + self.config.l2_regularization * l2_penalty(self.model)
        shard = batch.get("shard")
        # under a mesh: this process's share of the global batch's mean
        obj = loss * (shard[0] / shard[1]) if shard and shard[0] != shard[1] else loss
        (obj / k if k > 1 else obj).backward()
        self._micro += 1
        if self.mesh is not None:
            loss = self._all_reduce(obj.detach().float(), rows, update=self._micro == k)
        if self._micro == k:
            self.optimizer.step()
            if rows is not None:
                with torch.profiler.record_function("rowwise_adam"):
                    rowwise_adam(self._emb_table, self._emb_m, self._emb_v, batch["emb_uniq"],
                                 rows.grad, self.optimizer.param_groups[0]["lr"],
                                 self.step_count + 1)
            self._micro = 0
        self.step_count += 1
        return loss.detach()

    def train_step(self, raw: dict) -> torch.Tensor:
        """``step(prepare(raw))``."""
        return self.step(self.prepare(raw))

    def _all_reduce(self, loss: torch.Tensor, rows: Optional[torch.Tensor],
                    update: bool) -> torch.Tensor:
        """One all-reduce over the mesh: this process's weighted loss and, at
        an ``update``, the dense gradients and the sparse ``rows``' gradient,
        summed in place. Returns the global loss."""
        ts = []
        if update:
            ts = [p.grad for g in self.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
            if rows is not None:
                ts.append(rows.grad)
        loss = loss.reshape(1)
        all_reduce_sum_(ts + [loss], self.mesh)
        return loss.reshape(())

    # -- scan groups ------------------------------------------------------

    def pack_group(self, raws: list) -> ScanGroup:
        """The host side of a scan group (the prefetch thread's work): each
        batch's host prep (``_prep_host``, unless done), the group padded to
        its largest dedup bucket, every array stacked into one uint8 buffer
        (pinned for the card) with room for the N seeds."""
        raws = [self._prep_host(r) for r in raws]
        if "art_uniq" in raws[0]:
            bucket = max(r["art_uniq"].shape[0] for r in raws)
            raws = [pad_dedup_to(r, bucket) for r in raws]
        stacks = {k: [np.asarray(r[k]) for r in raws] for k in raws[0]
                  if k not in _GROUP_HOST_KEYS}
        stacks["seeds"] = [np.zeros((), np.int64)] * len(raws)
        layout, off = [], 0
        for k, parts in stacks.items():
            shape = (len(parts),) + parts[0].shape
            layout.append((k, parts[0].dtype.str, shape, off))
            off += -(-int(np.prod(shape)) * parts[0].dtype.itemsize // _ALIGN) * _ALIGN
        host = torch.empty(off, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        for k, dt, shape, o in layout:
            out = buf[o:o + int(np.prod(shape)) * np.dtype(dt).itemsize].view(dt).reshape(shape)
            np.stack(stacks[k], out=out)
        return ScanGroup(tuple(layout), host, len(raws))

    def run_group(self, group: ScanGroup, graph: bool = True) -> torch.Tensor:
        """The N steps of a packed group; returns their losses [N] (on the
        device). On the card: one copy into the key's static buffer, then
        the warm-up run, the capture, or a replay (see the module
        docstring); on the CPU, or on the card with ``graph=False`` (the
        steps a replay is held against), the same steps eagerly."""
        n, k = group.n, self.config.accumulation_steps
        seed = self.next_seed()
        seeds = np.array([step_seed(seed, self.step_count + i) for i in range(n)], np.uint64)
        _views(group.host, group.layout)["seeds"].numpy()[:] = seeds.view(np.int64)
        step0, micro0 = self.step_count, self._micro
        if self.device.type != "cuda" or not graph:
            buf = group.host.to(self.device, non_blocking=True)
            return self._scan_body(_views(buf, group.layout), n)
        key = (group.layout, micro0)
        entry = self._graphs.get(key)
        if entry is None:
            entry = _Graph(torch.empty(group.host.shape, dtype=torch.uint8, device=self.device),
                           group.layout)
        entry.static.copy_(group.host, non_blocking=True)
        if key not in self._graphs:  # the warm-up: this group's steps, eagerly, on a side stream
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                losses = self._scan_body(entry.views, n)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graphs[key] = entry
            self.scan_stats["eager_groups"] += 1
            return losses
        if entry.graph is None:
            entry.graph, entry.losses, entry.launches = self._capture(entry, n)
        entry.graph.replay()
        self.step_count, self._micro = step0 + n, (micro0 + n) % k
        # a replay changes the parameters and buffers behind autograd's back
        self._bump_versions()
        stats = self.scan_stats
        stats["replays"] += 1
        for name, c in entry.launches.items():
            stats["launches"][name] = stats["launches"].get(name, 0) + c
        return entry.losses.clone()

    def drop_graphs(self) -> None:
        """Forget the captured graphs and their memory pool (a pool lives as
        long as a graph holds it): each key warms up and is captured anew."""
        self._graphs.clear()
        self._pool = None

    def _bump_versions(self) -> None:
        """Bump the versions of the model's parameters and buffers, so that
        caches keyed on them (NRMS's packed weights) miss: after a replay,
        which changed them unseen, and before a capture, which must record
        every step's own packing."""
        for t in itertools.chain(self.model.parameters(), self.model.buffers()):
            torch.autograd.graph.increment_version(t)

    def _capture(self, entry: _Graph, n: int) -> tuple:
        """(graph, losses, launches) of the scan body over ``entry``'s static
        buffers; raises with the reason when the steps cannot be captured."""
        counters = kernel_counters()
        self._bump_versions()
        before = {name: fn.captured for name, fn in counters.items()}
        step0, micro0 = self.step_count, self._micro
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            # thread_local: the prefetch thread may pin the next group meanwhile
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                losses = self._scan_body(entry.views, n)
        except Exception as e:
            raise RuntimeError(f"scan_steps={self.config.scan_steps}: the train step could not "
                               f"be captured in a CUDA graph: {e}") from e
        finally:
            self.step_count, self._micro = step0, micro0  # nothing ran yet
        self.scan_stats["captures"] += 1
        self.scan_stats["capture_s"] += time.perf_counter() - t0
        launches = {name: fn.captured - before[name] for name, fn in counters.items()
                    if fn.captured > before[name]}
        return graph, losses, launches

    def _scan_body(self, views: dict, n: int) -> torch.Tensor:
        """The N steps of a group over its (host or device) views: step i
        builds its batch from slice i on the device, takes seed i and
        ``art_n_uniq`` i as device scalars, and runs ``_micro_step``."""
        losses = []
        for i in range(n):
            raw = {key: v[i] for key, v in views.items() if key != "seeds"}
            batch = self.builder(self.tables, raw)
            batch["labels"] = raw["labels"].to(torch.float32)
            batch["dropout_seed"] = views["seeds"][i]
            losses.append(self._micro_step(batch))
        return torch.stack(losses)

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
        n_scan = self.config.scan_steps

        def work():
            group = []
            for raw in it:
                if n_scan == 1:
                    raw = self._prep_host(raw)
                    yield "step", _pinned(raw) if pin else raw
                    continue
                group.append(raw)
                if len(group) == n_scan:
                    yield "scan", self.pack_group(group)
                    group = []
            for raw in group:  # the remainder (< scan_steps): per step, as in JAX
                raw = self._prep_host(raw)
                yield "step", _pinned(raw) if pin else raw

        losses: list[torch.Tensor] = []
        last_logged = 0
        for kind, payload in _prefetched(work(), self.config.prefetch):
            if kind == "scan":
                losses.extend(self.run_group(payload).unbind(0))
            else:
                losses.append(self.step(self.prepare(payload)))
            # as JAX: once log_every steps have passed, the newest step's loss
            if (scalar_logger is not None and log_every
                    and len(losses) - last_logged >= log_every):
                last_logged = len(losses)
                scalar_logger.log("train/loss_step", float(losses[-1]),
                                  step=step0 + len(losses))
        return losses

    def _resume(self, ckpt_dir: Path, mgr: CheckpointManager):
        """(start epoch, best metric, best state, es_wait, lr_wait, lr)
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
            best = mgr.restore_best(self)
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
        best, best_emb = self._snapshot(), self._emb_snapshot()
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
                if best_r is not None:
                    best, best_emb = best_r["model"], best_r.get("emb")
                else:
                    best, best_emb = self._snapshot(), self._emb_snapshot()

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
                    best, best_emb = self._snapshot(), self._emb_snapshot()
                    if mgr is not None and self._writes:
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
                # two resumes from the previous consistent pair. Under a
                # mesh process 0 writes, and the others wait for it.
                if self._writes:
                    mgr.save_step(self, epoch)
                    (ckpt_dir / "meta.json").write_text(json.dumps({
                        "epoch": epoch, "best_metric": float(best_metric), "es_wait": es_wait,
                        "lr_wait": lr_wait, "lr": lr, "history": self.history,
                        "seeds": self.seeds.get_state().tolist()}))
                if self.mesh is not None:
                    barrier(self.mesh)
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
            self._load_emb(best_emb)  # the sparse mode's moments, as JAX restores them
            # the step count is unchanged by the restore, so the step-keyed
            # article vectors would pair final-epoch articles with
            # best-epoch user towers
            self._art_cache = None
        return self.history

    @property
    def _writes(self) -> bool:
        """This process writes checkpoints: no mesh, or process 0 of it."""
        return self.mesh is None or self.mesh.rank == 0

    # -- scoring ----------------------------------------------------------

    def score(self, feed: EvalFeed, two_tower=None) -> Ragged:
        """Sigmoid scores aligned with the feed's inview lists, in eval mode,
        at most ``serving.EVAL_WINDOW`` batches in flight.

        With ``two_tower`` (default: ``config.two_tower_eval``) the corpus is
        encoded once through the article tower and impressions are scored by
        the user tower (``serving.py``): the same logits as the full forward."""
        if two_tower is None:
            two_tower = self.config.two_tower_eval
        if self.mesh is not None:
            feed = _RowShard(feed, self)
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
