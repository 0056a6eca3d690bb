"""Plain reference of NRMS training: the first steps of a run, in fp32 with
TF32 off, written from the model's equations (Wu et al., EMNLP 2019, as
ebnerd-benchmark's ``NRMSModel`` builds it) in plain PyTorch. It imports
nothing of the program and takes nothing that the program made: it gets
the benchmark's made data and weights and works out again which
impressions form each batch, the batch's unique articles, the step's
dropout seed and both dropout masks.

One step, for a batch of B impressions with H clicked and K candidate
articles of T title tokens:

- the batch's unique articles, ``np.unique`` over its H + K slots, in
  sorted order; each article is encoded once and its vector gathered back
  to its slots (the gather's backward sums the slots);
- the news tower: word embedding, dropout (stream 0, Din wide), multi-head
  self-attention (no biases, no output projection, scale
  1/sqrt(head_dim)), dropout (stream 1, D wide), additive pooling
  ``softmax_t(tanh(o W + b) q)`` (max-subtracted, +1e-8 in the
  denominator) and the weighted sum of o over t;
- the user tower: the same encoder over the H history vectors, no
  dropout;
- logits <cand, user>, softmax cross-entropy over the K candidates,
  averaged over the batch; autograd; Adam (betas 0.9, 0.999, eps 1e-8).

The masks are the Philox masks of ``philox.py`` under the step's seed, row
``article * T + t`` over the batch's unique articles. The step's seed is the
trainer's draw: two 32-bit words from a CPU ``torch.Generator`` seeded with
the run's trainer seed, low word first.

``precision`` is the arithmetic of every product: "fp32", or a lower one
for the benchmark's control: "tf32" (operands rounded to 10 mantissa bits)
or "fp8" (operands scaled per tensor to e4m3's range and rounded to it),
forward and backward. ``fault="half"`` plants a fault for the benchmark's
readings: the loss over the first half of the batch only. The work runs in blocks of
articles and of impressions, so that its memory stays bounded: the news
tower's forward once without a graph, its backward by recomputing each
block.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from . import philox

BETAS, EPS = (0.9, 0.999), 1e-8
_E4M3_MAX = 448.0


def leaf_shapes(cfg: dict) -> dict:
    """Every weight of the model by name, in the layout x @ W."""
    e, d, a = cfg["word_emb_dim"], cfg["head_num"] * cfg["head_dim"], cfg["attention_hidden_dim"]
    out = {"emb": (cfg["vocab_size"], e)}
    for tower, din in (("news", e), ("user", d)):
        out.update({f"{tower}.wq": (din, d), f"{tower}.wk": (din, d), f"{tower}.wv": (din, d),
                    f"{tower}.w": (d, a), f"{tower}.b": (a,), f"{tower}.q": (a,)})
    return out


def _bound(cfg: dict, name: str, shape: tuple) -> float:
    """The configuration's ``init_bounds`` of the weight, else its
    Glorot-uniform bound (the model's own initialiser)."""
    if name in cfg.get("init_bounds", {}):
        return cfg["init_bounds"][name]
    fan_in, fan_out = (shape[0], 1) if len(shape) == 1 else shape
    return math.sqrt(6.0 / (fan_in + fan_out))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight, fp32, uniform within its bound (``_bound``), from one
    draw of a ``torch.Generator`` on ``device`` seeded with ``seed``: views
    of one buffer, by name."""
    shapes = leaf_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    sizes = [math.prod(s) for s in shapes.values()]
    buf = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        bound = _bound(cfg, name, shape)
        out[name] = buf[off:off + n].mul_(2.0 * bound).sub_(bound).view(shape)
        off += n
    return out


def step_seeds(trainer_seed: int, n: int) -> list:
    """The dropout seeds of a run's first ``n`` steps."""
    gen = torch.Generator().manual_seed(trainer_seed)
    out = []
    for _ in range(n):
        lo, hi = torch.randint(0, 1 << 32, (2,), generator=gen).tolist()
        out.append((hi << 32) | lo)
    return out


def batch_rows(n_rows: int, batch: int, feed_seed: int, steps: int) -> list:
    """The impressions (rows of the made behaviors) of the first ``steps``
    batches: a permutation of the rows by ``default_rng(feed_seed)``, cut
    in order into batches."""
    order = np.random.default_rng(feed_seed).permutation(n_rows)
    return [order[i * batch:(i + 1) * batch] for i in range(steps)]


def _rounder(precision: str):
    if precision == "fp32":
        return None
    if precision == "tf32":
        def rnd(v):
            bits = v.contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return rnd
    if precision == "fp8":
        def rnd(v):
            amax = v.detach().abs().amax().clamp_min(1e-30)
            scale = _E4M3_MAX / amax
            return (v * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return rnd
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with both operands rounded, and its gradients' products too."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        ga = rnd(g) @ rnd(b).transpose(-1, -2)
        gb = rnd(a).transpose(-1, -2) @ rnd(g)
        return ga, gb, None


class _Ops:
    def __init__(self, precision: str):
        self.rnd = _rounder(precision)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b for a [M, K] and b [K, N], or both [..., M, K] and [..., K, N]."""
        return a @ b if self.rnd is None else _RoundedMatmul.apply(a, b, self.rnd)


def encode(ops: _Ops, x: torch.Tensor, p: dict, tower: str, heads: int,
           drop: Optional[tuple] = None, row0: int = 0) -> torch.Tensor:
    """x [N, T, Din] -> [N, D]; ``drop`` = (seed, keep) applies both masks,
    ``row0`` the article index of x[0] among the call's articles."""
    n, t, din = x.shape
    wq = p[f"{tower}.wq"]
    d = wq.shape[1]
    hd = d // heads
    if drop is not None:
        seed, keep = drop
        x = x * philox.mask(seed, 0, n * t, din, keep, row0 * t, x.device).view(n, t, din)
    flat = x.reshape(n * t, din)

    def proj(w):
        return ops.mm(flat, w).view(n, t, heads, hd).transpose(1, 2)

    q, k, v = proj(wq), proj(p[f"{tower}.wk"]), proj(p[f"{tower}.wv"])
    probs = torch.softmax(ops.mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd)), dim=-1)
    o = ops.mm(probs, v).transpose(1, 2).reshape(n, t, d)
    if drop is not None:
        o = o * philox.mask(seed, 1, n * t, d, keep, row0 * t, x.device).view(n, t, d)
    att = torch.tanh(ops.mm(o.reshape(n * t, d), p[f"{tower}.w"]).view(n, t, -1) + p[f"{tower}.b"])
    att = ops.mm(att.reshape(n * t, -1), p[f"{tower}.q"][:, None]).view(n, t)
    att = att - att.max(dim=-1, keepdim=True).values
    expo = torch.exp(att)
    weight = expo / (expo.sum(dim=-1, keepdim=True) + 1e-8)
    return (o * weight[..., None]).sum(dim=1)


@contextlib.contextmanager
def _no_tf32():
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def loss_and_grads(ops: _Ops, cfg: dict, p: dict, tokens: torch.Tensor, hist: np.ndarray,
                   cand: np.ndarray, labels: np.ndarray, seed: int, fault: Optional[str],
                   block: int) -> tuple:
    """(loss, {name: gradient}) of one batch: ``tokens`` [articles, T] on
    the device, ``hist`` [B, H] and ``cand`` [B, K] article indices,
    ``labels`` [B, K]."""
    dev = tokens.device
    b, h = hist.shape
    heads = cfg["head_num"]
    keep = 1.0 - cfg["dropout"]
    drop = (seed, keep) if keep < 1.0 else None
    uniq, inv = np.unique(np.concatenate([hist.reshape(-1), cand.reshape(-1)]),
                          return_inverse=True)
    art_tokens = tokens[torch.as_tensor(uniq, device=dev)]
    hist_slot = torch.as_tensor(inv[:b * h].reshape(b, h), device=dev)
    cand_slot = torch.as_tensor(inv[b * h:].reshape(b, -1), device=dev)
    lab = torch.as_tensor(labels, dtype=torch.float32, device=dev)

    def news(a0: int) -> torch.Tensor:
        return encode(ops, p["emb"][art_tokens[a0:a0 + block]], p, "news", heads, drop, a0)

    with torch.no_grad():
        art = torch.cat([news(a0) for a0 in range(0, len(uniq), block)])
    art.requires_grad_()
    rows = b // 2 if fault == "half" else b
    total = 0.0
    for r0 in range(0, rows, block):
        r1 = min(rows, r0 + block)
        user = encode(ops, art[hist_slot[r0:r1]], p, "user", heads)
        logits = ops.mm(art[cand_slot[r0:r1]], user[:, :, None])[..., 0]
        part = -(lab[r0:r1] * torch.log_softmax(logits, dim=-1)).sum() / rows
        part.backward()
        total += float(part.detach())
    for a0 in range(0, len(uniq), block):
        news(a0).backward(art.grad[a0:a0 + block])
    return total, {k: v.grad for k, v in p.items()}


def train(cfg: dict, mix: dict, data: dict, weights: dict, trainer_seed: int, feed_seed: int,
          steps: int = 3, precision: str = "fp32", fault: Optional[str] = None,
          block: int = 8192) -> dict:
    """The first ``steps`` training steps from ``weights`` on the made
    ``data`` (``hist`` [R, H], ``cand`` [R, K] article indices, ``labels``
    [R, K], ``tokens`` [articles, T]). Returns each step's ``losses``, the
    first step's gradient norm of each weight (``grad_norms``) and the norm
    of each weight's change after the last step (``change_norms``)."""
    dev = weights["emb"].device
    ops = _Ops(precision)
    tokens = torch.as_tensor(data["tokens"], dtype=torch.long, device=dev)
    p = {k: w.detach().clone().requires_grad_() for k, w in weights.items()}
    m = {k: torch.zeros_like(w) for k, w in p.items()}
    v = {k: torch.zeros_like(w) for k, w in p.items()}
    b1, b2 = BETAS
    lr = cfg["learning_rate"]
    losses, grad_norms = [], {}
    seeds = step_seeds(trainer_seed, steps)
    batches = batch_rows(len(data["hist"]), mix["batch_size"], feed_seed, steps)
    with _no_tf32():
        for i, rows in enumerate(batches):
            loss, grads = loss_and_grads(ops, cfg, p, tokens, data["hist"][rows],
                                         data["cand"][rows], data["labels"][rows], seeds[i],
                                         fault, block)
            losses.append(loss)
            if i == 0:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            with torch.no_grad():
                for k, w in p.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (v[k].sqrt() / math.sqrt(1.0 - b2 ** (i + 1))).add_(EPS)
                    w.addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** (i + 1)))
                    w.grad = None
            for w in p.values():
                w.grad = None
        with torch.no_grad():
            change = {k: float((p[k] - weights[k]).norm()) for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
