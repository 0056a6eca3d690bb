"""Quick-start smoke runs on dummy data (the port of
``examples/quick_start_dummy.py``): build each model family with random
embeddings at the JAX example's small sizes, run three Adam steps (lr 1e-3)
and a forward pass in eval mode.

  python -m ebnerd_tpu_torch.examples.quick_start_dummy             # all models
  python -m ebnerd_tpu_torch.examples.quick_start_dummy --model nrms --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..training.losses import categorical_crossentropy

B, H, K, T, TB = 8, 10, 5, 12, 16
VOCAB, EMB, N_USERS = 1000, 32, 64
MODELS = ("nrms", "nrms_docvec", "lstur", "npa", "naml", "fastformer")
STEPS = 3


def dummy_batch(model_name: str, rng: np.random.Generator, device) -> dict:
    """The JAX example's batch, from the same draws of ``rng``."""
    def arr(a):
        return torch.as_tensor(a).to(device)

    def toks(l, t):
        return arr(rng.integers(1, VOCAB, (B, l, t)).astype(np.int64))

    batch = {"hist_tokens": toks(H, T), "cand_tokens": toks(K, T)}
    if model_name in ("lstur", "npa"):
        batch["user_id"] = arr(rng.integers(0, N_USERS, B).astype(np.int64))
    if model_name == "naml":
        batch.update(
            hist_body=toks(H, TB), cand_body=toks(K, TB),
            hist_cat=arr(rng.integers(0, 20, (B, H)).astype(np.int64)),
            cand_cat=arr(rng.integers(0, 20, (B, K)).astype(np.int64)),
            hist_subcat=arr(rng.integers(0, 30, (B, H)).astype(np.int64)),
            cand_subcat=arr(rng.integers(0, 30, (B, K)).astype(np.int64)),
        )
    if model_name == "nrms_docvec":
        batch = {
            "hist_vecs": arr(rng.standard_normal((B, H, 64), dtype=np.float32)),
            "cand_vecs": arr(rng.standard_normal((B, K, 64), dtype=np.float32)),
        }
    return batch


def hparams(model_name: str, dropout: Optional[float] = None):
    """The JAX example's hyper-parameters of one family; ``dropout`` (when
    given) replaces the default rate."""
    from ..models import config as mcfg

    hp = {
        "nrms": lambda: mcfg.HParamsNRMS(title_size=T, history_size=H, head_num=4, head_dim=8,
                                         attention_hidden_dim=32),
        "nrms_docvec": lambda: mcfg.HParamsNRMSDocVec(
            title_size=64, history_size=H, head_num=4, head_dim=8, attention_hidden_dim=32,
            newsencoder_units_per_layer=(64, 64)),
        "lstur": lambda: mcfg.HParamsLSTUR(title_size=T, history_size=H, n_users=N_USERS,
                                           gru_unit=32, filter_num=32),
        "npa": lambda: mcfg.HParamsNPA(title_size=T, history_size=H, n_users=N_USERS,
                                       user_emb_dim=32, filter_num=32),
        "naml": lambda: mcfg.HParamsNAML(title_size=T, body_size=TB, history_size=H,
                                         filter_num=32, vert_num=20, subvert_num=30),
        "fastformer": lambda: mcfg.HParamsFastformer(embedding_dim=32, n_layers=2, n_heads=4,
                                                     intermediate_dim=64),
    }
    if model_name not in hp:
        raise ValueError(model_name)
    out = hp[model_name]()
    return out if dropout is None else dataclasses.replace(out, dropout=dropout)


def build(model_name: str, device, dropout: Optional[float] = None) -> torch.nn.Module:
    """One family at the example's sizes, weights from seed 0."""
    from ..models import LSTUR, NAML, NPA, NRMS, Fastformer, NRMSDocVec

    hp = hparams(model_name, dropout)
    if model_name == "nrms_docvec":
        return NRMSDocVec(hp, device=device)
    cls = {"nrms": NRMS, "lstur": LSTUR, "npa": NPA, "naml": NAML, "fastformer": Fastformer}
    return cls[model_name](hp, vocab_size=VOCAB, word_emb_dim=EMB, device=device)


def run_one(model_name: str, device="cuda", dropout: Optional[float] = None,
            load: Optional[Callable[[torch.nn.Module], None]] = None) -> dict:
    """Three Adam steps and an eval forward of one family on its dummy
    batch; ``load(model)`` may replace the initial weights. Returns the
    losses (the first is the loss at the initial weights) and the eval
    logits."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    model = build(model_name, device, dropout)
    if load is not None:
        load(model)
    batch = dummy_batch(model_name, rng, device)
    labels = torch.zeros(B, K, device=device)
    labels[:, 0] = 1.0
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    model.train()
    for step in range(STEPS):
        opt.zero_grad()
        loss = categorical_crossentropy(model(dict(batch, dropout_seed=step + 1)).float(), labels)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    model.eval()
    with torch.no_grad():
        preds = model(batch)
    if tuple(preds.shape) != (B, K) or not bool(torch.isfinite(preds).all()):
        raise RuntimeError(f"{model_name}: eval logits {tuple(preds.shape)} are not finite [B, K]")
    print(f"  {model_name}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, preds {tuple(preds.shape)}")
    return {"losses": losses, "preds": preds}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="all")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return {name: run_one(name, args.device)
            for name in (MODELS if args.model == "all" else (args.model,))}


if __name__ == "__main__":
    main()
