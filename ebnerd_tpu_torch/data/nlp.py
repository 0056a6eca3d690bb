"""Host-side NLP artifact builders (counterpart of ``ebnerd_tpu/data/nlp.py``):
the word-embedding matrix of a Hugging Face model, and CLS-token document
vectors. They run once to make numpy artifacts (a word-embedding init
matrix, a [V+1, D] docvec table); the model is any ``torch.nn.Module``
with the Hugging Face call surface, and the ``transformers`` package is
not imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

__all__ = [
    "get_transformers_word_embeddings",
    "generate_embeddings_with_transformers",
]


def get_transformers_word_embeddings(model) -> np.ndarray:
    """The word-embedding matrix [V, E] of a Hugging Face model, as numpy."""
    return model.embeddings.word_embeddings.weight.data.to("cpu").numpy()


def generate_embeddings_with_transformers(
    model,
    tokenizer,
    text_list: list[str],
    batch_size: int = 8,
    device="cuda",
    disable_tqdm: bool = False,
) -> np.ndarray:
    """CLS-token document vectors [N, D] float32 for a list of texts:
    batched tokenize, ``model(**enc)``, ``last_hidden_state[:, 0]``, no
    gradients, the model in eval mode on ``device`` (the card unless the
    caller passes ``device="cpu"``; raises without a card)."""
    dev = resolve_device(device)
    model = model.to(dev)
    model.eval()
    out = []
    iterator = range(0, len(text_list), batch_size)
    if not disable_tqdm:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="Encoding text", unit="batch")
        except ImportError:
            pass
    with torch.no_grad():
        for start in iterator:
            batch = text_list[start : start + batch_size]
            enc = tokenizer(batch, return_tensors="pt", padding=True, truncation=True).to(dev)
            hidden = model(**enc).last_hidden_state
            out.append(hidden[:, 0, :].to("cpu").numpy())
    return np.concatenate(out, axis=0).astype(np.float32)
