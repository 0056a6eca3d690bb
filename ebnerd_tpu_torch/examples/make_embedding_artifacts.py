"""The document-embedding parquet artifact for NRMSDocVec (the port of
``examples/make_embedding_artifacts.py``, after the reference's
``examples/quick_start/make_embedding_artifacts.ipynb``), its ``--synthetic``
path: 200 synthetic articles with standard-normal vectors from seed 0,
written as ``{article_id, document_vector}`` parquet (pyarrow, when called;
so it runs where pyarrow is, not on the card's machine).

The JAX example's other path encodes the articles with a Hugging Face
transformer (``AutoModel.from_pretrained``), which needs a download: it is
not ported (ROADMAP.md, "Not yet ported"), and this example raises when asked
for it.

  python -m ebnerd_tpu_torch.examples.make_embedding_artifacts --synthetic --out vecs.parquet
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import constants as c
from ..data.ragged import Ragged
from ..data.table import Table, write_parquet


def main(argv=None) -> Table:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--transformer_model_name", type=str,
                   default="FacebookAI/xlm-roberta-large")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dim", type=int, default=768, help="synthetic vector dim")
    p.add_argument("--out", type=str, default="document_vector.parquet")
    args = p.parse_args(argv)

    if not args.synthetic:
        raise NotImplementedError(
            f"encoding the articles with {args.transformer_model_name!r} needs "
            "AutoModel.from_pretrained (a download) and is not ported (ROADMAP.md, "
            "'Not yet ported'); "
            "pass --synthetic")
    from ..data.synthetic import make_synthetic_articles

    rng = np.random.default_rng(0)
    articles = make_synthetic_articles(rng, 200)
    vecs = rng.standard_normal((len(articles), args.dim)).astype(np.float32)
    out = Table({
        c.DEFAULT_ARTICLE_ID_COL: np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL]),
        "document_vector": Ragged.from_dense(vecs),
    })
    write_parquet(out, args.out)
    print(f"wrote {args.out}: {len(out)} articles x {vecs.shape[1]}-d vectors")
    return out


if __name__ == "__main__":
    main()
