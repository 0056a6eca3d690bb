"""Article-side feature builders: tokenization, token tables, doc embeddings
(copy of ``ebnerd_tpu/data/articles.py``), and ``VocabTokenizer``.

Tokenization runs on the host; the output is a dense ``[V+1, max_length]``
int32 token table (row 0 = padding/unknown) that lives on the device for
the gather in the step. ``convert_text2encoding_with_transformers`` takes
any tokenizer object with the Hugging Face call surface; ``VocabTokenizer``
is a small one over a word vocabulary file that gives ``BertTokenizerFast``'s
ids for such a vocabulary without the ``transformers`` package (which the
card's machine does not have). ``load_article_id_embeddings`` reads parquet
and needs pyarrow when it is called.
"""
from __future__ import annotations

import unicodedata
from pathlib import Path

import numpy as np

from ..constants import DEFAULT_ARTICLE_ID_COL
from .lookup import Lookup
from .ragged import Ragged
from .table import Table, read_parquet

__all__ = [
    "VocabTokenizer",
    "concat_str_columns",
    "convert_text2encoding_with_transformers",
    "create_article_id_to_value_mapping",
    "build_token_lookup",
    "build_value_lookup",
    "load_article_id_embeddings",
    "create_sort_based_prediction_score",
]


def concat_str_columns(df: Table, columns: list[str]) -> tuple[Table, str]:
    """Join several string columns with a space into a new column
    (reference: concat_str_columns, _polars.py:547-571)."""
    concat_name = "-".join(columns)
    cols = [np.asarray(df[col], dtype=object) for col in columns]
    joined = cols[0]
    for nxt in cols[1:]:
        joined = np.asarray([f"{a} {b}" for a, b in zip(joined, nxt)], dtype=object)
    return df.with_columns(**{concat_name: joined}), concat_name


def convert_text2encoding_with_transformers(
    df: Table,
    tokenizer,
    column: str,
    max_length: int,
) -> tuple[Table, str]:
    """Tokenize a text column to fixed-length int token ids
    (reference: _articles.py:31-79 — ``add_special_tokens=False``,
    pad/truncate to ``max_length``). Returns (table, new_column_name)."""
    texts = [str(t) for t in np.asarray(df[column])]
    enc = tokenizer(
        texts,
        add_special_tokens=False,
        padding="max_length",
        truncation=True,
        max_length=max_length,
    )
    new_column = f"{column}_encode_{tokenizer.name_or_path}"
    tokens = np.asarray(enc["input_ids"], dtype=np.int32)
    return df.with_columns(**{new_column: Ragged.from_dense(tokens)}), new_column


def create_article_id_to_value_mapping(
    df: Table,
    value_col: str,
    article_col: str = DEFAULT_ARTICLE_ID_COL,
) -> dict:
    """{article_id: value} dict (reference: _articles.py:21-28)."""
    ids = np.asarray(df[article_col])
    col = df[value_col]
    if isinstance(col, Ragged):
        return {int(i): col.row(j) for j, i in enumerate(ids)}
    return {int(i): col[j] for j, i in enumerate(ids)}


def build_token_lookup(
    df: Table,
    token_col: str,
    article_col: str = DEFAULT_ARTICLE_ID_COL,
    unknown_representation: str = "zeros",
) -> Lookup:
    """Dense [V+1, T] int32 token table from a tokenized article table."""
    col = df[token_col]
    if isinstance(col, Ragged):
        widths = np.unique(col.lengths)
        if len(widths) != 1:
            raise ValueError("token column must be fixed-width; tokenize with padding")
        values = col.values.reshape(len(col), int(widths[0]))
    else:
        values = np.asarray(col)
    return Lookup.from_values(
        np.asarray(df[article_col]), values.astype(np.int32), unknown_representation
    )


def build_value_lookup(
    df: Table,
    value_col: str,
    article_col: str = DEFAULT_ARTICLE_ID_COL,
    unknown_representation: str = "zeros",
    dtype=None,
) -> Lookup:
    """Dense [V+1, D] value table (e.g. document embeddings, category ids)."""
    col = df[value_col]
    if isinstance(col, Ragged):
        widths = np.unique(col.lengths)
        if len(widths) != 1:
            raise ValueError("value column must be fixed-width")
        values = col.values.reshape(len(col), int(widths[0]))
    else:
        values = np.asarray(col)
        if values.ndim == 1:
            values = values[:, None]
    if dtype is not None:
        values = values.astype(dtype)
    return Lookup.from_values(np.asarray(df[article_col]), values, unknown_representation)


def load_article_id_embeddings(
    df: Table, path, item_col: str = DEFAULT_ARTICLE_ID_COL
) -> Table:
    """Left-join a document-embedding parquet onto the articles table
    (reference: _articles.py:11-18)."""
    emb = read_parquet(path)
    emb_ids = np.asarray(emb[item_col])
    order = np.argsort(emb_ids, kind="stable")
    sorted_ids = emb_ids[order]
    ids = np.asarray(df[item_col])
    pos = np.minimum(np.searchsorted(sorted_ids, ids), len(sorted_ids) - 1)
    if not (sorted_ids[pos] == ids).all():
        raise ValueError("articles missing from embedding parquet")
    idx = order[pos]
    out = dict((n, df[n]) for n in df.columns)
    for name in emb.columns:
        if name == item_col:
            continue
        col = emb[name]
        out[name] = col.take_rows(idx) if isinstance(col, Ragged) else col[idx]
    return Table(out)


def create_sort_based_prediction_score(
    df: Table,
    column: str,
    desc: bool = True,
    article_col: str = DEFAULT_ARTICLE_ID_COL,
    prediction_score_col: str = "prediction_score",
) -> Table:
    """Rank articles by a popularity-style column and attach 1/rank scores
    (reference: _articles.py:82-131) — used by the feature baselines."""
    vals = np.asarray(df[column], dtype=np.float64)
    vals = np.where(np.isnan(vals), -np.inf if desc else np.inf, vals)
    order = np.argsort(-vals if desc else vals, kind="stable")
    ranks = np.empty(len(vals), dtype=np.int64)
    ranks[order] = np.arange(1, len(vals) + 1)
    return df.with_columns(**{prediction_score_col: (1.0 / ranks).astype(np.float32)})


class VocabTokenizer:
    """Word-level tokenizer over a vocabulary file (one token per line, id =
    line number, with BERT's ``[PAD]``, ``[UNK]``, ``[CLS]`` and ``[SEP]``),
    with the call surface ``convert_text2encoding_with_transformers`` uses.
    It gives ``BertTokenizerFast(vocab_file=...)``'s ids where the
    vocabulary holds whole words (no ``##`` pieces), as the CLI's synthetic
    vocabulary does: text is lowercased, decomposed (NFD) and stripped of
    combining marks, split on whitespace and around punctuation, and each
    word is looked up whole, else ``[UNK]`` (so "mål" becomes [UNK] against
    a vocabulary that holds "mål": its stripped form "mal" is not there).
    """

    max_input_chars_per_word = 100  # longer words are [UNK], as in BERT's WordPiece

    def __init__(self, vocab_file):
        tokens = Path(vocab_file).read_text(encoding="utf-8").split("\n")
        self.vocab: dict[str, int] = {}
        for i, tok in enumerate(tokens):
            if tok:
                self.vocab.setdefault(tok, i)
        for tok in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            if tok not in self.vocab:
                raise ValueError(f"{tok} is not in the vocabulary {vocab_file}")
        self.pad_id, self.unk_id = self.vocab["[PAD]"], self.vocab["[UNK]"]
        self.cls_id, self.sep_id = self.vocab["[CLS]"], self.vocab["[SEP]"]
        self.name_or_path = ""

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @staticmethod
    def _normalize(text: str) -> str:
        """BERT's normaliser: control characters dropped, whitespace to
        spaces, CJK characters spaced, then lowercase, NFD and no
        combining marks."""
        out = []
        for ch in unicodedata.normalize("NFD", text.lower()):
            cat = unicodedata.category(ch)
            if ch in "\x00\ufffd" or cat == "Mn":
                continue
            if ch in "\t\n\r" or cat == "Zs":
                out.append(" ")
            elif cat.startswith("C"):
                continue
            elif _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def tokenize(self, text: str) -> list[str]:
        """The words of ``text`` after normalisation, punctuation split off."""
        words = []
        for word in self._normalize(text).split():
            start = 0
            for i, ch in enumerate(word):
                if _is_punctuation(ch):
                    if i > start:
                        words.append(word[start:i])
                    words.append(ch)
                    start = i + 1
            if start < len(word):
                words.append(word[start:])
        return words

    def _id(self, word: str) -> int:
        if len(word) > self.max_input_chars_per_word:
            return self.unk_id
        return self.vocab.get(word, self.unk_id)

    def __call__(self, texts: list[str], add_special_tokens: bool = True, padding=False,
                 truncation: bool = False, max_length=None) -> dict:
        """``{"input_ids": [[...], ...]}`` for a list of texts: truncated to
        ``max_length`` (specials included) when ``truncation``, padded on the
        right to ``max_length`` with ``padding="max_length"``."""
        if padding not in (False, "max_length"):
            raise ValueError(f"VocabTokenizer pads to max_length only, got padding={padding!r}")
        out = []
        for text in texts:
            ids = [self._id(w) for w in self.tokenize(str(text))]
            if truncation and max_length is not None:
                ids = ids[:max(0, max_length - (2 if add_special_tokens else 0))]
            if add_special_tokens:
                ids = [self.cls_id] + ids + [self.sep_id]
            if padding == "max_length" and max_length is not None:
                ids = ids + [self.pad_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": out}


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)
