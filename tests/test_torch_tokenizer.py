"""The port's ``VocabTokenizer`` against ``BertTokenizerFast(vocab_file=...)``,
the tokenizer the JAX CLI builds for ``--synthetic``, over the same word
vocabulary (the corpus's title words): the ids of every title, subtitle
and body of a synthetic corpus are equal, at the title's and the body's
lengths, with and without special tokens; "mål" and "år" go to [UNK] in
both (their stripped forms are not in the vocabulary); and the token
tables ``convert_text2encoding_with_transformers`` makes are equal."""
import numpy as np
import pytest

from ebnerd_tpu import constants as c
from ebnerd_tpu.data.articles import convert_text2encoding_with_transformers as j_convert
from ebnerd_tpu.data.synthetic import make_synthetic_articles
from ebnerd_tpu_torch.data.articles import VocabTokenizer
from ebnerd_tpu_torch.data.articles import convert_text2encoding_with_transformers as p_convert
from ebnerd_tpu_torch.data.table import Table as PTable

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic articles, their texts and the vocabulary file the CLIs
    write."""
    arts = make_synthetic_articles(np.random.default_rng(42), 500)
    vocab = sorted({w for t in np.asarray(arts[c.DEFAULT_TITLE_COL]) for w in str(t).split()})
    vp = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vp.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + vocab))
    texts = [str(t) for col in (c.DEFAULT_TITLE_COL, c.DEFAULT_SUBTITLE_COL, c.DEFAULT_BODY_COL)
             for t in np.asarray(arts[col])]
    return arts, texts, vp


@pytest.mark.parametrize("max_length", [30, 40])
@pytest.mark.parametrize("special", [False, True])
def test_ids_equal_bert_tokenizer_fast(corpus, max_length, special):
    _, texts, vp = corpus
    bert = transformers.BertTokenizerFast(vocab_file=str(vp))
    port = VocabTokenizer(vp)
    kw = dict(add_special_tokens=special, padding="max_length", truncation=True,
              max_length=max_length)
    assert port(texts, **kw)["input_ids"] == bert(texts, **kw)["input_ids"]
    assert port.vocab_size == bert.vocab_size and port.name_or_path == bert.name_or_path


def test_accented_words_and_other_text(corpus):
    _, _, vp = corpus
    bert = transformers.BertTokenizerFast(vocab_file=str(vp))
    port = VocabTokenizer(vp)
    vocab = vp.read_text().split("\n")
    assert "mål" in vocab and "år" in vocab  # in the vocabulary, but stripped on the way in
    (ids,) = port(["mål år læge køb"], add_special_tokens=False)["input_ids"]
    assert ids[:2] == [1, 1] and ids[2:] == [vocab.index("læge"), vocab.index("køb")]
    texts = ["Mål og ÅR!", "LÆGE, køb: pris-krone.", "  tab\there\nnew  ", "日本 sol",
             "x" * 120, "", "sol " * 40, "ctrl\x07char \u00a0nbsp"]
    for kw in (dict(), dict(truncation=True, max_length=5),
               dict(add_special_tokens=False, padding="max_length", truncation=True,
                    max_length=12)):
        assert port(texts, **kw)["input_ids"] == bert(texts, **kw)["input_ids"], kw
    with pytest.raises(ValueError, match="max_length only"):
        port(texts, padding=True)


def test_token_tables_equal(corpus):
    arts, _, vp = corpus
    bert = transformers.BertTokenizerFast(vocab_file=str(vp))
    port = VocabTokenizer(vp)
    j, jcol = j_convert(arts, bert, c.DEFAULT_BODY_COL, max_length=40)
    p, pcol = p_convert(PTable({k: arts[k] for k in arts.columns if k != c.DEFAULT_SUBCATEGORY_COL}),
                        port, c.DEFAULT_BODY_COL, max_length=40)
    assert jcol == pcol
    assert np.array_equal(j[jcol].values, p[pcol].values) and j[jcol].values.dtype == np.int32
    assert np.array_equal(j[jcol].offsets, p[pcol].offsets)


def test_vocabulary_without_special_tokens_raises(tmp_path):
    vp = tmp_path / "v.txt"
    vp.write_text("[PAD]\nsol\n")
    with pytest.raises(ValueError, match=r"\[UNK\]"):
        VocabTokenizer(vp)
