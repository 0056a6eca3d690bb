"""The port's CLI (``ebnerd_tpu_torch/train_newsrec.py``) against the JAX
CLI (``examples/train_newsrec.py``): every flag with its default; on
``--synthetic --debug`` the stages up to the trainer (the sampled and
labelled train table, the val table, the lookup and its token, side and
docvec tables, the user mapping) equal, the splits the port builds in
memory against the parquet files the JAX CLI writes and reads back;
``build_model`` of each of the six families, loaded with the JAX model's
parameters through ``bridge.py``, gives its logits (fp32, 5e-5), and the
pretrained word vectors land as JAX's do; a full run on the CPU writes
every output, ``--resume`` continues from the checkpoint exactly,
``--sparse_embedding`` reaches the trainer as the JAX CLI's does and
trains (NRMS, and NAML's title and body tables), and the default device is
the card."""
import functools
import importlib.util
import json
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebnerd_tpu.models import inputs as jax_inputs
from ebnerd_tpu_torch import bridge
from ebnerd_tpu_torch import train_newsrec as cli
from ebnerd_tpu_torch.models import builder_for
from ebnerd_tpu_torch.utils.logging import ScalarLogger
from tests.test_torch_data_layer import same

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_train_newsrec",
                                               ROOT / "examples" / "train_newsrec.py")
jcli = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jcli)

SMALL = ["--head_num", "2", "--head_dim", "4"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The CLI's scalar logger without its TensorBoard writer (whose import
    alone takes seconds here; ``test_torch_logging.py`` covers the logger)."""
    monkeypatch.setattr(cli, "ScalarLogger", functools.partial(ScalarLogger, tensorboard=False))


def test_get_args_has_every_jax_flag_with_its_default():
    jargs, pargs = vars(jcli.get_args([])), vars(cli.get_args([]))
    assert pargs.pop("device") == "cuda"
    assert pargs == jargs
    flags = ["--synthetic", "--debug", "--sparse_embedding", "--prng_dropout", "--remat_encoder",
             "--use_fused_encoder", "--no_two_tower_eval", "--no_dedup", "--no_ckpt", "--resume",
             "--run_test", "--model", "naml", "--dtype", "bfloat16", "--encode_chunks", "2"]
    assert vars(jcli.get_args(flags)) == {k: v for k, v in vars(cli.get_args(flags)).items()
                                          if k != "device"}


class _Stop(Exception):
    pass


def _stages(module, monkeypatch, argv):
    """Run ``module.main(argv)`` up to the trainer and return what reaches
    the feeds and the trainer."""
    got = {}

    def feed(name):
        def make(df, lookup, **kw):
            got[name] = (df, lookup, kw.get("user_mapping"))
        return make

    def trainer(model, tables, builder, config, **kw):
        got["tables"], got["config"] = tables, config
        raise _Stop

    monkeypatch.setattr(module, "NewsrecFeed", feed("train"))
    monkeypatch.setattr(module, "EvalFeed", feed("val"))
    monkeypatch.setattr(module, "Trainer", trainer)
    with pytest.raises(_Stop):
        module.main(argv)
    return got


@pytest.mark.parametrize("model", ["nrms", "naml", "nrms_docvec", "lstur"])
def test_cli_stages_equal_the_jax_cli(monkeypatch, tmp_path, model):
    argv = ["--model", model, "--synthetic", "--debug"] + SMALL
    j = _stages(jcli, monkeypatch, argv + ["--out_dir", str(tmp_path / "jax")])
    p = _stages(cli, monkeypatch, argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    for name in ("train", "val"):
        (jdf, jlk, jmap), (pdf, plk, pmap) = j[name], p[name]
        same(jdf, pdf, name)
        same(jlk.ids, plk.ids, name + " lookup ids")
        same(jlk.matrix, plk.matrix, name + " lookup matrix")
        assert jmap == pmap and (jmap is not None) == (model == "lstur")
    same(j["tables"], p["tables"], "tables")
    assert set(p["tables"]) == {"nrms": {"title"}, "lstur": {"title"},
                                "naml": {"title", "body", "cat", "subcat"},
                                "nrms_docvec": {"docvec"}}[model]
    assert (p["config"].l2_regularization, p["config"].seed) == (
        j["config"].l2_regularization, j["config"].seed)
    # the JAX CLI's synthetic splits are parquet files; the port's are built in memory
    assert (tmp_path / "jax" / "synthetic").exists()
    assert not (tmp_path / "port" / "synthetic").exists()


# -- build_model: six families through the bridge ------------------------------------

VOCAB, T, H, K, B, N_ART = 40, 6, 5, 3, 2, 12


def _model_args(family):
    return cli.get_args(["--model", family, "--max_title_length", str(T), "--history_size",
                         str(H), "--attention_hidden_dim", "8", "--dropout", "0.0", "--device",
                         "cpu"] + SMALL)


def _tables(family):
    rng = np.random.default_rng(3)
    if family == "nrms_docvec":
        return {"docvec": rng.standard_normal((N_ART + 1, 768)).astype(np.float32)}
    tables = {"title": rng.integers(1, VOCAB, (N_ART + 1, T)).astype(np.int32)}
    if family == "naml":
        tables["body"] = rng.integers(1, VOCAB, (N_ART + 1, 40)).astype(np.int32)
        tables["cat"] = rng.integers(0, 10, N_ART + 1).astype(np.int32)
        tables["subcat"] = rng.integers(0, 50, N_ART + 1).astype(np.int32)
    return tables


def _raw():
    rng = np.random.default_rng(4)
    return {"hist_idx": rng.integers(0, N_ART + 1, (B, H)).astype(np.int32),
            "cand_idx": rng.integers(1, N_ART + 1, (B, K)).astype(np.int32),
            "user_idx": np.array([1, 3], np.int32)}


def _bridge(family, model, variables):
    params = jax.device_get(variables["params"])
    if family == "nrms":
        return bridge.load_nrms_params(model, params)
    if family == "lstur":
        return bridge.load_lstur_params(model, params)
    if family == "naml":
        return bridge.load_naml_params(model, params)
    sd = {"npa": lambda: bridge.npa_state_dict(params),
          "fastformer": lambda: bridge.fastformer_state_dict(params),
          "nrms_docvec": lambda: bridge.nrms_docvec_state_dict(
              params, jax.device_get(variables["batch_stats"]))}[family]()
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("family", cli.MODELS)
def test_build_model_gives_jax_logits_through_the_bridge(family):
    args = _model_args(family)
    vocab, emb = (0, 300) if family == "nrms_docvec" else (VOCAB, 16)
    jmodel = jcli.build_model(args, vocab, emb, None, 4)
    tables, raw = _tables(family), _raw()
    jbatch = jax_inputs.builder_for(family)({k: jnp.asarray(v) for k, v in tables.items()},
                                            {k: jnp.asarray(v) for k, v in raw.items()})
    variables = jmodel.init(jax.random.PRNGKey(0), jbatch)
    want = np.asarray(jmodel.apply(variables, jbatch, False))
    model = _bridge(family, cli.build_model(args, vocab, emb, None, 4), variables)
    assert model.device.type == "cpu" and model.dtype == torch.float32
    batch = builder_for(family)({k: torch.from_numpy(v) for k, v in tables.items()}, raw)
    with torch.no_grad():
        got = model.eval()(batch).numpy()
    assert got.shape == want.shape == (B, K)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("family", ["nrms", "lstur", "npa", "naml"])
def test_pretrained_word_vectors_land_as_in_jax(family):
    args = _model_args(family)
    w2v = np.random.default_rng(5).standard_normal((VOCAB, 16))  # float64, cast to fp32
    jmodel = jcli.build_model(args, VOCAB, 16, w2v, 4)
    tables, raw = _tables(family), _raw()
    jbatch = jax_inputs.builder_for(family)({k: jnp.asarray(v) for k, v in tables.items()},
                                            {k: jnp.asarray(v) for k, v in raw.items()})
    jtable = np.asarray(jmodel.init(jax.random.PRNGKey(0), jbatch)["params"]
                        ["word_embedding"]["embedding"])
    model = cli.build_model(args, VOCAB, 16, w2v, 4)
    table = model.word_embedding.embedding.detach().numpy()
    assert table.dtype == jtable.dtype == np.float32 and np.array_equal(table, jtable)
    # the other parameters are those of the model built without the vectors
    plain = cli.build_model(args, VOCAB, 16, None, 4)
    for (name, a), (_, b) in zip(model.named_parameters(), plain.named_parameters()):
        if name != "word_embedding.embedding":
            assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="embedding shape"):
        cli.build_model(args, VOCAB + 1, 16, w2v, 4)


def test_fastformer_takes_no_pretrained_vectors_or_kernel_dropout():
    """As the JAX CLI builds it: Fastformer ignores the vectors and
    --prng_dropout; LSTUR, NPA and NAML take --prng_dropout."""
    w2v = np.ones((VOCAB, 16), np.float32)
    args = cli.get_args(["--model", "fastformer", "--prng_dropout", "--device", "cpu"])
    model = cli.build_model(args, VOCAB, 16, w2v, 1)
    assert not (model.word_embedding.embedding == 1).all()
    assert not model.emb_drop.use_kernel
    for family in ("lstur", "npa", "naml"):
        args = cli.get_args(["--model", family, "--prng_dropout", "--device", "cpu"])
        assert cli.build_model(args, VOCAB, 16, None, 4).drop.use_kernel


# -- whole runs ----------------------------------------------------------------

def _zip_rows(path):
    with zipfile.ZipFile(path) as z:
        (name,) = z.namelist()
        lines = z.read(name).decode().split("\n")
    return {int(ln.split(" ")[0]): json.loads(ln.split(" ", 1)[1]) for ln in lines if ln}


def test_main_on_the_cpu_writes_every_output(tmp_path):
    out = tmp_path / "run"
    results = cli.main(["--model", "nrms", "--synthetic", "--debug", "--device", "cpu",
                        "--run_test", "--n_chunks_test", "2", "--out_dir", str(out)] + SMALL)
    for name in ("args.json", "results.json", "vocab.txt", "nrms_predictions.zip",
                 "nrms_test_predictions.zip", "logs/scalars.jsonl"):
        assert (out / name).exists(), name
    assert (out / "checkpoints" / "meta.json").exists()
    saved = json.loads((out / "results.json").read_text())
    assert saved == results
    assert set(saved) == {"auc", "mrr", "ndcg@5", "ndcg@10", "train_seconds",
                          "impressions_per_sec"}
    assert all(np.isfinite(v) for v in saved.values()) and 0 <= saved["auc"] <= 1
    assert json.loads((out / "args.json").read_text())["device"] == "cpu"
    val, _ = cli._synthetic_split("validation", 42, 20)
    test, _ = cli._synthetic_split("test", 42, 20)
    for zname, df in (("nrms_predictions.zip", val), ("nrms_test_predictions.zip", test)):
        rows = _zip_rows(out / zname)
        ids = np.asarray(df["impression_id"]).tolist()
        assert sorted(rows) == sorted(ids) and len(rows) == len(ids)  # each impression once
        lengths = dict(zip(ids, df["article_ids_inview"].lengths.tolist()))
        for imp, ranks in rows.items():
            assert sorted(ranks) == list(range(1, lengths[imp] + 1)), imp


def test_resume_continues_from_the_checkpoint(tmp_path):
    base = ["--model", "nrms", "--synthetic", "--device", "cpu", "--train_fraction", "0.1",
            "--bs_train", "64"] + SMALL
    whole = cli.main(base + ["--epochs", "2", "--out_dir", str(tmp_path / "whole")])
    cli.main(base + ["--epochs", "1", "--out_dir", str(tmp_path / "cut")])
    resumed = cli.main(base + ["--epochs", "2", "--resume", "--out_dir", str(tmp_path / "cut")])
    meta = json.loads((tmp_path / "cut" / "checkpoints" / "meta.json").read_text())
    assert meta["epoch"] == 1 and len(meta["history"]) == 2
    for k in ("auc", "mrr", "ndcg@5", "ndcg@10"):
        assert resumed[k] == whole[k], k


@pytest.mark.parametrize("model", ["nrms", "naml"])
def test_sparse_embedding_stages_equal_the_jax_cli(monkeypatch, tmp_path, model):
    """``--sparse_embedding`` reaches the trainer's config as in the JAX CLI,
    beside the same tables (NAML's body too: its ids go through the shared
    word table)."""
    argv = ["--model", model, "--synthetic", "--debug", "--sparse_embedding"] + SMALL
    j = _stages(jcli, monkeypatch, argv + ["--out_dir", str(tmp_path / "jax")])
    p = _stages(cli, monkeypatch, argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    same(j["tables"], p["tables"], "tables")
    for field in ("sparse_embedding", "sparse_embed_param", "sparse_min_bucket",
                  "sparse_token_tables", "l2_regularization", "dedup_articles", "adam_mu_dtype"):
        assert getattr(p["config"], field) == getattr(j["config"], field), field
    assert p["config"].sparse_embedding is True


@pytest.mark.parametrize("model", ["nrms", "naml"])
def test_sparse_embedding_trains_and_writes_results(tmp_path, model):
    out = tmp_path / "run"
    results = cli.main(["--model", model, "--synthetic", "--debug", "--device", "cpu",
                        "--sparse_embedding", "--epochs", "1", "--out_dir", str(out)] + SMALL)
    saved = json.loads((out / "results.json").read_text())
    assert saved == results and all(np.isfinite(v) for v in saved.values())
    assert 0 <= saved["auc"] <= 1 and (out / f"{model}_predictions.zip").exists()
    assert json.loads((out / "args.json").read_text())["sparse_embedding"] is True


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_main_defaults_to_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--synthetic", "--debug", "--out_dir", str(tmp_path)])
    assert not tmp_path.joinpath("args.json").exists()
