"""The port stands alone: no module of ``ebnerd_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax, optax or ``ebnerd_tpu``, and the
package imports without triton or nvcc. The check is a static scan of the
sources (an interpreter here may load jax at start-up)."""
import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax"}
SOURCES = sorted((ROOT / "ebnerd_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return (module.split(".")[0] in FORBIDDEN_ROOTS or module == "ebnerd_tpu"
            or module.startswith("ebnerd_tpu."))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_forbidden_matches_exact_names():
    assert _forbidden("jax.numpy") and _forbidden("ebnerd_tpu") and _forbidden("ebnerd_tpu.data")
    assert not _forbidden("ebnerd_tpu_torch") and not _forbidden("ebnerd_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_triton_or_nvcc():
    """Every module imports on a machine with no triton and no nvcc: the
    kernels are built at first launch, not at import."""
    import ebnerd_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(ebnerd_tpu_torch.__path__,
                                                   "ebnerd_tpu_torch.")]
    assert "ebnerd_tpu_torch.ops.news_encoder" in names
    for name in names:
        importlib.import_module(name)
    from ebnerd_tpu_torch.ops import _build
    assert not _build._libs  # nothing loaded or compiled by importing


def test_scan_covers_the_cli_and_the_data_layer():
    """The static scan reaches the CLI and every module the CLI brings in:
    the data layer, evaluation and utils."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in ("train_newsrec", "data/behaviors", "data/history", "data/articles",
                 "data/synthetic", "data/ops", "data/decay", "data/descriptive", "data/nlp",
                 "evaluation/beyond_accuracy", "evaluation/utils", "utils/misc",
                 "utils/logging"):
        assert f"ebnerd_tpu_torch/{name}.py" in scanned, name


def test_scan_covers_the_sparse_mode_and_the_optimizer():
    """The scan reaches the row-sparse mode, the hand-written Adam and the
    embedding-slab tool, each a copy or counterpart of a JAX module."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in ("training/sparse_embed", "training/adam", "tools/embed_grad"):
        assert f"ebnerd_tpu_torch/{name}.py" in scanned, name


def test_scan_covers_the_parallel_layer_and_the_parity_tools():
    """The scan reaches ``parallel/`` and the accuracy and multi-process
    tools, each a counterpart of a JAX module or script."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in ("parallel/__init__", "parallel/mesh", "parallel/distributed",
                 "tools/parity_headline", "tools/parity_train", "tools/dryrun_multihost"):
        assert f"ebnerd_tpu_torch/{name}.py" in scanned, name
