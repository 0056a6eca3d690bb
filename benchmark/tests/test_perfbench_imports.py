"""Nothing the harness runs loads JAX, flax, optax or the JAX package
(top-level module names compared whole), and the plain references import
nothing of the program."""
import ast
import json
import subprocess
import sys

from benchmark import core

RUN = """
import sys, json
sys.path.insert(0, {repo!r})
from benchmark import core, readings
from benchmark.tests.conftest import tiny
out = core.run_cell(tiny("nrms-fp32.h50"), 5, 0.3, True, "cpu")
print(json.dumps({{"bad": core.forbidden_modules(), "correct": out["correct"],
                  "ebnerd_torch": "ebnerd_tpu_torch" in sys.modules}}))
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", RUN.format(repo=str(core.REPO))],
                          capture_output=True, text=True, timeout=600, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "correct": True, "ebnerd_torch": True}


def test_forbidden_names_are_whole_top_level_names():
    before = dict(sys.modules)
    try:
        sys.modules["ebnerd_tpu_torch_probe"] = object()
        sys.modules["flaxen.x"] = object()
        assert core.forbidden_modules() == [m for m in core.forbidden_modules()
                                            if m.split(".")[0] in core.FORBIDDEN]
        assert "ebnerd_tpu_torch_probe" not in core.forbidden_modules()
        sys.modules["optax.sub"] = object()
        assert "optax.sub" in core.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    for path in sorted((core.HERE / "references").glob("*.py")):
        assert _imports(path) <= {"__future__", "contextlib", "math", "typing", "numpy", "torch"}, path


def test_harness_imports_no_jax():
    for path in sorted(core.HERE.rglob("*.py")):
        assert not _imports(path) & set(core.FORBIDDEN), path
