"""The benchmark's own tests (run them with ``python -m pytest
benchmark/tests``; the repository's ``pytest tests/`` does not collect
them). Tests that need a CUDA card carry the ``chip`` marker and skip
without one; each looks for the card inside the test."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import core  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def tiny(name: str, **cfg) -> object:
    """A cell of BENCHMARK.json cut to a size the CPU holds in seconds:
    every width and the batch made small, the cell's limits kept."""
    cell = core.load_cell(name)
    cell.cfg = dict(cell.cfg, vocab_size=500, word_emb_dim=32, head_num=2, head_dim=4,
                    attention_hidden_dim=8, **cfg)
    cell.mix = dict(cell.mix, batch_size=16, articles=60, table_batches=4)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
