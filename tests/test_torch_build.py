"""The port's kernel build bookkeeping, which runs on any machine: library
names follow the source and the nvcc flags, and nothing is compiled until
a kernel is asked for. The compile itself needs nvcc and runs on the card's
machine (chip_smoke.py)."""
import torch

from ebnerd_tpu_torch.ops import _build
from ebnerd_tpu_torch.tools import kernel_phases

torch.set_num_threads(1)


def test_library_name_follows_source_and_flags():
    plain = _build._target("news_encoder")
    assert plain.parent == _build.BUILD_DIR and plain.suffix == ".so"
    assert plain == _build._target("news_encoder", ())
    variants = {_build._target("news_encoder", flags)
                for flags in kernel_phases.VARIANTS.values()}
    assert len(variants) == len(kernel_phases.VARIANTS) and plain in variants


def test_every_source_exists_and_targets_sm90a():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_profiling_tool_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        return
    assert kernel_phases.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
