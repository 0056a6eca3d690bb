"""The port's counter-based dropout masks (``ops/philox.py``): Random123's
published Philox4x32-10 known answers, the 24-bit keep threshold, the
64-bit seed, and masks that do not depend on how the rows are split. The
CUDA device function is held against this plain version on the card
(``chip_smoke.py``); here ``dump_masks`` on the CPU is the plain version."""
import numpy as np
import pytest
import torch

from ebnerd_tpu_torch.ops import philox

torch.set_num_threads(1)

# Random123 kat_vectors: philox4x32_10 (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,expected", KAT, ids=["zeros", "ones", "pi"])
def test_known_answer_vectors(ctr, key, expected):
    out = philox.philox4x32(torch.tensor([ctr], dtype=torch.int64), key)[0]
    assert tuple(int(v) for v in out) == expected


def test_mask_values_and_keep_rate():
    m = philox.mask(123, philox.STREAM_EMB, 256, 128, 0.8)
    assert m.dtype == torch.float32 and m.shape == (256, 128)
    scale = torch.tensor(1.0) / torch.tensor(0.8)
    assert set(torch.unique(m).tolist()) == {0.0, float(scale)}
    assert abs((m > 0).float().mean().item() - 0.8) < 0.01
    assert philox.threshold(0.8) == int(0.8 * (1 << 24))


def test_mask_is_the_24_bit_threshold_of_the_counter_words():
    seed, stream, rows, width = (7 << 32) | 11, 1, 5, 10
    m = philox.mask(seed, stream, rows, width, 0.5)
    groups = -(-width // 4)
    r, g = np.meshgrid(np.arange(rows), np.arange(groups), indexing="ij")
    ctr = torch.tensor(np.stack([r, g, np.full_like(r, stream), np.zeros_like(r)], -1))
    bits = philox.philox4x32(ctr, (11, 7)).reshape(rows, groups * 4)[:, :width]
    np.testing.assert_array_equal((m > 0).numpy(), ((bits >> 8) < (1 << 23)).numpy())


def test_deterministic_and_seeded_by_all_64_bits():
    a = philox.mask(5, 0, 64, 32, 0.8)
    assert torch.equal(a, philox.mask(5, 0, 64, 32, 0.8))
    assert not torch.equal(a, philox.mask(6, 0, 64, 32, 0.8))
    assert not torch.equal(a, philox.mask(5 + (1 << 32), 0, 64, 32, 0.8))  # high word only
    assert not torch.equal(a, philox.mask(5, 1, 64, 32, 0.8))             # other stream
    assert philox.split_seed((1 << 64) - 1) == (0xFFFFFFFF, 0xFFFFFFFF)
    assert philox.split_seed(torch.tensor([9])) == (9, 0)
    with pytest.raises(ValueError):
        philox.split_seed(1 << 64)


@pytest.mark.parametrize("cut", [1, 7, 30, 63])
def test_masks_do_not_depend_on_the_row_split(cut):
    """Each element has its own counter, so a block of rows starting
    anywhere regenerates its part of the mask bit for bit."""
    full = philox.mask(99, 1, 64, 24, 0.8)
    top = philox.mask(99, 1, cut, 24, 0.8)
    rest = philox.mask(99, 1, 64 - cut, 24, 0.8, row0=cut)
    assert torch.equal(torch.cat([top, rest]), full)


def test_dump_masks_on_the_cpu_is_the_plain_version():
    before = philox.dump_masks.launches
    out = philox.dump_masks(123, 0, 64 * 30, 128, 0.8, device="cpu")
    assert torch.equal(out, philox.mask(123, 0, 64 * 30, 128, 0.8))
    assert philox.dump_masks.launches == before


def test_threshold_refuses_keep_outside_unit_interval():
    for keep in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError):
            philox.threshold(keep)
