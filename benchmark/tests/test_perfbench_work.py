"""The FLOP and byte counts at one small shape against counts made by
hand."""
import pytest

from benchmark import work

CFG = {"title_size": 3, "word_emb_dim": 8, "head_num": 2, "head_dim": 2,
       "attention_hidden_dim": 5, "compute_dtype": "bfloat16"}
MIX = {"history_size": 4, "npratio": 1}
PEAK = {"flops": {"bfloat16": 1e3, "float32": 5e2}, "bytes_per_s": 10.0}


def test_encoder_flops_by_hand():
    # t 3, din 8, d 4, a 5: QKV 3*(3*8*4*2)=576, QK^T and PV 2*(3*3*4*2)=144,
    # tanh(oW) 3*4*5*2=120, its q 3*5*2=30
    assert work.encoder_fwd_flops(3, 8, 4, 5) == 576 + 144 + 120 + 30


def test_step_flops_by_hand():
    x = work.dims(CFG, MIX)
    art = 870                     # above
    user = 3 * 4 * 4 * 4 * 2 + 2 * 4 * 4 * 4 * 2 + 4 * 4 * 5 * 2 + 4 * 5 * 2  # 384+256+160+40
    assert work.user_flops(x) == user
    # 2 impressions, 3 unique articles, k 2 logits of width 4
    assert work.step_flops(x, 2, 3) == 3.0 * (3 * art + 2 * user + 2 * 2 * 4 * 2)


def test_encoder_bytes_and_least_time_by_hand():
    (ff, fb), (bf, bb) = work.encoder_calls(n=2, t=3, din=8, d=4, a=5, es=2)
    w = 3 * 8 * 4 + 4 * 5 + 2 * 5           # 126 weights
    assert ff == 2 * 870 and bf == 2 * ff
    assert fb == 2 * 3 * 8 * 2 + w * 2 + 2 * 4 * 4              # x, weights, fp32 out
    assert bb == 2 * (2 * 3 * 8 * 2) + w * 2 + 2 * 4 * 4 + w * 4  # x, dx, w, g, dw fp32
    assert work.least_s([(ff, fb), (bf, bb)], "bfloat16", PEAK) == pytest.approx(
        max(ff / 1e3, fb / 10.0) + max(bf / 1e3, bb / 10.0))


def test_attention_by_hand():
    (ff, fb), (bf, bb) = work.attention_calls(n=2, t=3, d=4, es=4)
    assert ff == 2 * 2 * 3 * 3 * 4 * 2 and bf == 2 * ff
    assert fb == 2 * 3 * 4 * 4 * 4 and bb == 2 * 3 * 4 * 4 * 7


def test_peaks_by_card_name():
    assert work.peaks("NVIDIA H100 80GB HBM3")["flops"] == {"bfloat16": 989e12, "float32": 495e12}
    assert work.peaks("NVIDIA H100 PCIe")["bytes_per_s"] == 2.0e12
