"""kernels.encoder.roofline_pct: the news encoder's kernels (``ops/news_encoder.py``:
K1, K2 and T1-T4, the part files of group "encoder") against their least
time: the model's work of both towers, forward and backward, over the
traced window's batches (``work.encoder_least_s``), over the device time
of the kernels the name table assigns to the encoder."""
from benchmark import work


def read(ctx):
    t = ctx.trace.group_s.get("encoder")
    if not t or not ctx.batches:
        return None
    x = work.dims(ctx.cfg, ctx.mix)
    least = sum(work.encoder_least_s(x, len(b["labels"]), work.n_unique(b), ctx.peak)
                for b in ctx.batches)
    return 100.0 * least / t
