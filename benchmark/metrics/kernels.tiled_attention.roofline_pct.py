"""kernels.tiled_attention.roofline_pct: the tiled route's attention
kernels (T2 and T4, ``tiled_attention*``: the part files of group
"tiled_attention"), which run the user tower past T 32, against the least
time of the user tower's attention, forward and backward, over the traced
window's batches (``work.user_attention_least_s``). Nothing to read where
the user tower takes another route."""
from benchmark import work


def read(ctx):
    t = ctx.trace.group_s.get("tiled_attention")
    if not t or not ctx.batches:
        return None
    x = work.dims(ctx.cfg, ctx.mix)
    least = sum(work.user_attention_least_s(x, len(b["labels"]), ctx.peak) for b in ctx.batches)
    return 100.0 * least / t
