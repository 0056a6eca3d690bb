"""step.mfu_pct: the whole training step's share of the card's peak for the
compute dtype: the model's FLOPs of every batch of the traced window
(``work.step_flops``: forward x 3 over the batch's unique articles, its
users and its logits) over the window's host-clock length."""
from benchmark import work


def read(ctx):
    if not ctx.batches:
        return None
    x = work.dims(ctx.cfg, ctx.mix)
    flops = sum(work.step_flops(x, len(b["labels"]), work.n_unique(b)) for b in ctx.batches)
    return 100.0 * flops / ctx.window_s / ctx.peak["flops"][x["dtype"]]
