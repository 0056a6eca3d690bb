"""fit.wait_ms: milliseconds a step that ``fit``'s loop waits for its next
batch on the prefetch queue (the port's ``trainer.wait`` span,
``training/trainer.py`` ``_prefetched``), over the traced window's steps
(its ``trainer.step`` spans). Nothing to read where the program records no
such span."""


def read(ctx):
    try:
        from ebnerd_tpu_torch.utils.logging import span_totals
    except ImportError:
        return None
    totals = span_totals()
    waits, steps = (totals.get(k, (0, 0.0))[0] for k in ("trainer.wait", "trainer.step"))
    if not waits or not steps:
        return None
    return 1e3 * totals["trainer.wait"][1] / steps
