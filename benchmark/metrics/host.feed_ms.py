"""host.feed_ms: milliseconds a batch of the prefetch thread's whole host
work (the port's ``feed.batch`` span, ``training/trainer.py``
``_run_epoch``: the feed's batch build, ``_prep_host``'s dedup and the
pinning), over the traced window's batches. Nothing to read where the
program records no such span."""


def read(ctx):
    try:
        from ebnerd_tpu_torch.utils.logging import span_totals
    except ImportError:
        return None
    count, seconds = span_totals().get("feed.batch", (0, 0.0))
    return 1e3 * seconds / count if count else None
