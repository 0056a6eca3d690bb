"""fit.prepare_ms: host milliseconds a batch in ``Trainer.prepare`` (the
port's ``trainer.prepare`` span in ``fit``'s loop, ``training/trainer.py``:
the batch build and the copies to the card issued), over the traced
window's batches. Nothing to read where the program records no such
span."""


def read(ctx):
    try:
        from ebnerd_tpu_torch.utils.logging import span_totals
    except ImportError:
        return None
    count, seconds = span_totals().get("trainer.prepare", (0, 0.0))
    return 1e3 * seconds / count if count else None
