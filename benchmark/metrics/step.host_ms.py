"""step.host_ms: host milliseconds a step in ``Trainer.step`` (the port's
``trainer.step`` span in ``fit``'s loop, ``training/trainer.py``: the
forward, backward and Adam launched, and the host blocked where the
command buffer is full), over the traced window's steps. Nothing to read
where the program records no such span."""


def read(ctx):
    try:
        from ebnerd_tpu_torch.utils.logging import span_totals
    except ImportError:
        return None
    count, seconds = span_totals().get("trainer.step", (0, 0.0))
    return 1e3 * seconds / count if count else None
