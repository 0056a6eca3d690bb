"""device.idle_wait_pct: the share of the traced window in which the device
is idle while ``fit``'s loop waits for its next batch: the idle gaps that
``devtrace`` names by the main thread's ``trainer.wait`` range (the port's
span, ``training/trainer.py`` ``_prefetched``), over the window's host-clock
length. A part of ``device.idle_pct``. Nothing to read where the program
records no such span."""


def read(ctx):
    try:
        from ebnerd_tpu_torch.utils.logging import span_totals
    except ImportError:
        return None
    waits = span_totals().get("trainer.wait", (0, 0.0))[0]
    if not waits or not ctx.window_s or not ctx.trace.kernels:
        return None
    waited = sum(s for name, s in ctx.trace.gaps_by_host.items() if name.endswith("trainer.wait"))
    return 100.0 * waited / ctx.window_s
