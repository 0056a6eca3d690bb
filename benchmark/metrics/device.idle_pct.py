"""device.idle_pct: the share of the traced window in which no kernel runs
on the device (one minus the union of the kernel intervals over the
window's host-clock length)."""


def read(ctx):
    if not ctx.window_s or not ctx.trace.kernels:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s / ctx.window_s)
