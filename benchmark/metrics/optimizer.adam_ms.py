"""optimizer.adam_ms: device milliseconds a step inside the optimizer's
annotated range (``Optimizer.step#Adam.step``, ``torch.optim.Adam``'s step
in ``training/trainer.py``), from the device trace."""


def read(ctx):
    s = sum(v for k, v in ctx.trace.annotation_s.items() if k.startswith("Optimizer.step#"))
    return 1e3 * s / ctx.steps if s and ctx.steps else None
