"""host.dedup_ms: milliseconds a batch of the port's host dedup
(``training/dedup.py`` ``prep_dedup_batch``, through ``Trainer._prep_host``,
which ``fit``'s prefetch thread runs), by the host clock around each call,
over the traced window's batches. Moves ``train_imp_s`` where the host
feed paces the step."""


def read(ctx):
    spans = ctx.host_spans.get("dedup")
    return 1e3 * sum(spans) / len(spans) if spans else None
