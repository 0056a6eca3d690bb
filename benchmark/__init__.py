"""The benchmark of the PyTorch/H100 port (``ebnerd_tpu_torch``): its
harness, traffic generator, plain references, work counts and metric
readers. ``run.py`` is the entry point; see ``core.py``."""
