"""The JAX package's ``examples/`` on the port: each one runs with
``python -m ebnerd_tpu_torch.examples.<name>``, takes the JAX example's
flags (plus ``--device`` where it runs a model), and builds a synthetic split
in memory (``data.synthetic.synthetic_ebnerd_tables``), so it needs no
pyarrow; a path that reads or writes parquet imports pyarrow only when
called."""
