"""Host data layer of the port: ragged columns, tables, id lookups and the
training and eval feeds (numpy only; copies of the matching ``ebnerd_tpu.data`` modules)."""
from .dataloader import EvalFeed, NewsrecFeed, pad_to_multiple
from .lookup import Lookup
from .ragged import Ragged
from .table import Table, read_parquet, write_parquet

__all__ = ["EvalFeed", "NewsrecFeed", "Lookup", "Ragged", "Table", "pad_to_multiple",
           "read_parquet", "write_parquet"]
