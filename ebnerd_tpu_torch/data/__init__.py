"""Host data layer of the port: ragged columns, tables, id lookups and the
eval feed (numpy only; copies of the matching ``ebnerd_tpu.data`` modules)."""
from .dataloader import EvalFeed, pad_to_multiple
from .lookup import Lookup
from .ragged import Ragged
from .table import Table

__all__ = ["EvalFeed", "Lookup", "Ragged", "Table", "pad_to_multiple"]
