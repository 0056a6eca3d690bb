from .mesh import (
    Mesh,
    ShardedTable,
    data_sharding,
    host_shard_rows,
    make_mesh,
    replicated,
    shard_batch,
    table_sharding,
)
