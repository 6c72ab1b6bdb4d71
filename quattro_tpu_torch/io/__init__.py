"""Native (C++) trajectory-log shard IO with a pure-Python backend (counterpart of ``quattro_tpu.io``)."""

from quattro_tpu_torch.io.shardio import (  # noqa: F401
    ShardReader,
    ShardWriter,
    index_shard,
    merge_shards,
    native_available,
    read_shard,
)

__all__ = [
    "ShardReader",
    "ShardWriter",
    "index_shard",
    "merge_shards",
    "native_available",
    "read_shard",
]
