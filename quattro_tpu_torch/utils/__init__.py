"""Observability: phase timing, profiler scopes, metrics IO, roofline counts, debug checks.

Counterpart of ``quattro_tpu.utils``.
"""

from quattro_tpu_torch.utils.debug import nan_guard, tree_checksum, verify_halo_exchange
from quattro_tpu_torch.utils.metrics import (
    JsonlLogger,
    load_dataset_shards,
    save_dataset_shard,
    solver_log_summary,
)
from quattro_tpu_torch.utils.timing import PhaseTimer, block_nnz_per_sec, device_trace

__all__ = [
    "nan_guard",
    "tree_checksum",
    "verify_halo_exchange",
    "JsonlLogger",
    "load_dataset_shards",
    "save_dataset_shard",
    "solver_log_summary",
    "PhaseTimer",
    "block_nnz_per_sec",
    "device_trace",
]
