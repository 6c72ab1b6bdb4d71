"""Structured metrics logging (host side).

Counterpart of ``quattro_tpu/utils/metrics.py``: solver telemetry arrives as
stacked tensors (``ILQRLogs``, on any device) and is written as JSONL records
or compressed npz shards, which are replayable, appendable and greppable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _host(value) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class JsonlLogger:
    """Append-only JSONL metrics writer with automatic timestamps."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: Dict[str, Any]) -> None:
        payload = {"ts": time.time(), **_to_jsonable(record)}
        with open(self.path, "a") as f:
            f.write(json.dumps(payload) + "\n")

    def read(self):
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def _to_jsonable(value):
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    if hasattr(value, "item") and getattr(value, "ndim", 1) == 0:
        return value.item()
    if hasattr(value, "tolist"):
        return _host(value).tolist()
    return value


def solver_log_summary(logs, valid_only: bool = True) -> Dict[str, Any]:
    """Reduce one solve's ``ILQRLogs`` (tensors of leading axis ``max_iter``) to per-iteration scalars for JSONL."""
    valid = _host(logs.valid)
    idx = np.nonzero(valid)[0] if valid_only else np.arange(valid.size)
    return {
        "iterations": int(valid.sum()),
        "cost": _host(logs.cost)[idx].tolist(),
        "new_cost": _host(logs.new_cost)[idx].tolist(),
        "alpha": _host(logs.alpha)[idx].tolist(),
        "found_update": _host(logs.found_update)[idx].astype(bool).tolist(),
    }


def save_dataset_shard(path: str, x_data, kk_data, shard_index: Optional[int] = None) -> str:
    """Write a compressed npz dataset shard; ``shard_index`` appends ``_00000``-style numbering.

    Idempotent per shard, so a collection job can be rerun.
    """
    if shard_index is not None:
        base, ext = os.path.splitext(path)
        path = f"{base}_{shard_index:05d}{ext or '.npz'}"
    np.savez_compressed(path, x_data=_host(x_data), kk_data=_host(kk_data))
    return path


def load_dataset_shards(paths):
    """Concatenate npz shards back into one dataset (the sources are kept)."""
    xs, ks = [], []
    for p in paths:
        with np.load(p) as data:
            xs.append(data["x_data"])
            ks.append(data["kk_data"])
    return np.concatenate(xs, axis=0), np.concatenate(ks, axis=0)
