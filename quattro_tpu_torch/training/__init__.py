"""Training pipeline: on-device data collection and the Adam gain-model trainer.

Counterpart of ``quattro_tpu.training``: closed-loop MPC sweeps through the
logged batched solve become gain rows (``collect.py``), and ``train.py`` fits
the ``GainPredictor`` on them.
"""

from quattro_tpu_torch.training.collect import (
    CollectStats,
    DeviceGainDataset,
    GainDataset,
    ShardDataset,
    collect_gain_dataset,
    collect_gain_dataset_host,
    collect_gain_dataset_host_batched,
    lhs_initial_states,
    load_gain_dataset,
    perturb_params,
    save_gain_dataset,
)
from quattro_tpu_torch.training.train import TrainConfig, train_gain_predictor

__all__ = [
    "collect_gain_dataset",
    "collect_gain_dataset_host",
    "collect_gain_dataset_host_batched",
    "CollectStats",
    "DeviceGainDataset",
    "GainDataset",
    "ShardDataset",
    "lhs_initial_states",
    "load_gain_dataset",
    "perturb_params",
    "save_gain_dataset",
    "TrainConfig",
    "train_gain_predictor",
]
