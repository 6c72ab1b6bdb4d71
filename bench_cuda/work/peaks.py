"""The card's published peaks, frozen for the benchmark.

Copied from ``quattro_tpu_torch/utils/roofline.py:35-37`` (``PEAKS["h100-sxm"]``):
NVIDIA's H100 SXM data sheet, 67 TFLOP/s float32 and 34 TFLOP/s float64
outside the tensor cores, 3.35 TB/s of HBM3, at the full 700 W power limit.
A share of these is stated beside the card's ``power.limit``.
"""

FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12
