"""Analytic FLOPs/bytes models and roofline accounting for the solver phases.

Counterpart of ``quattro_tpu/utils/roofline.py``: the same cost models of
every hot phase, so a measured time converts into achieved FLOP/s, achieved
memory bytes/s, arithmetic intensity and share of peak, and says which wall
(compute or bandwidth) a kernel is against.

``PEAKS`` holds the NVIDIA H100 SXM's published peaks (NVIDIA H100 data
sheet): 67 TFLOP/s float32 and 34 TFLOP/s float64 without tensor cores, and
3.35 TB/s HBM3. The float32 peak is stated, not derived from another type's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class PeakSpec(NamedTuple):
    name: str
    f32_flops: float  # peak FLOP/s in float32
    f64_flops: float  # peak FLOP/s in float64
    hbm_bytes: float  # peak device-memory bandwidth, bytes/s

    def flops(self, dtype) -> float:
        """Peak FLOP/s for ``"f32"``/``"f64"`` or ``torch.float32``/``torch.float64``."""
        if dtype in ("f32", torch.float32):
            return self.f32_flops
        if dtype in ("f64", torch.float64):
            return self.f64_flops
        raise ValueError(f"no peak for dtype {dtype!r} (f32|f64)")


PEAKS: Dict[str, PeakSpec] = {
    "h100-sxm": PeakSpec("h100-sxm", 67e12, 34e12, 3.35e12),
}


def riccati_step_flops(n: int, m: int) -> float:
    """One backward Riccati step (per trajectory): Q-expansion, regularized
    Cholesky solve of (1+n) right-hand sides, gains, value update.

    Dominant terms (2 FLOPs per multiply-add):
      t1 = V_xx A (2n^3), Q_xx = l_xx + A' t1 (2n^3),
      Q_ux = l_ux + B' t1 (2n^2 m), t3 = V_xx B (2n^2 m),
      Q_uu = l_uu + B' t3 (2nm^2), Q_x/Q_u (2n^2 + 2nm),
      chol (m^3/3) + substitutions (2m^2 (1+n)),
      value update K'Q_uu K + K'Q_ux + Q_ux'K + K-terms (~4n^2 m + 2nm^2).
    """
    return (
        4 * n**3
        + 6 * n**2 * m
        + 4 * n * m**2
        + 2 * n**2
        + 2 * n * m
        + m**3 / 3
        + 2 * m**2 * (1 + n)
    )


def riccati_flops(horizon: int, n: int, m: int, batch: int = 1) -> float:
    return batch * horizon * riccati_step_flops(n, m)


def riccati_bytes(horizon: int, n: int, m: int, batch: int = 1, elem: int = 4,
                  carry_in_hbm: bool = False) -> float:
    """Minimal HBM traffic of one backward pass: stream the stage data once,
    write the gains once. ``carry_in_hbm`` adds the (V_x, V_xx) carry
    round-trip per step (what a non-fused scan pays; the fused kernels keep
    the carry on chip)."""
    stage_in = 2 * n * n + 2 * n * m + m * m + n + m  # A, l_xx, B, l_ux, l_uu, l_x, l_u
    gains_out = m + m * n
    carry = 2 * 2 * (n * n + n) if carry_in_hbm else 0  # rw of (V_xx, V_x)
    return batch * horizon * (stage_in + gains_out + carry) * elem


def linearize_flops(horizon: int, n: int, m: int, dyn_flops: float,
                    rk4: bool = True, batch: int = 1) -> float:
    """Batched jacfwd of the discrete dynamics: n+m forward tangents + primal.

    ``dyn_flops`` = cost of ONE continuous-dynamics evaluation; RK4 does 4
    stages plus combination. A JVP costs ~2x the primal."""
    stages = 4.2 if rk4 else 1.0
    per_eval = stages * dyn_flops
    return batch * horizon * per_eval * (1 + 2 * (n + m))


def rollout_flops(horizon: int, n: int, m: int, dyn_flops: float,
                  n_alphas: int = 6, rk4: bool = True, batch: int = 1) -> float:
    """Line search: n_alphas feedback rollouts (dynamics + K dx per step)."""
    stages = 4.2 if rk4 else 1.0
    per_step = stages * dyn_flops + 2 * n * m + 2 * m
    return batch * n_alphas * horizon * per_step


def transformer_flops(seq_len: int, d_model: int, n_layers: int,
                      d_ff: int, out_dim: int, in_dim: int) -> float:
    """One forward pass of the decoder-only gain predictor.

    Per layer: QKV+output projections 8 T d^2, attention 4 T^2 d,
    MLP 4 T d d_ff; plus embeddings/head."""
    per_layer = 8 * seq_len * d_model**2 + 4 * seq_len**2 * d_model \
        + 4 * seq_len * d_model * d_ff
    embed = 2 * seq_len * in_dim * d_model
    head = 2 * seq_len * d_model * out_dim
    return n_layers * per_layer + embed + head


QUADROTOR_DYN_FLOPS = 260.0  # trig-heavy 12-state vector field, counted by hand
CARTPOLE_DYN_FLOPS = 60.0


def report(flops: float, bytes_moved: float, seconds: float,
           peak: PeakSpec, dtype: str = "f32") -> Dict[str, float]:
    """Roofline report: achieved rates, share of peak, intensity, bound."""
    peak_flops = peak.flops(dtype)
    achieved_flops = flops / seconds
    achieved_bw = bytes_moved / seconds
    intensity = flops / bytes_moved if bytes_moved else float("inf")
    ridge = peak_flops / peak.hbm_bytes  # FLOPs/byte where the roofs meet
    return {
        "seconds": seconds,
        "flops": flops,
        "bytes": bytes_moved,
        "achieved_gflops_per_sec": achieved_flops / 1e9,
        "achieved_gbytes_per_sec": achieved_bw / 1e9,
        "arithmetic_intensity_flops_per_byte": intensity,
        "bound": "compute" if intensity > ridge else "bandwidth",
        "pct_of_peak_flops": 100.0 * achieved_flops / peak_flops,
        "pct_of_peak_bandwidth": 100.0 * achieved_bw / peak.hbm_bytes,
        "roofline_limit_seconds": max(flops / peak_flops, bytes_moved / peak.hbm_bytes),
        "pct_of_roofline": 100.0
        * max(flops / peak_flops, bytes_moved / peak.hbm_bytes)
        / seconds,
    }
