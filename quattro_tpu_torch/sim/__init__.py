"""Host-side MuJoCo validation harness (counterpart of ``quattro_tpu.sim``).

MuJoCo is the independent plant, with real model mismatch, that the port's
controllers are checked against; the analytic plants of ``systems/`` stay the
solver's models. The bridges are numpy on the host and need the ``mujoco``
package only when one is constructed: this package imports without it.
Headless only.
"""

from quattro_tpu_torch.sim.mujoco_bridge import (
    CartPoleBridge,
    QuadrotorBridge,
    euler_to_quat,
    quat_to_rpy,
)

__all__ = ["CartPoleBridge", "QuadrotorBridge", "euler_to_quat", "quat_to_rpy"]
