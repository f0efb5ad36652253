"""Vehicle dynamics residual kernels.

Port of /root/reference/gpmp2/dynamics/VehicleDynamics.h and the
three factor wrappers (VehicleDynamicsFactorPose2 / Pose2Vector / Vector).
In the factor program these apply per-state via
`TrajProblem.flag_vehicle_dynamics`; the raw residuals are exported here
for custom graphs.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "simple_2d_vehicle_dynamics_pose2",
    "simple_2d_vehicle_dynamics_vector3",
]


def simple_2d_vehicle_dynamics_pose2(vel):
    """Nonholonomic 'no sideways sliding' cost for SE(2) body-frame
    velocity [vx, vy, omega]: err = v_y (VehicleDynamics.h:19-27).

    Used for Pose2 and Pose2Vector states (the factor wrappers take
    vel.head<3>() — pass the first 3 velocity components)."""
    return vel[..., 1]


def simple_2d_vehicle_dynamics_vector3(conf, vel):
    """World-frame variant for vector states [x, y, theta, ...]:
    err = v_y cos(theta) - v_x sin(theta) (VehicleDynamics.h:31-40)."""
    th = conf[..., 2]
    return vel[..., 1] * jnp.cos(th) - vel[..., 0] * jnp.sin(th)
