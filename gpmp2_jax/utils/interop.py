"""Flat-buffer trajectory interop (reference: gpmp2/utils/OpenRAVEutils.cpp).

The reference exposes two conversions used by its OpenRAVE plugin
(OpenRAVEutils.cpp:15-80): gtsam Values -> a caller-owned flat double
buffer of shape (2*(total_step+1), dof) holding all configurations then
all velocities, clamping configurations to joint limits on the way out;
and the inverse buffer -> Values. There is no OpenRAVE here, but external
controllers/simulators consume exactly this layout, so this framework
ships the same contract on host numpy buffers:

    [ conf_0 ... conf_N | vel_0 ... vel_N ]   row-major, (2*(N+1), dof)

`trajectory_to_buffer` clamps each configuration row to
[joint_lower_limit, joint_upper_limit] exactly as
convertValuesOpenRavePointer (OpenRAVEutils.cpp:57-80);
`buffer_to_trajectory` mirrors convertOpenRavePointerValues
(OpenRAVEutils.cpp:83-104).
"""

from __future__ import annotations

import numpy as np


def trajectory_to_buffer(traj, joint_lower_limit, joint_upper_limit):
    """Pack a Trajectory (pose (n,d), vel (n,d)) into a host (2n, d) buffer,
    clamping configurations to the joint limits.

    Mirrors convertValuesOpenRavePointer (OpenRAVEutils.cpp:56-80): confs
    occupy rows 0..n-1 (limit-clamped), velocities rows n..2n-1 (unclamped).
    Raises ValueError when the limit vectors don't match dof
    (reference throws std::runtime_error, OpenRAVEutils.cpp:60-63).
    """
    conf = np.asarray(traj.pose, dtype=np.float64)
    vel = np.asarray(traj.vel, dtype=np.float64)
    if conf.ndim != 2 or conf.shape != vel.shape:
        raise ValueError(
            f"expected matching (n, dof) pose/vel, got {conf.shape} vs {vel.shape}"
        )
    dof = conf.shape[1]
    lo = np.asarray(joint_lower_limit, dtype=np.float64).reshape(-1)
    hi = np.asarray(joint_upper_limit, dtype=np.float64).reshape(-1)
    if lo.shape[0] != dof or hi.shape[0] != dof:
        raise ValueError(
            f"joint limit size {lo.shape[0]}/{hi.shape[0]} differs from dof {dof}"
        )
    return np.concatenate([np.clip(conf, lo, hi), vel], axis=0)


def buffer_to_trajectory(buffer, dof):
    """Unpack a (2n, dof) (or flat 2n*dof) buffer into (conf (n,d), vel (n,d)).

    Mirrors convertOpenRavePointerValues (OpenRAVEutils.cpp:83-104). Returns
    plain numpy arrays; wrap in `Trajectory(...)` / move to device as needed.
    """
    buf = np.asarray(buffer, dtype=np.float64).reshape(-1, dof)
    if buf.shape[0] % 2 != 0:
        raise ValueError(f"buffer rows {buf.shape[0]} not an even 2*(N+1)")
    n = buf.shape[0] // 2
    return buf[:n].copy(), buf[n:].copy()
