"""Config-space factor residual kernels: goal, joint/velocity limits,
workspace priors.

Ports of the reference's kinematics-layer factors, exported as
pure residual functions for the manual-graph path (the reference wraps each
in a gtsam NonlinearFactor; here a factor is `residual(...)` plus
`jax.jacfwd`/analytic Jacobians, whitened by the caller's precision):

  - hinge / joint-limit:  /root/reference/gpmp2/kinematics/JointLimitCost.h:16-32,
    JointLimitFactorVector.h:63-79, JointLimitFactorPose2Vector.h:66-91
  - velocity limit:       VelocityLimitFactorVector.h:62-78
  - end-effector goal:    GoalFactorArm.h:26-102
  - workspace priors:     GaussianPriorWorkspacePosition.h:53-69,
    GaussianPriorWorkspaceOrientation.h:53-71, GaussianPriorWorkspacePose.h:53-70

The planner's factor program (planner/problem.py) evaluates these same
kernels per trajectory state; they are shared, not duplicated.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry import so3
from ..geometry.statespace import StateSpace
from .fk import link_poses

__all__ = [
    "hinge_limit_cost",
    "joint_limit_error",
    "velocity_limit_error",
    "goal_factor_error",
    "workspace_position_error",
    "workspace_orientation_error",
    "workspace_pose_error",
]


def hinge_limit_cost(p, down, up, thresh):
    """Double-sided hinge with threshold (JointLimitCost.h:16-32):
    below down+thresh -> (down+thresh - p); inside -> 0; above up-thresh ->
    (p - up+thresh). Elementwise over arrays."""
    lo = down + thresh
    hi = up - thresh
    return jnp.where(p < lo, lo - p, jnp.where(p <= hi, jnp.zeros_like(p), p - hi))


def limit_mask(space: StateSpace, dtype):
    """Joint-limit mask: Pose2Vector states zero the first 3 (SE(2)) error
    dims (JointLimitFactorPose2Vector.h:66-91)."""
    if space.kind == "se2_vector":
        return jnp.concatenate([jnp.zeros(3, dtype), jnp.ones(space.dim - 3, dtype)])
    return jnp.ones(space.dim, dtype)


def joint_limit_error(space: StateSpace, conf, down, up, thresh):
    """Joint position limit residual (d,) on the storage coordinates
    (JointLimitFactorVector.h:63-79; the Pose2Vector variant's +3 offset is
    realized by masking the SE(2) block)."""
    return limit_mask(space, conf.dtype) * hinge_limit_cost(conf, down, up, thresh)


def velocity_limit_error(vel, vel_limit, thresh):
    """Symmetric velocity-limit residual (d,): hinge on (-v_max, +v_max)
    (VelocityLimitFactorVector.h:62-78)."""
    return hinge_limit_cost(vel, -vel_limit, vel_limit, thresh)


def goal_factor_error(fk, conf, goal_point, link_id: int = -1):
    """End-effector workspace goal residual (3,): FK position of `link_id`
    (default: last link) minus the goal (GoalFactorArm.h:58-77)."""
    return link_poses(fk, conf).trans[link_id] - jnp.asarray(goal_point, conf.dtype)


def workspace_position_error(fk, conf, link_id, des_point):
    """Workspace position prior residual (3,)
    (GaussianPriorWorkspacePosition.h:53-69)."""
    return link_poses(fk, conf).trans[link_id] - jnp.asarray(des_point, conf.dtype)


def workspace_orientation_error(fk, conf, link_id, des_rot):
    """Workspace orientation prior residual (3,): Log(R_des^T R_fk)
    (GaussianPriorWorkspaceOrientation.h:53-71)."""
    R = link_poses(fk, conf).rot[link_id]
    des = jnp.asarray(des_rot, conf.dtype)
    return so3.logmap(jnp.swapaxes(des, -1, -2) @ R)


def workspace_pose_error(fk, conf, link_id, des_rot, des_point):
    """Full workspace pose prior residual (6,) = [rot err, pos err]
    (GaussianPriorWorkspacePose.h:53-70)."""
    poses = link_poses(fk, conf)
    des = jnp.asarray(des_rot, conf.dtype)
    r_rot = so3.logmap(jnp.swapaxes(des, -1, -2) @ poses.rot[link_id])
    r_pos = poses.trans[link_id] - jnp.asarray(des_point, conf.dtype)
    return jnp.concatenate([r_rot, r_pos], axis=-1)
