"""SE(3) rigid transforms as (rotation matrix, translation) pytrees.

Replacement for gtsam::Pose3 as used throughout the reference
(/root/reference/gpmp2). Conventions match GTSAM:

  - tangent ordering is [omega(3), v(3)] (rotation first), as in
    gtsam::Pose3::Expmap.
  - exp/log are the exact SE(3) exponential/logarithm.
  - retract(X, xi) = X * Exp(xi) (right/local convention).

Poses are NamedTuples of arrays so they nest in pytrees, batch under vmap,
and map onto 3x3 matmuls that XLA fuses well.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import so3

__all__ = ["Pose3", "identity", "compose", "inverse", "expmap", "logmap", "between",
           "retract", "local", "transform_from", "adjoint", "from_matrix", "to_matrix"]


class Pose3(NamedTuple):
    """Rigid transform: x_world = rot @ x_local + trans."""

    rot: jnp.ndarray  # (..., 3, 3)
    trans: jnp.ndarray  # (..., 3)


def identity(dtype=jnp.float32) -> Pose3:
    return Pose3(jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype))


def from_matrix(H) -> Pose3:
    """Build from a 4x4 homogeneous matrix."""
    H = jnp.asarray(H)
    return Pose3(H[..., :3, :3], H[..., :3, 3])


def to_matrix(p: Pose3):
    """4x4 homogeneous matrix."""
    bot = jnp.zeros(p.rot.shape[:-2] + (1, 4), dtype=p.rot.dtype)
    bot = bot.at[..., 0, 3].set(1.0)
    top = jnp.concatenate([p.rot, p.trans[..., :, None]], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def compose(a: Pose3, b: Pose3) -> Pose3:
    return Pose3(a.rot @ b.rot, (a.rot @ b.trans[..., None])[..., 0] + a.trans)


def inverse(p: Pose3) -> Pose3:
    rT = jnp.swapaxes(p.rot, -1, -2)
    return Pose3(rT, -(rT @ p.trans[..., None])[..., 0])


def between(a: Pose3, b: Pose3) -> Pose3:
    """a^-1 * b."""
    return compose(inverse(a), b)


def transform_from(p: Pose3, point):
    """Map a point from the pose's local frame to the world frame.

    Semantics of gtsam::Pose3::transform_from used by the sphere model
    (/root/reference/gpmp2/kinematics/RobotModel-inl.h:28-39).
    """
    return (p.rot @ jnp.asarray(point)[..., None])[..., 0] + p.trans


def expmap(xi) -> Pose3:
    """SE(3) exponential. xi = [omega, v] per gtsam::Pose3::Expmap."""
    xi = jnp.asarray(xi)
    w, v = xi[..., :3], xi[..., 3:]
    R = so3.expmap(w)
    t = (so3.left_jacobian(w) @ v[..., None])[..., 0]
    return Pose3(R, t)


def logmap(p: Pose3):
    """SE(3) logarithm, returns [omega, v]."""
    w = so3.logmap(p.rot)
    v = (so3.left_jacobian_inverse(w) @ p.trans[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def retract(p: Pose3, xi) -> Pose3:
    """Right retraction: p * Exp(xi)."""
    return compose(p, expmap(xi))


def local(a: Pose3, b: Pose3):
    """Tangent of b seen from a: Log(a^-1 b)."""
    return logmap(between(a, b))


def adjoint(p: Pose3):
    """6x6 Adjoint matrix mapping body twists to world twists.

    Matches gtsam::Pose3::AdjointMap with [omega, v] ordering; used to
    re-root arm Jacobians onto mobile bases
    (/root/reference/gpmp2/kinematics/Pose2MobileArm.cpp:100).
    """
    R = p.rot
    tx = so3.hat(p.trans)
    top = jnp.concatenate([R, jnp.zeros_like(R)], axis=-1)
    bot = jnp.concatenate([tx @ R, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)
