"""SE(2) planar rigid transforms stored as [x, y, theta] arrays.

Replacement for gtsam::Pose2 used by the mobile-base robot
families of the reference (/root/reference/gpmp2/kinematics/Pose2Mobile*).
Conventions match GTSAM:

  - tangent ordering is [vx, vy, omega] (translation first), as in
    gtsam::Pose2::Expmap.
  - exp/log are the exact SE(2) exponential/logarithm.
  - retract(X, xi) = X * Exp(xi) (right/local convention; gtsam Pose2 uses
    a first-order chart by default but the choice of chart does not change
    optima, and all reference *factors* use exact Expmap/Logmap through
    traits — see /root/reference/gpmp2/gp/GaussianProcessPriorLie.h:71).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["identity", "compose", "inverse", "between", "expmap", "logmap",
           "retract", "local", "transform_from", "theta_wrap"]

_EPS = 1e-10


def identity(dtype=jnp.float32):
    return jnp.zeros(3, dtype=dtype)


def theta_wrap(t):
    """Wrap an angle to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(t), jnp.cos(t))


def compose(a, b):
    """a * b for [x, y, theta] poses."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + c * b[..., 0] - s * b[..., 1]
    y = a[..., 1] + s * b[..., 0] + c * b[..., 1]
    t = theta_wrap(a[..., 2] + b[..., 2])
    return jnp.stack([x, y, t], axis=-1)


def inverse(p):
    p = jnp.asarray(p)
    c, s = jnp.cos(p[..., 2]), jnp.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return jnp.stack([x, y, -p[..., 2]], axis=-1)


def between(a, b):
    return compose(inverse(a), b)


def expmap(xi):
    """SE(2) exponential; xi = [vx, vy, omega]."""
    xi = jnp.asarray(xi)
    vx, vy, w = xi[..., 0], xi[..., 1], xi[..., 2]
    w2 = w * w
    small = w2 < 1e-10
    safe_w = jnp.where(small, jnp.ones_like(w), w)
    # V(w) = [[sin w / w, -(1-cos w)/w], [(1-cos w)/w, sin w / w]]
    a = jnp.where(small, 1.0 - w2 / 6.0, jnp.sin(safe_w) / safe_w)
    b = jnp.where(small, w / 2.0 - w * w2 / 24.0, (1.0 - jnp.cos(safe_w)) / safe_w)
    x = a * vx - b * vy
    y = b * vx + a * vy
    return jnp.stack([x, y, w], axis=-1)


def logmap(p):
    """SE(2) logarithm, returns [vx, vy, omega]."""
    p = jnp.asarray(p)
    x, y, w = p[..., 0], p[..., 1], theta_wrap(p[..., 2])
    w2 = w * w
    small = w2 < 1e-10
    safe_w = jnp.where(small, jnp.ones_like(w), w)
    a = jnp.where(small, 1.0 - w2 / 6.0, jnp.sin(safe_w) / safe_w)
    b = jnp.where(small, w / 2.0 - w * w2 / 24.0, (1.0 - jnp.cos(safe_w)) / safe_w)
    det = a * a + b * b
    # V^-1 = 1/det [[a, b], [-b, a]]
    vx = (a * x + b * y) / det
    vy = (-b * x + a * y) / det
    return jnp.stack([vx, vy, w], axis=-1)


def retract(p, xi):
    return compose(p, expmap(xi))


def local(a, b):
    return logmap(between(a, b))


def transform_from(p, point):
    """Map a planar point from pose frame to world frame."""
    p = jnp.asarray(p)
    point = jnp.asarray(point)
    c, s = jnp.cos(p[..., 2]), jnp.sin(p[..., 2])
    x = p[..., 0] + c * point[..., 0] - s * point[..., 1]
    y = p[..., 1] + s * point[..., 0] + c * point[..., 1]
    return jnp.stack([x, y], axis=-1)
