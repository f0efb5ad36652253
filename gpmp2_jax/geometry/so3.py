"""SO(3) operations on 3x3 rotation matrices.

Replacement for the gtsam::Rot3 machinery the reference library
(/root/reference/gpmp2) builds on. Conventions follow GTSAM so the factor
semantics of the reference are preserved:

  - tangent vectors are rotation vectors (axis * angle), right (body-frame)
    trivialization: retract(R, w) = R @ Expmap(w), local(R1, R2) = Logmap(R1^T R2).

All functions are pure, differentiable, and batch via `jax.vmap`.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "hat",
    "vee",
    "expmap",
    "logmap",
    "rotz",
    "rotx",
    "roty",
    "ypr",
    "left_jacobian",
    "left_jacobian_inverse",
]

_EPS = 1e-10


def hat(w):
    """Skew-symmetric matrix of a 3-vector: hat(w) @ v == cross(w, v)."""
    w = jnp.asarray(w)
    zero = jnp.zeros((), dtype=w.dtype)
    return jnp.stack(
        [
            jnp.stack([zero, -w[2], w[1]]),
            jnp.stack([w[2], zero, -w[0]]),
            jnp.stack([-w[1], w[0], zero]),
        ]
    )


def vee(W):
    """Inverse of hat: extract 3-vector from a skew-symmetric matrix."""
    return jnp.stack([W[2, 1], W[0, 2], W[1, 0]])


def _sinc_cosc(theta2):
    """Taylor-safe sin(t)/t and (1-cos(t))/t^2 given t^2.

    Uses the where-guard pattern (safe value in the untaken branch) so the
    exact expressions are bit-accurate for normal angles and AD stays
    NaN-free at zero.
    """
    small = theta2 < 1e-8
    safe_t2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe_t2)
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    cosc = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    return sinc, cosc


def expmap(w):
    """SO(3) exponential map (Rodrigues) of a rotation vector."""
    w = jnp.asarray(w)
    theta2 = jnp.dot(w, w)
    W = hat(w)
    sinc, cosc = _sinc_cosc(theta2)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + sinc * W + cosc * (W @ W)


def logmap(R):
    """SO(3) logarithm: rotation vector of a rotation matrix.

    Numerically-stable version handling theta near 0 and near pi, matching
    gtsam::Rot3::Logmap semantics (reference factors call Logmap through
    traits, e.g. /root/reference/gpmp2/gp/GaussianProcessPriorLie.h:71).
    """
    R = jnp.asarray(R)
    tr = jnp.trace(R)
    # antisymmetric part -> axis * 2 sin(theta)
    v = jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    cos_theta = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    # AD-safety (double-where): every branch below must have finite
    # gradients for ALL inputs, selected or not — arccos'(+-1) and
    # sqrt'(0) are infinite and a single inf in an unselected branch
    # poisons the whole where() gradient (this bit a workspace-orientation
    # prior whose initial EE orientation equals the target exactly).
    eps_clip = 1e-6 if R.dtype == jnp.float32 else 1e-12
    near_id = cos_theta > 1.0 - 1e-6  # theta < ~1.4e-3
    cos_safe = jnp.clip(cos_theta, -1.0 + eps_clip, 1.0 - eps_clip)
    theta = jnp.arccos(cos_safe)
    sin_theta = jnp.sin(theta)  # >= ~sqrt(2*eps_clip) by the clip
    generic = theta / (2.0 * sin_theta) * v
    # small angle: theta^2 ~ |v|^2/4 (|v| = 2 sin theta); smooth in R, and
    # more accurate than arccos near 1 where arccos loses half the bits
    t2 = 0.25 * jnp.dot(v, v)
    small_w = 0.5 * (1.0 + t2 / 12.0) * v
    w = jnp.where(near_id, small_w, generic)
    # Near pi: use diagonal-based extraction.
    # S = (R + R^T)/2 = I + (1 - cos t)(aa^T - I), so
    #   a_k^2 = (S_kk - cos t) / (1 - cos t),
    #   a_i a_k = S_ik / (1 - cos t)  (i != k).
    S = 0.5 * (R + R.T)
    one_minus_cos = jnp.maximum(1.0 - cos_theta, _EPS)
    diag = jnp.clip((jnp.diagonal(S) - cos_theta) / one_minus_cos, 0.0, 1.0)
    diag = jnp.where(diag < _EPS, _EPS, diag)  # sqrt'(0) is inf
    axis_abs = jnp.sqrt(diag)
    k = jnp.argmax(axis_abs)
    col = S[:, k] / (one_minus_cos * jnp.where(axis_abs[k] < _EPS, _EPS, axis_abs[k]))
    axis = col.at[k].set(axis_abs[k])
    nrm = jnp.linalg.norm(axis)
    axis = axis / jnp.where(nrm < _EPS, _EPS, nrm)
    # sign of axis from antisymmetric part (v = 2 sin(theta) * axis); near pi
    # sin(theta) >= 0 for theta in (0, pi], so align axis with v when v != 0.
    sign = jnp.where(jnp.dot(axis, v) < 0.0, -1.0, 1.0)
    near_pi_w = theta * axis * sign
    return jnp.where(theta > jnp.pi - 1e-4, near_pi_w, w)


def left_jacobian(w):
    """SO(3) left Jacobian J_l(w): Exp(w + dw) ~ Exp(J_l dw) Exp(w)."""
    w = jnp.asarray(w)
    theta2 = jnp.dot(w, w)
    small = theta2 < 1e-8
    safe_t2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe_t2)
    W = hat(w)
    A = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    B = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (safe_t2 * theta)
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + A * W + B * (W @ W)


def left_jacobian_inverse(w):
    """Inverse of the SO(3) left Jacobian."""
    w = jnp.asarray(w)
    theta2 = jnp.dot(w, w)
    small = theta2 < 1e-8
    safe_t2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe_t2)
    W = hat(w)
    half_theta = 0.5 * theta
    sin_half = jnp.sin(half_theta)
    safe_sin_half = jnp.where(jnp.abs(sin_half) < _EPS, jnp.ones_like(sin_half), sin_half)
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * jnp.cos(half_theta) / safe_sin_half) / safe_t2,
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye - 0.5 * W + cot_term * (W @ W)


def rotx(a):
    """Rotation about the x axis (gtsam::Rot3::Rx)."""
    a = jnp.asarray(a)
    c, s = jnp.cos(a), jnp.sin(a)
    one = jnp.ones((), dtype=c.dtype)
    zero = jnp.zeros((), dtype=c.dtype)
    return jnp.stack(
        [
            jnp.stack([one, zero, zero]),
            jnp.stack([zero, c, -s]),
            jnp.stack([zero, s, c]),
        ]
    )


def roty(a):
    """Rotation about the y axis."""
    a = jnp.asarray(a)
    c, s = jnp.cos(a), jnp.sin(a)
    one = jnp.ones((), dtype=c.dtype)
    zero = jnp.zeros((), dtype=c.dtype)
    return jnp.stack(
        [
            jnp.stack([c, zero, s]),
            jnp.stack([zero, one, zero]),
            jnp.stack([-s, zero, c]),
        ]
    )


def rotz(a):
    """Rotation about the z axis (gtsam::Rot3::Rz)."""
    a = jnp.asarray(a)
    c, s = jnp.cos(a), jnp.sin(a)
    one = jnp.ones((), dtype=c.dtype)
    zero = jnp.zeros((), dtype=c.dtype)
    return jnp.stack(
        [
            jnp.stack([c, -s, zero]),
            jnp.stack([s, c, zero]),
            jnp.stack([zero, zero, one]),
        ]
    )


def ypr(yaw, pitch, roll):
    """Yaw-pitch-roll rotation, matching gtsam::Rot3::Ypr = Rz(y) Ry(p) Rx(r)."""
    return rotz(yaw) @ roty(pitch) @ rotx(roll)
