"""Gaussian-process trajectory interpolation.

Port of
/root/reference/gpmp2/gp/GaussianProcessInterpolatorLinear.h (vector states)
and GaussianProcessInterpolatorLie.h (Lie-group states), generalized over a
`StateSpace`. Used both by the GP-interpolated obstacle factors (collision
checking between support states) and by post-hoc trajectory densification
(/root/reference/gpmp2/planner/TrajUtils.cpp:96-197).

Interpolated state at tau in [0, delta_t] between support states
(x1, v1), (x2, v2):

  vector case (Linear.h:62-122):
      x(tau) = Lambda(tau) [x1; v1] + Psi(tau) [x2; v2], top/bottom d rows
      give pose/velocity.

  Lie case (Lie.h:64-146):
      r1 = [0; v1],  r2 = [Log(x1^-1 x2); v2]
      pose(tau) = x1 * Exp( (Lambda[:d] r1 + Psi[:d] r2) )
      vel(tau)  = Lambda[d:] r1 + Psi[d:] r2

Jacobians are obtained by JAX AD through these expressions (validated
against the reference's hand-derived chain rules in tests), so there is no
analog of updatePoseJacobians here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..geometry.statespace import StateSpace
from .gputils import calc_lambda, calc_psi

__all__ = ["interp_coeffs", "interpolate_pose", "interpolate_velocity", "interpolate_state"]


class InterpCoeffs(NamedTuple):
    """Precomputed Lambda/Psi for a (delta_t, tau) pair."""

    lam: jnp.ndarray  # (2d, 2d)
    psi: jnp.ndarray  # (2d, 2d)


def interp_coeffs(Qc, delta_t, tau) -> InterpCoeffs:
    return InterpCoeffs(calc_lambda(Qc, delta_t, tau), calc_psi(Qc, delta_t, tau))


def interpolate_state(space: StateSpace, coeffs: InterpCoeffs, x1, v1, x2, v2):
    """Interpolate (pose, velocity) at tau. Works for vector and Lie spaces."""
    d = space.dim
    lam, psi = coeffs
    if space.is_vector:
        s1 = jnp.concatenate([x1, v1], axis=-1)
        s2 = jnp.concatenate([x2, v2], axis=-1)
        out = lam @ s1 + psi @ s2
        return out[..., :d], out[..., d:]
    r1 = jnp.concatenate([jnp.zeros_like(v1), v1], axis=-1)
    r2 = jnp.concatenate([space.local(x1, x2), v2], axis=-1)
    mixed = lam @ r1 + psi @ r2
    pose = space.compose(x1, space.expmap(mixed[..., :d]))
    vel = mixed[..., d:]
    return pose, vel


def interpolate_pose(space: StateSpace, coeffs: InterpCoeffs, x1, v1, x2, v2):
    return interpolate_state(space, coeffs, x1, v1, x2, v2)[0]


def interpolate_velocity(space: StateSpace, coeffs: InterpCoeffs, x1, v1, x2, v2):
    return interpolate_state(space, coeffs, x1, v1, x2, v2)[1]
