"""Constant-velocity GP (white-noise-on-acceleration LTI-SDE) matrices.

Port of the closed-form math in
/root/reference/gpmp2/gp/GPutils.h:22-59 (Barfoot RSS'14):

  state x = (theta, theta_dot) in R^{2d}
  Phi(tau)    = [[I, tau I], [0, I]]
  Q(tau)      = [[tau^3/3 Qc, tau^2/2 Qc], [tau^2/2 Qc, tau Qc]]
  Q(tau)^-1   = [[12 tau^-3 Qc^-1, -6 tau^-2 Qc^-1], [-6 tau^-2 Qc^-1, 4 tau^-1 Qc^-1]]
  Lambda(tau) = Phi(tau) - Q(tau) Phi(dt-tau)^T Q(dt)^-1 Phi(dt)
  Psi(tau)    = Q(tau) Phi(dt-tau)^T Q(dt)^-1

All functions take Qc as a (d, d) covariance matrix (the reference's getQc
extracts it from a gtsam noise model, GPutils.cpp:14-19; here callers pass
the covariance directly) and return (2d, 2d) arrays. Everything is pure and
differentiable; `tau`/`delta_t` may be traced scalars.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# The GP interpolation matrices below scale every interpolated state. At
# DEFAULT precision XLA computed their float32 products on the H100 in
# TF32 (~3 digits), so they are asked for in full precision.
_HIGHEST = lax.Precision.HIGHEST

__all__ = ["calc_Q", "calc_Q_inv", "calc_phi", "calc_lambda", "calc_psi"]


def _block2(m00, m01, m10, m11):
    top = jnp.concatenate([m00, m01], axis=-1)
    bot = jnp.concatenate([m10, m11], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def calc_Q(Qc, tau):
    """Process noise covariance over an interval tau (GPutils.h:25-31)."""
    Qc = jnp.asarray(Qc)
    tau = jnp.asarray(tau, dtype=Qc.dtype)
    return _block2(
        (tau**3) / 3.0 * Qc, (tau**2) / 2.0 * Qc,
        (tau**2) / 2.0 * Qc, tau * Qc,
    )


def calc_Q_inv(Qc, tau):
    """Closed-form inverse of calc_Q (GPutils.h:34-40)."""
    Qc = jnp.asarray(Qc)
    tau = jnp.asarray(tau, dtype=Qc.dtype)
    Qc_inv = jnp.linalg.inv(Qc)
    return _block2(
        12.0 * tau**-3.0 * Qc_inv, -6.0 * tau**-2.0 * Qc_inv,
        -6.0 * tau**-2.0 * Qc_inv, 4.0 / tau * Qc_inv,
    )


def calc_phi(dof: int, tau, dtype=None):
    """State transition matrix over tau (GPutils.h:43-47)."""
    tau = jnp.asarray(tau)
    dtype = dtype or tau.dtype
    eye = jnp.eye(dof, dtype=dtype)
    zero = jnp.zeros((dof, dof), dtype=dtype)
    return _block2(eye, jnp.asarray(tau, dtype)[..., None, None] * eye, zero, eye)


def calc_lambda(Qc, delta_t, tau):
    """Interpolation matrix Lambda(tau) (GPutils.h:50-55)."""
    Qc = jnp.asarray(Qc)
    d = Qc.shape[-1]
    return calc_phi(d, tau, Qc.dtype) - jnp.matmul(
        calc_psi(Qc, delta_t, tau), calc_phi(d, delta_t, Qc.dtype),
        precision=_HIGHEST)


def calc_psi(Qc, delta_t, tau):
    """Interpolation matrix Psi(tau) (GPutils.h:58-62)."""
    Qc = jnp.asarray(Qc)
    d = Qc.shape[-1]
    phi_t = jnp.swapaxes(
        calc_phi(d, delta_t - jnp.asarray(tau, Qc.dtype), Qc.dtype), -1, -2)
    return jnp.matmul(
        jnp.matmul(calc_Q(Qc, tau), phi_t, precision=_HIGHEST),
        calc_Q_inv(Qc, delta_t), precision=_HIGHEST)
