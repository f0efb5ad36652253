"""Gauss-Markov GP prior factor residuals.

Port of the 4-way GP prior factors:
  - vector states: /root/reference/gpmp2/gp/GaussianProcessPriorLinear.h
        error = [x1 + dt v1 - x2, v1 - v2], noise covariance Q(dt)
  - Lie states:    /root/reference/gpmp2/gp/GaussianProcessPriorLie.h:71-85
        error = [Log(x1^-1 x2) - dt v1, v2 - v1], noise covariance Q(dt)

(NB the velocity-difference sign differs between the two in the reference;
we reproduce each exactly so whitened errors match.)

The residual function returns the *unwhitened* error; the solver whitens
with the precision Q(dt)^-1 from gputils.calc_Q_inv. For the vector case
the Jacobians are constant:

  H1 = [[I, dt I], [0, I]],  H2 = [[-I, 0], [0, -I]]

and are provided analytically to skip AD in the hot path.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry.statespace import StateSpace

__all__ = ["gp_prior_error", "gp_prior_jacobians_linear"]


def gp_prior_error(space: StateSpace, x1, v1, x2, v2, delta_t):
    """Unwhitened GP prior residual, shape (2d,)."""
    if space.is_vector:
        return jnp.concatenate(
            [x1 + delta_t * v1 - x2, v1 - v2], axis=-1
        )
    r = space.local(x1, x2)
    return jnp.concatenate([r - v1 * delta_t, v2 - v1], axis=-1)


def gp_prior_jacobians_linear(dof: int, delta_t, dtype=jnp.float32):
    """Constant Jacobians of the vector-space GP prior wrt z1=(x1,v1), z2=(x2,v2).

    Returns (H1, H2) with shapes (2d, 2d) matching
    GaussianProcessPriorLinear.h:68-82.
    """
    eye = jnp.eye(dof, dtype=dtype)
    zero = jnp.zeros((dof, dof), dtype=dtype)
    dt = jnp.asarray(delta_t, dtype)
    H1 = jnp.concatenate(
        [
            jnp.concatenate([eye, dt * eye], axis=-1),
            jnp.concatenate([zero, eye], axis=-1),
        ],
        axis=-2,
    )
    H2 = -jnp.eye(2 * dof, dtype=dtype)
    return H1, H2
