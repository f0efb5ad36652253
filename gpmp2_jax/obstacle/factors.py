"""Obstacle-avoidance and self-collision residual kernels.

Port of the reference obstacle factors:
  - hinge loss: /root/reference/gpmp2/obstacle/ObstacleCost.h:27-79
        err = eps_total - d(x) when d(x) <= eps_total else 0;
        out-of-range SDF query => cost 0, gradient 0 (the reference catches
        SDFQueryOutOfRange; here it's a `where` mask).
  - ObstacleSDFFactor / ObstaclePlanarSDFFactor (+GP variants):
        per body sphere, eps_total = sphere_radius + eps
        (ObstacleSDFFactor-inl.h:40-57); the 2D variant evaluates at the
        sphere center's (x, y) projection (ObstaclePlanarSDFFactor-inl.h:43-47).
  - SelfCollision: /root/reference/gpmp2/obstacle/SelfCollision.h:66-132.

The residuals are plain differentiable functions; JAX AD produces exactly
the reference's hand-chained Jacobians because the hinge is written with
`where` (zero branch has zero gradient) and the SDF lookup's gradient is the
analytic gradient of the interpolant. The 28 per-robot typedef headers of
the reference collapse into these generic kernels parameterized by a
RobotModel.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..kinematics.robot import RobotModel, sphere_centers_world
from .sdf import PlanarSDF, SignedDistanceField, planar_sdf_lookup, sdf_lookup

__all__ = [
    "hinge_loss",
    "obstacle_factor_error",
    "obstacle_planar_factor_error",
    "self_collision_error",
]


def hinge_loss(dist, eps_total, in_range):
    """max(0, eps - d) with out-of-range clamped to zero cost.

    Gradient wrt dist is -1 on the active branch (including d == eps, per
    ObstacleCost.h:41-49: `dist > eps` is the zero branch) and 0 otherwise.
    """
    err = jnp.where(dist <= eps_total, eps_total - dist, 0.0)
    return jnp.where(in_range, err, 0.0)


def obstacle_factor_error(model: RobotModel, sdf: SignedDistanceField, q, eps):
    """3D obstacle factor residual, shape (num_spheres,).

    Matches ObstacleSDFFactor::evaluateError (ObstacleSDFFactor-inl.h:17-60).
    """
    centers = sphere_centers_world(model, q)  # (S, 3)
    eps_total = model.sphere_radii + eps
    dist, _, ok = sdf_lookup(sdf, centers, screen_thresh=eps_total)
    return hinge_loss(dist, eps_total, ok)


def obstacle_planar_factor_error(model: RobotModel, sdf: PlanarSDF, q, eps):
    """2D obstacle factor residual: spheres projected to the plane.

    Matches ObstaclePlanarSDFFactor::evaluateError
    (ObstaclePlanarSDFFactor-inl.h:17-57).
    """
    centers = sphere_centers_world(model, q)[..., :2]  # (S, 2)
    dist, _, ok = planar_sdf_lookup(sdf, centers)
    return hinge_loss(dist, model.sphere_radii + eps, ok)


def self_collision_error(model: RobotModel, q, pairs_a, pairs_b, pair_eps):
    """Self-collision residual over sphere pairs, shape (num_pairs,).

    pairs_a/pairs_b: (P,) int32 sphere indices; pair_eps: (P,) safety
    margins. eps_total = r_a + r_b + eps (SelfCollision.h:86-90); residual
    is a hinge on the center distance (SelfCollision.h:112-132). Per-pair
    sigmas are applied by the solver's weight, matching the Diagonal noise
    model built from data column 3 (SelfCollision.h:60).
    """
    centers = sphere_centers_world(model, q)
    ca = centers[pairs_a]
    cb = centers[pairs_b]
    eps_total = model.sphere_radii[pairs_a] + model.sphere_radii[pairs_b] + pair_eps
    # sqrt guarded: pairs of identical spheres would give 0 distance; the
    # reference never does that, but keep the gradient finite.
    d2 = jnp.sum((ca - cb) ** 2, axis=-1)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
    return jnp.where(dist <= eps_total, eps_total - dist, 0.0)
