"""Configuration-space abstraction: the replacement for GTSAM's
Lie-group traits machinery and the reference's dynamic-size product groups
(/root/reference/gpmp2/geometry/ProductDynamicLieGroup.h,
 /root/reference/gpmp2/geometry/Pose2Vector.h).

A `StateSpace` describes how a robot family's configuration ("pose" in the
reference's terminology) is stored and how tangent-space operations behave.
Dispatch is static (plain Python over a frozen descriptor), so every robot
family compiles to a fixed-shape XLA program — there are no dynamic
dimensions anywhere, unlike the reference's Eigen::Dynamic types.

Supported spaces (mirroring the reference's robot families):
  - VectorSpace(d): Arm / PointRobot configurations (R^d).
  - SE2Space():     Pose2MobileBase (gtsam::Pose2).
  - SE2VectorSpace(n): Pose2Vector = SE(2) x R^n for every mobile
    manipulator family (arm(s) / lin.actuator + arm(s)).
  - SE3Space():     gtsam::Pose3 trajectory states — the reference exports
    GP prior + interpolator on Pose3
    (/root/reference/gpmp2/gp/GaussianProcessPriorPose3.h:15,
     GaussianProcessInterpolatorPose3.h:15; public API gpmp2.h:77-99).

Storage conventions:
  - VectorSpace: (d,) array.
  - SE2Space: (3,) array [x, y, theta].
  - SE2VectorSpace: (3 + n,) array, [x, y, theta, q_1..q_n]; the tangent is
    [vx, vy, omega, qdot] matching gtsam's Pose2Vector ordering (pose block
    first — see Pose2Vector.h:26-53).
  - SE3Space: (12,) array [R row-major (9), t (3)]; the tangent is
    [omega (3), v (3)] matching gtsam::Pose3::Expmap ordering. Rotation is
    stored as the full matrix (not a quaternion) so chart ops stay
    branch-free matmuls.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from . import se2, se3

__all__ = ["VectorSpace", "SE2Space", "SE2VectorSpace", "SE3Space", "StateSpace"]


def _se3_unflat(x) -> "se3.Pose3":
    return se3.Pose3(
        x[..., :9].reshape(x.shape[:-1] + (3, 3)), x[..., 9:]
    )


def _se3_flat(p: "se3.Pose3"):
    return jnp.concatenate(
        [p.rot.reshape(p.rot.shape[:-2] + (9,)), p.trans], axis=-1
    )


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """Static descriptor of a configuration space.

    kind: 'vector' | 'se2' | 'se2_vector'
    dim:  tangent dimension (== dof of the robot family)
    """

    kind: str
    dim: int

    # ---- core chart ops (all take/return flat arrays of shape (storage_dim,))

    @property
    def storage_dim(self) -> int:
        return 12 if self.kind == "se3" else self.dim

    def identity(self, dtype=jnp.float32):
        if self.kind == "se3":
            return _se3_flat(se3.identity(dtype=dtype))
        return jnp.zeros(self.storage_dim, dtype=dtype)

    def retract(self, x, delta):
        """Right retraction x * Exp(delta) (exact exp on each group block)."""
        if self.kind == "vector":
            return x + delta
        if self.kind == "se2":
            return se2.retract(x, delta)
        if self.kind == "se2_vector":
            pose = se2.retract(x[..., :3], delta[..., :3])
            return jnp.concatenate([pose, x[..., 3:] + delta[..., 3:]], axis=-1)
        if self.kind == "se3":
            return _se3_flat(se3.retract(_se3_unflat(x), delta))
        raise ValueError(self.kind)

    def local(self, x, y):
        """Log(x^-1 y): tangent of y in the chart centered at x."""
        if self.kind == "vector":
            return y - x
        if self.kind == "se2":
            return se2.local(x, y)
        if self.kind == "se2_vector":
            pose = se2.local(x[..., :3], y[..., :3])
            return jnp.concatenate([pose, y[..., 3:] - x[..., 3:]], axis=-1)
        if self.kind == "se3":
            return se3.local(_se3_unflat(x), _se3_unflat(y))
        raise ValueError(self.kind)

    def compose(self, x, y):
        if self.kind == "vector":
            return x + y
        if self.kind == "se2":
            return se2.compose(x, y)
        if self.kind == "se2_vector":
            pose = se2.compose(x[..., :3], y[..., :3])
            return jnp.concatenate([pose, x[..., 3:] + y[..., 3:]], axis=-1)
        if self.kind == "se3":
            return _se3_flat(se3.compose(_se3_unflat(x), _se3_unflat(y)))
        raise ValueError(self.kind)

    def inverse(self, x):
        if self.kind == "vector":
            return -x
        if self.kind == "se2":
            return se2.inverse(x)
        if self.kind == "se2_vector":
            return jnp.concatenate([se2.inverse(x[..., :3]), -x[..., 3:]], axis=-1)
        if self.kind == "se3":
            return _se3_flat(se3.inverse(_se3_unflat(x)))
        raise ValueError(self.kind)

    def expmap(self, delta):
        if self.kind == "vector":
            return delta
        if self.kind == "se2":
            return se2.expmap(delta)
        if self.kind == "se2_vector":
            return jnp.concatenate(
                [se2.expmap(delta[..., :3]), delta[..., 3:]], axis=-1
            )
        if self.kind == "se3":
            return _se3_flat(se3.expmap(delta))
        raise ValueError(self.kind)

    def logmap(self, x):
        if self.kind == "vector":
            return x
        if self.kind == "se2":
            return se2.logmap(x)
        if self.kind == "se2_vector":
            return jnp.concatenate([se2.logmap(x[..., :3]), x[..., 3:]], axis=-1)
        if self.kind == "se3":
            return se3.logmap(_se3_unflat(x))
        raise ValueError(self.kind)

    @property
    def is_vector(self) -> bool:
        return self.kind == "vector"

    def interpolate_linear(self, x, y, alpha):
        """Chart-based interpolation x * Exp(alpha * Log(x^-1 y)).

        For vector spaces this is plain lerp; for SE(2) blocks it matches the
        gtsam `interpolate` used by initPose2VectorTrajStraightLine
        (/root/reference/gpmp2/planner/TrajUtils.cpp:53-73).
        """
        return self.retract(x, alpha * self.local(x, y))


def VectorSpace(d: int) -> StateSpace:
    return StateSpace("vector", d)


def SE2Space() -> StateSpace:
    return StateSpace("se2", 3)


def SE2VectorSpace(n: int) -> StateSpace:
    space = StateSpace("se2_vector", 3 + n)
    return space


def SE3Space() -> StateSpace:
    """gtsam::Pose3 trajectory states: tangent dim 6 ([omega, v]), storage
    dim 12 (rotation matrix row-major + translation)."""
    return StateSpace("se3", 6)
