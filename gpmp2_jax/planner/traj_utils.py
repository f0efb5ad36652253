"""Trajectory initialization and GP densification.

Port of /root/reference/gpmp2/planner/TrajUtils.{h,cpp}:
  - init_traj_straight_line: chart-space lerp of poses with constant
    average velocity (initArmTrajStraightLine TrajUtils.cpp:25-50;
    initPose2VectorTrajStraightLine :53-73; initPose2TrajStraightLine
    :76-93 — all three collapse into one StateSpace-generic function).
  - interpolate_traj: insert `inter` GP-interpolated states per interval
    (interpolateArmTraj TrajUtils.cpp:96-158 and the Pose2/Pose2Vector
    variants :200-275), returning a densified trajectory with renumbered
    states.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry.statespace import StateSpace
from ..gp.gputils import calc_lambda, calc_psi
from ..gp.interpolator import InterpCoeffs, interpolate_state
from .problem import Trajectory

__all__ = ["init_traj_straight_line", "interpolate_traj"]


def init_traj_straight_line(space: StateSpace, start, end, total_step: int,
                            total_time: float) -> Trajectory:
    """Straight-line initialization with constant average velocity.

    Poses interpolate along the chart geodesic start -> end; velocity is
    local(start, end) / total_time at every state (the reference uses
    (end - start) / total_time for vectors and the Pose2 chart for SE(2))."""
    start = jnp.asarray(start)
    end = jnp.asarray(end)
    n = total_step + 1
    alphas = jnp.linspace(0.0, 1.0, n, dtype=start.dtype)
    tangent = space.local(start, end)
    poses = jax.vmap(lambda a: space.retract(start, a * tangent))(alphas)
    avg_vel = tangent / jnp.asarray(total_time, start.dtype)
    vels = jnp.broadcast_to(avg_vel, (n, space.dim))
    return Trajectory(poses, vels)


def interpolate_traj(space: StateSpace, traj: Trajectory, Qc, delta_t,
                     inter_step: int) -> Trajectory:
    """Densify: between each pair of support states insert `inter_step`
    GP-interpolated states. Output has N*(inter_step+1)+1 states.

    Matches interpolateArmTraj (TrajUtils.cpp:96-158): interpolated state
    at tau_j = j * delta_t / (inter_step + 1), original support states kept.
    """
    Qc = jnp.asarray(Qc)
    dt = jnp.asarray(delta_t, traj.pose.dtype)
    n = traj.pose.shape[0]
    num_int = inter_step + 1
    taus = (
        jnp.arange(1, num_int, dtype=traj.pose.dtype) * dt / num_int
    )  # (inter_step,)

    lam = jax.vmap(lambda t: calc_lambda(Qc, dt, t))(taus)
    psi = jax.vmap(lambda t: calc_psi(Qc, dt, t))(taus)

    def interval(p1, v1, p2, v2):
        def at_tau(l, ps):
            return interpolate_state(space, InterpCoeffs(l, ps), p1, v1, p2, v2)

        ip, iv = jax.vmap(at_tau)(lam, psi)
        # interval block: support state then its interpolants
        return (
            jnp.concatenate([p1[None], ip], axis=0),
            jnp.concatenate([v1[None], iv], axis=0),
        )

    bp, bv = jax.vmap(interval)(
        traj.pose[:-1], traj.vel[:-1], traj.pose[1:], traj.vel[1:]
    )  # (n-1, num_int, ...)
    poses = jnp.concatenate(
        [bp.reshape((n - 1) * num_int, -1), traj.pose[-1][None]], axis=0
    )
    vels = jnp.concatenate(
        [bv.reshape((n - 1) * num_int, -1), traj.vel[-1][None]], axis=0
    )
    return Trajectory(poses, vels)
