"""Manual factor-graph assembly: the reference's NonlinearFactorGraph path.

The reference's examples assemble graphs by hand — PriorFactorVector,
GaussianProcessPriorLinear, ObstaclePlanarSDFFactorArm, ... pushed onto a
gtsam::NonlinearFactorGraph, then handed to an optimizer (SURVEY.md call
stack 3.3; /root/reference/matlab/Arm2FactorGraphExample.m:76-120,
/root/reference/gpmp2_python/examples/pointRobot3FactorExample.py:107-160).
This module is the batched equivalent of that *manual* API: a
`FactorGraph` collects factor records over a fixed state chain
(x_0..x_N, v_0..v_N), each factor built from the public factor kernels,
and compiles them into the same block-tridiagonal normal equations the
planner uses — so a hand-built graph runs on the identical batched
GN/LM/Dogleg solver (solver/optimize.py).

Structural contract (checked at add time): unary factors touch one state;
binary factors touch ADJACENT states (i, i+1). That is exactly the
structure of every reference example (the Markov GP chain), and it is what
keeps H block-tridiagonal. Arbitrary-topology graphs belong to
planner/multigraph.py, which builds dense normal equations instead.

Unlike the reference (virtual dispatch per factor per iteration), factors
are GROUPED by kernel and evaluated as one vmapped call per group: a
50-state manual graph with hundreds of GP-interpolated obstacle factors
compiles to a handful of fused kernels plus scatter-adds into the
block-tridiagonal (H_diag, H_off, b) — not hundreds of traced calls.
Factor parameters (prior means, interpolation coefficients, limits) are
stacked into per-group arrays; the kernel itself is shared.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.statespace import StateSpace
from ..gp.interpolator import InterpCoeffs, interp_coeffs, interpolate_pose
from ..gp.prior import gp_prior_error
from ..kinematics.factors import (
    goal_factor_error,
    joint_limit_error,
    velocity_limit_error,
    workspace_orientation_error,
    workspace_pose_error,
    workspace_position_error,
)
from ..obstacle.factors import (
    obstacle_factor_error,
    obstacle_planar_factor_error,
)
from ..obstacle.sdf import PlanarSDF
from ..solver.optimize import OptimizerParams, OptResult, optimize_batch
from .problem import Trajectory

__all__ = ["FactorGraph"]


@dataclasses.dataclass
class _Factor:
    """One factor record. `kernel(params, *states) -> r`; factors with the
    same `group` (and idx arity) evaluate as ONE vmapped kernel call with
    their `params` pytrees stacked along a new leading axis."""

    idx: Tuple[int, ...]  # (i,) unary or (i, i+1) binary
    W: jnp.ndarray  # (R,) diagonal or (R, R) full precision
    name: str
    group: object  # hashable grouping key; kernel shared within a group
    kernel: Callable  # kernel(params, p, v) or kernel(params, p1, v1, p2, v2)
    params: object  # pytree of arrays (stacked within a group), or ()


def _np_Q_inv(Qc: np.ndarray, tau: float) -> np.ndarray:
    """Host-side float64 GP precision Q(tau)^-1 (GPutils.h:34-40), avoiding
    an explicit float64 jnp request when x64 is disabled."""
    Qi = np.linalg.inv(Qc)
    return np.block([
        [12.0 * tau**-3.0 * Qi, -6.0 * tau**-2.0 * Qi],
        [-6.0 * tau**-2.0 * Qi, 4.0 / tau * Qi],
    ])


def _sigma_to_prec_diag(sigma, R: int) -> jnp.ndarray:
    """Isotropic/diagonal sigma -> precision diagonal of length R.
    Computed host-side in float64 (cast to the trajectory dtype at use)."""
    s = np.atleast_1d(np.asarray(sigma, np.float64))
    if s.shape[0] == 1:
        s = np.broadcast_to(s, (R,))
    if s.shape != (R,):
        raise ValueError(f"sigma must be scalar or length {R}, got {s.shape}")
    return jnp.asarray(1.0 / s**2)


def _stack_params(params_list, dtype):
    """Stack per-factor params pytrees along a new leading axis (float
    leaves cast to the trajectory dtype); a group whose params are all ()
    stacks to () (vmapped with in_axes=None)."""
    if all(isinstance(p, tuple) and len(p) == 0 for p in params_list):
        return (), None

    def stack(*xs):
        a = jnp.stack([jnp.asarray(x) for x in xs])
        return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a

    return jax.tree_util.tree_map(stack, *params_list), 0


class FactorGraph:
    """A hand-assembled factor graph over a support-state chain.

    Usage mirrors the reference examples: construct, `add_*` factors in any
    order, then `error(traj)` / `linearize(traj)` / `optimize(init)`.
    """

    def __init__(self, space: StateSpace, num_states: int):
        if num_states < 1:
            raise ValueError("num_states must be >= 1")
        self.space = space
        self.n = num_states
        self.factors: List[_Factor] = []

    # -- structural checks -------------------------------------------------

    def _check_idx(self, *idx: int):
        for i in idx:
            if not (0 <= i < self.n):
                raise ValueError(
                    f"state index {i} out of range [0, {self.n})"
                )
        if len(idx) == 2 and idx[1] != idx[0] + 1:
            raise ValueError(
                f"binary factors must touch adjacent states (i, i+1) to "
                f"keep the normal equations block-tridiagonal; got {idx}. "
                f"Use planner.multigraph for arbitrary topologies."
            )

    def _add(self, idx, W, name, group, kernel, params=()):
        self.factors.append(_Factor(tuple(idx), W, name, group, kernel, params))
        return self

    # -- the reference factor inventory ------------------------------------

    def add_prior_pose(self, i: int, mean, sigma):
        """PriorFactorVector / PriorFactorPose2 / ... on x_i (gtsam
        PriorFactor semantics: r = local(mean, x))."""
        self._check_idx(i)
        d = self.space.dim
        space = self.space
        kernel = _shared_kernel(self, ("prior_pose",),
                                lambda mean_, p, v: space.local(mean_, p))
        return self._add((i,), _sigma_to_prec_diag(sigma, d), "prior_pose",
                         ("prior_pose",), kernel, jnp.asarray(mean))

    def add_prior_vel(self, i: int, mean, sigma):
        """PriorFactorVector on v_i."""
        self._check_idx(i)
        d = self.space.dim
        kernel = _shared_kernel(self, ("prior_vel",),
                                lambda mean_, p, v: v - mean_)
        return self._add((i,), _sigma_to_prec_diag(sigma, d), "prior_vel",
                         ("prior_vel",), kernel, jnp.asarray(mean))

    def add_gp_prior(self, i: int, j: int, delta_t, Qc):
        """GaussianProcessPriorLinear / -Lie between states i and j=i+1
        (gp/prior.py; reference GaussianProcessPriorLinear.h:57-83)."""
        self._check_idx(i, j)
        W = jnp.asarray(_np_Q_inv(np.asarray(Qc, np.float64), float(delta_t)))
        space = self.space
        dt = float(delta_t)
        kernel = _shared_kernel(
            self, ("gp_prior", dt),
            lambda _, p1, v1, p2, v2: gp_prior_error(space, p1, v1, p2, v2, dt),
        )
        return self._add((i, j), W, "gp_prior", ("gp_prior", dt), kernel)

    def _obstacle_kernel(self, robot, sdf, eps, interpolated: bool):
        planar = isinstance(sdf, PlanarSDF)
        err = obstacle_planar_factor_error if planar else obstacle_factor_error
        space = self.space
        eps = float(eps)
        if not interpolated:
            key = ("obstacle", id(robot), id(sdf), eps)
            return key, _shared_kernel(
                self, key, lambda _, p, v: err(robot, sdf, p, eps)
            )
        key = ("obstacle_gp", id(robot), id(sdf), eps)

        def kernel(co_arrays, p1, v1, p2, v2):
            co = InterpCoeffs(*(a.astype(p1.dtype) for a in co_arrays))
            pt = interpolate_pose(space, co, p1, v1, p2, v2)
            return err(robot, sdf, pt, eps)

        return key, _shared_kernel(self, key, kernel)

    def add_obstacle(self, i: int, robot, sdf, cost_sigma, eps):
        """ObstacleSDFFactor / ObstaclePlanarSDFFactor on x_i
        (ObstacleSDFFactor-inl.h:18-60); 2D/3D selected by the SDF type."""
        self._check_idx(i)
        key, kernel = self._obstacle_kernel(robot, sdf, eps, False)
        S = robot.num_spheres
        return self._add((i,), _sigma_to_prec_diag(cost_sigma, S),
                         "obstacle", key, kernel)

    def add_obstacle_gp(self, i: int, j: int, robot, sdf, cost_sigma, eps,
                        Qc, delta_t, tau):
        """ObstacleSDFFactorGP / ObstaclePlanarSDFFactorGP between states
        i, j=i+1 at interpolation offset tau (ObstacleSDFFactorGP-inl.h:18-77)."""
        self._check_idx(i, j)
        key, kernel = self._obstacle_kernel(robot, sdf, eps, True)
        co = interp_coeffs(jnp.asarray(np.asarray(Qc, np.float64)),
                           jnp.asarray(float(delta_t)),
                           jnp.asarray(float(tau)))
        S = robot.num_spheres
        return self._add((i, j), _sigma_to_prec_diag(cost_sigma, S),
                         "obstacle_gp", key, kernel, tuple(co))

    def add_vehicle_dynamics(self, i: int, sigma):
        """VehicleDynamicsFactorPose2 / -Vector on (x_i, v_i)
        (VehicleDynamics.h:19-40)."""
        self._check_idx(i)
        space = self.space

        def dyn(_, p, v):
            if space.kind in ("se2", "se2_vector"):
                return v[1:2]
            th = p[2]
            return (v[1] * jnp.cos(th) - v[0] * jnp.sin(th))[None]

        kernel = _shared_kernel(self, ("dynamics",), dyn)
        return self._add((i,), _sigma_to_prec_diag(sigma, 1), "dynamics",
                         ("dynamics",), kernel)

    def add_joint_limit(self, i: int, down, up, thresh, sigma):
        """JointLimitFactorVector / -Pose2Vector on x_i
        (JointLimitFactorVector.h:63-79)."""
        self._check_idx(i)
        d = self.space.dim
        space = self.space
        P = self.space.storage_dim
        th = jnp.broadcast_to(jnp.asarray(thresh, jnp.float32), (P,))
        kernel = _shared_kernel(
            self, ("joint_limit",),
            lambda pr, p, v: joint_limit_error(
                space, p, pr[0], pr[1], pr[2].astype(p.dtype)
            ),
        )
        return self._add(
            (i,), _sigma_to_prec_diag(sigma, d), "joint_limit",
            ("joint_limit",), kernel,
            (jnp.asarray(down), jnp.asarray(up), th),
        )

    def add_velocity_limit(self, i: int, vel_limit, thresh, sigma):
        """VelocityLimitFactorVector on v_i (VelocityLimitFactorVector.h:62-78)."""
        self._check_idx(i)
        d = self.space.dim
        th = jnp.broadcast_to(jnp.asarray(thresh, jnp.float32), (d,))
        kernel = _shared_kernel(
            self, ("vel_limit",),
            lambda pr, p, v: velocity_limit_error(
                v, pr[0], pr[1].astype(v.dtype)
            ),
        )
        return self._add((i,), _sigma_to_prec_diag(sigma, d), "vel_limit",
                         ("vel_limit",), kernel,
                         (jnp.asarray(vel_limit), th))

    def add_goal(self, i: int, fk, goal_point, sigma, link_id: int = -1):
        """GoalFactorArm on x_i: end-effector position - goal
        (GoalFactorArm.h:58-77)."""
        self._check_idx(i)
        key = ("goal", id(fk), link_id)
        kernel = _shared_kernel(
            self, key, lambda gp, p, v: goal_factor_error(fk, p, gp, link_id)
        )
        return self._add((i,), _sigma_to_prec_diag(sigma, 3), "goal", key,
                         kernel, jnp.asarray(goal_point))

    def add_workspace_position(self, i: int, fk, link_id, des_point, sigma):
        """GaussianPriorWorkspacePositionArm on x_i."""
        self._check_idx(i)
        key = ("ws_position", id(fk), link_id)
        kernel = _shared_kernel(
            self, key,
            lambda des, p, v: workspace_position_error(fk, p, link_id, des),
        )
        return self._add((i,), _sigma_to_prec_diag(sigma, 3), "ws_position",
                         key, kernel, jnp.asarray(des_point))

    def add_workspace_orientation(self, i: int, fk, link_id, des_rot, sigma):
        """GaussianPriorWorkspaceOrientationArm on x_i."""
        self._check_idx(i)
        key = ("ws_orientation", id(fk), link_id)
        kernel = _shared_kernel(
            self, key,
            lambda des, p, v: workspace_orientation_error(fk, p, link_id, des),
        )
        return self._add((i,), _sigma_to_prec_diag(sigma, 3),
                         "ws_orientation", key, kernel, jnp.asarray(des_rot))

    def add_workspace_pose(self, i: int, fk, link_id, des_rot, des_point, sigma):
        """GaussianPriorWorkspacePoseArm on x_i."""
        self._check_idx(i)
        key = ("ws_pose", id(fk), link_id)
        kernel = _shared_kernel(
            self, key,
            lambda des, p, v: workspace_pose_error(fk, p, link_id, des[0], des[1]),
        )
        return self._add((i,), _sigma_to_prec_diag(sigma, 6), "ws_pose", key,
                         kernel, (jnp.asarray(des_rot), jnp.asarray(des_point)))

    def add_custom(self, idx: Sequence[int], res: Callable, sigma_or_W,
                   residual_dim: int, name: str = "custom"):
        """Any user residual: unary `res(pose_i, vel_i)` or adjacent-binary
        `res(p1, v1, p2, v2)` returning a (residual_dim,) vector. Each
        custom factor traces individually (its own group)."""
        if len(idx) not in (1, 2):
            raise ValueError(
                f"add_custom supports unary (i,) or adjacent-binary "
                f"(i, i+1) factors; got {len(idx)} indices {tuple(idx)}. "
                f"Use planner.multigraph for arbitrary topologies."
            )
        self._check_idx(*idx)
        W = jnp.asarray(sigma_or_W)
        if W.ndim < 2:
            W = _sigma_to_prec_diag(sigma_or_W, residual_dim)
        kernel = lambda _, *states: res(*states)  # noqa: E731
        return self._add(tuple(idx), W, name, object(), kernel)

    # -- evaluation --------------------------------------------------------

    def _groups(self):
        """Factors grouped by (group key, arity, W shape) preserving
        insertion order of first appearance."""
        groups = {}
        for f in self.factors:
            k = (f.group, len(f.idx), f.W.shape, f.W.ndim)
            groups.setdefault(k, []).append(f)
        return list(groups.values())

    def error(self, traj: Trajectory):
        """Total graph error 0.5 * sum of weighted squared residuals
        (gtsam::NonlinearFactorGraph::error)."""
        pose, vel = traj.pose, traj.vel
        dtype = pose.dtype
        err = jnp.zeros((), dtype)
        for fs in self._groups():
            kernel = fs[0].kernel
            params, p_ax = _stack_params([f.params for f in fs], dtype)
            W = jnp.stack([f.W for f in fs]).astype(dtype)  # (F, R[, R])
            i0 = jnp.asarray([f.idx[0] for f in fs])
            if len(fs[0].idx) == 1:
                r = jax.vmap(kernel, in_axes=(p_ax, 0, 0))(
                    params, pose[i0], vel[i0]
                )
            else:
                r = jax.vmap(kernel, in_axes=(p_ax, 0, 0, 0, 0))(
                    params, pose[i0], vel[i0], pose[i0 + 1], vel[i0 + 1]
                )
            if W.ndim == 2:
                err = err + 0.5 * jnp.sum(W * r * r)
            else:
                err = err + 0.5 * jnp.einsum("fr,frs,fs->", r, W, r)
        return err

    def linearize(self, traj: Trajectory):
        """Assemble block-tridiagonal Gauss-Newton normal equations:
        (H_diag (n,m,m), H_off (n-1,m,m), b (n,m), err ()). One vmapped
        jacfwd per factor GROUP (not per factor), scatter-added into the
        block-tridiagonal arrays; duplicate state indices accumulate
        correctly through `.at[].add`."""
        space, n = self.space, self.n
        d = space.dim
        m = 2 * d
        pose, vel = traj.pose, traj.vel
        dtype = pose.dtype

        H_diag = jnp.zeros((n, m, m), dtype)
        H_off = jnp.zeros((n - 1, m, m), dtype)
        b = jnp.zeros((n, m), dtype)
        err = jnp.zeros((), dtype)

        for fs in self._groups():
            kernel = fs[0].kernel
            params, p_ax = _stack_params([f.params for f in fs], dtype)
            W = jnp.stack([f.W for f in fs]).astype(dtype)
            i0 = jnp.asarray([f.idx[0] for f in fs])
            unary = len(fs[0].idx) == 1

            if unary:
                def one(pr, p, v):
                    def f(dz):
                        r = kernel(pr, space.retract(p, dz[:d]), v + dz[d:])
                        return r, r

                    J, r = jax.jacfwd(f, has_aux=True)(jnp.zeros(m, dtype))
                    return r, J

                r, J = jax.vmap(one, in_axes=(p_ax, 0, 0))(
                    params, pose[i0], vel[i0]
                )  # (F, R), (F, R, m)
            else:
                def two(pr, p1, v1, p2, v2):
                    def f(dz):
                        r = kernel(
                            pr,
                            space.retract(p1, dz[:d]), v1 + dz[d : 2 * d],
                            space.retract(p2, dz[2 * d : 3 * d]), v2 + dz[3 * d :],
                        )
                        return r, r

                    J, r = jax.jacfwd(f, has_aux=True)(jnp.zeros(2 * m, dtype))
                    return r, J

                r, J = jax.vmap(two, in_axes=(p_ax, 0, 0, 0, 0))(
                    params, pose[i0], vel[i0], pose[i0 + 1], vel[i0 + 1]
                )  # (F, R), (F, R, 2m)

            if W.ndim == 2:
                Wr = W * r  # (F, R)
                WJ = W[..., None] * J
            else:
                Wr = jnp.einsum("frs,fs->fr", W, r)
                WJ = jnp.einsum("frs,fsm->frm", W, J)
            err = err + 0.5 * jnp.sum(r * Wr)

            if unary:
                H_diag = H_diag.at[i0].add(jnp.einsum("frm,frn->fmn", J, WJ))
                b = b.at[i0].add(-jnp.einsum("frm,fr->fm", J, Wr))
            else:
                J1, J2 = J[..., :m], J[..., m:]
                WJ1, WJ2 = WJ[..., :m], WJ[..., m:]
                H_diag = H_diag.at[i0].add(jnp.einsum("frm,frn->fmn", J1, WJ1))
                H_diag = H_diag.at[i0 + 1].add(
                    jnp.einsum("frm,frn->fmn", J2, WJ2)
                )
                H_off = H_off.at[i0].add(jnp.einsum("frm,frn->fmn", J1, WJ2))
                b = b.at[i0].add(-jnp.einsum("frm,fr->fm", J1, Wr))
                b = b.at[i0 + 1].add(-jnp.einsum("frm,fr->fm", J2, Wr))

        return H_diag, H_off, b, err

    def optimize(self, init: Trajectory,
                 params: Optional[OptimizerParams] = None) -> OptResult:
        """Solve the graph with the batched GN/LM/Dogleg driver
        (reference: GaussNewton/Dogleg optimizer on the manual graph,
        Arm2FactorGraphExample.m:136-148). Returns an unbatched OptResult."""
        if params is None:
            params = OptimizerParams(method="gaussnewton", max_iter=100,
                                     rel_thresh=1e-5)
        space = self.space
        d = space.dim

        def lin_b(traj_b):
            H_diag, H_off, b, err = self.linearize(
                Trajectory(traj_b.pose[0], traj_b.vel[0])
            )
            return H_diag[None], H_off[None], b[None], err[None]

        def err_b(traj_b):
            return self.error(Trajectory(traj_b.pose[0], traj_b.vel[0]))[None]

        def retract_b(traj_b, delta):
            pose = jax.vmap(jax.vmap(space.retract))(
                traj_b.pose, delta[..., :d]
            )
            return Trajectory(pose, traj_b.vel + delta[..., d:])

        init_b = Trajectory(init.pose[None], init.vel[None])
        res = optimize_batch(lin_b, err_b, retract_b, init_b, params)
        return OptResult(
            Trajectory(res.traj.pose[0], res.traj.vel[0]),
            res.error[0], res.iterations[0], res.converged[0], res.gave_up[0],
        )


def _shared_kernel(graph: FactorGraph, key, fn):
    """One kernel object per (graph, key): factors added with the same key
    share the callable, which is what makes them one vmapped group."""
    cache = graph.__dict__.setdefault("_kernel_cache", {})
    hit = cache.get(key)
    if hit is None:
        cache[key] = fn
        return fn
    return hit
