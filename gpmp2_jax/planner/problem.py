"""Trajectory optimization problem: the structure-of-arrays factor program.

This is the replacement for the reference's graph assembly
(/root/reference/gpmp2/planner/BatchTrajOptimizer-inl.h:19-84). The same
recipe — start/goal priors, optional joint/velocity-limit factors, an
obstacle factor per support state, obs_check_inter GP-interpolated obstacle
factors per interval, and a GP prior per interval — but instead of a bag of
virtual-dispatch factors, each factor *type* is one batched residual kernel
evaluated across the whole trajectory at once, and the normal equations are
accumulated directly into block-tridiagonal (H_diag, H_off, b) form.

State layout: n = total_step+1 support states; z_i = [pose tangent, vel]
(m = 2*dof). The Markov structure of the graph guarantees only adjacent
states couple, so H is exactly block-tridiagonal (SURVEY.md section 7).

Extension slots beyond the reference recipe:
  - `extra_*` per-state priors (weight-masked): the mechanism behind the
    iSAM2-style incremental replanner (fixConfigAndVel / addStateEstimate,
    ISAM2TrajOptimizer-inl.h:162-195) — factor add/remove becomes weight
    masking so the jitted program shape never changes.
  - vehicle-dynamics factor flag (VehicleDynamics.h:19-40), applied at
    every state for mobile robots.
  - goal_region mode: replaces the end-config prior with an end-effector
    workspace goal (GoalFactorArm.h:26-102).

All fields are arrays -> a TrajProblem vmaps over a problem batch (leading
axis on every data leaf, including SDF data for per-problem worlds).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..geometry.statespace import StateSpace
from ..gp.gputils import calc_lambda, calc_psi, calc_Q_inv
from ..gp.interpolator import InterpCoeffs, interpolate_pose
from ..gp.prior import gp_prior_error, gp_prior_jacobians_linear
from ..kinematics.factors import (
    goal_factor_error,
    joint_limit_error,
    velocity_limit_error,
    workspace_pose_error,
)
from ..kinematics.robot import RobotModel, sphere_centers_world
from ..obstacle.factors import (
    obstacle_factor_error,
    obstacle_planar_factor_error,
)
from ..obstacle.sdf import PlanarSDF
from ..solver.linearize import (HIGHEST, jtwj_diag, jtwj_full, jtwr_diag,
                                jtwr_full, quad_err_diag, quad_err_full)

__all__ = ["Trajectory", "TrajProblem", "traj_error", "traj_linearize",
           "collision_cost"]


class Trajectory(NamedTuple):
    """Support states: pose (n, P) storage layout, vel (n, d)."""

    pose: jnp.ndarray
    vel: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TrajProblem:
    """One planning problem (vmappable pytree; meta fields are static)."""

    # data
    robot: RobotModel
    sdf: object  # PlanarSDF | SignedDistanceField
    dt: jnp.ndarray  # () delta_t = total_time / total_step
    Qc: jnp.ndarray  # (d, d) GP power-spectral-density covariance
    start_pose: jnp.ndarray  # (P,)
    start_vel: jnp.ndarray  # (d,)
    end_pose: jnp.ndarray  # (P,)
    end_vel: jnp.ndarray  # (d,)
    pose_prior_w: jnp.ndarray  # (d,) precision diag (start prior)
    vel_prior_w: jnp.ndarray  # (d,)
    goal_pose_w: jnp.ndarray  # (d,) precision diag (goal prior; zero = removed)
    goal_vel_w: jnp.ndarray  # (d,)
    obs_w: jnp.ndarray  # () precision 1/cost_sigma^2
    eps: jnp.ndarray  # () obstacle safety margin
    taus: jnp.ndarray  # (inter,) interpolation offsets within an interval
    # joint limits (used iff flags set)
    pos_lim_down: jnp.ndarray  # (d,)
    pos_lim_up: jnp.ndarray  # (d,)
    pos_lim_thresh: jnp.ndarray  # (d,)
    pos_lim_w: jnp.ndarray  # (d,)
    vel_lim: jnp.ndarray  # (d,)
    vel_lim_thresh: jnp.ndarray  # (d,)
    vel_lim_w: jnp.ndarray  # (d,)
    # extension: vehicle dynamics weight (used iff flag set)
    dyn_w: jnp.ndarray  # ()
    # extension: workspace goal (used iff goal_region set)
    goal_point: jnp.ndarray  # (3,)
    goal_w: jnp.ndarray  # ()
    # extension: K weight-masked per-state prior slots (replanning)
    extra_idx: jnp.ndarray  # (K,) int32
    extra_pose: jnp.ndarray  # (K, P)
    extra_vel: jnp.ndarray  # (K, d)
    extra_pose_w: jnp.ndarray  # (K, d)
    extra_vel_w: jnp.ndarray  # (K, d)
    # extension: self-collision factor at every state (SelfCollision.h)
    sc_pairs_a: jnp.ndarray  # (Psc,) int32 sphere indices
    sc_pairs_b: jnp.ndarray  # (Psc,) int32
    sc_eps: jnp.ndarray  # (Psc,) per-pair safety margins
    sc_w: jnp.ndarray  # (Psc,) per-pair precisions
    # extension: Kw weight-masked workspace prior slots
    # (GaussianPriorWorkspacePosition/Orientation/Pose.h); each slot pins
    # link `ws_link[k]`'s frame at trajectory state `ws_idx[k]`
    ws_idx: jnp.ndarray  # (Kw,) int32 state index
    ws_link: jnp.ndarray  # (Kw,) int32 link index
    ws_rot: jnp.ndarray  # (Kw, 3, 3) desired orientation
    ws_point: jnp.ndarray  # (Kw, 3) desired position
    ws_pos_w: jnp.ndarray  # (Kw, 3) position precision (zero = off)
    ws_rot_w: jnp.ndarray  # (Kw, 3) orientation precision (zero = off)
    # meta (static)
    N: int = 10  # total_step: number of intervals
    planar: bool = False
    flag_pos_limit: bool = False
    flag_vel_limit: bool = False
    flag_vehicle_dynamics: bool = False
    goal_region: bool = False  # workspace goal instead of end-config prior
    num_extra: int = 0
    flag_self_collision: bool = False
    num_ws: int = 0

    @property
    def space(self) -> StateSpace:
        return self.robot.space


jax.tree_util.register_dataclass(
    TrajProblem,
    data_fields=[
        "robot", "sdf", "dt", "Qc", "start_pose", "start_vel", "end_pose",
        "end_vel", "pose_prior_w", "vel_prior_w", "goal_pose_w",
        "goal_vel_w", "obs_w", "eps", "taus",
        "pos_lim_down", "pos_lim_up", "pos_lim_thresh", "pos_lim_w",
        "vel_lim", "vel_lim_thresh", "vel_lim_w", "dyn_w",
        "goal_point", "goal_w",
        "extra_idx", "extra_pose", "extra_vel", "extra_pose_w", "extra_vel_w",
        "sc_pairs_a", "sc_pairs_b", "sc_eps", "sc_w",
        "ws_idx", "ws_link", "ws_rot", "ws_point", "ws_pos_w", "ws_rot_w",
    ],
    meta_fields=["N", "planar", "flag_pos_limit", "flag_vel_limit",
                 "flag_vehicle_dynamics", "goal_region", "num_extra",
                 "flag_self_collision", "num_ws"],
)


# --------------------------------------------------------------------------
# residual kernels (shared by error-only and linearize paths)
# --------------------------------------------------------------------------


def _obs_res(prob: TrajProblem, pose):
    if prob.planar:
        return obstacle_planar_factor_error(prob.robot, prob.sdf, pose, prob.eps)
    return obstacle_factor_error(prob.robot, prob.sdf, pose, prob.eps)


def _obs_res_and_jac(prob: TrajProblem, conf):
    """Analytic obstacle residual + Jacobian wrt configuration: (S,), (S, d).

    hinge error = eps_total - d(p) on active spheres; J = -grad_sdf @
    J_center (the reference's row-wise chain rule,
    ObstacleSDFFactor-inl.h:40-57), with out-of-range and inactive rows
    zeroed (ObstacleCost.h:31-49)."""
    from ..kinematics.robot import sphere_centers_and_jac
    from ..obstacle.sdf import planar_sdf_lookup, sdf_lookup

    centers, Jc = sphere_centers_and_jac(prob.robot, conf)  # (S,3), (S,3,d)
    eps_total = prob.robot.sphere_radii + prob.eps
    if prob.planar:
        dist, grad, ok = planar_sdf_lookup(prob.sdf, centers[..., :2])
        Jc_eff = Jc[:, :2, :]  # (S, 2, d)
    else:
        dist, grad, ok = sdf_lookup(prob.sdf, centers,
                                    screen_thresh=eps_total)
        Jc_eff = Jc
    active = ok & (dist <= eps_total)
    r = jnp.where(active, eps_total - dist, 0.0)
    J = jnp.where(
        active[:, None],
        -jnp.einsum("sk,skd->sd", grad, Jc_eff, precision=HIGHEST),  # f32
        0.0,
    )
    return r, J


def _obs_res_and_jac_batched(prob: TrajProblem, confs):
    """Batched analytic obstacle residual + Jacobian: (..., d) configs ->
    (..., S), (..., S, d). Feeds ALL collision states (support +
    interpolated) through a single FK pass and a single SDF gather.

    Revolute arms route through the triple-product form
    (`_obs_res_jac_arm_fused`): the (S, 3, d) geometric Jacobian and its
    (S, d, 3) cross-product intermediates never materialize — only the
    per-config joint axis frames do. Other families use the generic
    centers+Jacobian path (`arm_fk_spheres_batched`)."""
    from ..kinematics import fk as fk_mod
    from ..kinematics.robot import arm_fk_spheres_batched
    from ..obstacle.sdf import planar_sdf_lookup, sdf_lookup

    if isinstance(prob.robot.fk, fk_mod.ArmFK):
        return _obs_res_jac_arm_fused(prob, confs)

    centers, Jc = arm_fk_spheres_batched(prob.robot, confs)
    eps_total = prob.robot.sphere_radii + prob.eps
    if prob.planar:
        dist, grad, ok = planar_sdf_lookup(prob.sdf, centers[..., :2])
        Jc_eff = Jc[..., :2, :]
    else:
        dist, grad, ok = sdf_lookup(prob.sdf, centers,
                                    screen_thresh=eps_total)
        Jc_eff = Jc
    active = ok & (dist <= eps_total)
    r = jnp.where(active, eps_total - dist, 0.0)
    J = jnp.where(
        active[..., None],
        -jnp.einsum("...sk,...skd->...sd", grad, Jc_eff,
                    precision=HIGHEST),  # full f32, not TF32
        0.0,
    )
    return r, J


def _obs_res_jac_arm_fused(prob: TrajProblem, confs):
    """Obstacle residual + Jacobian for revolute DH arms via the scalar
    triple product (see kinematics/robot.py:sphere_centers_axes):

        J[s, j] = -g_s . (z_j x (p_s - o_j))
                = -(z_j . (p_s x g_s) - g_s . (z_j x o_j))

    i.e. one (S, 6) x (d, 6) contraction per config against
    [p x g | -g] and [z | z x o] — the same math as the reference's
    row-wise chain rule (ObstacleSDFFactor-inl.h:40-57 with Arm.cpp's
    geometric Jacobian) with the (S, d, 3) cross intermediates folded
    away. Planar variants fall out with grad_z = 0."""
    from ..kinematics.robot import sphere_centers_axes_batched
    from ..obstacle.sdf import planar_sdf_lookup_components, sdf_lookup_components

    d = confs.shape[-1]
    lead = confs.shape[:-1]
    flat = confs.reshape(-1, d)
    centers, z, o = sphere_centers_axes_batched(
        prob.robot, flat
    )  # (N, S, 3), (N, d, 3), (N, d, 3)
    eps_total = prob.robot.sphere_radii + prob.eps
    # COMPONENT-wise lookup: the corner gather runs on the FLAT query
    # vector (each corner column a contiguous slice) instead of on
    # (..., 3)/(..., 8) vector tails, which a tiled device memory pads
    # (the reason on the previous accelerator). Opt-in screens
    # (coarse/screen_boxes) are ignored here — they only change WHICH rows
    # are gathered, never the hinge.
    cx, cy, cz = centers[..., 0], centers[..., 1], centers[..., 2]
    if prob.planar:
        dist, gx, gy, ok = planar_sdf_lookup_components(prob.sdf, cx, cy)
        gz = jnp.zeros_like(gx)
    else:
        dist, gx, gy, gz, ok = sdf_lookup_components(prob.sdf, cx, cy, cz)
    active = ok & (dist <= eps_total)
    r = jnp.where(active, eps_total - dist, 0.0)
    # c = p x g, w = z x o in components
    c1 = cy * gz - cz * gy
    c2 = cz * gx - cx * gz
    c3 = cx * gy - cy * gx
    zx, zy, zz = z[..., 0], z[..., 1], z[..., 2]
    w1 = zy * o[..., 2] - zz * o[..., 1]
    w2 = zz * o[..., 0] - zx * o[..., 2]
    w3 = zx * o[..., 1] - zy * o[..., 0]
    jmask = (
        jnp.arange(d)[None, :] <= prob.robot.sphere_link_ids[:, None]
    )  # (S, d)
    # contraction unrolled into six broadcast FMAs over (N, S, d): XLA
    # fuses them into ONE loop pass, where the einsum form lowered to a
    # convolution plus operand relayout copies on the previous accelerator
    dot = (
        c1[..., :, None] * zx[..., None, :]
        + c2[..., :, None] * zy[..., None, :]
        + c3[..., :, None] * zz[..., None, :]
        - gx[..., :, None] * w1[..., None, :]
        - gy[..., :, None] * w2[..., None, :]
        - gz[..., :, None] * w3[..., None, :]
    )
    J = jnp.where(active[..., None] & jmask, -dot, 0.0)
    S = r.shape[-1]
    return r.reshape(lead + (S,)), J.reshape(lead + (S, d))


def _obs_err_batched(prob: TrajProblem, confs):
    """Hinge obstacle residuals for a stack of configurations (..., d) ->
    (..., S): ONE batched FK pass + ONE SDF gather for all states — the
    error-only twin of `_obs_res_and_jac_batched`, used by `traj_error` /
    `collision_cost` so the manual-graph API and the quality metrics run at
    planner-linearize speed instead of the per-state vmap."""
    from ..obstacle.factors import hinge_loss
    from ..obstacle.sdf import planar_sdf_lookup, sdf_lookup

    lead = confs.shape[:-1]
    flat = confs.reshape(-1, confs.shape[-1])
    centers = jax.vmap(
        lambda q: sphere_centers_world(prob.robot, q)
    )(flat)  # (N, S, 3)
    eps_total = prob.robot.sphere_radii + prob.eps
    if prob.planar:
        dist, _, ok = planar_sdf_lookup(prob.sdf, centers[..., :2])
    else:
        dist, _, ok = sdf_lookup(prob.sdf, centers, screen_thresh=eps_total)
    r = hinge_loss(dist, eps_total, ok)
    return r.reshape(lead + r.shape[-1:])


def _pos_limit_res(prob: TrajProblem, pose):
    """Joint position limit residual (d,). Only meaningful for vector /
    se2_vector spaces; the hinge runs on the storage coordinates, matching
    JointLimitFactorVector.h:63-79 (and the +3 offset variant)."""
    return joint_limit_error(
        prob.space, pose, prob.pos_lim_down, prob.pos_lim_up, prob.pos_lim_thresh
    )


def _vel_limit_res(prob: TrajProblem, vel):
    """Symmetric velocity limit (VelocityLimitFactorVector.h:62-78)."""
    return velocity_limit_error(vel, prob.vel_lim, prob.vel_lim_thresh)


def _dyn_res(prob: TrajProblem, pose, vel):
    """Planar vehicle dynamics residual, shape (1,).

    se2 / se2_vector states: body-frame velocity => err = v_y
    (VehicleDynamics.h:19-27). vector states (d>=3, [x, y, theta, ...]):
    world-frame => err = v_y cos(theta) - v_x sin(theta)
    (VehicleDynamics.h:31-40)."""
    if prob.space.kind in ("se2", "se2_vector"):
        return vel[1:2]
    th = pose[2]
    return (vel[1] * jnp.cos(th) - vel[0] * jnp.sin(th))[None]


def _goal_res(prob: TrajProblem, pose):
    """Workspace goal residual: end-effector position - goal
    (GoalFactorArm.h:58-77). End-effector = last link frame origin."""
    return goal_factor_error(prob.robot.fk, pose, prob.goal_point)


def _selfcoll_res(prob: TrajProblem, conf):
    """Self-collision residual (Psc,) (SelfCollision.h:112-132)."""
    from ..obstacle.factors import self_collision_error

    return self_collision_error(
        prob.robot, conf, prob.sc_pairs_a, prob.sc_pairs_b, prob.sc_eps
    )


def _selfcoll_res_and_jac(prob: TrajProblem, conf):
    """Analytic self-collision residual + Jacobian (Psc,), (Psc, d)."""
    from ..kinematics.robot import sphere_centers_and_jac

    centers, Jc = sphere_centers_and_jac(prob.robot, conf)
    ca = centers[prob.sc_pairs_a]
    cb = centers[prob.sc_pairs_b]
    Ja = Jc[prob.sc_pairs_a]  # (P, 3, d)
    Jb = Jc[prob.sc_pairs_b]
    radii = prob.robot.sphere_radii
    eps_total = radii[prob.sc_pairs_a] + radii[prob.sc_pairs_b] + prob.sc_eps
    diff = ca - cb
    d2 = jnp.sum(diff * diff, axis=-1)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
    active = dist <= eps_total
    r = jnp.where(active, eps_total - dist, 0.0)
    # d(dist)/dconf = (diff/dist) . (Ja - Jb); residual derivative is minus
    grad = jnp.einsum("pk,pkd->pd", diff / dist[:, None], Ja - Jb,
                      precision=HIGHEST)  # full f32, not TF32
    J = jnp.where(active[:, None], -grad, 0.0)
    return r, J


def _ws_residuals(prob: TrajProblem, pose_at, dpose=None):
    """Workspace-prior residuals for all slots: (Kw, 6) rows
    [rot err (3), pos err (3)]. pose_at: (Kw, P) configs gathered at ws_idx
    (optionally perturbed)."""

    def one(k_conf, rot_des, point_des, link_id):
        return workspace_pose_error(prob.robot.fk, k_conf, link_id, rot_des, point_des)

    return jax.vmap(one)(pose_at, prob.ws_rot, prob.ws_point, prob.ws_link)


def _interp_coeffs_all(prob: TrajProblem):
    """Lambda/Psi for every tau: (inter, 2d, 2d) each."""
    lam = jax.vmap(lambda t: calc_lambda(prob.Qc, prob.dt, t))(prob.taus)
    psi = jax.vmap(lambda t: calc_psi(prob.Qc, prob.dt, t))(prob.taus)
    return lam, psi


def _prior_res(space: StateSpace, mean, x):
    """Prior residual local(mean, x) (gtsam PriorFactor semantics)."""
    return space.local(mean, x)


# --------------------------------------------------------------------------
# error-only path (LM/dogleg accept test; cheap, no Jacobians)
# --------------------------------------------------------------------------


def traj_error(prob: TrajProblem, traj: Trajectory):
    """Total graph error, 0.5 * sum of whitened squared residuals —
    matching gtsam::NonlinearFactorGraph::error on the same graph."""
    space = prob.space
    pose, vel = traj.pose, traj.vel
    err = jnp.zeros((), pose.dtype)

    # boundary priors
    err += quad_err_diag(prob.pose_prior_w, _prior_res(space, prob.start_pose, pose[0]))
    err += quad_err_diag(prob.vel_prior_w, vel[0] - prob.start_vel)
    if prob.goal_region:
        err += quad_err_diag(prob.goal_w, _goal_res(prob, pose[prob.N]))
    else:
        err += quad_err_diag(prob.goal_pose_w, _prior_res(space, prob.end_pose, pose[prob.N]))
        err += quad_err_diag(prob.goal_vel_w, vel[prob.N] - prob.end_vel)

    # GP prior per interval
    W_gp = calc_Q_inv(prob.Qc, prob.dt)
    gp_r = jax.vmap(
        lambda p1, v1, p2, v2: gp_prior_error(space, p1, v1, p2, v2, prob.dt)
    )(pose[:-1], vel[:-1], pose[1:], vel[1:])
    err += quad_err_full(W_gp, gp_r)

    # obstacle factors (support + GP-interpolated states): for vector
    # spaces ALL collision states run through one batched FK pass + one
    # SDF gather, mirroring the fused linearize path (the per-state vmap
    # was measurably slower for the manual-graph API / quality metrics)
    T_taus = prob.taus.shape[0]
    d = space.dim
    n = prob.N + 1
    if T_taus > 0 and space.is_vector:
        lam, psi = _interp_coeffs_all(prob)
        lam_p = lam[:, :d, :]
        psi_p = psi[:, :d, :]

        def conf_at(p1, v1, p2, v2):
            s1 = jnp.concatenate([p1, v1], axis=-1)
            s2 = jnp.concatenate([p2, v2], axis=-1)
            return (
                # interpolated configurations in full f32, not TF32
                jnp.einsum("tde,e->td", lam_p, s1, precision=HIGHEST)
                + jnp.einsum("tde,e->td", psi_p, s2, precision=HIGHEST)
            )

        confs = jax.vmap(conf_at)(pose[:-1], vel[:-1], pose[1:], vel[1:])
        all_confs = jnp.concatenate(
            [pose, confs.reshape((n - 1) * T_taus, d)], axis=0
        )
        err += quad_err_diag(prob.obs_w, _obs_err_batched(prob, all_confs))
    else:
        err += quad_err_diag(prob.obs_w, _obs_err_batched(prob, pose))
        if T_taus > 0:
            lam, psi = _interp_coeffs_all(prob)

            def interval(p1, v1, p2, v2):
                def at_tau(l, ps):
                    pt = interpolate_pose(space, InterpCoeffs(l, ps), p1, v1, p2, v2)
                    return _obs_res(prob, pt)

                return jax.vmap(at_tau)(lam, psi)

            rs = jax.vmap(interval)(pose[:-1], vel[:-1], pose[1:], vel[1:])
            err += quad_err_diag(prob.obs_w, rs)

    if prob.flag_pos_limit:
        r = jax.vmap(lambda p: _pos_limit_res(prob, p))(pose)
        err += quad_err_diag(prob.pos_lim_w, r)
    if prob.flag_vel_limit:
        r = jax.vmap(lambda v: _vel_limit_res(prob, v))(vel)
        err += quad_err_diag(prob.vel_lim_w, r)
    if prob.flag_vehicle_dynamics:
        r = jax.vmap(lambda p, v: _dyn_res(prob, p, v))(pose, vel)
        err += quad_err_diag(prob.dyn_w, r)

    if prob.flag_self_collision:
        r = jax.vmap(lambda p: _selfcoll_res(prob, p))(pose)
        err += quad_err_diag(prob.sc_w, r)

    if prob.num_ws > 0:
        rw = _ws_residuals(prob, pose[prob.ws_idx])
        W6 = jnp.concatenate([prob.ws_rot_w, prob.ws_pos_w], axis=-1)
        err += quad_err_diag(W6, rw)

    if prob.num_extra > 0:
        rp = jax.vmap(lambda mean, x: _prior_res(space, mean, x))(
            prob.extra_pose, pose[prob.extra_idx]
        )
        rv = vel[prob.extra_idx] - prob.extra_vel
        err += quad_err_diag(prob.extra_pose_w, rp)
        err += quad_err_diag(prob.extra_vel_w, rv)

    return err


# --------------------------------------------------------------------------
# linearization -> block-tridiagonal normal equations
# --------------------------------------------------------------------------


def _jac_unary_pose(space: StateSpace, res_fn, poses):
    """vmapped (residual, Jacobian-wrt-pose-tangent) for a pose-only factor."""
    d = space.dim

    def one(p):
        def f(dp):
            r = res_fn(space.retract(p, dp))
            return r, r

        J, r = jax.jacfwd(f, has_aux=True)(jnp.zeros(d, p.dtype))
        return r, J

    return jax.vmap(one)(poses)


def traj_linearize(prob: TrajProblem, traj: Trajectory):
    """Build (H_diag (n,m,m), H_off (n-1,m,m), b (n,m), error ()).

    H = J^T W J (Gauss-Newton), b = -J^T W r, error = 0.5 r^T W r.
    """
    space = prob.space
    d = space.dim
    n = prob.N + 1
    m = 2 * d
    pose, vel = traj.pose, traj.vel
    dtype = pose.dtype

    H_diag = jnp.zeros((n, m, m), dtype)
    H_off = jnp.zeros((n - 1, m, m), dtype)
    b = jnp.zeros((n, m), dtype)
    err = jnp.zeros((), dtype)

    def add_unary_pose(H_diag, b, err, idx, r, J, W):
        """r: (..., R), J: (..., R, d) wrt pose tangent; idx int or array."""
        err = err + quad_err_diag(W, r)
        H_pp = jtwj_diag(J, W, J)
        g_p = jtwr_diag(J, W, r)
        H_diag = H_diag.at[idx, :d, :d].add(H_pp)
        b = b.at[idx, :d].add(-g_p)
        return H_diag, b, err

    def add_unary_vel(H_diag, b, err, idx, r, J, W):
        err = err + quad_err_diag(W, r)
        H_vv = jtwj_diag(J, W, J)
        g_v = jtwr_diag(J, W, r)
        H_diag = H_diag.at[idx, d:, d:].add(H_vv)
        b = b.at[idx, d:].add(-g_v)
        return H_diag, b, err

    # ---- boundary priors ------------------------------------------------
    def prior_pose_rj(mean, p):
        def f(dp):
            r = _prior_res(space, mean, space.retract(p, dp))
            return r, r

        return jax.jacfwd(f, has_aux=True)(jnp.zeros(d, dtype))

    J0, r0 = prior_pose_rj(prob.start_pose, pose[0])
    H_diag, b, err = add_unary_pose(H_diag, b, err, 0, r0, J0, prob.pose_prior_w)
    rv0 = vel[0] - prob.start_vel
    H_diag, b, err = add_unary_vel(
        H_diag, b, err, 0, rv0, jnp.eye(d, dtype=dtype), prob.vel_prior_w
    )
    if prob.goal_region:
        def fg(dp):
            r = _goal_res(prob, space.retract(pose[prob.N], dp))
            return r, r

        Jg, rg = jax.jacfwd(fg, has_aux=True)(jnp.zeros(d, dtype))
        H_diag, b, err = add_unary_pose(H_diag, b, err, prob.N, rg, Jg, prob.goal_w)
    else:
        JN, rN = prior_pose_rj(prob.end_pose, pose[prob.N])
        H_diag, b, err = add_unary_pose(H_diag, b, err, prob.N, rN, JN, prob.goal_pose_w)
        rvN = vel[prob.N] - prob.end_vel
        H_diag, b, err = add_unary_vel(
            H_diag, b, err, prob.N, rvN, jnp.eye(d, dtype=dtype), prob.goal_vel_w
        )

    # ---- GP prior per interval -----------------------------------------
    W_gp = calc_Q_inv(prob.Qc, prob.dt)
    if space.is_vector:
        gp_r = jax.vmap(
            lambda p1, v1, p2, v2: gp_prior_error(space, p1, v1, p2, v2, prob.dt)
        )(pose[:-1], vel[:-1], pose[1:], vel[1:])
        H1, H2 = gp_prior_jacobians_linear(d, prob.dt, dtype)
        J1 = jnp.broadcast_to(H1, (n - 1, m, m))
        J2 = jnp.broadcast_to(H2, (n - 1, m, m))
    else:
        def gp_rj(p1, v1, p2, v2):
            def f(dz):
                r = gp_prior_error(
                    space,
                    space.retract(p1, dz[:d]), v1 + dz[d : 2 * d],
                    space.retract(p2, dz[2 * d : 3 * d]), v2 + dz[3 * d :],
                    prob.dt,
                )
                return r, r

            J, r = jax.jacfwd(f, has_aux=True)(jnp.zeros(2 * m, dtype))
            return r, J[:, :m], J[:, m:]

        gp_r, J1, J2 = jax.vmap(gp_rj)(pose[:-1], vel[:-1], pose[1:], vel[1:])

    err = err + quad_err_full(W_gp, gp_r)
    H_diag = H_diag.at[:-1].add(jtwj_full(J1, W_gp, J1))
    H_diag = H_diag.at[1:].add(jtwj_full(J2, W_gp, J2))
    H_off = H_off + jtwj_full(J1, W_gp, J2)
    b = b.at[:-1].add(-jtwr_full(J1, W_gp, gp_r))
    b = b.at[1:].add(-jtwr_full(J2, W_gp, gp_r))

    # ---- obstacle factors (support + GP-interpolated states) -----------
    # analytic path: all robot families have analytic sphere Jacobians.
    # For vector spaces the support AND interpolated configurations run
    # through ONE batched FK pass + ONE SDF gather. Accumulated with SLICE
    # updates, not index scatters: every state has a factor, and a slice
    # add needs no `.at[arange(n)].add` scatter.
    T_taus = prob.taus.shape[0]
    if T_taus > 0 and space.is_vector:
        lam, psi = _interp_coeffs_all(prob)
        # conf(tau) = Lam[:d] [x1;v1] + Psi[:d] [x2;v2] with CONSTANT
        # coefficient blocks per tau -> chain rule is one matmul
        # (reference updatePoseJacobians,
        # GaussianProcessInterpolatorLinear.h:88-96).
        lam_p = lam[:, :d, :]  # (T, d, 2d)
        psi_p = psi[:, :d, :]

        def conf_at(p1, v1, p2, v2):
            s1 = jnp.concatenate([p1, v1], axis=-1)
            s2 = jnp.concatenate([p2, v2], axis=-1)
            return (
                # interpolated configurations in full f32, not TF32
                jnp.einsum("tde,e->td", lam_p, s1, precision=HIGHEST)
                + jnp.einsum("tde,e->td", psi_p, s2, precision=HIGHEST)
            )  # (T, d)

        confs = jax.vmap(conf_at)(pose[:-1], vel[:-1], pose[1:], vel[1:])
        # ONE pass over support + interpolated states: on the previous
        # accelerator a two-pass split (separate obstacle calls, no
        # concat/slice) was slower — the strided slices this concat forces
        # cost less than the second pass's fixed overheads
        all_confs = jnp.concatenate(
            [pose, confs.reshape((n - 1) * T_taus, d)], axis=0
        )
        r_all, J_all = _obs_res_and_jac_batched(prob, all_confs)
        S_sph = r_all.shape[-1]
        obs_r, obs_J = r_all[:n], J_all[:n]
        rs = r_all[n:].reshape(n - 1, T_taus, S_sph)
        Jconf = J_all[n:].reshape(n - 1, T_taus, S_sph, d)
    else:
        obs_r, obs_J = _obs_res_and_jac_batched(prob, pose)

    err = err + quad_err_diag(prob.obs_w, obs_r)
    H_diag = H_diag.at[:, :d, :d].add(jtwj_diag(obs_J, prob.obs_w, obs_J))
    b = b.at[:, :d].add(-jtwr_diag(obs_J, prob.obs_w, obs_r))

    # ---- GP-interpolated obstacle factors ------------------------------
    if T_taus > 0:
        if space.is_vector:
            # Factored Gram: contract the sphere axis in CONFIGURATION
            # space first (G, g are (d, d)/(d)-sized per interval/tau),
            # then push through the constant interpolation coefficients.
            # The naive widened form materializes Jfull = Jconf @ coeff
            # with shape (n-1, T, S, 2m) — 330 MB at the bench batch —
            # three times per step; this form never builds it. Same math
            # (reassociation only).
            coeff = jnp.concatenate([lam_p, psi_p], axis=-1)  # (T, d, 2m)
            W = prob.obs_w
            # Gram contractions in full f32 (HIGHEST), not TF32
            G = jnp.einsum("itsd,itsf->itdf", Jconf, Jconf,
                           precision=HIGHEST)  # (n-1, T, d, d)
            g_c = jnp.einsum("itsd,its->itd", Jconf, rs,
                             precision=HIGHEST)  # (n-1, T, d)
            Hfull = W * jnp.einsum(
                "tdE,itdf,tfF->iEF", coeff, G, coeff,
                precision=HIGHEST)  # (n-1, 2m, 2m)
            gfull = W * jnp.einsum("tdE,itd->iE", coeff, g_c,
                                   precision=HIGHEST)  # (n-1, 2m)
        else:
            lam, psi = _interp_coeffs_all(prob)
            # Lie hybrid: AD only through the (cheap) interpolation chart,
            # analytic FK/SDF Jacobian at the interpolated configuration:
            #   J_z = J_conf(pose_tau) @ d tangent(pose_tau)/d z   (AD)
            def interval_rj(p1, v1, p2, v2):
                def at_tau(l, ps):
                    co = InterpCoeffs(l, ps)
                    pt0 = interpolate_pose(space, co, p1, v1, p2, v2)

                    def mid(dz):
                        pt = interpolate_pose(
                            space, co,
                            space.retract(p1, dz[:d]), v1 + dz[d : 2 * d],
                            space.retract(p2, dz[2 * d : 3 * d]), v2 + dz[3 * d :],
                        )
                        return space.local(pt0, pt)

                    J_mid = jax.jacfwd(mid)(jnp.zeros(2 * m, dtype))  # (d, 2m)
                    r, J_conf = _obs_res_and_jac(prob, pt0)  # (S,), (S, d)
                    return r, J_conf @ J_mid  # (S, 2m)

                return jax.vmap(at_tau)(lam, psi)

            rs, Jfull = jax.vmap(interval_rj)(
                pose[:-1], vel[:-1], pose[1:], vel[1:]
            )  # (n-1, T, S), (n-1, T, S, 2m)
            # One widened (2m x 2m) Gram accumulation over (T, S) instead
            # of three m x m einsums: H11/H22/H12 are its blocks.
            W = prob.obs_w
            # Gram contractions in full f32 (HIGHEST), not TF32
            Hfull = W * jnp.einsum("itsE,itsF->iEF", Jfull, Jfull,
                                   precision=HIGHEST)
            gfull = W * jnp.einsum("itsE,its->iE", Jfull, rs,
                                   precision=HIGHEST)  # (n-1, 2m)

        err = err + quad_err_diag(prob.obs_w, rs)
        H_diag = H_diag.at[:-1].add(Hfull[:, :m, :m])
        H_diag = H_diag.at[1:].add(Hfull[:, m:, m:])
        H_off = H_off + Hfull[:, :m, m:]
        b = b.at[:-1].add(-gfull[:, :m])
        b = b.at[1:].add(-gfull[:, m:])

    # ---- joint / velocity limits ---------------------------------------
    # Analytic Jacobians (VERDICT r1 weak 7): the hinge residual is
    # elementwise on the storage coordinates, so d r_k / d tangent_k is a
    # DIAGONAL of -1/0/+1 (below / inside / above; JointLimitCost.h:16-32),
    # masked like the residual. Vector-block tangents equal storage deltas
    # and masked SE(2) rows are identically zero, so no AD is needed in
    # this innermost loop.
    eye_d = jnp.eye(d, dtype=dtype)
    if prob.flag_pos_limit:
        from ..kinematics.factors import limit_mask

        lr = jax.vmap(lambda p: _pos_limit_res(prob, p))(pose)  # (n, d)
        lo = prob.pos_lim_down + prob.pos_lim_thresh
        hi = prob.pos_lim_up - prob.pos_lim_thresh
        slope = limit_mask(space, dtype) * jnp.where(
            pose < lo, -1.0, jnp.where(pose <= hi, 0.0, 1.0)
        ).astype(dtype)
        err = err + quad_err_diag(prob.pos_lim_w, lr)
        # diagonal add via diag-embed + slice (no advanced-index scatter)
        H_diag = H_diag.at[:, :d, :d].add(
            (prob.pos_lim_w * slope * slope)[..., None] * eye_d
        )
        b = b.at[:, :d].add(-(prob.pos_lim_w * slope * lr))
    if prob.flag_vel_limit:
        vr = jax.vmap(lambda v: _vel_limit_res(prob, v))(vel)  # (n, d)
        vlo = -prob.vel_lim + prob.vel_lim_thresh
        vhi = prob.vel_lim - prob.vel_lim_thresh
        vslope = jnp.where(
            vel < vlo, -1.0, jnp.where(vel <= vhi, 0.0, 1.0)
        ).astype(dtype)
        err = err + quad_err_diag(prob.vel_lim_w, vr)
        H_diag = H_diag.at[:, d:, d:].add(
            (prob.vel_lim_w * vslope * vslope)[..., None] * eye_d
        )
        b = b.at[:, d:].add(-(prob.vel_lim_w * vslope * vr))

    # ---- vehicle dynamics ----------------------------------------------
    if prob.flag_vehicle_dynamics:
        def dyn_rj(p, v):
            def f(dz):
                r = _dyn_res(prob, space.retract(p, dz[:d]), v + dz[d:])
                return r, r

            return jax.jacfwd(f, has_aux=True)(jnp.zeros(m, dtype))

        dJ, dr = jax.vmap(dyn_rj)(pose, vel)  # (n, 1, m), (n, 1)
        err = err + quad_err_diag(prob.dyn_w, dr)
        H_diag = H_diag + jtwj_diag(dJ, prob.dyn_w, dJ)
        b = b - jtwr_diag(dJ, prob.dyn_w, dr)

    # ---- self-collision --------------------------------------------------
    if prob.flag_self_collision:
        sc_r, sc_J = jax.vmap(lambda p: _selfcoll_res_and_jac(prob, p))(pose)
        err = err + quad_err_diag(prob.sc_w, sc_r)
        H_diag = H_diag.at[:, :d, :d].add(jtwj_diag(sc_J, prob.sc_w, sc_J))
        b = b.at[:, :d].add(-jtwr_diag(sc_J, prob.sc_w, sc_r))

    # ---- workspace prior slots ------------------------------------------
    if prob.num_ws > 0:
        def ws_rj(k_conf, rot_des, point_des, link_id):
            def f(dp):
                r = workspace_pose_error(
                    prob.robot.fk, space.retract(k_conf, dp), link_id,
                    rot_des, point_des,
                )
                return r, r

            return jax.jacfwd(f, has_aux=True)(jnp.zeros(d, dtype))

        wJ, wr = jax.vmap(ws_rj)(
            pose[prob.ws_idx], prob.ws_rot, prob.ws_point, prob.ws_link
        )  # (Kw, 6, d), (Kw, 6)
        W6 = jnp.concatenate([prob.ws_rot_w, prob.ws_pos_w], axis=-1)
        err = err + quad_err_diag(W6, wr)
        # slot -> state routing as a one-hot matmul: its sums run in a
        # fixed order, where a scatter-add's atomics on the GPU do not. At
        # HIGHEST the product is exact (1.0 * x plus zeros); under TF32 it
        # would round the values it routes.
        oh_ws = (prob.ws_idx[:, None] == jnp.arange(n)[None, :]).astype(dtype)
        H_diag = H_diag.at[:, :d, :d].add(
            jnp.einsum("kn,kij->nij", oh_ws, jtwj_diag(wJ, W6, wJ),
                       precision=HIGHEST)
        )
        b = b.at[:, :d].add(
            -jnp.einsum("kn,ki->ni", oh_ws, jtwr_diag(wJ, W6, wr),
                        precision=HIGHEST)
        )

    # ---- extra (replanning) prior slots --------------------------------
    if prob.num_extra > 0:
        def ep_rj(mean, p):
            def f(dp):
                r = _prior_res(space, mean, space.retract(p, dp))
                return r, r

            return jax.jacfwd(f, has_aux=True)(jnp.zeros(d, dtype))

        eJ, er = jax.vmap(ep_rj)(prob.extra_pose, pose[prob.extra_idx])
        err = err + quad_err_diag(prob.extra_pose_w, er)
        # slot -> state routing via one-hot matmul (the warm-replan hot
        # path: K ~ 2n slots per lane), at HIGHEST so the routing is exact
        # and its sums run in a fixed order (see the workspace slots above)
        oh = (prob.extra_idx[:, None] == jnp.arange(n)[None, :]).astype(dtype)
        H_diag = H_diag.at[:, :d, :d].add(
            jnp.einsum("kn,kij->nij", oh, jtwj_diag(eJ, prob.extra_pose_w, eJ),
                       precision=HIGHEST)
        )
        b = b.at[:, :d].add(
            -jnp.einsum("kn,ki->ni", oh, jtwr_diag(eJ, prob.extra_pose_w, er),
                        precision=HIGHEST)
        )

        ev = vel[prob.extra_idx] - prob.extra_vel
        err = err + quad_err_diag(prob.extra_vel_w, ev)
        # velocity prior Jacobian is the identity: H_vv adds diag(w) per
        # slot, routed with the same one-hot
        eye_d2 = jnp.eye(d, dtype=dtype)
        H_diag = H_diag.at[:, d:, d:].add(
            jnp.einsum("kn,kij->nij", oh,
                       prob.extra_vel_w[..., None] * eye_d2,
                       precision=HIGHEST)
        )
        b = b.at[:, d:].add(
            -jnp.einsum("kn,ki->ni", oh, prob.extra_vel_w * ev,
                        precision=HIGHEST)
        )

    return H_diag, H_off, b, err


def collision_cost(prob: TrajProblem, poses):
    """Sum of raw (unwhitened, eps=0) obstacle errors over given poses —
    the reference's trajectory-quality metric
    (BatchTrajOptimizer-inl.h:87-100)."""
    prob0 = dataclasses.replace(prob, eps=jnp.zeros_like(prob.eps))
    return jnp.sum(_obs_err_batched(prob0, poses))
