"""Batch trajectory optimization: the top-level planner API.

Port of /root/reference/gpmp2/planner/BatchTrajOptimizer.{h,cpp}.
The reference's 7 per-robot-family entry points (BatchTrajOptimize2DArm,
3DArm, Pose2MobileArm2D, Pose2MobileArm, Pose2Mobile2Arms,
Pose2MobileVetLinArm, Pose2MobileVetLin2Arms — BatchTrajOptimizer.cpp:40-128)
collapse into ONE generic `batch_traj_optimize(robot, sdf, ...)`: the robot
family is carried by the RobotModel pytree and the SDF type (PlanarSDF vs
SignedDistanceField) selects the 2D/3D obstacle kernel.

Unlike the reference (one problem per call), the core entry point is
batched: give it B start/goal pairs (and optionally B SDF worlds / margins)
and the whole batch optimizes in one jitted program — vmap over problems
with shared (unbatched) robot/SDF leaves broadcast instead of materialized,
one lax.while_loop to joint convergence with per-problem masks.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..kinematics.robot import RobotModel
from ..obstacle.sdf import (PlanarSDF, SignedDistanceField, pack_planar_sdf,
                            pack_sdf)
from ..solver.optimize import OptimizerParams, OptResult, optimize_batch
from .problem import Trajectory, TrajProblem, collision_cost, traj_error, traj_linearize
from .settings import TrajOptimizerSetting
from .traj_utils import init_traj_straight_line

__all__ = [
    "make_problem",
    "set_workspace_prior",
    "infer_batch_axes",
    "batch_traj_optimize",
    "plan_batch",
    "collision_cost_batch",
    "optimizer_params_from_setting",
]


def _maybe_pack_sdf(sdf, sdf_pack: Optional[bool]):
    import os

    is_planar = isinstance(sdf, PlanarSDF)
    # NOTE: screen_sdf (coarse conservative bound table) exists as an
    # opt-in but is NOT applied automatically: on the previous
    # accelerator the extra coarse-screen gather pass made the linearize
    # slower despite skipping most fine rows. Not measured on the GPU.
    if sdf_pack is False or getattr(sdf, "packed", None) is not None:
        return sdf
    if sdf_pack is None:
        # NOTE: the budget is on the TOTAL packed-table bytes, so a large
        # per-problem world batch may fall on the other side of it than a
        # single world — pass sdf_pack explicitly when mixing the two.
        budget = int(os.environ.get("GPMP2_SDF_PACK_BUDGET", 2 << 30))
        factor = 4 if is_planar else 8
        if sdf.data.nbytes * factor > budget:
            return sdf
    if is_planar:
        return pack_planar_sdf(sdf)
    # GPMP2_PACK_DTYPE stores packed corners narrower (e.g. float16).
    # On the previous accelerator this did not speed the gather (per-query
    # address cost dominated, not bytes), so full precision stays the
    # default; the option remains for memory-constrained worlds (f16
    # halves the 8x table). Not measured on the GPU.
    pack_dtype = os.environ.get("GPMP2_PACK_DTYPE", "")
    dtype = jnp.dtype(pack_dtype) if pack_dtype not in ("", "none", "auto") else None
    return pack_sdf(sdf, dtype=dtype)


def _validate_problem_inputs(robot, start_pose, start_vel, end_pose,
                             end_vel, setting):
    """Constructor-time shape/value validation, mirroring the reference's
    factor-ctor throws (JointLimitFactorVector.h:52-56,
    VelocityLimitFactorVector.h:49-55): fail here with shapes in the
    message instead of as an XLA shape error deep inside the trace."""
    space = robot.space
    d, P = space.dim, space.storage_dim
    if setting.dof != d:
        raise ValueError(
            f"make_problem: setting.dof={setting.dof} does not match the "
            f"robot's state dimension {d} ({space.kind})"
        )
    for name, arr, want in (
        ("start_pose", start_pose, P), ("end_pose", end_pose, P),
        ("start_vel", start_vel, d), ("end_vel", end_vel, d),
    ):
        shape = jnp.shape(arr)
        if len(shape) not in (1, 2) or shape[-1] != want:
            raise ValueError(
                f"make_problem: {name} must have shape ({want},) or "
                f"(B, {want}), got {shape}"
            )
    batch_shapes = {
        jnp.shape(a)[0]
        for a in (start_pose, start_vel, end_pose, end_vel)
        if len(jnp.shape(a)) == 2
    }
    if len(batch_shapes) > 1:
        raise ValueError(
            f"make_problem: inconsistent batch sizes across start/end "
            f"arrays: {sorted(batch_shapes)}"
        )
    Qc = np.asarray(setting.Qc)
    if Qc.shape != (d, d):
        raise ValueError(
            f"make_problem: setting.Qc must have shape ({d}, {d}), got "
            f"{Qc.shape}"
        )
    if setting.flag_vel_limit and (np.asarray(setting.vel_limits) <= 0).any():
        raise ValueError(
            "make_problem: vel_limits must be strictly positive when "
            "flag_vel_limit is set (VelocityLimitFactorVector.h:49-55), got "
            f"{np.asarray(setting.vel_limits).tolist()}"
        )
    if setting.flag_pos_limit:
        lo = np.asarray(setting.joint_pos_limits_down)
        hi = np.asarray(setting.joint_pos_limits_up)
        if (lo > hi).any():
            raise ValueError(
                "make_problem: joint_pos_limits_down must be <= "
                f"joint_pos_limits_up, got down={lo.tolist()} up={hi.tolist()}"
            )


def make_problem(
    robot: RobotModel,
    sdf,
    start_pose,
    start_vel,
    end_pose,
    end_vel,
    setting: TrajOptimizerSetting,
    *,
    num_extra: int = 0,
    self_collision_pairs=None,
    num_ws: int = 0,
    flag_vehicle_dynamics: bool = False,
    dyn_sigma: float = 1e-3,
    goal_region: bool = False,
    goal_point=None,
    goal_sigma: float = 1e-3,
    dtype=None,
    sdf_pack: Optional[bool] = None,
) -> TrajProblem:
    """Build a TrajProblem from a reference-style setting.

    Graph recipe of BatchTrajOptimizer-inl.h:19-84: delta_t = total_time /
    total_step; interpolated obstacle factors at tau_j = j * delta_t /
    (obs_check_inter + 1), j = 1..obs_check_inter.

    start/end arrays may carry a leading batch axis; all other leaves stay
    unbatched (use `infer_batch_axes` + `plan_batch`)."""
    space = robot.space
    d = space.dim
    _validate_problem_inputs(
        robot, start_pose, start_vel, end_pose, end_vel, setting
    )
    if dtype is None:
        dtype = jnp.asarray(start_pose).dtype
        if dtype not in (jnp.float32, jnp.float64):
            dtype = jnp.float32
    f = lambda x: jnp.asarray(x, dtype)

    def f_float(x):
        """Cast float leaves to the compute dtype; leave integer leaves
        (e.g. sphere link ids) untouched."""
        x = jnp.asarray(x)
        return x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x

    # self-collision pair table: rows (sphere_a, sphere_b, eps, sigma)
    # (the reference's N x 4 data matrix, SelfCollision.h:60)
    if self_collision_pairs is not None:
        scp = np.asarray(self_collision_pairs, dtype=np.float64)
        sc_a = jnp.asarray(scp[:, 0], jnp.int32)
        sc_b = jnp.asarray(scp[:, 1], jnp.int32)
        sc_eps = f(scp[:, 2])
        sc_w = f(1.0 / scp[:, 3] ** 2)
        flag_sc = True
    else:
        sc_a = jnp.zeros((0,), jnp.int32)
        sc_b = jnp.zeros((0,), jnp.int32)
        sc_eps = jnp.zeros((0,), dtype)
        sc_w = jnp.zeros((0,), dtype)
        flag_sc = False

    # corner-pack shared worlds for the fast single-row-gather lookup
    # (sdf.py module docstring). Auto (None): pack unbatched fields whose
    # packed table fits the budget; True forces, False disables.
    sdf = _maybe_pack_sdf(sdf, sdf_pack)

    dt = setting.total_time / setting.total_step
    inter = setting.obs_check_inter
    taus = (jnp.arange(1, inter + 1, dtype=dtype)) * (dt / (inter + 1))

    P = space.storage_dim
    K = num_extra
    return TrajProblem(
        robot=jax.tree_util.tree_map(f_float, robot),
        sdf=jax.tree_util.tree_map(f_float, sdf),
        dt=f(dt),
        Qc=f(setting.Qc),
        start_pose=f(start_pose),
        start_vel=f(start_vel),
        end_pose=f(end_pose),
        end_vel=f(end_vel),
        pose_prior_w=f(1.0 / setting.conf_prior_sigma**2) * jnp.ones(d, dtype),
        vel_prior_w=f(1.0 / setting.vel_prior_sigma**2) * jnp.ones(d, dtype),
        goal_pose_w=f(1.0 / setting.conf_prior_sigma**2) * jnp.ones(d, dtype),
        goal_vel_w=f(1.0 / setting.vel_prior_sigma**2) * jnp.ones(d, dtype),
        obs_w=f(1.0 / setting.cost_sigma**2),
        eps=f(setting.epsilon),
        taus=taus,
        pos_lim_down=f(setting.joint_pos_limits_down),
        pos_lim_up=f(setting.joint_pos_limits_up),
        pos_lim_thresh=f(setting.pos_limit_thresh),
        pos_lim_w=f(1.0 / setting.pos_limit_sigma**2),
        vel_lim=f(setting.vel_limits),
        vel_lim_thresh=f(setting.vel_limit_thresh),
        vel_lim_w=f(1.0 / setting.vel_limit_sigma**2),
        dyn_w=f(1.0 / dyn_sigma**2),
        goal_point=f(goal_point if goal_point is not None else jnp.zeros(3)),
        goal_w=f(1.0 / goal_sigma**2),
        extra_idx=jnp.zeros((K,), jnp.int32),
        extra_pose=jnp.zeros((K, P), dtype),
        extra_vel=jnp.zeros((K, d), dtype),
        extra_pose_w=jnp.zeros((K, d), dtype),
        extra_vel_w=jnp.zeros((K, d), dtype),
        sc_pairs_a=sc_a, sc_pairs_b=sc_b, sc_eps=sc_eps, sc_w=sc_w,
        ws_idx=jnp.zeros((num_ws,), jnp.int32),
        ws_link=jnp.zeros((num_ws,), jnp.int32),
        ws_rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (num_ws, 3, 3)),
        ws_point=jnp.zeros((num_ws, 3), dtype),
        ws_pos_w=jnp.zeros((num_ws, 3), dtype),
        ws_rot_w=jnp.zeros((num_ws, 3), dtype),
        N=setting.total_step,
        planar=isinstance(sdf, PlanarSDF),
        flag_pos_limit=setting.flag_pos_limit,
        flag_vel_limit=setting.flag_vel_limit,
        flag_vehicle_dynamics=flag_vehicle_dynamics,
        goal_region=goal_region,
        num_extra=K,
        flag_self_collision=flag_sc,
        num_ws=num_ws,
    )


def infer_batch_axes(problems: TrajProblem, template: TrajProblem):
    """vmap in_axes pytree: 0 where a leaf has one more axis than in
    `template` (an unbatched problem), None (broadcast) elsewhere."""

    def ax(b, t):
        return 0 if jnp.ndim(b) == jnp.ndim(t) + 1 else None

    return jax.tree_util.tree_map(ax, problems, template)


def set_workspace_prior(prob: TrajProblem, slot: int, state_idx: int,
                        link_id: int, *, point=None, rot=None,
                        pos_sigma: float = 0.01, rot_sigma: float = 0.01):
    """Fill a workspace-prior slot: pin link `link_id`'s frame at state
    `state_idx` to a desired position and/or orientation
    (GaussianPriorWorkspacePosition/Orientation/Pose semantics; pass both
    `point` and `rot` for the full-pose prior)."""
    import dataclasses

    dtype = prob.ws_point.dtype
    upd = dict(
        ws_idx=prob.ws_idx.at[slot].set(state_idx),
        ws_link=prob.ws_link.at[slot].set(link_id),
    )
    if point is not None:
        upd["ws_point"] = prob.ws_point.at[slot].set(jnp.asarray(point, dtype))
        upd["ws_pos_w"] = prob.ws_pos_w.at[slot].set(1.0 / pos_sigma**2)
    if rot is not None:
        upd["ws_rot"] = prob.ws_rot.at[slot].set(jnp.asarray(rot, dtype))
        upd["ws_rot_w"] = prob.ws_rot_w.at[slot].set(1.0 / rot_sigma**2)
    return dataclasses.replace(prob, **upd)


def optimizer_params_from_setting(setting: TrajOptimizerSetting) -> OptimizerParams:
    return OptimizerParams(
        method=setting.opt_type,
        max_iter=setting.max_iter,
        rel_thresh=setting.rel_thresh,
        iter_no_increase=setting.final_iter_no_increase,
        verbosity=setting.verbosity,
    )


def _retract_traj(space, traj: Trajectory, delta) -> Trajectory:
    """Apply tangent update delta (B, n, 2d) to a batched trajectory."""
    d = space.dim
    pose = jax.vmap(jax.vmap(space.retract))(traj.pose, delta[..., :d])
    vel = traj.vel + delta[..., d:]
    return Trajectory(pose, vel)


@lru_cache(maxsize=None)
def _vmapped_lin_err(problem_axes):
    """vmapped (linearize, error) over a batch, keyed by the axes pytree
    (hashable: every leaf is 0/None). Stable function objects enable the
    chunked-mode jit cache in solver.optimize."""
    lin = jax.vmap(traj_linearize, in_axes=(problem_axes, 0))
    err = jax.vmap(traj_error, in_axes=(problem_axes, 0))
    return lin, err


@lru_cache(maxsize=None)
def _vmapped_lin_flat(problem_axes):
    """Block-flattened vmapped linearize: H_diag (B, n, m*m), H_off
    (B, n-1, m*m). Merging the block dims makes the minor dim m*m instead
    of m, which a tiled device memory pads far less (the reason this
    layout was chosen on the previous accelerator); the solve re-splits
    them for free (solver/optimize.py lin_layout='flat')."""
    lin = jax.vmap(traj_linearize, in_axes=(problem_axes, 0))

    def lin_flat(data, traj):
        Hd, Ho, b, e = lin(data, traj)
        B, n, m = Hd.shape[0], Hd.shape[1], Hd.shape[-1]
        return (Hd.reshape(B, n, m * m), Ho.reshape(B, n - 1, m * m), b, e)

    return lin_flat


@lru_cache(maxsize=None)
def _retract_for(space):
    return partial(_retract_traj, space)


# host mirrors of problem leaves for the f64 rescue, keyed by device-array
# identity: the big shared leaves (e.g. a 108 MB SDF field) transfer to the
# host ONCE per problem object instead of once per solve call. Weakrefs
# keep dead entries collectable.
_RESCUE_HOST_CACHE: dict = {}
_RESCUE_HOST_MAX = 64


def _host_copy(leaf, cast_f64: bool):
    import weakref

    key = (id(leaf), cast_f64)
    hit = _RESCUE_HOST_CACHE.get(key)
    if hit is not None and hit[0]() is leaf:
        return hit[1]
    arr = np.array(jax.device_get(leaf))
    if cast_f64 and np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float64)
    try:
        ref = weakref.ref(leaf)
    except TypeError:
        return arr
    if len(_RESCUE_HOST_CACHE) >= _RESCUE_HOST_MAX:
        dead = [k for k, v in _RESCUE_HOST_CACHE.items() if v[0]() is None]
        for k in dead:
            del _RESCUE_HOST_CACHE[k]
        if len(_RESCUE_HOST_CACHE) >= _RESCUE_HOST_MAX:
            _RESCUE_HOST_CACHE.clear()
    _RESCUE_HOST_CACHE[key] = (ref, arr)
    return arr


def _rescue_gave_up_f64(problems: TrajProblem, problem_axes,
                        init_traj: Trajectory, params: OptimizerParams,
                        res: OptResult) -> OptResult:
    """Re-solve gave-up lanes in float64 on the host CPU backend.

    The reference runs GTSAM in double precision throughout
    (BatchTrajOptimizer.cpp:212-308 drives double-precision GTSAM); the
    batched path is float32, and on the hardest draws the LM lambda
    escalation hits the f32 rounding floor and gives up where the f64
    oracle converges (on the previous accelerator this was the entire
    Arm3Limits2D converged gap). This rescue gathers the gave_up lanes,
    casts their problems to f64, re-solves FROM THE INITIAL TRAJECTORY
    (matching the oracle's from-scratch semantics) on the CPU backend, and
    scatters trajectories/stats back in the original dtype. It runs on the
    host because it was written for a device without float64; the GPU
    computes in float64, and moving the rescue onto it is open work. It
    is opt-in (`rescue_f64`) and never a hidden fallback.

    The corner-packed SDF table (8x/4x the field, redundant with `data`)
    is NOT transferred: the rescue solves with packed=None (the lookups
    fall back to the per-corner path, fine at rescue lane counts). Shared
    leaves transfer once per problem object (_RESCUE_HOST_CACHE).

    Host-driven and eager by construction — plan_batch only invokes it
    outside jit. No-op when nothing gave up."""
    import dataclasses as _dc

    gave = np.array(jax.device_get(res.gave_up))
    idx = np.nonzero(gave)[0]
    if idx.size == 0:
        return res
    cpu = jax.devices("cpu")[0]

    # drop the packed table from the transfer (placeholder keeps the pytree
    # structure through tree_map; the axes copy marks it shared)
    sdf_dev = problems.sdf
    if getattr(sdf_dev, "packed", None) is not None:
        problems = _dc.replace(
            problems, sdf=sdf_dev._replace(packed=jnp.zeros((), jnp.float32)))
        problem_axes = _dc.replace(
            problem_axes, sdf=problem_axes.sdf._replace(packed=None))

    def take_cast(ax, leaf):
        if leaf is None:
            # absent optional subtree (e.g. SDF screen/coarse fields): the
            # axes tree flattens it to a None "leaf" under is_leaf — keep
            # it None so the rebuilt pytree has the same empty subtree
            return None
        if ax is None:
            return _host_copy(leaf, cast_f64=True)
        arr = _host_copy(leaf, cast_f64=False)
        arr = np.take(arr, idx, axis=ax)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float64)
        return arr

    probs_np = jax.tree_util.tree_map(
        take_cast, problem_axes, problems, is_leaf=lambda x: x is None)
    if getattr(probs_np.sdf, "packed", None) is not None:
        probs_np = _dc.replace(
            probs_np, sdf=probs_np.sdf._replace(packed=None))
    pose0 = _host_copy(init_traj.pose, cast_f64=False)[idx]
    vel0 = _host_copy(init_traj.vel, cast_f64=False)[idx]
    sub_params = _dc.replace(
        params, rescue_f64=False, loop="dynamic", compact=False,
        lin_layout="batch", ts_mesh=None, ts_parts=0)
    with jax.enable_x64(), jax.default_device(cpu):
        probs64 = jax.tree_util.tree_map(jnp.asarray, probs_np)
        init64 = Trajectory(jnp.asarray(pose0.astype(np.float64)),
                            jnp.asarray(vel0.astype(np.float64)))
        sub = jax.device_get(
            plan_batch(probs64, init64, sub_params, problem_axes))

    pose = np.array(jax.device_get(res.traj.pose))
    vel = np.array(jax.device_get(res.traj.vel))
    err = np.array(jax.device_get(res.error))
    iters = np.array(jax.device_get(res.iterations))
    conv = np.array(jax.device_get(res.converged))
    pose[idx] = np.asarray(sub.traj.pose).astype(pose.dtype)
    vel[idx] = np.asarray(sub.traj.vel).astype(vel.dtype)
    err[idx] = np.asarray(sub.error).astype(err.dtype)
    iters[idx] = iters[idx] + np.asarray(sub.iterations)
    conv[idx] = np.asarray(sub.converged)
    gave[idx] = np.asarray(sub.gave_up)
    return OptResult(
        Trajectory(jnp.asarray(pose), jnp.asarray(vel)),
        jnp.asarray(err), jnp.asarray(iters), jnp.asarray(conv),
        jnp.asarray(gave),
    )


def plan_batch(problems: TrajProblem, init_traj: Trajectory,
               params: OptimizerParams, problem_axes=None) -> OptResult:
    """Optimize a batch of problems. `problem_axes` is a vmap in_axes
    pytree over `problems` (0 = per-problem leaf, None = shared); defaults
    to all-shared-except-start/goal via rank inference against start_pose.
    Jit-friendly (falls back to a fully-traced static loop under jit); when
    called eagerly with params.loop == 'chunked' the solve runs as jitted
    chunks with host-side early exit.
    The heart of the framework."""
    space = problems.space
    if problem_axes is None:
        # default: batch exactly the leaves with a leading batch axis equal
        # to start_pose's batch size; detect by rank against a canonical
        # single problem obtained from slicing start_pose.
        raise ValueError(
            "plan_batch requires problem_axes; use infer_batch_axes or "
            "batch_traj_optimize"
        )

    lin, err = _vmapped_lin_err(problem_axes)
    if params.method in ("lm", "gaussnewton") and params.lin_layout == "batch":
        # block-flattened layout: avoids the ~9x padded traffic of
        # minor-dim-m H arrays in the optimizer loop
        import dataclasses as _dc

        lin = _vmapped_lin_flat(problem_axes)
        params = _dc.replace(params, lin_layout="flat")
    elif params.lin_layout == "flat":
        lin = _vmapped_lin_flat(problem_axes)
    retract = _retract_for(space)
    res = optimize_batch(
        lin, err, retract, init_traj, params,
        data=problems, data_axes=problem_axes,
    )
    if params.rescue_f64 and not isinstance(
            jax.tree_util.tree_leaves(init_traj)[0], jax.core.Tracer):
        res = _rescue_gave_up_f64(problems, problem_axes, init_traj,
                                  params, res)
    return res


def batch_traj_optimize(
    robot: RobotModel,
    sdf,
    start_pose,
    start_vel,
    end_pose,
    end_vel,
    setting: TrajOptimizerSetting,
    init_traj: Optional[Trajectory] = None,
    **problem_kwargs,
):
    """Single- or multi-problem planner entry point.

    If start/end carry a leading batch axis (ndim 2), the whole batch is
    planned jointly (robot and SDF shared/broadcast); otherwise a batch of
    1 is planned and unbatched results returned. Returns OptResult.

    Mirrors BatchTrajOptimize<...> (BatchTrajOptimizer-inl.h:19-84) +
    optimize() (BatchTrajOptimizer.cpp:212-308); init defaults to the
    straight-line initialization of TrajUtils.cpp:25-50.
    """
    start_pose = jnp.asarray(start_pose)
    start_vel = jnp.asarray(start_vel)
    end_pose = jnp.asarray(end_pose)
    end_vel = jnp.asarray(end_vel)
    batched = start_pose.ndim == 2
    space = robot.space
    params = optimizer_params_from_setting(setting)

    if not batched:
        start_pose, start_vel = start_pose[None], start_vel[None]
        end_pose, end_vel = end_pose[None], end_vel[None]
        if init_traj is not None:
            init_traj = Trajectory(init_traj.pose[None], init_traj.vel[None])

    probs = make_problem(
        robot, sdf, start_pose, start_vel, end_pose, end_vel, setting,
        **problem_kwargs,
    )
    template = make_problem(
        robot, probs.sdf, start_pose[0], start_vel[0], end_pose[0],
        end_vel[0], setting, **problem_kwargs,
    )
    axes = infer_batch_axes(probs, template)

    if init_traj is None:
        init_traj = jax.vmap(
            lambda sp, ep: init_traj_straight_line(
                space, sp, ep, setting.total_step, setting.total_time
            )
        )(probs.start_pose, probs.end_pose)

    res = plan_batch(probs, init_traj, params, axes)
    if batched:
        return res
    return OptResult(
        Trajectory(res.traj.pose[0], res.traj.vel[0]),
        res.error[0], res.iterations[0], res.converged[0], res.gave_up[0],
    )


def collision_cost_batch(problems: TrajProblem, traj: Trajectory,
                         problem_axes=None):
    """Batched CollisionCost metric (BatchTrajOptimizer-inl.h:87-100)."""
    if problem_axes is None:
        return jax.vmap(collision_cost)(problems, traj.pose)
    return jax.vmap(collision_cost, in_axes=(problem_axes, 0))(problems, traj.pose)
