"""Incremental trajectory replanning (iSAM2-equivalent API).

Port of /root/reference/gpmp2/planner/ISAM2TrajOptimizer.{h,-inl.h}.
The reference wraps gtsam::ISAM2 (Bayes-tree incremental smoothing with
GN-style relinearization, params 1e-3/1, -inl.h:18-22). Bayes-tree surgery
has no XLA analog, so the batched equivalent is a *warm-started
masked re-solve*: the jitted program shape is static, factor add/remove is
weight masking (the `extra_*` prior slots and separate goal weights of
TrajProblem), and each `update()` re-optimizes from the current estimate —
which the block-tridiagonal solver makes cheap. Parity target is the batch
re-solve (the reference's own tests only smoke-test the iSAM2 path,
SURVEY.md section 4).

API mirror (ISAM2TrajOptimizer.h:98-133):
  init_factor_graph / init_values / update / change_goal_config_and_vel /
  remove_goal_config_and_vel / fix_config_and_vel / add_pose_estimate /
  add_state_estimate / values.

The reference's 5 per-robot typedefs collapse into this one class.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..kinematics.robot import RobotModel
from ..solver.optimize import OptimizerParams
from .batch import make_problem, plan_batch
from .problem import Trajectory, TrajProblem
from .settings import TrajOptimizerSetting

__all__ = ["ISAM2TrajOptimizer", "ISAM2BatchSessions"]


class ISAM2TrajOptimizer:
    """Stateful single-session incremental replanner.

    For fleets of replanning sessions, hold a batch of TrajProblems and
    vmap the same machinery; this class keeps the reference's one-session
    API shape.
    """

    def __init__(self, robot: RobotModel, sdf, setting: TrajOptimizerSetting,
                 max_fixed: Optional[int] = None):
        self._robot = robot
        self._sdf = sdf
        self._setting = setting
        # one slot per support state is enough for fixConfigAndVel sweeps +
        # a few measurement estimates
        self._K = max_fixed if max_fixed is not None else 2 * (setting.total_step + 1)
        self._slot = 0
        self._prob: Optional[TrajProblem] = None
        self._traj: Optional[Trajectory] = None
        # The reference's ISAM2 is GN-flavored (ISAM2TrajOptimizer-inl.h:18-22)
        # but each update() here is a warm-started re-solve with the
        # setting's optimizer: damped steps (LM default) navigate the hinge
        # kinks that stall plain GN, and warm starts make updates cheap.
        # warm_iter: small per-update iteration budget — warm starts from
        # the previous estimate converge in 1-3 accepted steps, so the
        # chunked loop's host early-exit makes updates far cheaper than a
        # cold solve at the full setting.max_iter.
        self._params = OptimizerParams(
            method=setting.opt_type,
            max_iter=setting.max_iter,
            rel_thresh=setting.rel_thresh,
            iter_no_increase=True,
            loop="chunked",
            chunk_size=4,
            reject_budget=4,
        )

    # ---- graph construction (initFactorGraph, -inl.h:27-88) -------------

    def init_factor_graph(self, start_pose, start_vel, goal_pose, goal_vel):
        self._prob = make_problem(
            self._robot, self._sdf, start_pose, start_vel, goal_pose,
            goal_vel, self._setting, num_extra=self._K,
        )
        self._slot = 0

    def init_values(self, traj: Trajectory):
        """Seed with (e.g.) a batch-optimization result (initValues)."""
        self._traj = traj

    # ---- incremental ops -------------------------------------------------

    def update(self):
        """Re-solve warm-started from the current estimate
        (ISAM2TrajOptimizer-inl.h:102-115). Routes through plan_batch so
        the jitted chunks are cached MODULE-WIDE (keyed by the axes pytree
        + stable function identities) — new session objects reuse the
        compiled program instead of re-jitting."""
        assert self._prob is not None and self._traj is not None
        probs = jax.tree_util.tree_map(lambda x: x[None], self._prob)
        axes = jax.tree_util.tree_map(lambda x: 0, probs)
        traj = Trajectory(self._traj.pose[None], self._traj.vel[None])
        res = plan_batch(probs, traj, self._params, axes)
        self._traj = Trajectory(res.traj.pose[0], res.traj.vel[0])
        self._err = res.error[0]

    def change_goal_config_and_vel(self, goal_pose, goal_vel):
        """Swap the goal priors (-inl.h:121-140: remove cached goal factor,
        add new one — here: overwrite mean, restore weights)."""
        d = self._robot.space.dim
        dtype = self._prob.end_pose.dtype
        w_pose = jnp.full((d,), 1.0 / self._setting.conf_prior_sigma**2, dtype)
        w_vel = jnp.full((d,), 1.0 / self._setting.vel_prior_sigma**2, dtype)
        self._prob = dataclasses.replace(
            self._prob,
            end_pose=jnp.asarray(goal_pose, dtype),
            end_vel=jnp.asarray(goal_vel, dtype),
            goal_pose_w=w_pose,
            goal_vel_w=w_vel,
        )

    def remove_goal_config_and_vel(self):
        """Drop the goal priors entirely (-inl.h:146-156) — weight masking."""
        self._prob = dataclasses.replace(
            self._prob,
            goal_pose_w=jnp.zeros_like(self._prob.goal_pose_w),
            goal_vel_w=jnp.zeros_like(self._prob.goal_vel_w),
        )

    def fix_config_and_vel(self, state_idx: int, pose, vel):
        """Pin an executed state with strong priors (-inl.h:162-169)."""
        d = self._robot.space.dim
        w = 1.0 / self._setting.conf_prior_sigma**2
        wv = 1.0 / self._setting.vel_prior_sigma**2
        self._add_slot(state_idx, pose, vel,
                       np.full(d, w), np.full(d, wv))

    def add_pose_estimate(self, state_idx: int, pose, pose_cov):
        """Measured pose with covariance (-inl.h:174-183). pose_cov:
        scalar, diag vector, or full matrix (diagonal used)."""
        d = self._robot.space.dim
        w = self._cov_to_prec(pose_cov, d)
        self._add_slot(state_idx, pose, np.zeros(d), w, np.zeros(d))

    def add_state_estimate(self, state_idx: int, pose, pose_cov, vel, vel_cov):
        """Measured full state with covariances (-inl.h:186-195)."""
        d = self._robot.space.dim
        self._add_slot(
            state_idx, pose, vel,
            self._cov_to_prec(pose_cov, d), self._cov_to_prec(vel_cov, d),
        )

    # ---- results ---------------------------------------------------------

    def values(self) -> Trajectory:
        """Current optimized trajectory (calculateEstimate equivalent)."""
        return self._traj

    @property
    def error(self):
        return getattr(self, "_err", None)

    # ---- internals -------------------------------------------------------

    @staticmethod
    def _cov_to_prec(cov, d):
        cov = np.asarray(cov, dtype=np.float64)
        if cov.ndim >= 2:
            cov = np.diagonal(cov)
        if not np.all(cov > 0.0):
            # a zero/negative variance would silently become an inf/NaN
            # precision and poison the whole solve; GTSAM's Gaussian noise
            # models reject it too (constrained models are a separate type)
            raise ValueError(
                "pose/vel covariance diagonals must be strictly positive; "
                f"got min {cov.min()!r}"
            )
        return np.broadcast_to(1.0 / cov, (d,))

    def _add_slot(self, state_idx, pose, vel, pose_w, vel_w):
        assert self._prob is not None, "call init_factor_graph first"
        k = self._slot
        assert k < self._K, "out of replanning prior slots"
        self._slot += 1
        dtype = self._prob.extra_pose.dtype
        self._prob = dataclasses.replace(
            self._prob,
            extra_idx=self._prob.extra_idx.at[k].set(state_idx),
            extra_pose=self._prob.extra_pose.at[k].set(
                jnp.asarray(pose, dtype)
            ),
            extra_vel=self._prob.extra_vel.at[k].set(jnp.asarray(vel, dtype)),
            extra_pose_w=self._prob.extra_pose_w.at[k].set(
                jnp.asarray(pose_w, dtype)
            ),
            extra_vel_w=self._prob.extra_vel_w.at[k].set(
                jnp.asarray(vel_w, dtype)
            ),
        )


class ISAM2BatchSessions:
    """A fleet of independent replanning sessions optimized as ONE jitted
    batched program — the serving-side shape of incremental replanning
    (BASELINE config 5). Each lane is a session: its own start/goal, its
    own executed-state pins, all sharing robot + SDF.

    The reference runs one gtsam::ISAM2 per session on one core; here the
    whole fleet's warm-started masked re-solve is a single vmapped
    chunk-jitted solve with host early exit, so an update() costs roughly
    one batched linearize+solve per accepted step — thousands of session
    updates per second on one chip (bench_replan.py).

    Ops mirror ISAM2TrajOptimizer lane-wise; per-lane arguments carry a
    leading batch axis.
    """

    def __init__(self, robot: RobotModel, sdf, setting: TrajOptimizerSetting,
                 batch: int, max_fixed: Optional[int] = None,
                 warm_iter: int = 4, loop: str = "static"):
        self._robot = robot
        self._sdf = sdf
        self._setting = setting
        self._B = batch
        self._K = max_fixed if max_fixed is not None else 2 * (setting.total_step + 1)
        self._slot = np.zeros(batch, np.int32)
        self._probs: Optional[TrajProblem] = None
        self._axes = None
        self._traj: Optional[Trajectory] = None
        # warm_iter: small per-update iteration budget. Warm-started
        # updates accept 1-2 steps; a straggler lane simply improves
        # further on the NEXT update instead of holding the whole fleet on
        # the full setting.max_iter schedule. loop='static' runs the
        # budget as ONE fixed-trip jitted dispatch — no per-chunk host
        # round-trips ('chunked' remains available).
        self._params = OptimizerParams(
            method=setting.opt_type,
            max_iter=warm_iter,
            rel_thresh=setting.rel_thresh,
            iter_no_increase=True,
            loop=loop,
            chunk_size=2,
            reject_budget=4,
        )
        # cold-start budget (first update from a fresh init): the full
        # setting schedule, chunked with early exit. Compaction off: each
        # compacted batch size is a separate XLA compile, which costs more
        # than the straggler FLOPs a one-off cold solve would save.
        self._cold_params = dataclasses.replace(
            self._params, max_iter=setting.max_iter, loop="chunked",
            chunk_size=8, reject_budget=8, compact=False,
        )
        self._first_update = True

    def init_factor_graph(self, start_pose, start_vel, goal_pose, goal_vel):
        """start/goal arrays carry the (B, ...) session axis."""
        from .batch import infer_batch_axes

        self._probs = make_problem(
            self._robot, self._sdf, jnp.asarray(start_pose),
            jnp.asarray(start_vel), jnp.asarray(goal_pose),
            jnp.asarray(goal_vel), self._setting, num_extra=self._K,
        )
        # per-SESSION pin slots: make_problem leaves the extra_* slots
        # unbatched (shared); each lane needs its own
        B = self._B
        self._probs = dataclasses.replace(
            self._probs,
            **{f: jnp.tile(getattr(self._probs, f)[None],
                           (B,) + (1,) * getattr(self._probs, f).ndim)
               for f in ("extra_idx", "extra_pose", "extra_vel",
                          "extra_pose_w", "extra_vel_w")},
        )
        # axes: batch exactly the per-session leaves (start/goal/extra
        # slots); robot/SDF stay shared
        tmpl = make_problem(
            self._robot, self._sdf, jnp.asarray(start_pose)[0],
            jnp.asarray(start_vel)[0], jnp.asarray(goal_pose)[0],
            jnp.asarray(goal_vel)[0], self._setting, num_extra=self._K,
        )
        self._axes = infer_batch_axes(self._probs, tmpl)
        self._slot[:] = 0
        self._first_update = True

    def init_values(self, traj: Trajectory):
        """Seed all lanes, e.g. with a batch plan result ((B, n, ...))."""
        self._traj = traj

    def update(self):
        """One fleet re-solve: the FIRST update runs the full cold
        schedule (chunked, host early exit); later updates run the small
        warm static budget in a single dispatch."""
        assert self._probs is not None and self._traj is not None
        params = self._cold_params if self._first_update else self._params
        self._first_update = False
        res = plan_batch(self._probs, self._traj, params, self._axes)
        self._traj = res.traj
        self._res = res
        return res

    def change_goal_config_and_vel(self, goal_pose, goal_vel, lanes=None):
        """Swap goal priors for `lanes` (default: all) — (B, d) inputs."""
        d = self._robot.space.dim
        dtype = self._probs.end_pose.dtype
        goal_pose = jnp.asarray(goal_pose, dtype)
        goal_vel = jnp.asarray(goal_vel, dtype)
        if lanes is None:
            new_pose, new_vel = goal_pose, goal_vel
        else:
            mask = (jnp.zeros((self._B, 1), bool)
                    .at[self._lane_indices(lanes)].set(True))
            new_pose = jnp.where(mask, goal_pose, self._probs.end_pose)
            new_vel = jnp.where(mask, goal_vel, self._probs.end_vel)
        # keep the weight leaves in their existing (shared or batched)
        # shape — the axes pytree was inferred at init and must stay valid
        w_pose = jnp.full_like(self._probs.goal_pose_w,
                               1.0 / self._setting.conf_prior_sigma**2)
        w_vel = jnp.full_like(self._probs.goal_vel_w,
                              1.0 / self._setting.vel_prior_sigma**2)
        self._probs = dataclasses.replace(
            self._probs, end_pose=new_pose, end_vel=new_vel,
            goal_pose_w=w_pose, goal_vel_w=w_vel,
        )

    def remove_goal_config_and_vel(self, lanes=None):
        """Drop the goal priors for `lanes` (default: all) — weight
        masking, lane-wise mirror of ISAM2TrajOptimizer
        (ISAM2TrajOptimizer-inl.h:146-156)."""
        if lanes is None:
            w_pose = jnp.zeros_like(self._probs.goal_pose_w)
            w_vel = jnp.zeros_like(self._probs.goal_vel_w)
        else:
            # weight leaves may be shared (unbatched) — lane-selective
            # removal needs them batched; broadcast EACH leaf independently
            # (they are usually in lockstep, but nothing guarantees it)
            w_pose, w_vel = self._probs.goal_pose_w, self._probs.goal_vel_w
            if w_pose.ndim == 1:
                w_pose = jnp.tile(w_pose[None], (self._B, 1))
                self._axes = dataclasses.replace(self._axes, goal_pose_w=0)
            if w_vel.ndim == 1:
                w_vel = jnp.tile(w_vel[None], (self._B, 1))
                self._axes = dataclasses.replace(self._axes, goal_vel_w=0)
            mask = (jnp.zeros((self._B, 1), bool)
                    .at[self._lane_indices(lanes)].set(True))
            w_pose = jnp.where(mask, 0.0, w_pose)
            w_vel = jnp.where(mask, 0.0, w_vel)
        self._probs = dataclasses.replace(
            self._probs, goal_pose_w=w_pose, goal_vel_w=w_vel
        )

    def fix_config_and_vel(self, state_idx, pose, vel):
        """Pin each lane's executed state: state_idx (B,), pose/vel (B, d)
        (the per-lane fixConfigAndVel sweep of a receding-horizon fleet).
        All five slot scatters fuse into ONE jitted dispatch instead of
        five eager device calls."""
        d = self._robot.space.dim
        self._write_slots(
            state_idx, pose, vel,
            np.full((self._B, d), 1.0 / self._setting.conf_prior_sigma**2),
            np.full((self._B, d), 1.0 / self._setting.vel_prior_sigma**2),
        )

    def add_pose_estimate(self, state_idx, pose, pose_cov):
        """Fuse measured poses lane-wise: state_idx (B,), pose (B, d),
        pose_cov scalar / (d,) / (B, d) / (B, d, d) (diagonal used) —
        fleet mirror of ISAM2TrajOptimizer-inl.h:174-183. Velocity weight
        zero: the slot constrains pose only."""
        d = self._robot.space.dim
        B = self._B
        self._write_slots(
            state_idx, pose, np.zeros((B, d)),
            self._cov_to_prec_batch(pose_cov, d),
            np.zeros((B, d)),
        )

    def add_state_estimate(self, state_idx, pose, pose_cov, vel, vel_cov):
        """Fuse measured full states lane-wise (-inl.h:186-195)."""
        d = self._robot.space.dim
        self._write_slots(
            state_idx, pose, vel,
            self._cov_to_prec_batch(pose_cov, d),
            self._cov_to_prec_batch(vel_cov, d),
        )

    def _cov_to_prec_batch(self, cov, d):
        """Covariance in any broadcastable form -> (B, d) precision diag."""
        cov = np.asarray(cov, np.float64)
        if cov.ndim == 3:  # (B, d, d) full matrices
            cov = np.diagonal(cov, axis1=-2, axis2=-1)
        if not np.all(cov > 0.0):
            raise ValueError(
                "pose/vel covariance diagonals must be strictly positive; "
                f"got min {cov.min()!r}"
            )
        return np.broadcast_to(1.0 / cov, (self._B, d))

    @staticmethod
    def _lane_indices(lanes):
        """Coerce a `lanes` argument to integer indices. Boolean masks (a
        natural way to say 'these lanes') would otherwise be silently
        reinterpreted as indices 0/1 by `.at[lanes]`."""
        lanes = np.asarray(lanes)
        if lanes.dtype == bool:
            lanes = np.nonzero(lanes)[0]
        return jnp.asarray(lanes, jnp.int32)

    def _write_slots(self, state_idx, pose, vel, pose_w, vel_w):
        assert (self._slot < self._K).all(), "out of replanning prior slots"
        dtype = self._probs.extra_pose.dtype
        upd = _pin_slots_jit(
            self._probs.extra_idx, self._probs.extra_pose,
            self._probs.extra_vel, self._probs.extra_pose_w,
            self._probs.extra_vel_w,
            jnp.asarray(self._slot), jnp.asarray(state_idx, jnp.int32),
            jnp.asarray(pose, dtype), jnp.asarray(vel, dtype),
            jnp.asarray(pose_w, dtype), jnp.asarray(vel_w, dtype),
        )
        self._probs = dataclasses.replace(
            self._probs,
            **dict(zip(("extra_idx", "extra_pose", "extra_vel",
                        "extra_pose_w", "extra_vel_w"), upd)),
        )
        self._slot += 1

    def values(self) -> Trajectory:
        return self._traj

    @property
    def result(self):
        return getattr(self, "_res", None)


@jax.jit
def _pin_slots_jit(extra_idx, extra_pose, extra_vel, extra_pose_w,
                   extra_vel_w, slot, state_idx, pose, vel, w, wv):
    """Write one pin-slot per lane (lane b's slot[b]) in a single fused
    program (ISAM2BatchSessions fix/add ops). w, wv: (B, d) precision
    diagonals."""
    B = pose.shape[0]
    lanes = jnp.arange(B)
    return (
        extra_idx.at[lanes, slot].set(state_idx),
        extra_pose.at[lanes, slot].set(pose),
        extra_vel.at[lanes, slot].set(vel),
        extra_pose_w.at[lanes, slot].set(w),
        extra_vel_w.at[lanes, slot].set(wv),
    )
