"""Tests for the float64 give-up rescue (OptimizerParams.rescue_f64).

The reference runs GTSAM in double precision throughout; the f32 batched
path can give up (LM lambda blow-up) on draws the f64 oracle solves (on
the previous accelerator, the entire Arm3Limits2D converged gap).
plan_batch's rescue re-solves gave-up lanes
from the initial trajectory in f64 on the CPU backend and scatters the
results back. These tests exercise the machinery deterministically by
forcing gave_up lanes (CPU f32 happens to converge on the suite draws —
the real give-ups depend on the device's rounding)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.kinematics import PointRobotFK, make_robot_model
from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
from gpmp2_jax.planner.batch import (
    _rescue_gave_up_f64,
    infer_batch_axes,
    optimizer_params_from_setting,
    plan_batch,
)
from gpmp2_jax.planner.problem import Trajectory
from gpmp2_jax.planner.traj_utils import init_traj_straight_line
from gpmp2_jax.solver.optimize import OptResult


def _setup(B=8):
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    robot = make_robot_model(PointRobotFK(), [(0, 0.08, (0.0, 0.0, 0.0))])
    setting = TrajOptimizerSetting(
        dof=2, total_step=10, total_time=10.0, cost_sigma=0.1,
        obs_check_inter=5, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(2),
    )
    rng = np.random.default_rng(3)
    s = jnp.asarray(
        np.stack([rng.uniform(-0.9, -0.5, B), rng.uniform(-0.9, 0.0, B)],
                 -1), jnp.float32)
    g = jnp.asarray(
        np.stack([rng.uniform(1.4, 1.8, B), rng.uniform(1.2, 1.8, B)], -1),
        jnp.float32)
    zeros = jnp.zeros((B, 2), jnp.float32)
    probs = make_problem(robot, sdf, s, zeros, g, zeros, setting)
    template = make_problem(robot, sdf, s[0], zeros[0], g[0], zeros[0],
                            setting)
    axes = infer_batch_axes(probs, template)
    space = robot.space
    init = jax.vmap(
        lambda a, b: init_traj_straight_line(
            space, a, b, setting.total_step, setting.total_time)
    )(probs.start_pose, probs.end_pose)
    params = optimizer_params_from_setting(setting)
    return probs, axes, init, params


class TestRescueF64:
    def test_noop_when_nothing_gave_up(self):
        probs, axes, init, params = _setup()
        res = plan_batch(probs, init, params, axes)
        assert not bool(jnp.any(res.gave_up))
        res_r = plan_batch(
            probs, init, dataclasses.replace(params, rescue_f64=True), axes)
        np.testing.assert_array_equal(np.asarray(res.traj.pose),
                                      np.asarray(res_r.traj.pose))
        np.testing.assert_array_equal(np.asarray(res.error),
                                      np.asarray(res_r.error))

    def test_forced_gave_up_lanes_recover(self):
        probs, axes, init, params = _setup()
        res = plan_batch(probs, init, params, axes)
        B = int(res.error.shape[0])
        bad = np.zeros(B, bool)
        bad[[1, 4, 6]] = True
        # corrupt the bad lanes' results and flag them gave_up
        pose = np.asarray(res.traj.pose).copy()
        vel = np.asarray(res.traj.vel).copy()
        pose[bad] = 1e3
        vel[bad] = -1e3
        err = np.asarray(res.error).copy()
        err[bad] = np.inf
        forced = OptResult(
            Trajectory(jnp.asarray(pose), jnp.asarray(vel)),
            jnp.asarray(err), res.iterations,
            jnp.asarray(np.asarray(res.converged) & ~bad),
            jnp.asarray(bad),
        )
        rescued = _rescue_gave_up_f64(probs, axes, init, params, forced)
        conv = np.asarray(rescued.converged)
        gave = np.asarray(rescued.gave_up)
        assert conv[bad].all()
        assert not gave[bad].any()
        # rescued lanes land on the plain solve's optimum (f64 vs f32
        # solves of a well-conditioned problem agree to fp32 tolerance)
        np.testing.assert_allclose(
            np.asarray(rescued.error)[bad], np.asarray(res.error)[bad],
            rtol=1e-3)
        np.testing.assert_allclose(
            np.asarray(rescued.traj.pose)[bad],
            np.asarray(res.traj.pose)[bad], atol=1e-2)
        # untouched lanes are bit-identical
        good = ~bad
        np.testing.assert_array_equal(
            np.asarray(rescued.traj.pose)[good],
            np.asarray(res.traj.pose)[good])
        np.testing.assert_array_equal(np.asarray(rescued.error)[good],
                                      np.asarray(res.error)[good])

    def test_forced_rescue_3d_sdf(self):
        """3D SignedDistanceField problems carry MORE absent optional
        fields (None subtrees) than planar ones; the rescue's axes
        flattening must pass them through untouched (r5 regression: the
        WAM suite config crashed with a dtype-object error here)."""
        from gpmp2_jax.obstacle.sdf import SignedDistanceField
        from gpmp2_jax.robots import generate_arm

        arm = generate_arm("SimpleTwoLinksArm")
        n = 16
        cell = 2.0 / (n - 1)
        xs = -1.0 + cell * np.arange(n)
        Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
        dist = np.sqrt(X**2 + Y**2 + (Z - 0.4) ** 2) - 0.25
        sdf = SignedDistanceField(
            origin=jnp.asarray([-1.0, -1.0, -1.0], jnp.float32),
            cell_size=jnp.asarray(cell, jnp.float32),
            data=jnp.asarray(dist, jnp.float32))
        setting = TrajOptimizerSetting(
            dof=2, total_step=6, total_time=3.0, cost_sigma=0.1,
            obs_check_inter=3, opt_type="lm", max_iter=50, rel_thresh=1e-2,
            Qc=np.eye(2))
        B = 4
        rng = np.random.default_rng(1)
        s = jnp.asarray(0.1 * rng.normal(size=(B, 2)), jnp.float32)
        g = jnp.asarray(np.array([1.2, -0.5]) + 0.1 * rng.normal(size=(B, 2)),
                        jnp.float32)
        zeros = jnp.zeros((B, 2), jnp.float32)
        probs = make_problem(arm, sdf, s, zeros, g, zeros, setting)
        template = make_problem(arm, sdf, s[0], zeros[0], g[0], zeros[0],
                                setting)
        axes = infer_batch_axes(probs, template)
        space = arm.space
        init = jax.vmap(
            lambda a, b: init_traj_straight_line(space, a, b, 6, 3.0)
        )(probs.start_pose, probs.end_pose)
        params = optimizer_params_from_setting(setting)
        res = plan_batch(probs, init, params, axes)
        bad = np.zeros(B, bool)
        bad[1] = True
        forced = OptResult(
            res.traj, res.error, res.iterations,
            jnp.asarray(np.asarray(res.converged) & ~bad), jnp.asarray(bad))
        rescued = _rescue_gave_up_f64(probs, axes, init, params, forced)
        assert bool(np.asarray(rescued.converged)[1])
        assert not bool(np.asarray(rescued.gave_up)[1])

    def test_forced_rescue_per_problem_worlds(self):
        """Per-problem SDF worlds (the MultiWorld suite config): the
        packed table is a PER-LANE leaf (axis 0), replaced by a scalar
        placeholder for the transfer and recomputed as packed=None — the
        taken per-lane `data` must drive the rescue correctly."""
        from gpmp2_jax.obstacle.sdf import PlanarSDF

        n = 32
        ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
        X, Y = np.meshgrid(ys, ys)
        B = 6
        rng = np.random.default_rng(2)
        cys = rng.uniform(-0.3, 0.3, B)
        data = np.stack([np.sqrt(X**2 + (Y - c) ** 2) - 0.3 for c in cys])
        sdf = PlanarSDF(origin=jnp.asarray([-1.5, -1.5], jnp.float32),
                        cell_size=jnp.asarray(3.0 / (n - 1), jnp.float32),
                        data=jnp.asarray(data, jnp.float32))
        sdf_single = PlanarSDF(sdf.origin, sdf.cell_size, sdf.data[0])
        robot = make_robot_model(PointRobotFK(),
                                 [(0, 0.05, (0.0, 0.0, 0.0))])
        setting = TrajOptimizerSetting(
            dof=2, total_step=8, total_time=4.0, cost_sigma=0.1,
            obs_check_inter=3, opt_type="lm", max_iter=50, rel_thresh=1e-2,
            Qc=np.eye(2))
        s = jnp.asarray(
            np.stack([np.full(B, -0.9), rng.uniform(-0.3, 0.3, B)], -1),
            jnp.float32)
        g = jnp.asarray(
            np.stack([np.full(B, 0.9), rng.uniform(-0.3, 0.3, B)], -1),
            jnp.float32)
        zeros = jnp.zeros((B, 2), jnp.float32)
        probs = make_problem(robot, sdf, s, zeros, g, zeros, setting,
                             sdf_pack=True)
        template = make_problem(robot, sdf_single, s[0], zeros[0], g[0],
                                zeros[0], setting, sdf_pack=True)
        axes = infer_batch_axes(probs, template)
        assert probs.sdf.packed is not None
        assert axes.sdf.packed == 0  # per-lane packed leaf
        space = robot.space
        init = jax.vmap(
            lambda a, b: init_traj_straight_line(space, a, b, 8, 4.0)
        )(probs.start_pose, probs.end_pose)
        params = optimizer_params_from_setting(setting)
        res = plan_batch(probs, init, params, axes)
        bad = np.zeros(B, bool)
        bad[[0, 3]] = True
        forced = OptResult(
            res.traj, res.error, res.iterations,
            jnp.asarray(np.asarray(res.converged) & ~bad), jnp.asarray(bad))
        rescued = _rescue_gave_up_f64(probs, axes, init, params, forced)
        assert np.asarray(rescued.converged)[bad].all()
        assert not np.asarray(rescued.gave_up)[bad].any()
        np.testing.assert_allclose(
            np.asarray(rescued.error)[bad], np.asarray(res.error)[bad],
            rtol=1e-3)

    def test_host_copy_caches_per_object(self, monkeypatch):
        """Shared problem leaves (e.g. a 108 MB SDF field) must transfer to
        the host once per object, not once per rescue call."""
        from gpmp2_jax.planner import batch as batch_mod

        batch_mod._RESCUE_HOST_CACHE.clear()
        calls = {"n": 0}
        orig = jax.device_get

        def counting(x):
            calls["n"] += 1
            return orig(x)

        monkeypatch.setattr(jax, "device_get", counting)
        leaf = jnp.arange(12.0)
        a1 = batch_mod._host_copy(leaf, cast_f64=True)
        a2 = batch_mod._host_copy(leaf, cast_f64=True)
        assert calls["n"] == 1
        assert a1 is a2 and a1.dtype == np.float64
        # a DIFFERENT object (even equal-valued) transfers again
        batch_mod._host_copy(jnp.arange(12.0), cast_f64=True)
        assert calls["n"] == 2
        batch_mod._RESCUE_HOST_CACHE.clear()

    def test_rescue_output_dtype_matches(self):
        probs, axes, init, params = _setup()
        res = plan_batch(probs, init, params, axes)
        B = int(res.error.shape[0])
        bad = np.zeros(B, bool)
        bad[0] = True
        forced = OptResult(
            res.traj, res.error, res.iterations,
            jnp.asarray(np.asarray(res.converged) & ~bad),
            jnp.asarray(bad),
        )
        rescued = _rescue_gave_up_f64(probs, axes, init, params, forced)
        assert rescued.traj.pose.dtype == res.traj.pose.dtype
        assert rescued.error.dtype == res.error.dtype
        assert rescued.iterations.dtype == res.iterations.dtype
