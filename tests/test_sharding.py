"""Mesh scale-out tests on the 8-device virtual CPU mesh: sharded batched
planning matches the single-device result."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.kinematics.fk import PointRobotFK
from gpmp2_jax.kinematics.robot import make_robot_model
from gpmp2_jax.obstacle.sdf import PlanarSDF
from gpmp2_jax.parallel import make_mesh, shard_problems
from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
from gpmp2_jax.planner.batch import (
    infer_batch_axes,
    optimizer_params_from_setting,
    plan_batch,
)
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def _setup(B=16):
    ys = -1.5 + 3.0 / 95 * np.arange(96)
    X, Y = np.meshgrid(ys, ys)
    dist = np.sqrt((X - 0.0) ** 2 + (Y - 0.12) ** 2) - 0.3
    sdf = PlanarSDF(
        origin=jnp.asarray([-1.5, -1.5]), cell_size=jnp.asarray(3.0 / 95),
        data=jnp.asarray(dist),
    )
    robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))],
                             dtype=jnp.float64)
    setting = TrajOptimizerSetting(
        dof=2, total_step=8, total_time=5.0, obs_check_inter=2,
        opt_type="lm", max_iter=50, rel_thresh=1e-4, Qc=np.eye(2),
    )
    rng = np.random.default_rng(0)
    starts = jnp.asarray(np.stack([np.full(B, -0.8), rng.uniform(-0.5, 0.5, B)], -1))
    goals = jnp.asarray(np.stack([np.full(B, 0.8), rng.uniform(-0.5, 0.5, B)], -1))
    zeros = jnp.zeros((B, 2))
    probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
    template = make_problem(robot, sdf, starts[0], zeros[0], goals[0], zeros[0], setting)
    axes = infer_batch_axes(probs, template)
    init = jax.vmap(
        lambda s, g: init_traj_straight_line(robot.space, s, g, 8, 5.0)
    )(starts, goals)
    return probs, axes, init, optimizer_params_from_setting(setting)


class TestSharding:
    def test_eight_devices_available(self):
        assert len(jax.devices()) == 8

    def test_sharded_solve_matches_unsharded(self):
        probs, axes, init, params = _setup(B=16)
        res_plain = plan_batch(probs, init, params, axes)

        mesh = make_mesh(axis_names=("dp",))
        probs_s, init_s = shard_problems(mesh, probs, init, axes)
        solve = jax.jit(lambda p, t: plan_batch(p, t, params, axes))
        res_shard = solve(probs_s, init_s)

        np.testing.assert_allclose(
            np.asarray(res_shard.error), np.asarray(res_plain.error), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(res_shard.traj.pose), np.asarray(res_plain.traj.pose),
            atol=1e-7,
        )
        # the result actually lives sharded across devices
        assert len(res_shard.traj.pose.sharding.device_set) == 8

    def test_mesh_shapes(self):
        mesh = make_mesh(shape=(4, 2), axis_names=("dp", "ts"))
        assert mesh.devices.shape == (4, 2)

    def test_fleet_stats_psum(self):
        """On-device psum'd fleet statistics match host-side reductions,
        and work both with a packed and an UNPACKED shared SDF (the
        `packed=None` leaf regression in shard_problems axes flattening)."""
        from gpmp2_jax.parallel import fleet_stats

        probs, axes, init, params = _setup(B=16)
        mesh = make_mesh(axis_names=("dp",))
        probs_s, init_s = shard_problems(mesh, probs, init, axes)

        @jax.jit
        def solve(p, t):
            res = plan_batch(p, t, params, axes)
            return res, fleet_stats(mesh, res)

        res, stats = solve(probs_s, init_s)
        assert float(stats["n"]) == 16
        assert float(stats["converged"]) == float(
            np.asarray(res.converged).sum())
        assert float(stats["gave_up"]) == float(np.asarray(res.gave_up).sum())
        np.testing.assert_allclose(
            float(stats["mean_error"]), float(np.asarray(res.error).mean()),
            rtol=1e-6)

    def test_ts_sharded_planner_long_horizon(self):
        """End-to-end long-horizon (n=257 states) planner solve through the
        trajectory-axis-sharded damped solve on a 2-axis (dp=4, ts=2) mesh
        matches the single-device solve (SURVEY 2.11 sequence-parallel row
        wired into optimize_batch via OptimizerParams.ts_mesh/ts_parts)."""
        import dataclasses as dc

        ys = -1.5 + 3.0 / 95 * np.arange(96)
        X, Y = np.meshgrid(ys, ys)
        dist = np.sqrt(X**2 + (Y - 0.12) ** 2) - 0.3
        sdf = PlanarSDF(
            origin=jnp.asarray([-1.5, -1.5]), cell_size=jnp.asarray(3.0 / 95),
            data=jnp.asarray(dist),
        )
        robot = make_robot_model(
            PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))], dtype=jnp.float64
        )
        setting = TrajOptimizerSetting(
            dof=2, total_step=256, total_time=5.0, obs_check_inter=0,
            opt_type="lm", max_iter=30, rel_thresh=1e-4, Qc=np.eye(2),
        )
        B = 8
        rng = np.random.default_rng(3)
        starts = jnp.asarray(
            np.stack([np.full(B, -0.8), rng.uniform(-0.5, 0.5, B)], -1))
        goals = jnp.asarray(
            np.stack([np.full(B, 0.8), rng.uniform(-0.5, 0.5, B)], -1))
        zeros = jnp.zeros((B, 2))
        probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
        tmpl = make_problem(robot, sdf, starts[0], zeros[0], goals[0],
                            zeros[0], setting)
        axes = infer_batch_axes(probs, tmpl)
        init = jax.vmap(
            lambda s, g: init_traj_straight_line(robot.space, s, g, 256, 5.0)
        )(starts, goals)
        params = optimizer_params_from_setting(setting)

        res_plain = plan_batch(probs, init, params, axes)

        mesh = make_mesh(shape=(4, 2), axis_names=("dp", "ts"))
        probs_s, init_s = shard_problems(mesh, probs, init, axes)
        params_ts = dc.replace(params, ts_mesh=mesh, ts_parts=8)
        res_ts = jax.jit(
            lambda p, t: plan_batch(p, t, params_ts, axes)
        )(probs_s, init_s)

        assert bool(np.asarray(res_ts.converged).all())
        np.testing.assert_allclose(
            np.asarray(res_ts.error), np.asarray(res_plain.error), rtol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(res_ts.traj.pose), np.asarray(res_plain.traj.pose),
            atol=1e-6,
        )

    def test_shard_problems_with_unpacked_sdf(self):
        """packed=None shared world: axes flattening must not drift
        (jax flatten_axes semantics, not naive None-is-leaf counting)."""
        import dataclasses as dc
        probs, axes, init, params = _setup(B=16)
        probs_u = dc.replace(probs, sdf=probs.sdf._replace(packed=None))
        mesh = make_mesh(axis_names=("dp",))
        probs_s, init_s = shard_problems(mesh, probs_u, init, axes)
        res = jax.jit(lambda p, t: plan_batch(p, t, params, axes))(
            probs_s, init_s)
        assert bool(np.isfinite(np.asarray(res.error)).all())
