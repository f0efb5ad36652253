"""Incremental replanner tests, mirroring the reference's replanning flow
(WAMReplannerExample / doc/ExampleReplanning.md: batch solve -> iSAM2 init
-> fix executed state -> change goal -> update) with parity checked against
a fresh batch re-solve (SURVEY.md hard part 4)."""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.kinematics.fk import PointRobotFK
from gpmp2_jax.kinematics.robot import make_robot_model
from gpmp2_jax.obstacle.sdf import PlanarSDF
from gpmp2_jax.planner import TrajOptimizerSetting, batch_traj_optimize
from gpmp2_jax.planner.isam2 import ISAM2BatchSessions, ISAM2TrajOptimizer


def _world():
    ys = -1.5 + 3.0 / 95 * np.arange(96)
    X, Y = np.meshgrid(ys, ys)
    dist = np.sqrt(X**2 + (Y - 0.12) ** 2) - 0.3
    sdf = PlanarSDF(
        origin=jnp.asarray([-1.5, -1.5]), cell_size=jnp.asarray(3.0 / 95),
        data=jnp.asarray(dist),
    )
    robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))],
                             dtype=jnp.float64)
    setting = TrajOptimizerSetting(
        dof=2, total_step=10, total_time=5.0, obs_check_inter=3,
        opt_type="lm", max_iter=100, rel_thresh=1e-6, Qc=np.eye(2),
    )
    return robot, sdf, setting


class TestISAM2:
    def test_replanning_session(self):
        robot, sdf, setting = _world()
        start = jnp.asarray([-0.8, 0.0])
        goal = jnp.asarray([0.8, 0.0])
        zero = jnp.zeros(2)

        # batch phase
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)

        # incremental phase
        opt = ISAM2TrajOptimizer(robot, sdf, setting)
        opt.init_factor_graph(start, zero, goal, zero)
        opt.init_values(res.traj)
        opt.update()
        base = opt.values()
        # warm-started update on the already-solved problem barely moves it
        np.testing.assert_allclose(
            np.asarray(base.pose), np.asarray(res.traj.pose), atol=1e-4
        )

        # robot executed up to state 3: fix it, then change the goal
        executed_pose = base.pose[3]
        executed_vel = base.vel[3]
        opt.fix_config_and_vel(3, executed_pose, executed_vel)
        new_goal = jnp.asarray([0.8, 0.4])
        opt.change_goal_config_and_vel(new_goal, zero)
        opt.update()
        replanned = opt.values()

        # fixed state stays pinned; new goal reached
        np.testing.assert_allclose(
            np.asarray(replanned.pose[3]), np.asarray(executed_pose), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(replanned.pose[-1]), np.asarray(new_goal), atol=1e-3
        )

    def test_remove_goal(self):
        robot, sdf, setting = _world()
        start = jnp.asarray([-0.8, 0.0])
        goal = jnp.asarray([0.8, 0.0])
        zero = jnp.zeros(2)
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)

        opt = ISAM2TrajOptimizer(robot, sdf, setting)
        opt.init_factor_graph(start, zero, goal, zero)
        opt.init_values(res.traj)
        opt.remove_goal_config_and_vel()
        opt.update()
        freed = opt.values()
        # without the goal prior the end drifts from the old goal toward
        # the GP-smooth continuation; start stays pinned
        np.testing.assert_allclose(
            np.asarray(freed.pose[0]), np.asarray(start), atol=1e-3
        )

    def test_parity_with_batch_resolve(self):
        """Replanned solution matches a cold batch solve of the equivalent
        modified problem (goal changed) — the reference's parity bar.

        The new goal stays on the same side of the obstacle as the warm
        path: warm and cold solves then land in the same homotopy basin
        (opposite-side goals legitimately produce different local optima,
        exactly as the reference's local optimizer would)."""
        robot, sdf, setting = _world()
        start = jnp.asarray([-0.8, 0.0])
        goal = jnp.asarray([0.8, 0.0])
        new_goal = jnp.asarray([0.8, -0.35])
        zero = jnp.zeros(2)
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)

        opt = ISAM2TrajOptimizer(robot, sdf, setting)
        opt.init_factor_graph(start, zero, goal, zero)
        opt.init_values(res.traj)
        opt.change_goal_config_and_vel(new_goal, zero)
        opt.update()
        inc = opt.values()

        fresh = batch_traj_optimize(robot, sdf, start, zero, new_goal, zero, setting)
        # same basin -> same optimum within optimizer tolerance; the graph
        # error (the north-star metric) agrees to < 1%
        np.testing.assert_allclose(
            np.asarray(inc.pose), np.asarray(fresh.traj.pose), atol=2e-2
        )
        from gpmp2_jax.planner import make_problem, traj_error

        prob = make_problem(robot, sdf, start, zero, new_goal, zero, setting)
        e_inc = float(traj_error(prob, inc))
        e_fresh = float(fresh.error)
        assert abs(e_inc - e_fresh) <= 0.01 * max(e_fresh, 1e-12), (e_inc, e_fresh)

    def test_add_state_estimate(self):
        robot, sdf, setting = _world()
        start = jnp.asarray([-0.8, 0.0])
        goal = jnp.asarray([0.8, 0.0])
        zero = jnp.zeros(2)
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
        opt = ISAM2TrajOptimizer(robot, sdf, setting)
        opt.init_factor_graph(start, zero, goal, zero)
        opt.init_values(res.traj)
        measured = jnp.asarray([-0.55, -0.25])
        opt.add_state_estimate(2, measured, 1e-6 * np.eye(2),
                               jnp.asarray([0.3, 0.0]), 1e-6 * np.eye(2))
        opt.update()
        pulled = opt.values()
        np.testing.assert_allclose(
            np.asarray(pulled.pose[2]), np.asarray(measured), atol=1e-2
        )


class TestBatchSessions:
    """ISAM2BatchSessions: a fleet of replanning sessions as one vmapped
    warm-started re-solve (BASELINE config 5 machinery)."""

    def test_fleet_matches_single_sessions(self):
        robot, sdf, setting = _world()
        B = 4
        rng = np.random.default_rng(0)
        starts = jnp.asarray(
            np.stack([[-0.8, dy] for dy in rng.uniform(-0.3, 0.3, B)]))
        goals = jnp.asarray(
            np.stack([[0.8, dy] for dy in rng.uniform(-0.3, 0.3, B)]))
        zeros = jnp.zeros((B, 2))

        res = batch_traj_optimize(robot, sdf, starts, zeros, goals, zeros,
                                  setting)

        # warm_iter=100: full per-update budget so the fleet is exactly the
        # single-session replanner vmapped (the default small warm budget
        # trades a little per-update convergence for serving throughput)
        fleet = ISAM2BatchSessions(robot, sdf, setting, batch=B,
                                   warm_iter=100)
        fleet.init_factor_graph(starts, zeros, goals, zeros)
        fleet.init_values(res.traj)
        fleet.update()

        # each lane fixes its executed state 3 and moves its goal
        poses = fleet.values()
        fleet.fix_config_and_vel(
            np.full(B, 3), poses.pose[:, 3], poses.vel[:, 3])
        new_goals = goals + jnp.asarray([0.0, 0.35])
        fleet.change_goal_config_and_vel(new_goals, zeros)
        fleet.update()
        fleet_traj = fleet.values()

        # parity per lane vs the single-session replanner
        for b in range(B):
            opt = ISAM2TrajOptimizer(robot, sdf, setting)
            opt.init_factor_graph(starts[b], zeros[b], goals[b], zeros[b])
            opt.init_values(
                type(res.traj)(res.traj.pose[b], res.traj.vel[b]))
            opt.update()
            pb = opt.values()
            opt.fix_config_and_vel(3, pb.pose[3], pb.vel[3])
            opt.change_goal_config_and_vel(new_goals[b], zeros[b])
            opt.update()
            np.testing.assert_allclose(
                np.asarray(fleet_traj.pose[b]), np.asarray(opt.values().pose),
                atol=2e-3,
            )
        # fleet reaches the new goals
        np.testing.assert_allclose(
            np.asarray(fleet_traj.pose[:, -1]), np.asarray(new_goals),
            atol=1e-3,
        )

    def test_fleet_measurement_fusion_matches_single(self):
        """Lane-wise add_state_estimate / add_pose_estimate /
        remove_goal_config_and_vel (the measurement-fusion ops of
        ISAM2TrajOptimizer-inl.h:174-195 at fleet scale) match the
        single-session replanner per lane."""
        robot, sdf, setting = _world()
        B = 3
        rng = np.random.default_rng(7)
        starts = jnp.asarray(
            np.stack([[-0.8, dy] for dy in rng.uniform(-0.2, 0.2, B)]))
        goals = jnp.asarray(
            np.stack([[0.8, dy] for dy in rng.uniform(-0.2, 0.2, B)]))
        zeros = jnp.zeros((B, 2))
        res = batch_traj_optimize(robot, sdf, starts, zeros, goals, zeros,
                                  setting)

        fleet = ISAM2BatchSessions(robot, sdf, setting, batch=B,
                                   warm_iter=100)
        fleet.init_factor_graph(starts, zeros, goals, zeros)
        fleet.init_values(res.traj)
        fleet.update()

        measured = np.asarray(fleet.values().pose[:, 2]) + np.asarray(
            [[0.05, -0.08]] * B)
        meas_vel = np.tile([0.25, 0.0], (B, 1))
        fleet.add_state_estimate(np.full(B, 2), measured, 1e-6 * np.ones(2),
                                 meas_vel, 1e-6 * np.ones(2))
        measured_p = np.asarray(fleet.values().pose[:, 5]) + np.asarray(
            [[0.0, 0.06]] * B)
        fleet.add_pose_estimate(np.full(B, 5), measured_p, 1e-6)
        fleet.remove_goal_config_and_vel(lanes=[1])
        fleet.update()
        fleet_traj = fleet.values()

        for b in range(B):
            opt = ISAM2TrajOptimizer(robot, sdf, setting)
            opt.init_factor_graph(starts[b], zeros[b], goals[b], zeros[b])
            opt.init_values(
                type(res.traj)(res.traj.pose[b], res.traj.vel[b]))
            opt.update()
            opt.add_state_estimate(2, measured[b], 1e-6 * np.ones(2),
                                   meas_vel[b], 1e-6 * np.ones(2))
            opt.add_pose_estimate(5, measured_p[b], 1e-6)
            if b == 1:
                opt.remove_goal_config_and_vel()
            opt.update()
            np.testing.assert_allclose(
                np.asarray(fleet_traj.pose[b]), np.asarray(opt.values().pose),
                atol=2e-3,
            )
        # the fused measurements actually pin the states
        np.testing.assert_allclose(np.asarray(fleet_traj.pose[:, 2]),
                                   measured, atol=1e-2)
        np.testing.assert_allclose(np.asarray(fleet_traj.pose[:, 5]),
                                   measured_p, atol=1e-2)

    def test_partial_lane_goal_change(self):
        robot, sdf, setting = _world()
        B = 3
        starts = jnp.tile(jnp.asarray([-0.8, 0.0]), (B, 1))
        goals = jnp.tile(jnp.asarray([0.8, 0.0]), (B, 1))
        zeros = jnp.zeros((B, 2))
        res = batch_traj_optimize(robot, sdf, starts, zeros, goals, zeros,
                                  setting)
        fleet = ISAM2BatchSessions(robot, sdf, setting, batch=B)
        fleet.init_factor_graph(starts, zeros, goals, zeros)
        fleet.init_values(res.traj)
        new_goals = jnp.tile(jnp.asarray([0.8, 0.5]), (B, 1))
        fleet.change_goal_config_and_vel(new_goals, zeros, lanes=[1])
        fleet.update()
        traj = fleet.values()
        # lane 1 moved to the new goal; lanes 0/2 kept the old one
        np.testing.assert_allclose(np.asarray(traj.pose[1, -1]),
                                   [0.8, 0.5], atol=1e-3)
        np.testing.assert_allclose(np.asarray(traj.pose[0, -1]),
                                   [0.8, 0.0], atol=1e-3)
        np.testing.assert_allclose(np.asarray(traj.pose[2, -1]),
                                   [0.8, 0.0], atol=1e-3)


def _mobile_world():
    """SE(2) x R^2 mobile manipulator world (the reference's
    Pose2MobileArm2D replanner domain, ISAM2TrajOptimizer.h:140-152)."""
    from gpmp2_jax.robots import generate_mobile_arm

    ys = -2.0 + 4.0 / 95 * np.arange(96)
    X, Y = np.meshgrid(ys, ys)
    dist = np.sqrt((X - 0.1) ** 2 + (Y - 0.4) ** 2) - 0.35
    sdf = PlanarSDF(
        origin=jnp.asarray([-2.0, -2.0]), cell_size=jnp.asarray(4.0 / 95),
        data=jnp.asarray(dist),
    )
    robot = generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64)
    setting = TrajOptimizerSetting(
        dof=5, total_step=10, total_time=5.0, obs_check_inter=2,
        opt_type="lm", max_iter=100, rel_thresh=1e-6, Qc=np.eye(5),
    )
    return robot, sdf, setting


class TestMobileReplanning:
    """Lie-state (Pose2Vector = SE(2) x R^n) incremental replanning — the
    reference ships mobile replanner classes (ISAM2TrajOptimizer.h:140-171)
    and implements goal-change/fix-state on Pose2Vector states
    (-inl.h:121-195); these tests exercise the same ops on
    Pose2MobileArmFK sessions."""

    def test_mobile_session(self):
        robot, sdf, setting = _mobile_world()
        start = jnp.asarray([-1.2, -0.8, 0.0, 0.3, 0.6], jnp.float64)
        goal = jnp.asarray([1.2, 0.9, 1.0, 0.6, 0.3], jnp.float64)
        zero = jnp.zeros(5, jnp.float64)

        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero,
                                  setting)
        opt = ISAM2TrajOptimizer(robot, sdf, setting)
        opt.init_factor_graph(start, zero, goal, zero)
        opt.init_values(res.traj)
        opt.update()
        base = opt.values()
        np.testing.assert_allclose(
            np.asarray(base.pose), np.asarray(res.traj.pose), atol=1e-4)

        # robot executed to state 3 (an SE(2) x R^2 state): pin it, move
        # the goal on the manifold, re-solve warm
        executed_pose = base.pose[3]
        executed_vel = base.vel[3]
        opt.fix_config_and_vel(3, executed_pose, executed_vel)
        new_goal = jnp.asarray([1.2, 0.5, 0.7, 0.5, 0.4], jnp.float64)
        opt.change_goal_config_and_vel(new_goal, zero)
        opt.update()
        replanned = opt.values()

        np.testing.assert_allclose(
            np.asarray(replanned.pose[3]), np.asarray(executed_pose),
            atol=1e-3)
        np.testing.assert_allclose(
            np.asarray(replanned.pose[-1]), np.asarray(new_goal), atol=1e-3)

        # measurement fusion on the Lie state
        measured = np.asarray(replanned.pose[6]) + np.asarray(
            [0.04, -0.03, 0.05, 0.02, -0.02])
        opt.add_pose_estimate(6, jnp.asarray(measured), 1e-6 * np.eye(5))
        opt.update()
        np.testing.assert_allclose(
            np.asarray(opt.values().pose[6]), measured, atol=1e-2)

    def test_mobile_fleet_matches_single(self):
        robot, sdf, setting = _mobile_world()
        B = 3
        rng = np.random.default_rng(3)
        base_start = np.array([-1.2, -0.8, 0.0, 0.3, 0.6])
        base_goal = np.array([1.2, 0.9, 1.0, 0.6, 0.3])
        starts = jnp.asarray(
            base_start + 0.05 * rng.normal(size=(B, 5)), jnp.float64)
        goals = jnp.asarray(
            base_goal + 0.05 * rng.normal(size=(B, 5)), jnp.float64)
        zeros = jnp.zeros((B, 5), jnp.float64)

        res = batch_traj_optimize(robot, sdf, starts, zeros, goals, zeros,
                                  setting)
        fleet = ISAM2BatchSessions(robot, sdf, setting, batch=B,
                                   warm_iter=100)
        fleet.init_factor_graph(starts, zeros, goals, zeros)
        fleet.init_values(res.traj)
        fleet.update()

        poses = fleet.values()
        fleet.fix_config_and_vel(
            np.full(B, 3), poses.pose[:, 3], poses.vel[:, 3])
        new_goals = goals + jnp.asarray([0.0, -0.3, 0.2, 0.1, 0.0])
        fleet.change_goal_config_and_vel(new_goals, zeros)
        fleet.update()
        fleet_traj = fleet.values()

        for b in range(B):
            opt = ISAM2TrajOptimizer(robot, sdf, setting)
            opt.init_factor_graph(starts[b], zeros[b], goals[b], zeros[b])
            opt.init_values(
                type(res.traj)(res.traj.pose[b], res.traj.vel[b]))
            opt.update()
            pb = opt.values()
            opt.fix_config_and_vel(3, pb.pose[3], pb.vel[3])
            opt.change_goal_config_and_vel(new_goals[b], zeros[b])
            opt.update()
            np.testing.assert_allclose(
                np.asarray(fleet_traj.pose[b]),
                np.asarray(opt.values().pose), atol=2e-3)
        np.testing.assert_allclose(
            np.asarray(fleet_traj.pose[:, -1]), np.asarray(new_goals),
            atol=1e-3)
