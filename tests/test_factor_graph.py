"""Manual FactorGraph API (planner/factor_graph.py) — the reference's
NonlinearFactorGraph path (SURVEY call stack 3.3).

Key check: a hand-assembled graph following the batch recipe
(BatchTrajOptimizer-inl.h:19-84) must produce the SAME error and the SAME
block-tridiagonal linearization as the planner's internal SoA factor
program (planner/problem.py) on identical inputs — the manual API and the
planner are two views of one factor inventory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax.kinematics.fk import PointRobotFK
from gpmp2_jax.kinematics.robot import make_robot_model
from gpmp2_jax.obstacle.sdf import PlanarSDF
from gpmp2_jax.planner import (
    FactorGraph,
    TrajOptimizerSetting,
    Trajectory,
    make_problem,
)
from gpmp2_jax.planner.problem import traj_error, traj_linearize
from gpmp2_jax.planner.traj_utils import init_traj_straight_line
from gpmp2_jax.robots import generate_arm
from gpmp2_jax.solver.optimize import OptimizerParams


def circle_sdf_2d(n=41, lim=2.0, r=0.5):
    xs = np.linspace(-lim, lim, n)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    dist = np.sqrt(X**2 + Y**2) - r
    return PlanarSDF(
        origin=jnp.asarray([-lim, -lim]),
        cell_size=jnp.asarray(2 * lim / (n - 1)),
        data=jnp.asarray(dist),
    )


def build_manual_graph(robot, sdf, setting, start, goal):
    """The batch recipe assembled by hand from the public factor API,
    exactly as the reference examples do (Arm2FactorGraphExample.m:76-120)."""
    space = robot.space
    N = setting.total_step
    dt = setting.total_time / N
    zero = jnp.zeros(space.dim)
    g = FactorGraph(space, N + 1)
    g.add_prior_pose(0, start, setting.conf_prior_sigma)
    g.add_prior_vel(0, zero, setting.vel_prior_sigma)
    g.add_prior_pose(N, goal, setting.conf_prior_sigma)
    g.add_prior_vel(N, zero, setting.vel_prior_sigma)
    for i in range(N + 1):
        g.add_obstacle(i, robot, sdf, setting.cost_sigma, setting.epsilon)
    for i in range(N):
        g.add_gp_prior(i, i + 1, dt, setting.Qc)
        for j in range(1, setting.obs_check_inter + 1):
            tau = j * dt / (setting.obs_check_inter + 1)
            g.add_obstacle_gp(
                i, i + 1, robot, sdf, setting.cost_sigma, setting.epsilon,
                setting.Qc, dt, tau,
            )
    return g


class TestStructure:
    def test_rejects_nonadjacent_binary(self):
        from gpmp2_jax.geometry.statespace import VectorSpace

        g = FactorGraph(VectorSpace(2), 5)
        with pytest.raises(ValueError, match="adjacent"):
            g.add_gp_prior(0, 2, 0.5, np.eye(2))
        with pytest.raises(ValueError, match="out of range"):
            g.add_prior_pose(7, np.zeros(2), 1e-4)


class TestParityWithPlanner:
    """Manual graph == planner SoA program on the same recipe."""

    def _setup(self):
        robot = make_robot_model(
            PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))], dtype=jnp.float64
        )
        sdf = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64), circle_sdf_2d()
        )
        setting = TrajOptimizerSetting(
            dof=2, total_step=6, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
            obs_check_inter=3, Qc=np.eye(2),
        )
        start = jnp.asarray([-1.5, -1.5], jnp.float64)
        goal = jnp.asarray([1.5, 1.5], jnp.float64)
        z = jnp.zeros(2, jnp.float64)
        prob = make_problem(robot, sdf, start, z, goal, z, setting,
                            sdf_pack=False, dtype=jnp.float64)
        g = build_manual_graph(robot, sdf, setting, start, goal)
        traj = init_traj_straight_line(robot.space, start, goal, 6, 5.0)
        # nudge off the straight line so obstacle factors activate asymmetrically
        rng = np.random.default_rng(0)
        traj = Trajectory(
            traj.pose + 0.11 * jnp.asarray(rng.normal(size=traj.pose.shape)),
            traj.vel + 0.05 * jnp.asarray(rng.normal(size=traj.vel.shape)),
        )
        return prob, g, traj

    def test_error_matches(self):
        prob, g, traj = self._setup()
        np.testing.assert_allclose(
            float(g.error(traj)), float(traj_error(prob, traj)), rtol=1e-12
        )

    def test_linearization_matches(self):
        prob, g, traj = self._setup()
        Hd_m, Ho_m, b_m, err_m = g.linearize(traj)
        Hd_p, Ho_p, b_p, err_p = traj_linearize(prob, traj)
        np.testing.assert_allclose(float(err_m), float(err_p), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(b_m), np.asarray(b_p), atol=1e-9)
        np.testing.assert_allclose(np.asarray(Hd_m), np.asarray(Hd_p), atol=1e-9)
        np.testing.assert_allclose(np.asarray(Ho_m), np.asarray(Ho_p), atol=1e-9)


class TestOptimize:
    def test_point_robot_manual_solve(self):
        robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))])
        sdf = circle_sdf_2d()
        setting = TrajOptimizerSetting(
            dof=2, total_step=8, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
            obs_check_inter=3, Qc=np.eye(2),
        )
        start = jnp.asarray([-1.5, -1.5])
        goal = jnp.asarray([1.5, 1.5])
        g = build_manual_graph(robot, sdf, setting, start, goal)
        init = init_traj_straight_line(robot.space, start, goal, 8, 5.0)
        res = g.optimize(
            init, OptimizerParams(method="lm", max_iter=60, rel_thresh=1e-5)
        )
        assert bool(res.converged)
        assert float(res.error) < float(g.error(init))
        # solution must detour around the r=0.5 obstacle at the origin
        min_dist = float(jnp.min(jnp.linalg.norm(res.traj.pose, axis=-1)))
        assert min_dist > 0.4

    def test_goal_factor_unconstrained_end(self):
        """Arm3GoalReachExample pattern: no end-config prior, a workspace
        GoalFactor on the last state instead (GoalFactorArm.h:26-102)."""
        robot = generate_arm("SimpleThreeLinksArm")
        space = robot.space
        N = 6
        dt = 1.0 / N
        zero = jnp.zeros(3)
        g = FactorGraph(space, N + 1)
        start = jnp.zeros(3)
        g.add_prior_pose(0, start, 1e-4)
        g.add_prior_vel(0, zero, 1e-4)
        g.add_prior_vel(N, zero, 1e-4)
        for i in range(N):
            g.add_gp_prior(i, i + 1, dt, np.eye(3))
        goal_pt = jnp.asarray([1.0, 0.8, 0.0])
        g.add_goal(N, robot.fk, goal_pt, 1e-3)
        init = init_traj_straight_line(space, start, start + 0.1, N, 1.0)
        res = g.optimize(
            init, OptimizerParams(method="lm", max_iter=200, rel_thresh=1e-8)
        )
        from gpmp2_jax.kinematics.fk import link_poses

        ee = link_poses(robot.fk, res.traj.pose[N]).trans[-1]
        np.testing.assert_allclose(np.asarray(ee), np.asarray(goal_pt), atol=1e-2)
