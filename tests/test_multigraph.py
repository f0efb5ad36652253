"""Multi-chain planner graphs (planner/multigraph.py vs the reference
Python toolbox's graph_utils.py semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax import PlanarSDF, PointRobotFK, make_robot_model
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.planner import (
    TrajOptimizerSetting,
    Trajectory,
    build_planner_graph,
    edge_costs,
    make_multigraph_problem,
    make_problem,
    multigraph_error,
    optimize_multigraph,
    sample_initializations,
    shortest_path,
    traj_error,
)

F64 = jnp.float64


def point_robot(r=1.5):
    return make_robot_model(PointRobotFK(), [(0, r, (0.0, 0.0, 0.0))],
                            dtype=F64)


def multi_obstacle_sdf():
    ds = generate_2d_dataset("MultiObstacleDataset")
    return planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map,
                                     dtype=F64)


class TestSampling:
    def test_gp_posterior_samples(self):
        from gpmp2_jax.geometry.statespace import StateSpace

        space = StateSpace("vector", 2)
        start = jnp.asarray([0.0, 0.0], F64)
        end = jnp.asarray([17.0, 14.0], F64)
        chains = sample_initializations(
            space, start, end, n_steps=10, total_time=10.0,
            Qc=np.eye(2), n_chains=6, key=jax.random.PRNGKey(0),
        )
        assert chains.shape == (6, 11, 2)
        # endpoints pinned exactly
        np.testing.assert_allclose(np.asarray(chains[:, 0]),
                                   np.tile(np.asarray(start), (6, 1)))
        np.testing.assert_allclose(np.asarray(chains[:, -1]),
                                   np.tile(np.asarray(end), (6, 1)))
        # chains differ from each other and hover around the straight line
        spread = np.std(np.asarray(chains[:, 5, 0]))
        assert spread > 0.01
        mean_mid = np.mean(np.asarray(chains[:, 5]), axis=0)
        straight_mid = np.asarray(start + 0.5 * (end - start))
        assert np.linalg.norm(mean_mid - straight_mid) < 5.0


class TestGraphBuild:
    def test_chain_topology(self):
        chains = np.zeros((2, 5, 2))
        chains[0] = np.linspace([0, 0], [4, 0], 5)
        chains[1] = np.linspace([0, 0], [4, 0], 5) + [0, 1.0]
        chains[1][0] = [0, 0]
        chains[1][-1] = [4, 0]
        pose, vel, edges = build_planner_graph(chains, [1.0, 0.0])
        # M = 2 + 2 chains * 3 interior
        assert pose.shape == (8, 2)
        assert edges.shape == (8, 2)  # 4 edges per chain
        # all chain edges start at 0 or interior, end at 1 or interior
        assert (edges[:, 0] != 1).all()  # nothing leaves the goal
        assert (edges[:, 1] != 0).all()  # nothing enters the start

    def test_random_interconnections_seeded(self):
        chains = np.random.default_rng(0).normal(size=(3, 8, 2))
        _, _, e1 = build_planner_graph(chains, [0, 0], connect_prob=0.5,
                                       seed=7)
        _, _, e2 = build_planner_graph(chains, [0, 0], connect_prob=0.5,
                                       seed=7)
        np.testing.assert_array_equal(e1, e2)
        _, _, e0 = build_planner_graph(chains, [0, 0], connect_prob=0.0)
        assert e1.shape[0] > e0.shape[0]


class TestErrorParity:
    """A single-chain multigraph is exactly the batch planner's chain graph
    (minus the obstacle factor on the start node, which get_gtsam_graph
    omits for i == 0): costs must agree analytically."""

    def test_single_chain_matches_trajproblem(self):
        robot = point_robot(r=0.5)
        sdf = multi_obstacle_sdf()
        n_steps, total_time, inter = 6, 6.0, 2
        start = jnp.asarray([0.0, 0.0], F64)
        goal = jnp.asarray([10.0, 8.0], F64)
        zero = jnp.zeros(2, F64)
        dt = total_time / n_steps

        # one straight-line chain
        ts = np.linspace(0, 1, n_steps + 1)[:, None]
        chain = np.asarray(start)[None] * (1 - ts) + np.asarray(goal)[None] * ts
        pose_n, vel_n, edges = build_planner_graph(
            chain[None], (np.asarray(goal) - np.asarray(start)) / total_time)
        prob = make_multigraph_problem(
            robot, sdf, edges, start, zero, goal, zero,
            dt=dt, Qc=np.eye(2), cost_sigma=0.5, epsilon=4.0,
            obs_check_inter=inter, dtype=F64,
        )
        pose = jnp.asarray(pose_n, F64)
        vel = jnp.asarray(vel_n, F64)
        e_mg = float(multigraph_error(prob, pose, vel))

        setting = TrajOptimizerSetting(
            dof=2, total_step=n_steps, total_time=total_time,
            obs_check_inter=inter, cost_sigma=0.5, epsilon=4.0,
        )
        tp = make_problem(robot, sdf, start, zero, goal, zero, setting,
                          dtype=F64, sdf_pack=False)
        # node order 0, 1, 2.. = state 0, state N, states 1..N-1
        order = [0] + list(range(2, n_steps + 1)) + [1]
        traj = Trajectory(pose[jnp.asarray(order)], vel[jnp.asarray(order)])
        e_tp = float(traj_error(tp, traj))
        # remove the start-state obstacle cost the chain graph includes
        from gpmp2_jax.planner.multigraph import _obs_res

        e_start_obs = 0.5 * float(prob.obs_w) * float(
            jnp.sum(_obs_res(prob, pose[0]) ** 2))
        assert e_mg == pytest.approx(e_tp - e_start_obs, rel=1e-9)


class TestOptimizeAndPath:
    def test_joint_optimize_and_dijkstra(self):
        robot = point_robot(r=1.5)
        sdf = multi_obstacle_sdf()
        from gpmp2_jax.geometry.statespace import StateSpace

        space = StateSpace("vector", 2)
        start = jnp.asarray([0.0, 0.0], F64)
        goal = jnp.asarray([17.0, 14.0], F64)
        zero = jnp.zeros(2, F64)
        n_steps, total_time = 10, 10.0
        dt = total_time / n_steps

        chains = sample_initializations(
            space, start, goal, n_steps, total_time, np.eye(2), 4,
            jax.random.PRNGKey(1))
        avg_vel = (goal - start) / total_time
        pose_n, vel_n, edges = build_planner_graph(
            chains, avg_vel, connect_prob=0.5, seed=1)
        prob = make_multigraph_problem(
            robot, sdf, edges, start, zero, goal, zero,
            dt=dt, Qc=np.eye(2), cost_sigma=0.5, epsilon=4.0,
            obs_check_inter=1, dtype=F64,
        )
        pose0 = jnp.asarray(pose_n, F64)
        vel0 = jnp.asarray(vel_n, F64)
        e0 = float(multigraph_error(prob, pose0, vel0))
        pose, vel, err, iters, done = optimize_multigraph(prob, pose0, vel0)
        assert float(err) < e0, "joint optimization must reduce error"
        assert int(iters) >= 1

        ec, nc = edge_costs(prob, pose, vel)
        path = shortest_path(prob.edges, ec, nc)
        assert path[0] == 0 and path[-1] == 1
        # path visits n_steps+1 nodes (a full chain through the DAG)
        assert len(path) == n_steps + 1

    def test_dijkstra_prefers_cheap_branch(self):
        # diamond: 0 -> {2 cheap, 3 expensive} -> 1
        edges = np.asarray([[0, 2], [0, 3], [2, 1], [3, 1]], np.int32)
        ec = np.asarray([1.0, 1.0, 1.0, 1.0])
        nc = np.asarray([0.0, 0.0, 0.1, 5.0])
        path = shortest_path(edges, ec, nc)
        assert path == [0, 2, 1]

    def test_large_graph_warns(self):
        """The dense-solve size guard warns past ~tens of nodes."""
        import warnings

        from gpmp2_jax.geometry.statespace import VectorSpace
        from gpmp2_jax.kinematics.fk import PointRobotFK
        from gpmp2_jax.kinematics.robot import make_robot_model
        from gpmp2_jax.planner.multigraph import make_multigraph_problem

        robot = make_robot_model(PointRobotFK(), [(0, 0.1, (0.0, 0.0, 0.0))])
        xs = np.linspace(-2, 2, 21)
        X, Y = np.meshgrid(xs, xs)
        sdf = PlanarSDF(
            origin=jnp.asarray([-2.0, -2.0]), cell_size=jnp.asarray(0.2),
            data=jnp.asarray(np.sqrt(X**2 + Y**2) - 0.5),
        )
        M = 600  # 600 nodes x 4 vars = 2400 > 2048 guard
        edges = np.stack([np.arange(M - 1), np.arange(1, M)], axis=1).astype(np.int32)
        prob = make_multigraph_problem(
            robot, sdf, edges, np.zeros(2), np.zeros(2), np.ones(2),
            np.zeros(2), dt=0.1, Qc=np.eye(2), cost_sigma=0.1, epsilon=0.2,
            obs_check_inter=0,
        )
        pose = jnp.zeros((M, 2))
        vel = jnp.zeros((M, 2))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            optimize_multigraph(prob, pose, vel, max_iter=1)
            assert any("dense normal equations" in str(x.message) for x in w)
