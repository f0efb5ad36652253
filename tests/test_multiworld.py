"""Per-problem SDF worlds: a batch where every problem has its own
environment (BASELINE.md config 5 — thousands of randomized start/goal/SDF
worlds). The SDF data leaf carries a batch axis; infer_batch_axes marks it
batched and the whole fleet solves in one program."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.kinematics.fk import PointRobotFK
from gpmp2_jax.kinematics.robot import make_robot_model
from gpmp2_jax.obstacle.sdf import PlanarSDF
from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
from gpmp2_jax.planner.batch import (
    infer_batch_axes,
    optimizer_params_from_setting,
    plan_batch,
)
from gpmp2_jax.planner.problem import collision_cost
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def disc_world(cy):
    ys = -1.5 + 3.0 / 63 * np.arange(64)
    X, Y = np.meshgrid(ys, ys)
    return np.sqrt(X**2 + (Y - cy) ** 2) - 0.3


class TestMultiWorld:
    def test_batched_worlds_match_individual_solves(self):
        B = 4
        centers = [0.12, -0.2, 0.3, 0.0 + 1e-3]
        data = jnp.asarray(np.stack([disc_world(c) for c in centers]))
        sdf_batched = PlanarSDF(
            origin=jnp.asarray([-1.5, -1.5]), cell_size=jnp.asarray(3.0 / 63),
            data=data,
        )
        robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))],
                                 dtype=jnp.float64)
        setting = TrajOptimizerSetting(
            dof=2, total_step=8, total_time=4.0, obs_check_inter=2,
            opt_type="lm", max_iter=60, rel_thresh=1e-6, Qc=np.eye(2),
        )
        starts = jnp.tile(jnp.asarray([-0.9, 0.0]), (B, 1))
        goals = jnp.tile(jnp.asarray([0.9, 0.0]), (B, 1))
        zeros = jnp.zeros((B, 2))

        probs = make_problem(robot, sdf_batched, starts, zeros, goals, zeros,
                             setting, dtype=jnp.float64)
        sdf_single = PlanarSDF(sdf_batched.origin, sdf_batched.cell_size,
                               data[0])
        template = make_problem(robot, sdf_single, starts[0], zeros[0],
                                goals[0], zeros[0], setting, dtype=jnp.float64)
        axes = infer_batch_axes(probs, template)
        # the sdf data leaf must be detected as batched
        assert axes.sdf.data == 0 and axes.sdf.origin is None

        init = jax.vmap(
            lambda s, g: init_traj_straight_line(robot.space, s, g, 8, 4.0)
        )(starts, goals)
        res = plan_batch(probs, init, optimizer_params_from_setting(setting), axes)

        # each problem individually
        for i in range(B):
            sdf_i = PlanarSDF(sdf_batched.origin, sdf_batched.cell_size, data[i])
            prob_i = make_problem(robot, sdf_i, starts[i], zeros[i], goals[i],
                                  zeros[i], setting, dtype=jnp.float64)
            probs_i = jax.tree_util.tree_map(lambda x: x[None], prob_i)
            axes_i = jax.tree_util.tree_map(lambda x: 0, probs_i)
            init_i = jax.tree_util.tree_map(lambda x: x[i][None], init)
            res_i = plan_batch(probs_i, init_i,
                               optimizer_params_from_setting(setting), axes_i)
            np.testing.assert_allclose(
                np.asarray(res.traj.pose[i]), np.asarray(res_i.traj.pose[0]),
                atol=1e-8,
            )
            # different worlds -> genuinely different trajectories
        p0 = np.asarray(res.traj.pose[0])
        p1 = np.asarray(res.traj.pose[1])
        assert np.abs(p0 - p1).max() > 0.05

        # all collision-free in their own worlds
        cc = jax.vmap(collision_cost, in_axes=(axes, 0))(probs, res.traj.pose)
        np.testing.assert_array_less(np.asarray(cc), 1e-6)
