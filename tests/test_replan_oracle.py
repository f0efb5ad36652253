"""Replanning-sequence parity vs the independent oracle (VERDICT r2 #4).

tests/fixtures/oracle_replan_pointrobot2d.npz replays the reference's
replanning loop (WAMReplannerExample.m; ISAM2TrajOptimizer-inl.h:102-195)
in the float64 numpy oracle: cold solve, then per round fix an executed
state, swap the goal, and re-solve. The fixture records the exact pinned
values and perturbed goals, so this test feeds the IDENTICAL event
sequence through ISAM2TrajOptimizer — both sides optimize the same graphs
and each round's final cost must agree within 1%.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax import (
    PointRobotFK,
    Trajectory,
    TrajOptimizerSetting,
    make_robot_model,
)
from gpmp2_jax.datasets import planar_sdf_from_occupancy
from gpmp2_jax.planner import ISAM2TrajOptimizer
from gpmp2_jax.planner.traj_utils import init_traj_straight_line
from gpmp2_jax.robots import generate_mobile_arm

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
F64 = jnp.float64


def test_replan_sequence_parity():
    fx = np.load(os.path.join(FIXDIR, "oracle_replan_pointrobot2d.npz"))
    occ = np.zeros((300, 300))
    r0, r1, c0, c1 = fx["meta_occ_box"]
    occ[r0:r1, c0:c1] = 1.0
    sdf = planar_sdf_from_occupancy(fx["meta_origin"],
                                    float(fx["meta_cell"]), occ, dtype=F64)
    robot = make_robot_model(PointRobotFK(), [(0, 0.15, (0.0, 0.0, 0.0))],
                             dtype=F64)
    setting = TrajOptimizerSetting(
        dof=2, total_step=int(fx["meta_n_steps"]),
        total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]),
        cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]),
        opt_type="lm", max_iter=100,
        rel_thresh=float(fx["meta_rel_tol"]),
    )
    start = jnp.asarray(fx["meta_start"], F64)
    goal0 = jnp.asarray(fx["meta_goal0"], F64)
    z = jnp.zeros(2, F64)

    planner = ISAM2TrajOptimizer(robot, sdf, setting)
    planner.init_factor_graph(start, z, goal0, z)  # f64 via start dtype
    init = init_traj_straight_line(robot.space, start, goal0,
                                   setting.total_step,
                                   float(fx["meta_total_time"]))
    planner.init_values(init)
    planner.update()
    cold = float(planner.error)
    oracle_cold = float(fx["cold_final_error"])
    assert cold <= oracle_cold * 1.01 + 1e-9, (
        f"cold solve {cold} not within 1% of oracle {oracle_cold}"
    )

    rounds = int(fx["pin_idx"].shape[0])
    for r in range(rounds):
        planner.fix_config_and_vel(
            int(fx["pin_idx"][r]),
            jnp.asarray(fx["pin_pose"][r], F64),
            jnp.asarray(fx["pin_vel"][r], F64),
        )
        planner.change_goal_config_and_vel(
            jnp.asarray(fx["goal"][r], F64), z)
        planner.update()
        ours = float(planner.error)
        oracle_err = float(fx["final_error"][r])
        assert ours <= oracle_err * 1.01 + 1e-9, (
            f"round {r}: cost {ours} not within 1% of oracle {oracle_err}"
        )
        # the pinned state must actually be held (strong prior active)
        est = planner.values()
        np.testing.assert_allclose(
            np.asarray(est.pose[int(fx["pin_idx"][r])]),
            fx["pin_pose"][r], atol=1e-3,
        )


def test_replan_sequence_parity_mobilearm(dtype=F64):
    """Lie-state (SE(2) x R^2 Pose2MobileArm) replanning-sequence parity —
    the reference's Pose2MobileArm2D replanner typedef
    (ISAM2TrajOptimizer.h:140-152; -inl.h:121-195 operates on Pose2Vector
    states). Replays the oracle's exact event sequence (cold solve, then
    per round fixConfigAndVel at the oracle's estimate +
    changeGoalConfigAndVel) through ISAM2TrajOptimizer and requires each
    round's final cost within 1%. `dtype` float32 runs the planner's own
    dtype against the float64 oracle under the same rule."""
    fx = np.load(os.path.join(FIXDIR, "oracle_replan_mobilearm.npz"))
    occ = np.zeros((300, 300))
    r0, r1, c0, c1 = fx["meta_occ_box"]
    occ[r0:r1, c0:c1] = 1.0
    sdf = planar_sdf_from_occupancy(fx["meta_origin"],
                                    float(fx["meta_cell"]), occ, dtype=dtype)
    robot = generate_mobile_arm("SimpleTwoLinksArm", dtype=dtype)
    assert robot.space.kind == "se2_vector"
    setting = TrajOptimizerSetting(
        dof=5, total_step=int(fx["meta_n_steps"]),
        total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]),
        cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]),
        opt_type="lm", max_iter=100,
        rel_thresh=float(fx["meta_rel_tol"]),
    )
    start = jnp.asarray(fx["meta_start"], dtype)
    goal0 = jnp.asarray(fx["meta_goal0"], dtype)
    z = jnp.zeros(5, dtype)

    planner = ISAM2TrajOptimizer(robot, sdf, setting)
    planner.init_factor_graph(start, z, goal0, z)
    planner.init_values(Trajectory(jnp.asarray(fx["init_pose"], dtype),
                                   jnp.asarray(fx["init_vel"], dtype)))
    planner.update()
    cold = float(planner.error)
    oracle_cold = float(fx["cold_final_error"])
    assert cold <= oracle_cold * 1.01 + 1e-9, (
        f"cold solve {cold} not within 1% of oracle {oracle_cold}"
    )

    rounds = int(fx["pin_idx"].shape[0])
    for r in range(rounds):
        planner.fix_config_and_vel(
            int(fx["pin_idx"][r]),
            jnp.asarray(fx["pin_pose"][r], dtype),
            jnp.asarray(fx["pin_vel"][r], dtype),
        )
        planner.change_goal_config_and_vel(
            jnp.asarray(fx["goal"][r], dtype), z)
        planner.update()
        ours = float(planner.error)
        oracle_err = float(fx["final_error"][r])
        assert ours <= oracle_err * 1.01 + 1e-9, (
            f"round {r}: cost {ours} not within 1% of oracle {oracle_err}"
        )
        # the pinned SE(2) x R^2 state must actually be held
        est = planner.values()
        np.testing.assert_allclose(
            np.asarray(est.pose[int(fx["pin_idx"][r])]),
            fx["pin_pose"][r], atol=1e-3,
        )


def test_replan_sequence_mobilearm_float32():
    test_replan_sequence_parity_mobilearm(jnp.float32)
