"""Mobile-manipulator incremental replanning session.

The SE(2) x R^2 analog of examples/wam_replanner.py, covering the
reference's mobile replanner typedefs (ISAM2TrajOptimizer.h:140-171:
Pose2MobileArm2DTrajOptimizer etc.; -inl.h:121-195 implements
goal-change / fix-state on Pose2Vector states): batch-plan a
SimpleTwoLinksArm mobile manipulator through a 2D world, hand the result
to the incremental optimizer, fix the executed SE(2) x R^2 state, change
the goal mid-execution, fuse a measured pose, and re-solve incrementally.

Run: PYTHONPATH=. python examples/mobile_arm_replanner.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.obstacle.sdf import PlanarSDF
from gpmp2_jax.planner import TrajOptimizerSetting, batch_traj_optimize
from gpmp2_jax.planner.isam2 import ISAM2TrajOptimizer
from gpmp2_jax.robots import generate_mobile_arm


def main():
    robot = generate_mobile_arm("SimpleTwoLinksArm")
    print(f"robot space: {robot.space.kind} (dof {robot.space.dim})")

    # one-disc world
    ys = -2.0 + 4.0 / 95 * np.arange(96)
    X, Y = np.meshgrid(ys, ys)
    dist = np.sqrt((X - 0.1) ** 2 + (Y - 0.4) ** 2) - 0.35
    sdf = PlanarSDF(
        origin=jnp.asarray([-2.0, -2.0]), cell_size=jnp.asarray(4.0 / 95),
        data=jnp.asarray(dist, jnp.float32),
    )

    setting = TrajOptimizerSetting(
        dof=5, total_step=10, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
        obs_check_inter=3, opt_type="lm", max_iter=100, rel_thresh=1e-5,
        Qc=np.eye(5),
    )

    start = jnp.asarray([-1.2, -0.8, 0.0, 0.3, 0.6], jnp.float32)
    goal = jnp.asarray([1.2, 0.9, 1.0, 0.6, 0.3], jnp.float32)
    zero = jnp.zeros(5, jnp.float32)

    # phase 1: batch plan
    res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
    print(f"batch: converged={bool(res.converged)} err={float(res.error):.4f}")

    # phase 2: incremental session
    opt = ISAM2TrajOptimizer(robot, sdf, setting)
    opt.init_factor_graph(start, zero, goal, zero)
    opt.init_values(res.traj)
    opt.update()

    # robot executes through state 3; fix the executed SE(2) x R^2 state
    executed = opt.values()
    opt.fix_config_and_vel(3, executed.pose[3], executed.vel[3])

    # new goal arrives mid-execution (moved on the manifold)
    new_goal = jnp.asarray([1.2, 0.5, 0.7, 0.5, 0.4], jnp.float32)
    opt.change_goal_config_and_vel(new_goal, zero)
    opt.update()

    replanned = opt.values()
    print(f"replan: err={float(opt.error):.4f}")
    drift = float(jnp.linalg.norm(replanned.pose[3] - executed.pose[3]))
    reach = float(jnp.linalg.norm(replanned.pose[-1] - new_goal))
    print(f"fixed state drift: {drift:.5f}")
    print(f"new goal reach:    {reach:.5f}")
    assert drift < 1e-2 and reach < 1e-2

    # phase 3: fuse a localization measurement of the base+arm state
    measured = np.asarray(replanned.pose[6]) + np.asarray(
        [0.03, -0.02, 0.04, 0.02, -0.02], np.float32)
    opt.add_pose_estimate(6, jnp.asarray(measured), 1e-6 * np.eye(5))
    opt.update()
    fused = float(jnp.linalg.norm(opt.values().pose[6] - measured))
    print(f"measurement fusion residual: {fused:.5f}")
    assert fused < 1e-2
    print("ok")


if __name__ == "__main__":
    main()
