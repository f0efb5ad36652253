"""SE(2)-base mobile manipulator planning (Pose2Vector state).

Mirror of matlab/MobileArmFactorGraphExample.m / Mobile2ArmsExample.m: the
SimpleTwoLinksArm mobile preset plans across a 2D world while folding its
arm; the Lie-group GP prior runs on SE(2) x R^2 and obstacle factors use the
analytic mobile-base Jacobians.

Run: PYTHONPATH=. python examples/mobile_arm_planning.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.planner import (
    TrajOptimizerSetting,
    batch_traj_optimize,
    collision_cost,
    make_problem,
)
from gpmp2_jax.robots import generate_mobile_arm


def main():
    ds = generate_2d_dataset("MobileMap1")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    robot = generate_mobile_arm("SimpleTwoLinksArm")  # dof = 3 base + 2 arm

    setting = TrajOptimizerSetting(
        dof=5, total_step=12, total_time=12.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=3, opt_type="lm", max_iter=100, rel_thresh=1e-4,
        Qc=np.eye(5),
    )

    # state = [x, y, theta, q1, q2]
    start = jnp.asarray([-3.0, -3.0, 0.0, 0.0, 0.0], jnp.float32)
    goal = jnp.asarray([3.0, 3.0, np.pi / 2, np.pi / 4, -np.pi / 4], jnp.float32)
    zero = jnp.zeros(5, jnp.float32)

    res = batch_traj_optimize(
        robot, sdf, start, zero, goal, zero, setting,
        flag_vehicle_dynamics=True, dyn_sigma=0.001,
    )
    prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
    cc = float(collision_cost(prob, res.traj.pose))
    print(f"converged: {bool(res.converged)}  iters: {int(res.iterations)}")
    print(f"graph error: {float(res.error):.3f}  collision cost: {cc:.6f}")
    traj = np.asarray(res.traj.pose)
    print("base path (x, y, theta):")
    print(traj[:, :3].round(3))
    print("arm configs (q1, q2):")
    print(traj[:, 3:].round(3))


if __name__ == "__main__":
    main()
