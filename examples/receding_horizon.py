"""Receding-horizon point-robot planning.

Mirror of gpmp2_python/examples/pointRobot2Factor_rh.py:12-110: re-plan a
fixed-horizon window from the current state in a loop, executing one step
per iteration — the serving-style workload. Here each window re-plan is a
warm-started jitted solve (shapes static across iterations, so the loop
reuses one compiled program).

Run: PYTHONPATH=. python examples/receding_horizon.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.kinematics import PointRobotFK, make_robot_model
from gpmp2_jax.planner import TrajOptimizerSetting, batch_traj_optimize
from gpmp2_jax.planner.problem import Trajectory
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def main():
    ds = generate_2d_dataset("TwoObstaclesDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))])

    setting = TrajOptimizerSetting(
        dof=2, total_step=8, total_time=4.0, epsilon=0.2, cost_sigma=0.1,
        obs_check_inter=3, opt_type="lm", max_iter=50, rel_thresh=1e-4,
        Qc=np.eye(2),
    )

    goal = jnp.asarray([1.7, 1.7], jnp.float32)  # free corner
    cur = jnp.asarray([-0.9, -0.9], jnp.float32)
    cur_vel = jnp.zeros(2, jnp.float32)

    prev = None
    for step in range(12):
        init = None
        if prev is not None:
            # warm start: shift the previous window by one state
            pose = jnp.concatenate([prev.pose[1:], prev.pose[-1:]])
            vel = jnp.concatenate([prev.vel[1:], prev.vel[-1:]])
            init = Trajectory(pose.at[0].set(cur), vel.at[0].set(cur_vel))
        res = batch_traj_optimize(
            robot, sdf, cur, cur_vel, goal, jnp.zeros(2, jnp.float32),
            setting, init_traj=init,
        )
        prev = res.traj
        # execute the first interval
        cur = res.traj.pose[1]
        cur_vel = res.traj.vel[1]
        print(f"step {step:2d}: at ({float(cur[0]):+.3f}, {float(cur[1]):+.3f}) "
              f"err {float(res.error):8.3f} iters {int(res.iterations)}")
        if float(jnp.linalg.norm(cur - goal)) < 0.05:
            print("reached goal")
            break


if __name__ == "__main__":
    main()
