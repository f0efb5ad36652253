"""Planar 3-link arm planning (+ joint limits, + goal-reach variant).

Mirror of matlab/Arm3PlannerExample.m (BatchTrajOptimize2DArm),
Arm3JointLimitExample.m (flag_pos_limit/flag_vel_limit), and
Arm3GoalReachExample.m (workspace end-effector goal with unconstrained end
configuration, GoalFactorArm).

Run: PYTHONPATH=. python examples/arm3_planner.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.kinematics.fk import link_poses
from gpmp2_jax.planner import TrajOptimizerSetting, batch_traj_optimize
from gpmp2_jax.robots import generate_arm


def main():
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    robot = generate_arm("SimpleThreeLinksArm")

    start = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)
    goal = jnp.asarray([np.pi / 2, 0.0, 0.0], jnp.float32)
    zero = jnp.zeros(3, jnp.float32)

    # --- plain planner (Arm3PlannerExample) -----------------------------
    setting = TrajOptimizerSetting(
        dof=3, total_step=10, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
        obs_check_inter=5, opt_type="dogleg", max_iter=100, rel_thresh=1e-4,
        Qc=np.eye(3),
    )
    res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
    print(f"[planner]    converged={bool(res.converged)} err={float(res.error):.4f}")

    # --- with joint/velocity limits (Arm3JointLimitExample) -------------
    setting_lim = TrajOptimizerSetting(
        dof=3, total_step=10, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
        obs_check_inter=5, opt_type="lm", max_iter=100, rel_thresh=1e-4,
        Qc=np.eye(3),
        flag_pos_limit=True, flag_vel_limit=True,
        joint_pos_limits_down=-np.pi * np.ones(3),
        joint_pos_limits_up=np.pi * np.ones(3),
        vel_limits=0.6 * np.ones(3),
    )
    res_lim = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting_lim)
    vmax = float(jnp.abs(res_lim.traj.vel).max())
    print(f"[limits]     converged={bool(res_lim.converged)} max|vel|={vmax:.3f} "
          f"(limit 0.6)")

    # --- workspace goal-reach (Arm3GoalReachExample) --------------------
    # end-effector must reach a point; the end configuration is free.
    ee_goal = jnp.asarray([0.3, 1.2, 0.0], jnp.float32)
    setting_gr = TrajOptimizerSetting(
        dof=3, total_step=10, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
        obs_check_inter=5, opt_type="lm", max_iter=100, rel_thresh=1e-5,
        Qc=np.eye(3),
    )
    res_gr = batch_traj_optimize(
        robot, sdf, start, zero, goal, zero, setting_gr,
        goal_region=True, goal_point=ee_goal, goal_sigma=0.01,
    )
    ee = link_poses(robot.fk, res_gr.traj.pose[-1]).trans[-1]
    print(f"[goal reach] converged={bool(res_gr.converged)} "
          f"ee=({float(ee[0]):.3f},{float(ee[1]):.3f}) target=(0.3,1.2) "
          f"miss={float(jnp.linalg.norm(ee - ee_goal)):.4f}")


if __name__ == "__main__":
    main()
