"""Three-link arm reaching a WORKSPACE goal with an unconstrained end
configuration.

Mirror of /root/reference/matlab/Arm3GoalReachExample.m: no end-config
prior at all — instead a GoalFactorArm pins the end-effector position to
the workspace point (0, 1.1, 0) (goal sigma 1e-4), with a zero end
velocity prior, GP priors, and planar obstacle factors on the
OneObstacleDataset world. The optimizer is free to choose ANY final
configuration whose end effector reaches the point.

Run: PYTHONPATH=. python examples/arm3_goal_reach.py
"""

import jax

# float64 as in GTSAM: from the all-zeros start the arm is singular (every
# end-effector Jacobian column points along +y) and the 1e8 goal weight
# makes the first Newton systems too ill-conditioned for float32
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import FactorGraph, OptimizerParams, generate_arm
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.kinematics.fk import link_poses
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def main():
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    # settings (Arm3GoalReachExample.m:29-74)
    total_time, n_steps, total_check = 5.0, 10, 50
    dt = total_time / n_steps
    check_inter = total_check // n_steps - 1
    arm = generate_arm("SimpleThreeLinksArm")
    Qc = np.eye(3)
    cost_sigma, eps = 0.1, 0.1
    goal_point = jnp.asarray([0.0, 1.1, 0.0])

    start = jnp.zeros(3)
    zero = jnp.zeros(3)

    g = FactorGraph(arm.space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    # NO end-config prior — workspace goal + zero end velocity instead
    g.add_goal(n_steps, arm.fk, goal_point, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(1, n_steps + 1):
        g.add_gp_prior(i - 1, i, dt, Qc)
        g.add_obstacle(i, arm, sdf, cost_sigma, eps)
        for j in range(1, check_inter + 1):
            tau = j * (total_time / total_check)
            g.add_obstacle_gp(i - 1, i, arm, sdf, cost_sigma, eps, Qc, dt, tau)

    init = init_traj_straight_line(arm.space, start, start, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    # Dogleg: from the straight-arm start, pure GN oscillates in the
    # singular direction and LM's lambda blows past its cap; the trust
    # region walks the bend in smoothly
    res = g.optimize(init, OptimizerParams(
        method="dogleg", max_iter=300, rel_thresh=1e-9, abs_thresh=1e-9,
        reject_budget=100, delta_min=1e-12,
    ))
    ee = link_poses(arm.fk, res.traj.pose[n_steps]).trans[-1]
    print(f"Final Error = {float(res.error):.4f}  "
          f"({int(res.iterations)} iterations, "
          f"converged={bool(res.converged)})")
    print(f"end-effector reached ({float(ee[0]):.4f}, {float(ee[1]):.4f}) "
          f"vs goal ({float(goal_point[0]):.1f}, {float(goal_point[1]):.1f}); "
          f"final configuration {np.asarray(res.traj.pose[n_steps]).round(3)}")


if __name__ == "__main__":
    main()
