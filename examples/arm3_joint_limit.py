"""Three-link arm with joint position AND velocity limit factors.

Mirror of /root/reference/matlab/Arm3JointLimitExample.m: the third joint
is clamped to exactly 0 (limits [0, 0], sigma 1e-3), velocities to
|v| <= 1 (sigma 0.1) — so the planner must reach the goal using only the
first two joints within the velocity budget. Built by hand through the
FactorGraph API with the reference's exact limit vectors.

Run: PYTHONPATH=. python examples/arm3_joint_limit.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import FactorGraph, OptimizerParams, generate_arm
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def main():
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    # settings (Arm3JointLimitExample.m:29-79)
    total_time, n_steps, total_check = 5.0, 10, 50
    dt = total_time / n_steps
    check_inter = total_check // n_steps - 1
    arm = generate_arm("SimpleThreeLinksArm")
    Qc = np.eye(3)
    cost_sigma, eps = 0.1, 0.1
    lim_down = jnp.asarray([-1000.0, -1000.0, 0.0])
    lim_up = jnp.asarray([1000.0, 1000.0, 0.0])
    lim_thresh = 0.001
    vel_lim = jnp.ones(3)
    vel_thresh = 0.01

    start = jnp.zeros(3)
    goal = jnp.asarray([np.pi / 2, 0.0, 0.0])
    zero = jnp.zeros(3)

    g = FactorGraph(arm.space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(n_steps, goal, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(n_steps + 1):
        g.add_joint_limit(i, lim_down, lim_up, lim_thresh, 1e-3)
        g.add_velocity_limit(i, vel_lim, vel_thresh, 0.1)
        if i > 0:
            g.add_gp_prior(i - 1, i, dt, Qc)
            g.add_obstacle(i, arm, sdf, cost_sigma, eps)
            for j in range(1, check_inter + 1):
                tau = j * (total_time / total_check)
                g.add_obstacle_gp(i - 1, i, arm, sdf, cost_sigma, eps,
                                  Qc, dt, tau)

    init = init_traj_straight_line(arm.space, start, goal, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    res = g.optimize(init, OptimizerParams(method="lm", max_iter=200,
                                           rel_thresh=1e-6))
    print(f"Final Error = {float(res.error):.4f}  "
          f"({int(res.iterations)} iterations, "
          f"converged={bool(res.converged)})")
    q3_max = float(jnp.max(jnp.abs(res.traj.pose[:, 2])))
    v_max = float(jnp.max(jnp.abs(res.traj.vel)))
    print(f"max |q3| = {q3_max:.4f} (limited to ~0), "
          f"max |v| = {v_max:.3f} (limited to ~1)")
    for i in range(0, n_steps + 1, 2):
        q = np.asarray(res.traj.pose[i])
        print(f"  x_{i}: [{q[0]: .3f}, {q[1]: .3f}, {q[2]: .5f}]")


if __name__ == "__main__":
    main()
