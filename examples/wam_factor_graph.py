"""WAM 7-DOF, factor graph assembled BY HAND on the 3D desk world.

Mirror of /root/reference/matlab/WAMFactorGraphExample.m (and
gpmp2_python/examples/WAMFactorGraphExample.py): the same graph the batch
planner builds internally — start/goal priors, GP priors, 3D SDF obstacle
factors, GP-interpolated obstacle factors (total_check_step 100) — pushed
one factor at a time through the public FactorGraph API, then optimized
with Gauss-Newton.

Run: PYTHONPATH=. python examples/wam_factor_graph.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import FactorGraph, OptimizerParams, generate_arm
from gpmp2_jax.datasets import generate_3d_dataset, sdf_from_occupancy
from gpmp2_jax.obstacle import obstacle_factor_error


def main():
    # WAMDeskDataset -> EDT SDF (WAMFactorGraphExample.m:13-26)
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    arm = generate_arm("WAMArm")

    # settings (lines 42-60)
    total_time, n_steps, total_check = 2.0, 10, 100
    dt = total_time / n_steps
    check_inter = total_check // n_steps - 1
    Qc = np.eye(7)
    cost_sigma, eps = 0.02, 0.2

    start = jnp.asarray([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    goal = jnp.asarray([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    zero = jnp.zeros(7)

    g = FactorGraph(arm.space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(n_steps, goal, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(1, n_steps + 1):
        g.add_gp_prior(i - 1, i, dt, Qc)
        g.add_obstacle(i, arm, sdf, cost_sigma, eps)
        for j in range(1, check_inter + 1):
            tau = j * (total_time / total_check)
            g.add_obstacle_gp(i - 1, i, arm, sdf, cost_sigma, eps, Qc, dt, tau)

    from gpmp2_jax.planner.traj_utils import init_traj_straight_line

    init = init_traj_straight_line(arm.space, start, goal, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    res = g.optimize(init, OptimizerParams(method="lm", max_iter=100,
                                           rel_thresh=1e-4))
    print(f"Final Error = {float(res.error):.4f}  "
          f"({int(res.iterations)} iterations, "
          f"converged={bool(res.converged)})")

    # collision check along the optimized support states (eps=0 hinge)
    worst = float(
        max(float(obstacle_factor_error(arm, sdf, res.traj.pose[i], 0.0).sum())
            for i in range(n_steps + 1))
    )
    print(f"max per-state collision cost (eps=0): {worst:.6f}")


if __name__ == "__main__":
    main()
