"""Three-link planar arm, factor graph assembled BY HAND.

Mirror of /root/reference/matlab/Arm3FactorGraphExample.m: build the
TwoObstaclesDataset world, then assemble the graph factor by factor
through the public FactorGraph API (start/goal priors, GP priors per
interval, planar obstacle factors per state, GP-interpolated obstacle
factors) and hand it to the Gauss-Newton optimizer — exactly the
reference script's manual NonlinearFactorGraph push loop
(Arm3FactorGraphExample.m:74-122). --dogleg switches to the trust-region
optimizer (lines 140-152).

Run: PYTHONPATH=. python examples/arm3_factor_graph.py [--dogleg]
"""

import sys

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import FactorGraph, OptimizerParams, generate_arm
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def main():
    # dataset + SDF (Arm3FactorGraphExample.m:13-27)
    ds = generate_2d_dataset("TwoObstaclesDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    # settings (lines 30-58)
    total_time, n_steps, total_check = 5.0, 10, 50
    dt = total_time / n_steps
    check_inter = total_check // n_steps - 1
    arm = generate_arm("SimpleThreeLinksArm")
    Qc = np.eye(3)
    cost_sigma, eps = 0.1, 0.1

    start = jnp.asarray([0.0, 0.0, 0.0])
    goal = jnp.asarray([0.9, np.pi / 2 - 0.9, 0.0])
    zero = jnp.zeros(3)

    # manual graph assembly (lines 74-122)
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

    init = init_traj_straight_line(arm.space, start, goal, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")

    # GaussNewton by default, Dogleg with --dogleg (lines 140-152)
    method = "dogleg" if "--dogleg" in sys.argv else "gaussnewton"
    res = g.optimize(init, OptimizerParams(method=method, max_iter=100,
                                           rel_thresh=1e-5))
    print(f"Final Error = {float(res.error):.4f}  "
          f"({int(res.iterations)} iterations, method={method}, "
          f"converged={bool(res.converged)})")
    for i in range(n_steps + 1):
        q = np.asarray(res.traj.pose[i])
        print(f"  x_{i}: [{q[0]: .4f}, {q[1]: .4f}, {q[2]: .4f}]")


if __name__ == "__main__":
    main()
