"""SE(2) mobile base + TWO 2-link arms, factor graph assembled BY HAND.

Mirror of /root/reference/matlab/Mobile2ArmsFactorGraphExample.m:
MobileMap1 world, Pose2Vector (SE(2) x R^4) state via the SimpleTwoArms
preset, hand-built graph with Lie GP priors, planar obstacle factors and
GP-interpolated obstacle factors (check_inter 0 in the reference's 50-step
config; here 1 per interval at 20 steps for the same total check count),
Gauss-Newton solve. Base drives (-2, 2, -pi/2) -> (2, -1, pi/2).

Run: PYTHONPATH=. python examples/mobile_2arms_factor_graph.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import FactorGraph, OptimizerParams
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.robots import generate_mobile_arm


def main():
    ds = generate_2d_dataset("MobileMap1")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    # settings (Mobile2ArmsFactorGraphExample.m:25-49); 50 -> 20 steps with
    # 1 interpolated check per interval keeps the check density while
    # staying CI-fast
    total_time, n_steps, check_inter = 5.0, 20, 1
    dt = total_time / n_steps
    marm = generate_mobile_arm("SimpleTwoArms")
    space = marm.space  # SE(2) x R^4, dim 7
    Qc = np.eye(7)
    cost_sigma, eps = 0.5, 0.5

    # Pose2Vector storage: (x, y, theta, q1..q4)
    start = jnp.asarray([-2.0, 2.0, -np.pi / 2, 0.0, 0.0, 0.0, 0.0])
    goal = jnp.asarray([2.0, -1.0, np.pi / 2, 0.0, 0.0, 0.0, 0.0])
    zero = jnp.zeros(7)

    g = FactorGraph(space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(n_steps, goal, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(n_steps + 1):
        g.add_obstacle(i, marm, sdf, cost_sigma, eps)
        if i > 0:
            g.add_gp_prior(i - 1, i, dt, Qc)
            for j in range(1, check_inter + 1):
                tau = j * dt / (check_inter + 1)
                g.add_obstacle_gp(i - 1, i, marm, sdf, cost_sigma, eps,
                                  Qc, dt, tau)

    from gpmp2_jax.planner.traj_utils import init_traj_straight_line

    init = init_traj_straight_line(space, start, goal, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    res = g.optimize(init, OptimizerParams(method="gaussnewton",
                                           max_iter=100, rel_thresh=1e-5))
    print(f"Final Error = {float(res.error):.4f}  "
          f"({int(res.iterations)} iterations, "
          f"converged={bool(res.converged)})")
    for i in range(0, n_steps + 1, 4):
        p = np.asarray(res.traj.pose[i])
        print(f"  x_{i}: base=({p[0]: .3f}, {p[1]: .3f}, {p[2]: .3f}) "
              f"arms=({p[3]: .2f}, {p[4]: .2f} | {p[5]: .2f}, {p[6]: .2f})")


if __name__ == "__main__":
    main()
