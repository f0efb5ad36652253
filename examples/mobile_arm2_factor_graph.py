"""SE(2) mobile base + 2-link arm, factor graph assembled BY HAND.

Mirror of /root/reference/matlab/MobileArm2FactorGraphExample.m: MobileMap1
world, Pose2Vector (SE(2) x R^2) state, hand-built graph — Pose2Vector
priors, Lie GP priors, planar mobile-arm obstacle factors, vehicle
dynamics (sigma 0.001) — optimized with Gauss-Newton. The base drives from
(-1, 0, pi/2) to (1, 0, pi/2) around the block.

Run: PYTHONPATH=. python examples/mobile_arm2_factor_graph.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import FactorGraph, OptimizerParams
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.robots import generate_mobile_arm


def main():
    # MobileMap1 world (MobileArm2FactorGraphExample.m:9-17)
    ds = generate_2d_dataset("MobileMap1")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    # settings (lines 25-47); total_time_step reduced 50 -> 20 to keep the
    # example CI-fast — same world, same qualitative detour
    total_time, n_steps = 5.0, 20
    dt = total_time / n_steps
    marm = generate_mobile_arm("SimpleTwoLinksArm")
    space = marm.space  # SE(2) x R^2, dim 5
    Qc = np.eye(5)
    cost_sigma, eps = 0.1, 0.1
    dynamics_sigma = 0.001

    # Pose2Vector storage: (x, y, theta, q1, q2)
    start = jnp.asarray([-1.0, 0.0, np.pi / 2, 0.0, 0.0])
    goal = jnp.asarray([1.0, 0.0, np.pi / 2, 0.0, 0.0])
    zero = jnp.zeros(5)

    g = FactorGraph(space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(n_steps, goal, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(n_steps + 1):
        g.add_obstacle(i, marm, sdf, cost_sigma, eps)
        g.add_vehicle_dynamics(i, dynamics_sigma)
        if i > 0:
            g.add_gp_prior(i - 1, i, dt, Qc)

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
              f"conf=({p[3]: .3f}, {p[4]: .3f})")


if __name__ == "__main__":
    main()
