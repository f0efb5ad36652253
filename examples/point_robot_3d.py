"""3-DOF point robot (SE(2) mobile base) on the multi-obstacle 2D world.

Mirror of /root/reference/gpmp2_python/examples/pointRobot3FactorExample.py:
a Pose2MobileBase "point robot" (the reference's Pose2MobileBaseModel with
one r=1.5 sphere), vehicle-dynamics factor at every state, Lie GP priors,
planar obstacle factors + GP-interpolated factors, Dogleg optimization
from (0,0,0) to (17,17,0) across the MultiObstacleDataset.

Run: PYTHONPATH=. python examples/point_robot_3d.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import (
    FactorGraph,
    OptimizerParams,
    Pose2MobileBaseFK,
    make_robot_model,
)
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy


def main():
    # MultiObstacleDataset world (pointRobot3FactorExample.py:12-22)
    ds = generate_2d_dataset("MultiObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    # settings (lines 30-60); 50 -> 25 steps keeps CI-fast with the same
    # qualitative path
    total_time, n_steps, check_inter = 10.0, 25, 0
    dt = total_time / n_steps
    robot = make_robot_model(Pose2MobileBaseFK(), [(0, 1.5, (0.0, 0.0, 0.0))])
    space = robot.space  # SE(2)
    Qc = np.eye(3)
    cost_sigma, eps = 0.005, 1.5

    start = jnp.asarray([0.0, 0.0, 0.0])
    goal = jnp.asarray([17.0, 17.0, 0.0])
    zero = jnp.zeros(3)

    g = FactorGraph(space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(n_steps, goal, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(n_steps + 1):
        g.add_vehicle_dynamics(i, cost_sigma)
        if i > 0:
            g.add_gp_prior(i - 1, i, dt, Qc)
            g.add_obstacle(i, robot, sdf, cost_sigma, eps)
            for j in range(1, check_inter + 1):
                tau = j * dt / (check_inter + 1)
                g.add_obstacle_gp(i - 1, i, robot, sdf, cost_sigma, eps,
                                  Qc, dt, tau)

    from gpmp2_jax.planner.traj_utils import init_traj_straight_line

    init = init_traj_straight_line(space, start, goal, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    res = g.optimize(init, OptimizerParams(method="dogleg", max_iter=100,
                                           rel_thresh=1e-5))
    print(f"Final Error = {float(res.error):.4f}  "
          f"({int(res.iterations)} iterations, "
          f"converged={bool(res.converged)})")
    for i in range(0, n_steps + 1, 5):
        p = np.asarray(res.traj.pose[i])
        v = np.asarray(res.traj.vel[i])
        print(f"  x_{i}: ({p[0]: .2f}, {p[1]: .2f}, {p[2]: .2f})  "
              f"v=({v[0]: .2f}, {v[1]: .2f}, {v[2]: .2f})")


if __name__ == "__main__":
    main()
