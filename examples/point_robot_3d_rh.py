"""Receding-horizon 3-DOF point robot: replan from the current state until
the goal region is reached.

Mirror of /root/reference/gpmp2_python/examples/pointRobot3FactorExample_rh.py:
a short-horizon plan (5 steps / 2.5 s) is rebuilt every control cycle from
the robot's current state; the goal prior's sigma scales with the
remaining distance (sigma_goal * |x - goal| / initial distance, lines
222-235) so far-away goals pull softly and the final approach pins hard;
the robot "executes" to state 1 of each plan and replans.

Run: PYTHONPATH=. python examples/point_robot_3d_rh.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax import (
    FactorGraph,
    OptimizerParams,
    PointRobotFK,
    make_robot_model,
)
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def plan_window(space, robot, sdf, cur_pose, cur_vel, goal, goal_sigma,
                n_steps, total_time, check_inter, Qc, cost_sigma, eps):
    """One fixed-window plan (the reference's get_plan, lines 12-70):
    hard prior on the current state, distance-scaled goal prior, GP +
    obstacle factors over the short horizon."""
    dt = total_time / n_steps
    zero = jnp.zeros(space.dim)
    g = FactorGraph(space, n_steps + 1)
    g.add_prior_pose(0, cur_pose, 1e-4)
    g.add_prior_vel(0, cur_vel if cur_vel is not None else zero, 1e-4)
    g.add_prior_pose(n_steps, goal, goal_sigma)
    g.add_prior_vel(n_steps, zero, goal_sigma)
    for i in range(n_steps + 1):
        if i > 0:
            g.add_gp_prior(i - 1, i, dt, Qc)
            g.add_obstacle(i, robot, sdf, cost_sigma, eps)
            for j in range(1, check_inter + 1):
                tau = j * dt / (check_inter + 1)
                g.add_obstacle_gp(i - 1, i, robot, sdf, cost_sigma, eps,
                                  Qc, dt, tau)
    # reference window init: every state AT the current pose with the
    # average velocity toward the goal (get_plan, lines 29-32) — avoids the
    # overshoot a straight-line init causes on short horizons
    from gpmp2_jax.planner import Trajectory

    avg_vel = space.local(cur_pose, goal) / total_time
    init = Trajectory(
        jnp.tile(cur_pose[None], (n_steps + 1, 1)),
        jnp.tile(avg_vel[None], (n_steps + 1, 1)),
    )
    return g.optimize(init, OptimizerParams(method="dogleg", max_iter=60,
                                            rel_thresh=1e-4))


def main():
    ds = generate_2d_dataset("MultiObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    # the reference's PointRobot(3, 1): 3-dof vector state (x, y, theta),
    # FK uses only (x, y)
    robot = make_robot_model(PointRobotFK(dof=3), [(0, 1.5, (0.0, 0.0, 0.0))])
    space = robot.space

    # Parameters (pointRobot3FactorExample_rh.py:131-170)
    n_steps, total_time, check_inter = 5, 2.5, 1
    Qc = np.eye(3)
    cost_sigma, eps = 0.2, 4.0
    goal_region_threshold = 0.5
    sigma_goal = 1.0

    cur = jnp.asarray([0.0, 0.0, 0.0])
    cur_vel = jnp.zeros(3)
    goal = jnp.asarray([17.0, 14.0, 0.1])
    init_distance = float(jnp.linalg.norm(cur - goal))

    # Note on termination: with the reference's own numbers the goal sits
    # ~2.6 m from an obstacle while eps_total = eps + robot radius = 5.5 m,
    # so the hinge holds a standoff equilibrium ~3 m out — the reference
    # demo (an interactive plot loop with `while dist > 0.1`) never
    # actually ends. This mirror runs the same replanning loop and exits
    # when either the goal region is reached or the fleet settles.
    prev = cur
    settled = 0
    for cycle in range(40):
        dist = float(jnp.linalg.norm((cur - goal)[:2]))
        if dist <= goal_region_threshold:
            print(f"goal region reached after {cycle} cycles")
            break
        goal_sigma = max(sigma_goal * dist / init_distance, 1e-3)
        res = plan_window(space, robot, sdf, cur, cur_vel, goal, goal_sigma,
                          n_steps, total_time, check_inter, Qc, cost_sigma,
                          eps)
        # "execute" to state 1 of the plan (get_robot_state, line 173)
        prev, cur = cur, res.traj.pose[1]
        cur_vel = res.traj.vel[1]
        print(f"cycle {cycle:2d}: at ({float(cur[0]):6.2f}, "
              f"{float(cur[1]):6.2f}, {float(cur[2]):5.2f})  "
              f"dist {dist:6.2f}  err {float(res.error):.3f}")
        step = float(jnp.linalg.norm((cur - prev)[:2]))
        settled = settled + 1 if step < 0.02 else 0
        if settled >= 3:
            print(
                f"settled after {cycle + 1} cycles at standoff "
                f"{dist:.2f} m (goal inside the eps_total={eps + 1.5:.1f} m "
                f"hinge region of an obstacle — equilibrium, as in the "
                f"reference demo)"
            )
            break
    else:
        raise SystemExit("replanner neither reached the goal nor settled")


if __name__ == "__main__":
    main()
