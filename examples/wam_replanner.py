"""WAM incremental replanning session.

Mirror of matlab/WAMReplannerExample.m / doc/ExampleReplanning.md:40-90:
batch-plan, hand the result to the incremental optimizer, execute part of
the trajectory, fix the executed state, change the goal mid-execution, and
re-solve incrementally.

Run: PYTHONPATH=. python examples/wam_replanner.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_3d_dataset, sdf_from_occupancy
from gpmp2_jax.planner import TrajOptimizerSetting, batch_traj_optimize
from gpmp2_jax.planner.isam2 import ISAM2TrajOptimizer
from gpmp2_jax.robots import generate_arm


def main():
    robot = generate_arm("WAMArm")
    print("building WAMDeskDataset + SDF ...")
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=5, opt_type="lm", max_iter=50, rel_thresh=1e-3,
        Qc=np.eye(7),
    )

    start = jnp.asarray([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2], jnp.float32)
    goal = jnp.asarray([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55], jnp.float32)
    zero = jnp.zeros(7, jnp.float32)

    # phase 1: batch plan
    res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
    print(f"batch: converged={bool(res.converged)} err={float(res.error):.2f}")

    # phase 2: incremental session
    opt = ISAM2TrajOptimizer(robot, sdf, setting)
    opt.init_factor_graph(start, zero, goal, zero)
    opt.init_values(res.traj)
    opt.update()

    # robot executes through state 5; fix it (WAMReplannerExample flow)
    executed = opt.values()
    opt.fix_config_and_vel(5, executed.pose[5], executed.vel[5])

    # new goal arrives mid-execution
    new_goal = jnp.asarray([0.3, 0.8, 0.1, 1.4, 0.0, -0.7, 1.3], jnp.float32)
    opt.change_goal_config_and_vel(new_goal, zero)
    opt.update()

    replanned = opt.values()
    print(f"replan:  err={float(opt.error):.2f}")
    print("fixed state drift:",
          float(jnp.linalg.norm(replanned.pose[5] - executed.pose[5])))
    print("new goal reach:",
          float(jnp.linalg.norm(replanned.pose[-1] - new_goal)))


if __name__ == "__main__":
    main()
