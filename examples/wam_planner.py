"""WAM 7-DOF planning in the WAMDeskDataset world.

Mirror of matlab/WAMPlannerExample.m:13-175 (the canonical benchmark
config): WAMDeskDataset -> EDT SDF -> WAMArm -> batch_traj_optimize with
total_time 2s, 10 steps, 100 collision-checked states, cost_sigma 0.02 ->
collision-cost check.

Run: PYTHONPATH=. python examples/wam_planner.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_3d_dataset, sdf_from_occupancy
from gpmp2_jax.planner import (
    TrajOptimizerSetting,
    batch_traj_optimize,
    collision_cost,
    interpolate_traj,
    make_problem,
)
from gpmp2_jax.robots import generate_arm
from gpmp2_jax.utils import Timer


def main():
    robot = generate_arm("WAMArm")

    print("building WAMDeskDataset + signed distance field ...")
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=9, opt_type="lm", max_iter=100, rel_thresh=1e-3,
        Qc=np.eye(7),
    )

    start = jnp.asarray([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2], jnp.float32)
    goal = jnp.asarray([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55], jnp.float32)
    zero = jnp.zeros(7, jnp.float32)

    timer = Timer("plan")
    timer.tic()
    res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
    timer.toc(res.error)
    timer.print()

    prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
    dense = interpolate_traj(robot.space, res.traj, jnp.eye(7), 0.2, 9)
    cc = float(collision_cost(prob, dense.pose))
    print(f"converged: {bool(res.converged)}  iters: {int(res.iterations)}")
    print(f"graph error: {float(res.error):.2f}  dense collision cost: {cc:.6f}")
    print("support configurations:")
    print(np.asarray(res.traj.pose).round(3))


if __name__ == "__main__":
    main()
