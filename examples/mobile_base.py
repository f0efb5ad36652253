"""SE(2) mobile base planning with vehicle dynamics.

Mirror of matlab/MobileBaseFactorGraphExample.m: MobileMap1 world, SE(2)
base with the Lie-group GP prior and the nonholonomic vehicle-dynamics
factor (no sideways sliding), planned through a doorway-like map.

Run: PYTHONPATH=. python examples/mobile_base.py
"""

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.planner import (
    TrajOptimizerSetting,
    batch_traj_optimize,
    collision_cost,
    make_problem,
)
from gpmp2_jax.robots import generate_mobile_base


def main():
    ds = generate_2d_dataset("MobileMap1")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    robot = generate_mobile_base()

    setting = TrajOptimizerSetting(
        dof=3, total_step=15, total_time=15.0, epsilon=0.2, cost_sigma=0.01,
        obs_check_inter=3, opt_type="lm", max_iter=100, rel_thresh=1e-4,
        Qc=np.eye(3),
    )

    start = jnp.asarray([-3.0, -3.0, 0.0], jnp.float32)  # [x, y, theta]
    goal = jnp.asarray([3.0, 3.0, np.pi / 2], jnp.float32)
    zero = jnp.zeros(3, jnp.float32)

    res = batch_traj_optimize(
        robot, sdf, start, zero, goal, zero, setting,
        flag_vehicle_dynamics=True, dyn_sigma=0.001,
    )
    prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
    cc = float(collision_cost(prob, res.traj.pose))
    print(f"converged: {bool(res.converged)}  iters: {int(res.iterations)}")
    print(f"graph error: {float(res.error):.3f}  collision cost: {cc:.6f}")
    traj = np.asarray(res.traj.pose)
    vels = np.asarray(res.traj.vel)
    print("poses (x, y, theta):")
    print(traj.round(3))
    # nonholonomy check: body-frame sideways velocity ~ 0
    print("max |v_y| (body frame):", float(np.abs(vels[:, 1]).max()))


if __name__ == "__main__":
    main()
