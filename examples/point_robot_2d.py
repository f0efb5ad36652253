"""PointRobot 2D planning example.

Mirror of gpmp2_python/examples/PointRobotExample.py /
matlab/PointRobot2DFactorGraphExample.m: build the OneObstacleDataset
world, plan from (0,0)-ish to the far corner around the obstacle, plot.

Run: PYTHONPATH=. python examples/point_robot_2d.py [--plot out.png]
"""

import sys

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.kinematics import PointRobotFK, make_robot_model
from gpmp2_jax.planner import (
    TrajOptimizerSetting,
    batch_traj_optimize,
    collision_cost,
    interpolate_traj,
    make_problem,
)


def main():
    # dataset + SDF (OneObstacleDataset: 300x300 @ 0.01m, obstacle block
    # centered at cell (190, 160))
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    robot = make_robot_model(PointRobotFK(), [(0, 0.08, (0.0, 0.0, 0.0))])

    setting = TrajOptimizerSetting(
        dof=2, total_step=10, total_time=10.0, epsilon=0.2, cost_sigma=0.1,
        obs_check_inter=5, opt_type="lm", max_iter=100, rel_thresh=1e-5,
        Qc=np.eye(2),
    )

    start = jnp.asarray([-0.7, -0.7], jnp.float32)
    goal = jnp.asarray([1.7, 1.6], jnp.float32)  # free corner past the obstacle
    zero = jnp.zeros(2, jnp.float32)

    res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
    prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
    dense = interpolate_traj(robot.space, res.traj, jnp.eye(2), 1.0, 9)
    cc = float(collision_cost(prob, dense.pose))

    print(f"converged: {bool(res.converged)}  iters: {int(res.iterations)}")
    print(f"graph error: {float(res.error):.4f}  collision cost: {cc:.6f}")
    print("trajectory:")
    print(np.asarray(res.traj.pose).round(3))

    if "--plot" in sys.argv:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from gpmp2_jax.utils.plot import plot_evidence_map_2d

        fig, ax = plt.subplots(figsize=(6, 6))
        plot_evidence_map_2d(ax, ds.map, ds.origin_x, ds.origin_y, ds.cell_size)
        p = np.asarray(dense.pose)
        ax.plot(p[:, 0], p[:, 1], "b.-", markersize=3)
        sp = np.asarray(res.traj.pose)
        ax.plot(sp[:, 0], sp[:, 1], "ro", markersize=5)
        out = sys.argv[sys.argv.index("--plot") + 1]
        fig.savefig(out, dpi=120)
        print(f"saved {out}")


if __name__ == "__main__":
    main()
