"""Fleet planning: thousands of problems across a device mesh.

No reference analog (the C++ library plans one problem per call; SURVEY.md
section 2.11): this is the capability the batched rebuild adds. B
randomized WAM problems shard over all available devices ('dp' axis); one
jitted solve runs the whole fleet to per-problem convergence.

Run: PYTHONPATH=. python examples/batch_fleet.py       # every local GPU
     JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         PYTHONPATH=. python examples/batch_fleet.py   # 8 virtual CPU devices
"""

import os
import time

import jax

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.parallel import make_mesh, shard_problems
from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
from gpmp2_jax.planner.batch import (
    infer_batch_axes,
    optimizer_params_from_setting,
    plan_batch,
)
from gpmp2_jax.planner.traj_utils import init_traj_straight_line
from gpmp2_jax.obstacle.sdf import SignedDistanceField
from gpmp2_jax.robots import generate_arm


def main():
    B = int(os.environ.get("FLEET_BATCH", "256"))
    robot = generate_arm("WAMArm")

    # analytic ball-world SDF (fast to build for the demo)
    grid, cell = 48, 2.4 / 47
    origin = np.array([-1.2, -1.2, -0.4])
    ax = origin[:, None] + cell * np.arange(grid)[None, :]
    Z, Y, X = np.meshgrid(ax[2], ax[1], ax[0], indexing="ij")
    dist = np.sqrt((X - 0.45) ** 2 + Y**2 + (Z - 0.6) ** 2) - 0.2
    sdf = SignedDistanceField(
        origin=jnp.asarray(origin, jnp.float32),
        cell_size=jnp.asarray(cell, jnp.float32),
        data=jnp.asarray(dist, jnp.float32),
    )

    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=5, opt_type="lm", max_iter=30, rel_thresh=1e-2,
        Qc=np.eye(7),
    )

    rng = np.random.default_rng(0)
    bs = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    bg = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    starts = jnp.asarray(bs + 0.05 * rng.normal(size=(B, 7)), jnp.float32)
    goals = jnp.asarray(bg + 0.05 * rng.normal(size=(B, 7)), jnp.float32)
    zeros = jnp.zeros((B, 7), jnp.float32)

    probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
    template = make_problem(robot, sdf, starts[0], zeros[0], goals[0], zeros[0], setting)
    axes = infer_batch_axes(probs, template)
    init = jax.vmap(
        lambda s, g: init_traj_straight_line(robot.space, s, g, 10, 2.0)
    )(starts, goals)

    mesh = make_mesh(axis_names=("dp",))
    print(f"devices: {len(jax.devices())}; mesh: {mesh}")
    probs, init = shard_problems(mesh, probs, init, axes)

    params = optimizer_params_from_setting(setting)
    solve = jax.jit(lambda p, t: plan_batch(p, t, params, axes))

    t0 = time.perf_counter()
    res = solve(probs, init)
    err = np.asarray(res.error)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve(probs, init)
    err = np.asarray(res.error)
    t_repeat = time.perf_counter() - t0

    conv = np.asarray(res.converged)
    print(f"{B} problems | compile+1st {t_first:.1f}s | repeat {t_repeat*1e3:.0f}ms "
          f"| {conv.sum()/t_repeat:.0f} plans/s")
    print(f"converged {conv.mean()*100:.1f}% | median err {np.median(err):.2f} "
          f"| result sharded over {len(res.traj.pose.sharding.device_set)} devices")


if __name__ == "__main__":
    main()
