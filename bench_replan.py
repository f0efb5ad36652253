"""Incremental-replanning throughput (BASELINE config 5).

A fleet of B WAM replanning sessions (ISAM2BatchSessions): cold batch
solve, then R replanning rounds — each round every session pins its
executed state, perturbs its goal, and update() re-solves the whole fleet
warm-started in one chunk-jitted batched program.

Headline: session-updates per second per chip. Prints ONE JSON line.

Usage: python bench_replan.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from bench import WAM_GOAL, WAM_START


def wam_fleet(B, warm_iter=3, seed=0, sdf=None):
    """B WAM replanning sessions seeded from the straight-line init (not
    yet solved); returns (fleet, rng). `sdf` defaults to the
    WAMDeskDataset field."""
    import jax
    import jax.numpy as jnp

    from gpmp2_jax.datasets import generate_3d_dataset, sdf_from_occupancy
    from gpmp2_jax.planner import ISAM2BatchSessions, TrajOptimizerSetting
    from gpmp2_jax.planner.traj_utils import init_traj_straight_line
    from gpmp2_jax.robots import generate_arm

    dtype = jnp.float32
    robot = generate_arm("WAMArm", dtype=dtype)
    if sdf is None:
        ds = generate_3d_dataset("WAMDeskDataset")
        sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=dtype)
    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=5, opt_type="lm", max_iter=12, rel_thresh=1e-2,
        Qc=np.eye(7),
    )
    rng = np.random.default_rng(seed)
    starts = jnp.asarray(WAM_START + 0.05 * rng.normal(size=(B, 7)), dtype)
    goals = jnp.asarray(WAM_GOAL + 0.05 * rng.normal(size=(B, 7)), dtype)
    zeros = jnp.zeros((B, 7), dtype)
    # warm_iter 3: a warm update accepts ~2 steps; a straggler lane simply
    # improves further on its NEXT update
    fleet = ISAM2BatchSessions(robot, sdf, setting, batch=B,
                               warm_iter=warm_iter)
    fleet.init_factor_graph(starts, zeros, goals, zeros)
    fleet.init_values(jax.vmap(
        lambda s, g: init_traj_straight_line(
            robot.space, s, g, setting.total_step, setting.total_time)
    )(starts, goals))
    return fleet, rng


def replan_round(fleet, r, rng):
    """One replanning round over the whole fleet; returns update()'s
    result after its device work has finished."""
    import jax.numpy as jnp

    B = fleet._B
    dtype = fleet._probs.end_pose.dtype
    traj = fleet.values()
    state_idx = 1 + (r % 3)
    fleet.fix_config_and_vel(
        np.full(B, state_idx), traj.pose[:, state_idx],
        traj.vel[:, state_idx])
    if r % 2 == 0:
        # measurement fusion every other round: fuse a noisy observed
        # state at the following support state (the receding-horizon
        # consumer's add_state_estimate path,
        # ISAM2TrajOptimizer-inl.h:186-195, lane-wise)
        meas_idx = state_idx + 1
        meas_pose = traj.pose[:, meas_idx] + jnp.asarray(
            0.01 * rng.normal(size=(B, 7)), dtype)
        meas_vel = traj.vel[:, meas_idx] + jnp.asarray(
            0.01 * rng.normal(size=(B, 7)), dtype)
        fleet.add_state_estimate(
            np.full(B, meas_idx), meas_pose, 1e-4 * np.ones(7),
            meas_vel, 1e-4 * np.ones(7))
    dg = jnp.asarray(0.02 * rng.normal(size=(B, 7)), dtype)
    fleet.change_goal_config_and_vel(
        fleet._probs.end_pose + dg, jnp.zeros((B, 7), dtype))
    out = fleet.update()
    out.error.block_until_ready()
    return out


def main():
    import jax
    import jax.numpy as jnp

    from gpmp2_jax.compile_cache import configure_compile_cache

    configure_compile_cache()
    B = int(os.environ.get("BENCH_BATCH", "1024"))
    ROUNDS = int(os.environ.get("BENCH_ROUNDS", "8"))
    warm_iter = int(os.environ.get("BENCH_WARM_ITER", "3"))
    fleet, rng = wam_fleet(B, warm_iter=warm_iter)

    # warm-up: first update compiles the fleet program AND converges the
    # fleet cold from the straight-line init; second stabilizes the warm
    # regime the timed rounds measure
    print("warm-up updates (compile + cold converge) ...", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    fleet.update().error.block_until_ready()
    compile_s = time.perf_counter() - t0
    replan_round(fleet, 0, rng)
    print(f"warm-up done in {compile_s:.1f}s", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    for r in range(1, ROUNDS + 1):
        out = replan_round(fleet, r, rng)
    wall = time.perf_counter() - t0

    updates_per_sec = B * ROUNDS / wall
    conv = float(jnp.mean(out.converged.astype(jnp.float32)))
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "wam7_session_updates_per_sec_per_chip",
        "value": round(updates_per_sec, 1),
        "unit": "updates/s",
        "batch": B,
        "rounds": ROUNDS,
        "round_ms": round(1e3 * wall / ROUNDS, 2),
        "compile_s": round(compile_s, 1),
        "converged_frac": round(conv, 4),
        "mean_iters": round(float(jnp.mean(out.iterations.astype(jnp.float32))), 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
