"""Headline benchmark: WAM 7-DOF converged plans/sec on one GPU.

Config mirrors the canonical WAM benchmark (BASELINE.md /
matlab/WAMPlannerExample.m:13-66): 7-DOF WAM, the WAMDeskDataset 3D world
(300^3 occupancy -> EDT SDF), total_time 2 s, total_step 10,
obs_check_inter 9 (100 collision-checked states per trajectory),
cost_sigma 0.02, epsilon 0.2, Qc = I, prior sigma 1e-4, LM with the
reference's lambda schedule to convergence (rel 1e-2).

Protocol: B randomized start/goal problems (small perturbations of the
example's start/goal configs) batched into ONE chunked LM solve, timed
submit -> host materialization of results, best of R repeats after a
compile warm-up.

Baseline denominator: tools/oracle/gpmp2_oracle.cpp, a single-threaded C++
re-implementation of the reference's exact WAM benchmark path (same graph
recipe, GTSAM LM iterate() semantics, analytic FK Jacobians,
block-tridiagonal elimination) running THIS protocol's randomized plans.
The reference itself cannot be built here (requires GTSAM; see
BASELINE.md). 355.6 converged plans/s (2.81 ms/plan, n=512, -O3
-march=native; BASELINE_MEASURED.json) was measured on the CPU of an
earlier development host, not on the GPU machine's host, so vs_baseline
compares across machines until the oracle is re-run there.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
"""

import dataclasses
import json
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# start/goal of WAMPlannerExample.m:32-33
WAM_START = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
WAM_GOAL = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
# single-thread C++ oracle throughput (BASELINE_MEASURED.json; measured on
# an earlier development host's CPU)
BASELINE_PLANS_PER_SEC = 355.6


def wam_bench_problem(B, *, sdf=None, sdf_pack=None, chunk=9, tail=3,
                      loop="chunked", seed=0):
    """The benchmark's B WAM problems, ready for `plan_batch`.

    Returns a namespace with robot, sdf, setting, probs, axes, init,
    params (the chunk schedule below), starts and goals. `sdf` defaults to
    the WAMDeskDataset field; `sdf_pack=None` corner-packs it (864 MB
    table) as the planner does by default.
    """
    import jax
    import jax.numpy as jnp

    from gpmp2_jax.datasets import generate_3d_dataset, sdf_from_occupancy
    from gpmp2_jax.obstacle.factors import obstacle_factor_error
    from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
    from gpmp2_jax.planner.batch import (
        infer_batch_axes,
        optimizer_params_from_setting,
    )
    from gpmp2_jax.planner.traj_utils import init_traj_straight_line
    from gpmp2_jax.robots import generate_arm

    dtype = jnp.float32
    robot = generate_arm("WAMArm", dtype=dtype)
    if sdf is None:
        ds = generate_3d_dataset("WAMDeskDataset")
        sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=dtype)
    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=9, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(7),
    )

    # small per-problem noise around the example's start/goal;
    # rejection-sample so every problem's pinned endpoints are
    # collision-free (goal configs reach over the desk — ~40% of raw
    # 0.05-rad perturbations collide, and those are unplannable)
    rng = np.random.default_rng(seed)
    endpoint_err = jax.jit(jax.vmap(
        lambda q: obstacle_factor_error(robot, sdf, q, 0.0).sum()))

    def sample_feasible(base, n):
        out = []
        while len(out) < n:
            cand = base + 0.05 * rng.normal(size=(2 * n, 7))
            ok = np.asarray(endpoint_err(jnp.asarray(cand, dtype))) < 1e-6
            out.extend(cand[ok][: n - len(out)])
        return np.stack(out)

    starts = jnp.asarray(sample_feasible(WAM_START, B), dtype)
    goals = jnp.asarray(sample_feasible(WAM_GOAL, B), dtype)
    zeros = jnp.zeros((B, 7), dtype)
    probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting,
                         sdf_pack=sdf_pack)
    template = make_problem(robot, sdf, starts[0], zeros[0], goals[0],
                            zeros[0], setting, sdf_pack=sdf_pack)
    axes = infer_batch_axes(probs, template)
    init = jax.vmap(
        lambda s, g: init_traj_straight_line(
            robot.space, s, g, setting.total_step, setting.total_time)
    )(starts, goals)
    # chunk schedule 9 + tail 3: the first chunk covers the typical
    # accepted + rejected attempts, stragglers compact and mop up in short
    # chunks. Chosen on the previous accelerator; not re-tuned on the GPU.
    params = dataclasses.replace(
        optimizer_params_from_setting(setting), loop=loop,
        chunk_size=chunk, tail_chunk=tail)
    return SimpleNamespace(robot=robot, sdf=sdf, setting=setting,
                           probs=probs, axes=axes, init=init, params=params,
                           starts=starts, goals=goals)


def main():
    import jax
    import jax.numpy as jnp

    from gpmp2_jax.compile_cache import configure_compile_cache
    from gpmp2_jax.planner.batch import plan_batch
    from gpmp2_jax.planner.problem import Trajectory, collision_cost
    from gpmp2_jax.solver.optimize import _gather_data

    configure_compile_cache()
    B = int(os.environ.get("BENCH_BATCH", "2048"))
    REPEATS = int(os.environ.get("BENCH_REPEATS", "3"))
    LOOP = os.environ.get("BENCH_LOOP", "chunked")
    wb = wam_bench_problem(
        B, loop=LOOP, chunk=int(os.environ.get("BENCH_CHUNK", "9")),
        tail=int(os.environ.get("BENCH_TAIL", "3")))
    probs, axes, init = wb.probs, wb.axes, wb.init
    params = dataclasses.replace(
        wb.params,
        tail_growth=float(os.environ.get("BENCH_TAILGROWTH", "1.0")),
        lambda_init=float(os.environ.get("BENCH_LAMBDA0", "100.0")),
    )
    cc_fn = jax.vmap(collision_cost, in_axes=(axes, 0))
    cc_jit = jax.jit(cc_fn)

    if LOOP == "chunked":
        # host-driven: plan_batch manages its own jitted chunks; wrapping it
        # in jit would degrade it to the static schedule
        def solve(p, t):
            res = plan_batch(p, t, params, axes)
            return res, cc_jit(p, res.traj.pose)
    else:
        @jax.jit
        def solve(p, t):
            res = plan_batch(p, t, params, axes)
            return res, cc_fn(p, res.traj.pose)

    def run_once():
        t0 = time.perf_counter()
        res, cc = solve(probs, init)
        # ONE device_get fetches all five result arrays
        err, iters, conv, gave, ccn = jax.device_get(
            (res.error, res.iterations, res.converged, res.gave_up, cc))
        return time.perf_counter() - t0, err, iters, conv, gave, ccn

    t_compile, *_ = run_once()
    times = []
    for _ in range(REPEATS):
        t, err, iters, conv, gave, ccn = run_once()
        times.append(t)
    t_solve = min(times)

    # a lane that STOPPED (lambda blow-up / non-finite step) is gave_up,
    # not converged, and never counts toward the headline
    converged = int((conv & ~gave).sum())
    collision_free = ccn < 1e-4
    good = conv & ~gave & collision_free
    plans_per_sec = int(good.sum()) / t_solve

    # warm single-plan latency: the reference's own use case (RSS'16 /
    # WAMPlannerExample.m) is ONE plan at a time. One chunked solve at B=1
    # and B=32, timed submit -> host materialization.
    def warm_latency_ms(b):
        probs_b = _gather_data(probs, axes, jnp.arange(b))
        init_b = Trajectory(init.pose[:b], init.vel[:b])

        def once():
            t0 = time.perf_counter()
            res = plan_batch(probs_b, init_b, params, axes)
            jax.device_get((res.error, res.converged))
            return (time.perf_counter() - t0) * 1e3

        once()  # compile warm-up for this batch shape
        return min(once() for _ in range(max(REPEATS, 3)))

    lat1 = warm_latency_ms(1)
    lat32 = warm_latency_ms(32)
    dev = jax.devices()[0]
    out = {
        "metric": "wam7_converged_plans_per_sec_per_chip",
        "value": round(plans_per_sec, 1),
        "unit": "plans/s",
        "vs_baseline": round(plans_per_sec / BASELINE_PLANS_PER_SEC, 2),
        "batch": B,
        "loop": LOOP,
        "converged_frac": round(converged / B, 4),
        "gave_up_frac": round(float(gave.mean()), 4),
        "collision_free_frac": round(float(collision_free.mean()), 4),
        "solve_time_s": round(t_solve, 4),
        "latency_b1_ms": round(lat1, 1),
        "latency_b32_ms": round(lat32, 1),
        "compile_s": round(t_compile, 1),
        "mean_iters": round(float(iters.mean()), 2),
        "median_err": round(float(np.median(err)), 4),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
