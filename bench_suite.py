"""Full benchmark suite over the BASELINE.md configs.

For each config this measures TWO things and prints ONE JSON line:

  - quality on the EXACT 512-problem set that the measured C++ oracle
    solves (tools/oracle/suite_dump.py + gpmp2_oracle_suite.cpp): the
    framework's converged / collision-free fractions print next to the
    oracle's own on the identical problems (BASELINE_MEASURED_SUITE.json),
    so a low fraction is attributable to the problem set, not the solver.
  - throughput at a per-config batch size big enough to load the device
    (tiny 2D problems at B=512 leave an accelerator mostly idle; the C++
    baseline cost is per-plan and independent of batching). Fresh draws
    from the same distribution (seed 1). vs_baseline = good plans/s
    divided by the oracle's plans/s, measured on an earlier development
    host's CPU (BASELINE_MEASURED_SUITE.json), not on the GPU machine.

Configs:
  1. PointRobot2D    - 2-DOF point robot, OneObstacleDataset SDF, LM
  2. MobileBase SE2  - Lie GP prior + vehicle dynamics, MobileMap1
  3. Arm3 planar     - 3-link arm, joint+velocity limits
  4. WAM 7-DOF 3D    - (bench.py's config; unfiltered endpoints here)
  5. Multi-world     - per-problem SDF worlds (randomized discs)

Usage: python bench_suite.py [--cpu]   (prints one JSON line per config)
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")


def _oracle_baselines():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED_SUITE.json")
    try:
        with open(path) as f:
            return json.load(f)["configs"]
    except Exception:
        return {}


def run_config(name, robot, sdf, starts, goals, setting, *, thru_B,
               thru_starts, thru_goals, thru_sdf=None, oracle=None,
               chunk=None, tail=None, **problem_kwargs):
    """Quality on the exact (512) set + throughput at thru_B. `sdf` may be
    per-problem (MultiWorld); `thru_sdf` overrides it for the throughput
    batch."""
    import jax
    import jax.numpy as jnp

    from gpmp2_jax.planner import make_problem
    from gpmp2_jax.planner.batch import (
        infer_batch_axes,
        optimizer_params_from_setting,
        plan_batch,
    )
    from gpmp2_jax.planner.problem import collision_cost
    from gpmp2_jax.planner.traj_utils import init_traj_straight_line

    dtype = jnp.float32
    space = robot.space
    template_sdf = problem_kwargs.pop("template_sdf", sdf)
    # chunk 12 + ONE long (16-step) compacted tail chunk: the convergence
    # tail is long (MultiWorld: last lane converges at attempt 25) but
    # tiny after compaction, and every chunk boundary costs a host round
    # trip, so the whole tail runs in one compacted dispatch. Chosen on
    # the previous accelerator; not re-tuned on the GPU.
    # per-config overrides (chunk/tail args) beat the env/default: the
    # right tail depends on the per-step cost after compaction and the
    # convergence profile — Arm3's tail stays near full batch for many
    # attempts, so unconditional long tails overrun there, while the
    # fast-converging configs want one long compacted tail dispatch.
    params = dataclasses.replace(
        optimizer_params_from_setting(setting),
        chunk_size=(chunk if chunk is not None
                    else int(os.environ.get("SUITE_CHUNK", "12"))),
        tail_chunk=(tail if tail is not None
                    else int(os.environ.get("SUITE_TAIL", "16"))),
    )
    # quality pass: f64 give-up rescue ON (the oracle denominators run
    # GTSAM-semantics in double precision throughout; rescue_f64 is the
    # framework's equivalent for the hard tail).
    # The throughput pass stays rescue-free: the rescue's host round trip
    # would be charged to plans/s, and the q512 columns are the
    # like-for-like quality comparison.
    rescue = os.environ.get("SUITE_RESCUE", "1") != "0"
    params_q = dataclasses.replace(params, rescue_f64=rescue)

    def solve_set(this_sdf, s, g, params=params):
        B = s.shape[0]
        zeros = jnp.zeros((B, space.dim), dtype)
        probs = make_problem(robot, this_sdf, s, zeros, g, zeros, setting,
                             **problem_kwargs)
        template = make_problem(
            robot, template_sdf, s[0], zeros[0], g[0], zeros[0],
            setting, **problem_kwargs,
        )
        axes = infer_batch_axes(probs, template)
        init = jax.vmap(
            lambda a, b: init_traj_straight_line(
                space, a, b, setting.total_step, setting.total_time
            )
        )(probs.start_pose, probs.end_pose)
        cc_jit = jax.jit(jax.vmap(collision_cost, in_axes=(axes, 0)))

        def run():
            t0 = time.perf_counter()
            res = plan_batch(probs, init, params, axes)
            cc = cc_jit(probs, res.traj.pose)
            # ONE device_get for all result arrays: each separate
            # np.asarray pays a host round trip of its own
            err, ccn, gave, iters, convr = jax.device_get(
                (res.error, cc, res.gave_up, res.iterations, res.converged))
            conv = convr & ~gave
            return time.perf_counter() - t0, err, conv, ccn, gave, iters

        t_compile, *_ = run()
        best = np.inf
        # min of 3: the small configs solve in a fraction of a second,
        # where host round trips add run-to-run jitter
        for _ in range(3):
            t, err, conv, ccn, gave, iters = run()
            best = min(best, t)
        return best, t_compile, err, conv, ccn, gave, iters

    # quality on the exact oracle problem set
    _, _, err_q, conv_q, cc_q, gave_q, iters_q = solve_set(
        sdf, starts, goals, params=params_q)
    # throughput at the big batch
    t_thru, t_compile, err_t, conv_t, cc_t, gave_t, iters_t = solve_set(
        thru_sdf if thru_sdf is not None else sdf, thru_starts, thru_goals)

    good_t = conv_t & (cc_t < 1e-4)
    plans_per_sec = int(good_t.sum()) / t_thru
    out = {
        "config": name,
        "plans_per_sec": round(plans_per_sec, 1),
        "batch": int(thru_starts.shape[0]),
        "solve_s": round(t_thru, 4),
        "compile_s": round(t_compile, 1),
        "converged_frac": round(float(conv_t.mean()), 4),
        "gave_up_frac": round(float(gave_t.mean()), 4),
        "collision_free_frac": round(float((cc_t < 1e-4).mean()), 4),
        "mean_iters": round(float(iters_t.mean()), 2),
        # like-for-like quality on the oracle's exact 512 problems
        "q512_converged_frac": round(float(conv_q.mean()), 4),
        "q512_collision_free_frac": round(float((cc_q < 1e-4).mean()), 4),
        "q512_rescue_f64": rescue,
    }
    if oracle:
        out["vs_baseline"] = round(plans_per_sec / oracle["plans_per_sec"], 2)
        out["oracle_plans_per_sec"] = oracle["plans_per_sec"]
        out["oracle_q512_converged_frac"] = round(oracle["converged"] / 512, 4)
        out["oracle_q512_collision_free_frac"] = round(
            oracle["collision_free"] / 512, 4)
    print(json.dumps(out), flush=True)
    return out


def main():
    import jax
    import jax.numpy as jnp

    from gpmp2_jax.compile_cache import configure_compile_cache

    configure_compile_cache()

    from gpmp2_jax.datasets import (
        generate_2d_dataset,
        generate_3d_dataset,
        planar_sdf_from_occupancy,
        sdf_from_occupancy,
    )
    from gpmp2_jax.kinematics import PointRobotFK, make_robot_model
    from gpmp2_jax.obstacle.sdf import PlanarSDF
    from gpmp2_jax.planner import TrajOptimizerSetting
    from gpmp2_jax.robots import generate_arm, generate_mobile_base

    B = int(os.environ.get("SUITE_BATCH", "512"))
    dtype = jnp.float32
    rng = np.random.default_rng(0)   # exact oracle problem sets
    rng_t = np.random.default_rng(1)  # throughput batches, same distribution
    oracles = _oracle_baselines()

    def tb(name, default):
        return int(os.environ.get(name, str(default)))

    # ---- 1. PointRobot2D ------------------------------------------------
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf2 = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    robot = make_robot_model(PointRobotFK(), [(0, 0.08, (0.0, 0.0, 0.0))])
    setting = TrajOptimizerSetting(
        dof=2, total_step=10, total_time=10.0, cost_sigma=0.1,
        obs_check_inter=5, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(2),
    )
    def draw_pr(r, n):
        s = np.stack([r.uniform(-0.9, -0.5, n), r.uniform(-0.9, 0.0, n)], -1)
        g = np.stack([r.uniform(1.4, 1.8, n), r.uniform(1.2, 1.8, n)], -1)
        return jnp.asarray(s, dtype), jnp.asarray(g, dtype)
    starts, goals = draw_pr(rng, B)
    Bt = tb("SUITE_B_POINT", 16384)
    ts, tg = draw_pr(rng_t, Bt)
    run_config("PointRobot2D", robot, sdf2, starts, goals, setting,
               thru_B=Bt, thru_starts=ts, thru_goals=tg,
               oracle=oracles.get("PointRobot2D"))

    # ---- 2. MobileBase SE(2) + vehicle dynamics -------------------------
    dsm = generate_2d_dataset("MobileMap1")
    sdfm = planar_sdf_from_occupancy(dsm.origin, dsm.cell_size, dsm.map)
    base = generate_mobile_base()
    setting_m = TrajOptimizerSetting(
        dof=3, total_step=15, total_time=15.0, cost_sigma=0.01,
        obs_check_inter=3, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(3),
    )
    def draw_mb(r, n):
        s = np.stack([r.uniform(-3.5, -2.5, n), r.uniform(-3.5, -2.5, n),
                      r.uniform(-0.5, 0.5, n)], -1)
        g = np.stack([r.uniform(2.5, 3.5, n), r.uniform(2.5, 3.5, n),
                      r.uniform(1.0, 2.0, n)], -1)
        return jnp.asarray(s, dtype), jnp.asarray(g, dtype)
    starts_m, goals_m = draw_mb(rng, B)
    Bt = tb("SUITE_B_MOBILE", 4096)
    ts, tg = draw_mb(rng_t, Bt)
    run_config("MobileBaseSE2", base, sdfm, starts_m, goals_m, setting_m,
               thru_B=Bt, thru_starts=ts, thru_goals=tg,
               oracle=oracles.get("MobileBaseSE2"),
               flag_vehicle_dynamics=True, dyn_sigma=0.001)

    # ---- 3. Arm3 planar with limits ------------------------------------
    arm3 = generate_arm("SimpleThreeLinksArm")
    setting_a = TrajOptimizerSetting(
        dof=3, total_step=10, total_time=5.0, cost_sigma=0.1,
        obs_check_inter=5, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(3),
        flag_pos_limit=True, flag_vel_limit=True,
        joint_pos_limits_down=-np.pi * np.ones(3),
        joint_pos_limits_up=np.pi * np.ones(3),
        vel_limits=1.5 * np.ones(3),
    )
    def draw_a3(r, n):
        s = 0.2 * r.normal(size=(n, 3))
        g = np.array([np.pi / 2, 0, 0]) + 0.2 * r.normal(size=(n, 3))
        return jnp.asarray(s, dtype), jnp.asarray(g, dtype)
    starts_a, goals_a = draw_a3(rng, B)
    Bt = tb("SUITE_B_ARM3", 8192)
    ts, tg = draw_a3(rng_t, Bt)
    run_config("Arm3Limits2D", arm3, sdf2, starts_a, goals_a, setting_a,
               thru_B=Bt, thru_starts=ts, thru_goals=tg,
               oracle=oracles.get("Arm3Limits2D"), tail=0)

    # ---- 4. WAM 7-DOF (unfiltered endpoints; bench.py is the headline) --
    wam = generate_arm("WAMArm")
    dsw = generate_3d_dataset("WAMDeskDataset")
    sdfw = sdf_from_occupancy(dsw.origin, dsw.cell_size, dsw.map)
    setting_w = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, cost_sigma=0.02,
        obs_check_inter=9, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(7),
    )
    bs = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    bg = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    def draw_w(r, n):
        return (jnp.asarray(bs + 0.03 * r.normal(size=(n, 7)), dtype),
                jnp.asarray(bg + 0.03 * r.normal(size=(n, 7)), dtype))
    starts_w, goals_w = draw_w(rng, B)
    Bt = tb("SUITE_B_WAM", 2048)
    ts, tg = draw_w(rng_t, Bt)
    run_config("WAM7_3D", wam, sdfw, starts_w, goals_w, setting_w,
               thru_B=Bt, thru_starts=ts, thru_goals=tg,
               oracle=oracles.get("WAM7_3D"))

    # ---- 5. Multi-world (per-problem SDFs) ------------------------------
    n = 64
    ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
    X, Y = np.meshgrid(ys, ys)
    pr = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))])
    setting_mw = TrajOptimizerSetting(
        dof=2, total_step=8, total_time=4.0, cost_sigma=0.1,
        obs_check_inter=3, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(2),
    )
    def draw_mw(r, nn):
        cys = r.uniform(-0.3, 0.3, nn)
        data = np.stack([np.sqrt(X**2 + (Y - c) ** 2) - 0.3 for c in cys])
        sdf = PlanarSDF(
            origin=jnp.asarray([-1.5, -1.5], dtype),
            cell_size=jnp.asarray(3.0 / (n - 1), dtype),
            data=jnp.asarray(data, dtype),
        )
        s = np.stack([np.full(nn, -0.9), r.uniform(-0.3, 0.3, nn)], -1)
        g = np.stack([np.full(nn, 0.9), r.uniform(-0.3, 0.3, nn)], -1)
        return sdf, jnp.asarray(s, dtype), jnp.asarray(g, dtype)
    sdf_mw, starts_mw, goals_mw = draw_mw(rng, B)
    Bt = tb("SUITE_B_MULTI", 8192)
    sdf_t, ts, tg = draw_mw(rng_t, Bt)
    sdf_mw_single = PlanarSDF(sdf_mw.origin, sdf_mw.cell_size, sdf_mw.data[0])
    run_config("MultiWorld2D", pr, sdf_mw, starts_mw, goals_mw, setting_mw,
               thru_B=Bt, thru_starts=ts, thru_goals=tg, thru_sdf=sdf_t,
               oracle=oracles.get("MultiWorld2D"),
               template_sdf=sdf_mw_single)


if __name__ == "__main__":
    main()
