"""Dump the bench_suite.py problem sets for the C++ suite oracle.

Writes one self-describing binary per BASELINE config containing the exact
SDF grid, robot model, optimizer settings, and the B sampled start/goal
pairs that bench_suite.py uses (same seed, same construction code), so the
single-threaded C++ oracle (gpmp2_oracle_suite.cpp) measures the reference
denominator and quality columns on the IDENTICAL problem set.

Format (little-endian): ASCII header of `key value` lines terminated by a
single line `end`, then raw arrays in this order (float64 unless noted):
  dh_a[dof] dh_alpha[dof] dh_d[dof]            (family=arm only)
  spheres[S*5]  (link, cx, cy, cz, radius)
  pos_down[dof] pos_up[dof] pos_thresh[dof]    (has_limits=1 only)
  vel_lim[dof] vel_thresh[dof]                 (has_limits=1 only)
  starts[B*dof] goals[B*dof]
  sdf_data[(per_plan ? B : 1) * rows * cols]   (float32, row-major (Y, X))

Usage: python tools/oracle/suite_dump.py [outdir]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")


def write_config(path, *, family, dof, n_steps, inter, total_time,
                 cost_sigma, eps, prior_sigma, starts, goals, spheres,
                 sdf_origin, sdf_cell, sdf_data, per_plan=False, dh=None,
                 limits=None, dyn_sigma=0.0):
    starts = np.asarray(starts, np.float64)
    goals = np.asarray(goals, np.float64)
    B = starts.shape[0]
    S = len(spheres)
    sdf_data = np.asarray(sdf_data, np.float32)
    rows, cols = sdf_data.shape[-2], sdf_data.shape[-1]
    with open(path, "wb") as f:
        def w(key, val):
            f.write(f"{key} {val}\n".encode())

        w("family", family)  # 0 point, 1 arm, 2 se2base
        w("dof", dof)
        w("n_steps", n_steps)
        w("inter", inter)
        w("B", B)
        w("S", S)
        w("has_limits", 1 if limits is not None else 0)
        w("has_dynamics", 1 if dyn_sigma > 0 else 0)
        w("per_plan_sdf", 1 if per_plan else 0)
        w("rows", rows)
        w("cols", cols)
        w("total_time", repr(float(total_time)))
        w("cost_sigma", repr(float(cost_sigma)))
        w("eps", repr(float(eps)))
        w("prior_sigma", repr(float(prior_sigma)))
        w("dyn_sigma", repr(float(dyn_sigma)))
        w("origin_x", repr(float(sdf_origin[0])))
        w("origin_y", repr(float(sdf_origin[1])))
        w("cell", repr(float(sdf_cell)))
        f.write(b"end\n")
        if family == 1:
            a, alpha, d = dh
            np.asarray(a, np.float64).tofile(f)
            np.asarray(alpha, np.float64).tofile(f)
            np.asarray(d, np.float64).tofile(f)
        np.asarray(spheres, np.float64).tofile(f)
        if limits is not None:
            for arr in limits:  # down, up, pthresh, vlim, vthresh
                np.asarray(arr, np.float64).tofile(f)
        starts.tofile(f)
        goals.tofile(f)
        sdf_data.tofile(f)
    print(f"wrote {path} ({os.path.getsize(path)/1e6:.1f} MB)")


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "dumps")
    os.makedirs(outdir, exist_ok=True)

    from gpmp2_jax.datasets import (
        generate_2d_dataset,
        planar_sdf_from_occupancy,
    )
    from gpmp2_jax.kinematics import PointRobotFK, make_robot_model
    from gpmp2_jax.robots import generate_arm, generate_mobile_base

    B = int(os.environ.get("SUITE_BATCH", "512"))
    rng = np.random.default_rng(0)  # same seed & draw ORDER as bench_suite

    # ---- 1. PointRobot2D (bench_suite.py config 1) ----------------------
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf2 = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    starts = np.stack([rng.uniform(-0.9, -0.5, B), rng.uniform(-0.9, 0.0, B)], -1)
    goals = np.stack([rng.uniform(1.4, 1.8, B), rng.uniform(1.2, 1.8, B)], -1)
    write_config(
        os.path.join(outdir, "pointrobot2d.bin"), family=0, dof=2,
        n_steps=10, inter=5, total_time=10.0, cost_sigma=0.1, eps=0.2,
        prior_sigma=1e-4, starts=starts, goals=goals,
        spheres=[[0, 0.0, 0.0, 0.0, 0.08]],
        sdf_origin=np.asarray(sdf2.origin), sdf_cell=float(sdf2.cell_size),
        sdf_data=np.asarray(sdf2.data),
    )

    # ---- 2. MobileBaseSE2 ----------------------------------------------
    dsm = generate_2d_dataset("MobileMap1")
    sdfm = planar_sdf_from_occupancy(dsm.origin, dsm.cell_size, dsm.map)
    base = generate_mobile_base()
    starts_m = np.stack([rng.uniform(-3.5, -2.5, B), rng.uniform(-3.5, -2.5, B),
                         rng.uniform(-0.5, 0.5, B)], -1)
    goals_m = np.stack([rng.uniform(2.5, 3.5, B), rng.uniform(2.5, 3.5, B),
                        rng.uniform(1.0, 2.0, B)], -1)
    write_config(
        os.path.join(outdir, "mobilebase_se2.bin"), family=2, dof=3,
        n_steps=15, inter=3, total_time=15.0, cost_sigma=0.01, eps=0.2,
        prior_sigma=1e-4, starts=starts_m, goals=goals_m,
        spheres=[[0, 0.0, 0.0, 0.0, 0.35]],
        sdf_origin=np.asarray(sdfm.origin), sdf_cell=float(sdfm.cell_size),
        sdf_data=np.asarray(sdfm.data), dyn_sigma=0.001,
    )
    del base

    # ---- 3. Arm3Limits2D ------------------------------------------------
    arm3 = generate_arm("SimpleThreeLinksArm")
    starts_a = 0.2 * rng.normal(size=(B, 3))
    goals_a = np.array([np.pi / 2, 0, 0]) + 0.2 * rng.normal(size=(B, 3))
    sph = np.concatenate(
        [np.asarray(arm3.sphere_link_ids)[:, None],
         np.asarray(arm3.sphere_centers),
         np.asarray(arm3.sphere_radii)[:, None]], axis=1)
    write_config(
        os.path.join(outdir, "arm3limits2d.bin"), family=1, dof=3,
        n_steps=10, inter=5, total_time=5.0, cost_sigma=0.1, eps=0.2,
        prior_sigma=1e-4, starts=starts_a, goals=goals_a, spheres=sph,
        sdf_origin=np.asarray(sdf2.origin), sdf_cell=float(sdf2.cell_size),
        sdf_data=np.asarray(sdf2.data),
        dh=(np.asarray(arm3.fk.a), np.asarray(arm3.fk.alpha),
            np.asarray(arm3.fk.d)),
        limits=(np.full(3, -np.pi), np.full(3, np.pi), np.full(3, 1e-3),
                np.full(3, 1.5), np.full(3, 1e-3)),
    )

    # ---- 4. WAM7_3D: raw starts/goals for gpmp2_oracle.cpp --probs ------
    # (same rng stream position and scale as bench_suite.py's draws)
    bs = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    bg = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    starts_w = bs + 0.03 * rng.normal(size=(B, 7))
    goals_w = bg + 0.03 * rng.normal(size=(B, 7))
    wam_path = os.path.join(outdir, "wam7_probs.bin")
    with open(wam_path, "wb") as f:
        starts_w.astype(np.float64).tofile(f)
        goals_w.astype(np.float64).tofile(f)
    print(f"wrote {wam_path} ({os.path.getsize(wam_path)/1e6:.1f} MB)")

    # ---- 5. MultiWorld2D ------------------------------------------------
    n = 64
    ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
    X, Y = np.meshgrid(ys, ys)
    cys = rng.uniform(-0.3, 0.3, B)
    data = np.stack([np.sqrt(X**2 + (Y - c) ** 2) - 0.3 for c in cys])
    starts_mw = np.stack([np.full(B, -0.9), rng.uniform(-0.3, 0.3, B)], -1)
    goals_mw = np.stack([np.full(B, 0.9), rng.uniform(-0.3, 0.3, B)], -1)
    write_config(
        os.path.join(outdir, "multiworld2d.bin"), family=0, dof=2,
        n_steps=8, inter=3, total_time=4.0, cost_sigma=0.1, eps=0.2,
        prior_sigma=1e-4, starts=starts_mw, goals=goals_mw,
        spheres=[[0, 0.0, 0.0, 0.0, 0.05]],
        sdf_origin=np.asarray([-1.5, -1.5]), sdf_cell=3.0 / (n - 1),
        sdf_data=data, per_plan=True,
    )


if __name__ == "__main__":
    main()
