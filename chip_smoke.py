"""Smoke run of the batched planner on one GPU, through its user entry
points, at the WAM benchmark's real size.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded phases only

Phases (each prints its lines and its seconds, and raises on failure):

  device   the first JAX device must be a GPU; prints its kind, the device
           count and `nvidia-smi`'s name and power limit.
  solve    the block-tridiagonal solve the optimizer runs, at the WAM width
           (B=2048, n=11, m=14) on the H, b of a real first WAM linearize
           and on a random SPD batch, and at the mobile-two-arm width
           (B=256, n=11, m=34), against a float64 reference on the host.
  wam      bench.py's problem exactly (WAMDeskDataset, 864 MB packed SDF
           table, B=2048, chunked LM with compaction, bench.py's schedule)
           through `plan_batch`, and one plan through `batch_traj_optimize`.
  oracle   the float64 oracle fixtures through LM, Dogleg and Gauss-Newton
           and the replanning fixtures through ISAM2TrajOptimizer, by the
           1% rule of tests/test_parity_oracle.py / test_replan_oracle.py;
           then the WAM and mobile-base graphs in float32, the planner's
           own dtype, held to the same rule against the float64 oracle.
  replan   bench_replan.py's fleet (B=1024 WAM sessions): cold solve, then
           two update rounds.

--four replaces them with the bench-exact WAM batch sharded over a 4-card
'dp' mesh against the same problems on one card, and the trajectory-axis
sharded Schur solve on a (dp=2, ts=2) mesh against the one-card scan.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np

# Tolerances of the solve phase.
# The scan solves in float32 on Jacobi-scaled blocks. The planner's H
# spans ~8 orders of magnitude before scaling (priors at sigma 1e-4 against
# obstacle factors at ~0.1), so the float32 solution is held to a per-lane
# relative residual ||Hx - b|| / ||b||, computed in float64 on the host
# from the float32 operands, of at most 1e-3.
RESIDUAL_TOL = 1e-3
# Share of WAM lanes that must end converged, not gave_up and collision
# free (collision cost < 1e-4), as bench.py counts a good plan.
WAM_GOOD_FRACTION = 0.95


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(ok, message):
    """Raise SmokeFailure unless `ok` (kept under `python -O`, unlike
    assert)."""
    if not ok:
        raise SmokeFailure(message)


@contextlib.contextmanager
def phase(name):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def gpu_device():
    """The first JAX device; raises unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}")
    return dev


def card_name_and_power():
    """`nvidia-smi`'s name and power limit of each card (one line each)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---- solve --------------------------------------------------------------


def random_spd_batch(B, n, m, seed=0):
    """float32 SPD block-tridiagonal batch (D, U, b, lam), batch-major."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, m, m))
    D = A @ np.swapaxes(A, -1, -2) / m + (m + 2) * np.eye(m)
    U = 0.3 * rng.normal(size=(B, n - 1, m, m))
    b = rng.normal(size=(B, n, m))
    lam = np.abs(rng.normal(size=(B,)))
    return tuple(a.astype(np.float32) for a in (D, U, b, lam))


def relative_residuals(D, U, b, lam, x):
    """Per-lane ||(H + lam I) x - b|| / ||b||, in float64 on the host."""
    D, U, b, lam, x = (np.asarray(a, np.float64) for a in (D, U, b, lam, x))
    B, n, m = b.shape
    D = D.reshape(B, n, m, m)
    U = U.reshape(B, n - 1, m, m)
    Hx = np.einsum("bnij,bnj->bni", D, x) + lam[:, None, None] * x
    Hx[:, :-1] += np.einsum("bnij,bnj->bni", U, x[:, 1:])
    Hx[:, 1:] += np.einsum("bnji,bnj->bni", U, x[:, :-1])
    r = (Hx - b).reshape(B, -1)
    return np.linalg.norm(r, axis=-1) / np.linalg.norm(b.reshape(B, -1),
                                                       axis=-1)


def block_solve_f64(D, U, b, lam):
    """float64 reference on the host: block-Thomas elimination of
    (H + lam I) x = b with NumPy's LAPACK solves, all lanes at once."""
    D, U, b, lam = (np.asarray(a, np.float64) for a in (D, U, b, lam))
    B, n, m = b.shape
    D = D.reshape(B, n, m, m) + lam[:, None, None, None] * np.eye(m)
    U = U.reshape(B, n - 1, m, m)
    C, z, G = D[:, 0], b[:, 0], []
    w = []
    for i in range(n):
        if i:
            GU = np.linalg.solve(C, U[:, i - 1])  # C_{i-1}^{-1} U_{i-1}
            Gz = np.linalg.solve(C, z[..., None])[..., 0]
            Ut = np.swapaxes(U[:, i - 1], -1, -2)
            C = D[:, i] - Ut @ GU
            z = b[:, i] - (Ut @ Gz[..., None])[..., 0]
            G.append(GU)
            w.append(Gz)
    x = [np.linalg.solve(C, z[..., None])[..., 0]]
    for i in reversed(range(n - 1)):
        x.append(w[i] - (G[i] @ x[-1][..., None])[..., 0])
    return np.stack(x[::-1], axis=1)


def solve_parity(D, U, b, lam, label):
    """The optimizer's damped solve on (D, U, b, lam), held to
    RESIDUAL_TOL on every lane, and compared with the float64 block
    solve of the same float32 operands. Returns the worst residual."""
    import jax

    from gpmp2_jax.solver.blocktridiag import batched_block_tridiag_solve

    solve = jax.jit(lambda D, U, b, lam: batched_block_tridiag_solve(
        D, U, b, lam=lam))
    t0 = time.perf_counter()
    x = np.asarray(solve(D, U, b, lam))
    t_first = time.perf_counter() - t0
    check(x.shape == np.shape(b) and np.isfinite(x).all(),
          f"{label}: non-finite or misshapen solution")
    res = relative_residuals(D, U, b, lam, x)
    worst = float(res.max())
    x64 = block_solve_f64(D, U, b, lam)
    B = x.shape[0]
    diff = (np.linalg.norm((x - x64).reshape(B, -1), axis=-1)
            / np.linalg.norm(x64.reshape(B, -1), axis=-1))
    print(f"  {label}: B={b.shape[0]} n={b.shape[1]} m={b.shape[2]} "
          f"worst relative residual {worst:.3g} (limit {RESIDUAL_TOL}); "
          f"largest per-lane relative difference from the float64 block "
          f"solve {float(diff.max()):.3g}; first call {t_first:.1f} s",
          flush=True)
    check(worst <= RESIDUAL_TOL,
          f"{label}: residual {worst} > {RESIDUAL_TOL}")
    return worst


def wam_first_linearize(wb):
    """H, b of the first LM linearize of the WAM batch (flat layout) and
    the first attempt's damping."""
    import jax

    from gpmp2_jax.planner.batch import _vmapped_lin_flat

    lin = jax.jit(_vmapped_lin_flat(wb.axes))
    Hd, Ho, b, _ = lin(wb.probs, wb.init)
    lam = np.full((b.shape[0],), wb.params.lambda_init, np.float32)
    return Hd, Ho, b, lam


def solve_phase(wb, mobile_B=256, mobile_m=34):
    with phase("solve"):
        solve_parity(*wam_first_linearize(wb), "WAM first linearize")
        B, n, m = wb.init.vel.shape[0], wb.init.vel.shape[1], 14
        solve_parity(*random_spd_batch(B, n, m), "random SPD, WAM width")
        solve_parity(*random_spd_batch(mobile_B, n, mobile_m, seed=1),
                     "random SPD, mobile-two-arm width")


# ---- WAM main path --------------------------------------------------------


def wam_main_path(wb, good_fraction=WAM_GOOD_FRACTION):
    """bench.py's batch through plan_batch, then one plan through
    batch_traj_optimize. Returns the good-lane fraction."""
    import dataclasses

    import jax

    from gpmp2_jax.planner.batch import (
        _retract_for,
        _vmapped_lin_flat,
        batch_traj_optimize,
        plan_batch,
    )
    from gpmp2_jax.planner.problem import collision_cost
    from gpmp2_jax.solver.optimize import _chunked_callables

    with phase("wam"):
        B = wb.init.vel.shape[0]
        t0 = time.perf_counter()
        res = plan_batch(wb.probs, wb.init, wb.params, wb.axes)
        cc = jax.jit(jax.vmap(collision_cost, in_axes=(wb.axes, 0)))(
            wb.probs, res.traj.pose)
        err, conv, gave, iters, ccn = (np.asarray(a) for a in jax.device_get(
            (res.error, res.converged, res.gave_up, res.iterations, cc)))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res2 = plan_batch(wb.probs, wb.init, wb.params, wb.axes)
        err2 = np.asarray(res2.error)
        t_warm = time.perf_counter() - t0
        check(err.shape == (B,) and np.isfinite(err).all()
              and np.isfinite(err2).all(), "plan_batch: non-finite error")
        good = conv & ~gave & (ccn < 1e-4)
        frac = float(good.mean())
        print(f"  plan_batch B={B}: first call (compile included) "
              f"{t_first:.1f} s, warm {t_warm:.2f} s; converged "
              f"{float((conv & ~gave).mean()):.4f}, gave_up "
              f"{float(gave.mean()):.4f}, collision-free "
              f"{float((ccn < 1e-4).mean()):.4f}, good {frac:.4f} (limit "
              f"{good_fraction}); mean iterations {iters.mean():.2f}",
              flush=True)
        check(frac >= good_fraction,
              f"good fraction {frac} < {good_fraction}")

        # the first chunk's compiled program, as plan_batch runs it
        params = dataclasses.replace(wb.params, lin_layout="flat")
        _, _, first = _chunked_callables(
            _vmapped_lin_flat(wb.axes), _retract_for(wb.robot.space), params,
            data=wb.probs)
        mem = first.lower(wb.probs, wb.init).compile().memory_analysis()
        print(f"  first-chunk program memory_analysis: {mem}", flush=True)
        stats = jax.devices()[0].memory_stats() or {}
        print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
              flush=True)

        s = wb.setting
        one = batch_traj_optimize(
            wb.robot, wb.sdf, wb.starts[0], np.zeros(7, np.float32),
            wb.goals[0], np.zeros(7, np.float32), s)
        e1 = float(one.error)
        check(np.isfinite(e1), "single plan: non-finite error")
        print(f"  batch_traj_optimize (one plan): error {e1:.4f} converged "
              f"{bool(one.converged)} gave_up {bool(one.gave_up)}",
              flush=True)
    return frac


# ---- oracle parity in float64 --------------------------------------------


def oracle_phase(only=None):
    """Every oracle fixture (or those whose label starts with one of
    `only`) by its test's own check functions, in float64 on the default
    device."""
    import jax

    import test_parity_oracle as po
    import test_replan_oracle as ro

    cases = [
        ("pointrobot2d LM/Dogleg/GN", po.TestPointRobot2D().test_parity),
        ("arm3_planar LM/Dogleg/GN", po.TestArm3Planar().test_parity),
        ("mobilebase_se2 LM/Dogleg/GN", po.TestMobileBaseSE2().test_parity),
        ("wam7_3d LM/Dogleg/GN", po.TestWAM7().test_parity),
        ("replan pointrobot2d", ro.test_replan_sequence_parity),
        ("replan mobilearm", ro.test_replan_sequence_parity_mobilearm),
        ("wam7_3d LM float32",
         lambda: po.lm_float32_within(po.TestWAM7())),
        ("mobilebase_se2 LM float32",
         lambda: po.lm_float32_within(po.TestMobileBaseSE2())),
    ]
    if only is not None:
        cases = [c for c in cases if c[0].startswith(tuple(only))]
    with phase("oracle"), jax.enable_x64(True):
        for label, case in cases:
            t0 = time.perf_counter()
            costs = case()
            gap = ("" if costs is None else
                   f"; cost {costs[0]:.6g} vs {costs[1]:.6g}")
            print(f"  {label}: within 1% of the oracle{gap} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


# ---- replanning fleet -------------------------------------------------------


def replan_phase(B=1024, rounds=2, sdf=None):
    import jax

    from bench_replan import replan_round, wam_fleet

    with phase("replan"):
        fleet, rng = wam_fleet(B, sdf=sdf)
        t0 = time.perf_counter()
        out = fleet.update()
        err = np.asarray(out.error)
        print(f"  cold solve B={B}: {time.perf_counter() - t0:.1f} s "
              f"(compile included), converged "
              f"{float(np.mean(np.asarray(out.converged))):.4f}", flush=True)
        check(np.isfinite(err).all(), "cold solve: non-finite error")
        for r in range(rounds):
            t0 = time.perf_counter()
            out = replan_round(fleet, r, rng)
            err = np.asarray(out.error)
            pose = np.asarray(jax.device_get(out.traj.pose))
            check(np.isfinite(err).all() and np.isfinite(pose).all(),
                  f"round {r}: non-finite values")
            print(f"  update round {r}: {time.perf_counter() - t0:.2f} s, "
                  f"converged {float(np.mean(np.asarray(out.converged))):.4f}",
                  flush=True)


# ---- four cards -------------------------------------------------------------


def four_card_phases(n_devices=4, per_device=512, sdf_pack=None):
    import jax

    from __graft_entry__ import _dryrun_ts_axis, dryrun_multichip

    have = len(jax.devices())
    if have < n_devices:
        raise RuntimeError(f"--four needs {n_devices} devices, found {have}")
    with phase("four: dp-sharded WAM batch"):
        dryrun_multichip(n_devices, per_device=per_device, sdf_pack=sdf_pack)
    with phase("four: ts-sharded Schur solve"):
        _dryrun_ts_axis(n_devices)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded phases only")
    args = ap.parse_args(argv)

    import jax

    with phase("device"):
        dev = gpu_device()
        count = len(jax.devices())
        print(f"  device_kind {dev.device_kind!r}, {count} device(s)")
        print(f"  nvidia-smi: {card_name_and_power()}", flush=True)

    from gpmp2_jax.compile_cache import configure_compile_cache

    print(f"  compile cache: {configure_compile_cache()}", flush=True)
    if args.four:
        four_card_phases()
    else:
        from bench import wam_bench_problem

        with phase("setup: bench.py WAM batch"):
            wb = wam_bench_problem(2048)
        solve_phase(wb)
        wam_main_path(wb)
        del wb
        replan_phase()
        oracle_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
