"""Rehearsal of chip_smoke.py's phases on the CPU at tiny sizes, and of its
refusal to run without a GPU. The real-size run is `python chip_smoke.py`
on the card."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from __graft_entry__ import lanes_agree  # noqa: E402
from bench import wam_bench_problem  # noqa: E402


def ball_world(grid=24):
    """A small 3D field: one ball in front of the WAM (analytic SDF)."""
    from gpmp2_jax.obstacle.sdf import SignedDistanceField

    cell = 2.0 / (grid - 1)
    origin = np.array([-1.0, -1.0, -0.2])
    axes = [origin[k] + cell * np.arange(grid) for k in (2, 1, 0)]
    Z, Y, X = np.meshgrid(*axes, indexing="ij")
    dist = np.sqrt((X - 0.45) ** 2 + Y ** 2 + (Z - 0.6) ** 2) - 0.2
    return SignedDistanceField(
        origin=jnp.asarray(origin, jnp.float32),
        cell_size=jnp.asarray(cell, jnp.float32),
        data=jnp.asarray(dist, jnp.float32))


@pytest.fixture(scope="module")
def tiny_wam():
    with jax.enable_x64(False):
        yield wam_bench_problem(4, sdf=ball_world(), sdf_pack=False)


def test_main_refuses_cpu(capsys):
    """Without a GPU the script raises before any phase and prints no
    result line."""
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_solve_parity_random(capsys):
    worst = chip_smoke.solve_parity(
        *chip_smoke.random_spd_batch(8, 5, 6), "tiny")
    assert worst <= chip_smoke.RESIDUAL_TOL
    assert "tiny: B=8 n=5 m=6" in capsys.readouterr().out


def test_block_solve_f64_matches_dense():
    from test_batched_solve import dense_solve

    D, U, b, lam = chip_smoke.random_spd_batch(3, 5, 4, seed=2)
    x = chip_smoke.block_solve_f64(D, U, b, lam)
    np.testing.assert_allclose(
        x, dense_solve(*(np.asarray(a, np.float64) for a in (D, U, b, lam))),
        rtol=1e-10, atol=1e-12)


def test_residual_catches_a_wrong_solution():
    D, U, b, lam = chip_smoke.random_spd_batch(3, 4, 4)
    res = chip_smoke.relative_residuals(D, U, b, lam, np.zeros_like(b))
    np.testing.assert_allclose(res, 1.0)


def test_solve_phase_on_a_wam_linearize(tiny_wam):
    with jax.enable_x64(False):
        Hd, Ho, b, lam = chip_smoke.wam_first_linearize(tiny_wam)
        assert Hd.shape == (4, 11, 14 * 14) and b.dtype == jnp.float32
        chip_smoke.solve_parity(Hd, Ho, b, lam, "tiny WAM")


def test_wam_main_path(tiny_wam, capsys):
    with jax.enable_x64(False):
        frac = chip_smoke.wam_main_path(tiny_wam, good_fraction=0.5)
    out = capsys.readouterr().out
    assert 0.5 <= frac <= 1.0
    assert "memory_analysis" in out and "batch_traj_optimize" in out


def test_replan_phase(capsys):
    with jax.enable_x64(False):
        chip_smoke.replan_phase(B=4, rounds=2, sdf=ball_world())
    out = capsys.readouterr().out
    assert "update round 1" in out and "[replan] ok" in out


def test_oracle_phase_subset(capsys):
    chip_smoke.oracle_phase(only=["replan pointrobot2d"])
    assert "within 1% of the oracle" in capsys.readouterr().out


def test_lanes_agree_rule():
    """Flags may differ only where the errors agree within the
    convergence tolerance; any lane beyond it fails the check, converged
    or not."""
    e = np.array([1.0, 2.0, 3.0])
    assert lanes_agree(e, e * (1 + 5e-3), [1, 1, 0], [1, 0, 0],
                       [3, 4, 5], [3, 3, 5], 1e-2, 1e-5) == 1
    with pytest.raises(AssertionError, match="1 of 3 lanes disagree"):
        lanes_agree(e, e * np.array([1.0, 1.0, 1.05]), [1, 1, 1], [1, 1, 1],
                    [3, 3, 3], [3, 3, 3], 1e-2, 1e-5)
    e40 = np.ones(40)
    other = e40.copy()
    other[0] = 1.5  # one of 40 lanes at another minimum, both converged
    with pytest.raises(AssertionError, match="beyond the convergence"):
        lanes_agree(e40, other, [1] * 40, [1] * 40, [3] * 40, [3] * 40,
                    1e-2, 1e-5)


def test_oracle_phase_float32_case(capsys):
    """A float32 case prints its cost beside the float64 oracle's."""
    chip_smoke.oracle_phase(only=["mobilebase_se2 LM float32"])
    out = capsys.readouterr().out
    assert "mobilebase_se2 LM float32: within 1% of the oracle; cost" in out
