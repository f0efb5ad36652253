"""chip_smoke.py's phases at their real sizes, for a GPU.

Run on the card with
    JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py
Elsewhere every test here skips (the `gpu` fixture decides).
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.chip


@pytest.fixture(scope="module")
def wam_batch(gpu):
    from bench import wam_bench_problem

    with jax.enable_x64(False):
        yield wam_bench_problem(2048)


def test_solve_phase(gpu, wam_batch):
    with jax.enable_x64(False):
        chip_smoke.solve_phase(wam_batch)


def test_wam_main_path(gpu, wam_batch):
    with jax.enable_x64(False):
        assert chip_smoke.wam_main_path(wam_batch) >= chip_smoke.WAM_GOOD_FRACTION


def test_replan_phase(gpu):
    with jax.enable_x64(False):
        chip_smoke.replan_phase()


def test_oracle_phase(gpu):
    chip_smoke.oracle_phase()
