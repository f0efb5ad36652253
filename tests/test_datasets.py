"""Dataset + SDF-construction tests: EDT vs scipy, preset shapes, the
WAMDeskDataset world, and native-vs-fallback parity."""

import numpy as np
import pytest

from gpmp2_jax import native
from gpmp2_jax.datasets import (
    generate_2d_dataset,
    generate_3d_dataset,
    planar_sdf_from_occupancy,
    sdf_from_occupancy,
    signed_distance_field_2d,
)
from gpmp2_jax.obstacle.sdf import planar_sdf_lookup, sdf_lookup

import jax.numpy as jnp


class TestEDT:
    def test_native_matches_scipy_2d(self):
        from scipy import ndimage

        rng = np.random.default_rng(0)
        occ = rng.random((40, 50)) < 0.1
        occ[0, 0] = True  # ensure nonempty
        if native.edt_available():
            d_native = native.edt(occ)
            d_scipy = ndimage.distance_transform_edt(~occ)
            np.testing.assert_allclose(d_native, d_scipy, atol=1e-9)
        else:
            pytest.skip("native toolchain unavailable")

    def test_native_matches_scipy_3d(self):
        from scipy import ndimage

        rng = np.random.default_rng(1)
        occ = rng.random((20, 25, 30)) < 0.05
        occ[3, 4, 5] = True
        if native.edt_available():
            np.testing.assert_allclose(
                native.edt(occ), ndimage.distance_transform_edt(~occ), atol=1e-9
            )
        else:
            pytest.skip("native toolchain unavailable")


class TestSDFGen:
    def test_signed_field_signs(self):
        occ = np.zeros((50, 50))
        occ[20:30, 20:30] = 1.0
        field = signed_distance_field_2d(occ, 0.1)
        assert field[25, 25] < 0  # inside obstacle
        assert field[0, 0] > 0  # far outside
        # one cell outside boundary: distance ~ 1 cell
        assert abs(field[19, 25] - 0.1) < 1e-9

    def test_empty_map(self):
        field = signed_distance_field_2d(np.zeros((10, 10)), 0.1)
        np.testing.assert_allclose(field, 1000.0)


class TestPresets:
    def test_2d_presets(self):
        for name in ("OneObstacleDataset", "Empty", "TwoObstaclesDataset",
                     "MultiObstacleDataset", "MobileMap1"):
            ds = generate_2d_dataset(name)
            assert ds.map.shape == (ds.rows, ds.cols)
        one = generate_2d_dataset("OneObstacleDataset")
        assert one.map.sum() > 0
        assert one.map[190, 160] == 1.0  # obstacle center occupied

    def test_one_obstacle_world_coords(self):
        """Obstacle center cell (190, 160) is world (x, y) =
        (-1 + 160*0.01, -1 + 190*0.01) = (0.6, 0.9); the SDF there is
        negative (inside)."""
        ds = generate_2d_dataset("OneObstacleDataset")
        sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map,
                                        dtype=jnp.float64)
        d, _, ok = planar_sdf_lookup(sdf, jnp.asarray([0.6, 0.9]))
        assert bool(ok) and float(d) < 0
        d2, _, ok2 = planar_sdf_lookup(sdf, jnp.asarray([-0.9, -0.9]))
        assert bool(ok2) and float(d2) > 0

    def test_wam_desk_dataset(self):
        ds = generate_3d_dataset("WAMDeskDataset")
        assert ds.map.shape == (300, 300, 300)
        assert ds.corner_idx.shape == (12, 6)
        sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map,
                                 dtype=jnp.float64)
        assert sdf.data.shape == (300, 300, 300)
        # desk top box center: cells (x=170, y=220, z=130) -> world
        # (-1.5 + 1.7, -1.5 + 2.2, -1.5 + 1.3) = (0.2, 0.7, -0.2): inside
        d, _, ok = sdf_lookup(sdf, jnp.asarray([0.2, 0.7, -0.2]))
        assert bool(ok) and float(d) < 0
        # far free space
        d2, _, ok2 = sdf_lookup(sdf, jnp.asarray([-1.2, -1.2, 1.2]))
        assert bool(ok2) and float(d2) > 0.3
