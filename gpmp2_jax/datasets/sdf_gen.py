"""Occupancy-grid -> signed distance field construction.

Port of matlab/+gpmp2/signedDistanceField2D.m / ...3D.m and
gpmp2_python/utils/signedDistanceField2D.py:11-45:

  field = EDT(~occupied) - EDT(occupied), in cells, times cell_size;
  all-free maps return +1000 everywhere.

The exact EDT runs in the native C++ component (gpmp2_jax.native, built on
demand) with a scipy.ndimage fallback.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import native
from ..obstacle.sdf import PlanarSDF, SignedDistanceField

__all__ = [
    "signed_distance_field_2d",
    "signed_distance_field_3d",
    "planar_sdf_from_occupancy",
    "sdf_from_occupancy",
]


def _edt(occupied: np.ndarray) -> np.ndarray:
    try:
        return native.edt(occupied)
    except RuntimeError:
        from scipy import ndimage

        return ndimage.distance_transform_edt(~occupied)


def signed_distance_field_2d(ground_truth_map, cell_size) -> np.ndarray:
    """Occupancy (rows=Y, cols=X; 1 = obstacle) -> SDF in meters, same layout."""
    occ = np.asarray(ground_truth_map) > 0.75
    if not occ.any():
        return np.full(occ.shape, 1000.0)
    field = _edt(occ) - _edt(~occ)
    return field * float(cell_size)


def signed_distance_field_3d(ground_truth_map, cell_size) -> np.ndarray:
    """Occupancy volume -> SDF in meters, same layout as the input."""
    occ = np.asarray(ground_truth_map) > 0.75
    if not occ.any():
        return np.full(occ.shape, 1000.0)
    field = _edt(occ) - _edt(~occ)
    return field * float(cell_size)


def planar_sdf_from_occupancy(origin, cell_size, occupancy,
                              dtype=jnp.float32) -> PlanarSDF:
    """Occupancy (rows=Y, cols=X) -> PlanarSDF device pytree."""
    field = signed_distance_field_2d(occupancy, cell_size)
    return PlanarSDF(
        origin=jnp.asarray(origin, dtype),
        cell_size=jnp.asarray(cell_size, dtype),
        data=jnp.asarray(field, dtype),
    )


def sdf_from_occupancy(origin, cell_size, occupancy_xyz,
                       dtype=jnp.float32,
                       screen_boxes=None) -> SignedDistanceField:
    """3D occupancy in the reference dataset layout (X, Y, Z)
    (generate3Ddataset.m:10-12) -> SignedDistanceField with (Z, Y, X) data
    (the C++ SDF's z-slices of (Y, X) matrices; WAMPlannerExample.m:23-26
    performs the same per-slice transpose).

    `screen_boxes`: optional (K, 2, 3) world-frame [lo; hi] corners of the
    obstacle boxes' occupied-voxel-center hulls (see
    `dataset_screen_boxes`) — enables the compute-only gather screen in
    `sdf_lookup`."""
    field = signed_distance_field_3d(occupancy_xyz, cell_size)
    data_zyx = np.transpose(field, (2, 1, 0))
    return SignedDistanceField(
        origin=jnp.asarray(origin, dtype),
        cell_size=jnp.asarray(cell_size, dtype),
        data=jnp.asarray(data_zyx, dtype),
        screen_boxes=(None if screen_boxes is None
                      else jnp.asarray(screen_boxes, dtype)),
    )


def dataset_screen_boxes(ds, dtype=np.float64):
    """(K, 2, 3) world [lo; hi] voxel-center hulls from a Dataset3D's
    `corner_idx` rows ([x_lo, x_hi, y_lo, y_hi, z_lo, z_hi] cell indices,
    generate3d.py:add_obstacle_3d): world = origin + idx * cell_size."""
    ci = np.asarray(ds.corner_idx, dtype)
    origin = np.asarray(ds.origin, dtype)
    lo = origin[None, :] + ci[:, [0, 2, 4]] * ds.cell_size
    hi = origin[None, :] + ci[:, [1, 3, 5]] * ds.cell_size
    return np.stack([lo, hi], axis=1)
