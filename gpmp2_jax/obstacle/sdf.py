"""Signed distance fields as device arrays with differentiable lookups.

Port of /root/reference/gpmp2/obstacle/PlanarSDF.h (2D, bilinear)
and SignedDistanceField.h (3D, trilinear). Semantics preserved exactly:

  - data layout: 2D field is (rows, cols) = (Y, X); 3D field is
    (z_slices, rows, cols) = (Z, Y, X) — the reference stores a vector of
    z-slice matrices (SignedDistanceField.h:44), here one 3D array.
  - world -> cell: col = (x - ox)/cell, row = (y - oy)/cell, z likewise
    (PlanarSDF.h:103-116, SignedDistanceField.h:103-116).
  - interpolation: bi/tri-linear over the floor cell corner
    (PlanarSDF.h:92-102, SignedDistanceField.h:127-141).
  - gradient: analytic gradient OF THE INTERPOLANT (piecewise-constant per
    cell in each axis), returned in world units (divided by cell_size), with
    (x, y[, z]) component ordering (PlanarSDF.h:78-83, SDF.h:92-97).
  - out-of-range queries: the reference throws SDFQueryOutOfRange, which
    hingeLossObstacleCost converts to cost 0 / gradient 0
    (/root/reference/gpmp2/obstacle/ObstacleCost.h:31-38). XLA cannot throw,
    so lookups also return an `in_range` mask and the hinge loss applies the
    zero-cost clamp with `where`.

Both field types are NamedTuple pytrees -> they vmap/shard and live in
device memory; a batch axis on `data` gives per-problem worlds.

Corner-packed layout (`packed` field, built by `pack_sdf`/`pack_planar_sdf`):
packing every cell's 8 (2D: 4) interpolation corners contiguously turns
the trilinear lookup's 8 scattered corner reads into ONE row gather:
`take(packed (L, 8), base, axis=0)`, at the price of 8x field memory. It
was chosen on the previous accelerator, where gathers cost per gathered
element; whether it pays on the GPU is not measured yet. `make_problem`
packs shared (unbatched) worlds automatically under a memory budget.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

__all__ = [
    "PlanarSDF",
    "planar_sdf_lookup_components",
    "sdf_lookup_components",
    "SignedDistanceField",
    "planar_sdf_lookup",
    "sdf_lookup",
    "pack_sdf",
    "pack_planar_sdf",
]


class PlanarSDF(NamedTuple):
    """2D signed distance field. data is (rows, cols) = (Y, X), meters."""

    origin: jnp.ndarray  # (2,) world coords of cell (0, 0)
    cell_size: jnp.ndarray  # scalar
    data: jnp.ndarray  # (rows, cols)
    packed: Optional[jnp.ndarray] = None  # (4, rows*cols) corner-major packed


class SignedDistanceField(NamedTuple):
    """3D signed distance field. data is (Z, Y, X), meters.

    `coarse` (built by `screen_sdf`) is a conservative min-pooled bound
    table at `coarse_cell` resolution: coarse[c] <= dist(p) for every p
    whose containing fine cell maps into block c. The hinge lookup uses it
    to SCREEN queries — points whose bound already clears the hinge
    threshold skip the expensive random gather into the full-resolution
    table (their fine-row index collapses to 0, which the HBM row buffer
    absorbs) and report the bound itself (> threshold -> hinge inactive,
    same semantics)."""

    origin: jnp.ndarray  # (3,)
    cell_size: jnp.ndarray  # scalar
    data: jnp.ndarray  # (z, rows, cols)
    packed: Optional[jnp.ndarray] = None  # (z*rows*cols, 8) corner-packed
    coarse: Optional[jnp.ndarray] = None  # (zc, rc, cc) min-pooled bounds
    coarse_cell: Optional[jnp.ndarray] = None  # scalar = cell * factor
    # (K, 2, 3) world-frame [lo; hi] corners of the occupied voxel-CENTER
    # hulls (one per obstacle box). Enables the COMPUTE-ONLY screen in
    # `sdf_lookup`: dist_to_hull(p) lower-bounds the EDT field (centers
    # are inside their hull), so hull_dist(p) - sqrt(3)*cell >
    # hinge-threshold proves the trilerp hinge inactive WITHOUT touching
    # the table — screened queries collapse their gather index to row 0.
    # The earlier min-pooled `coarse` screen ADDs a second random gather
    # per query; this one costs ~12 FMA-norms per query of pure
    # elementwise compute. Neither is measured on the GPU.
    screen_boxes: Optional[jnp.ndarray] = None


def _corner_offsets_3d(rows, cols):
    # order matches the unpack in sdf_lookup: d000 d010 d001 d011 d100 ...
    rc = rows * cols
    return [0, cols, 1, cols + 1, rc, rc + cols, rc + 1, rc + cols + 1]


def pack_sdf(sdf: SignedDistanceField, dtype=None) -> SignedDistanceField:
    """Return `sdf` with the corner-packed table filled (device-side build,
    no host round-trip). packed[l, k] = flat[l + off_k] with wraparound at
    the top boundary — safe because clamped lookup coordinates give those
    corners exactly-zero interpolation weight (see sdf_lookup).

    `dtype` stores the packed table in a narrower type (e.g. float16:
    halves the random-gather bytes;
    corner values are dequantized to the compute dtype after the gather).
    f16's ~1e-4 absolute error on the [-2, 2] m distances perturbs hinge
    residuals by <0.1% of epsilon; the CPU/float64 parity paths never use
    a packed table."""
    if sdf.packed is not None:
        return sdf
    nz, rows, cols = sdf.data.shape[-3:]
    flat = sdf.data.reshape(sdf.data.shape[:-3] + (-1,))
    if dtype is not None:
        flat = flat.astype(dtype)
    packed = jnp.stack(
        [jnp.roll(flat, -off, axis=-1) for off in _corner_offsets_3d(rows, cols)],
        axis=-1,
    )
    return sdf._replace(packed=packed)


def _planar_packed_corner_major(pk) -> bool:
    """Layout discriminator: corner-major tables are (..., 4, cells),
    row-major are (..., cells, 4). cells == 4 (a 2x2 world) is ambiguous
    and treated as row-major — no perf stake at that size."""
    return pk.ndim >= 2 and pk.shape[-2] == 4 and pk.shape[-1] != 4


def pack_planar_sdf(sdf: PlanarSDF, corner_major: bool = False) -> PlanarSDF:
    """2D analog of `pack_sdf`: one packed row/column per cell holding its
    4 bilinear corners.

    Two layouts (both understood by every lookup):
      - ROW-MAJOR (..., cells, 4), the default: one contiguous 16-byte
        row per query — the layout for tables in device memory (large or
        per-problem world batches), where a corner-major column would
        cost 4 scattered reads.
      - CORNER-MAJOR (..., 4, cells), opt-in: the gather's output then
        has each corner as a contiguous row. On the previous accelerator
        it measured neutral in the full linearize: XLA reintroduces the
        relayout on the other side of the gather. Kept as a tested
        option; not measured on the GPU.
    """
    if sdf.packed is not None:
        return sdf
    cols = sdf.data.shape[-1]
    flat = sdf.data.reshape(sdf.data.shape[:-2] + (-1,))
    packed = jnp.stack(
        [jnp.roll(flat, -off, axis=-1) for off in (0, cols, 1, cols + 1)],
        axis=-2 if corner_major else -1,
    )
    return sdf._replace(packed=packed)


def screen_sdf(sdf: SignedDistanceField, factor: int = 8) -> SignedDistanceField:
    """Attach the conservative coarse screen table: min-pool the fine field
    over (factor + 1)-wide windows at stride `factor` (the +1 halo covers
    the 8 trilerp corners of any point inside the block), so
    coarse[c] <= trilinear dist(p) for all p in block c."""
    if sdf.coarse is not None:
        return sdf
    from jax import lax

    data = sdf.data
    win = factor + 1
    pooled = -lax.reduce_window(
        -data, -jnp.inf, lax.max,
        window_dimensions=(win, win, win),
        window_strides=(factor, factor, factor),
        padding=[(0, factor)] * 3,
    )
    # pad regions beyond the field keep -inf -> replace with the block min
    pooled = jnp.where(jnp.isfinite(pooled), pooled, data.min())
    return sdf._replace(
        coarse=pooled.astype(data.dtype),
        coarse_cell=jnp.asarray(sdf.cell_size * factor, data.dtype),
    )


def planar_sdf_lookup(sdf: PlanarSDF, point):
    """Bilinear signed distance + world-frame gradient + in-range mask.

    point: (..., 2) world (x, y). Returns (dist, grad(...,2), in_range).
    Matches PlanarSDF::getSignedDistance(point, g) including the gradient of
    the bilinear interpolant (PlanarSDF.h:106-118).
    """
    point = jnp.asarray(point)
    rows, cols = sdf.data.shape[-2], sdf.data.shape[-1]
    cs = sdf.cell_size
    x = (point[..., 0] - sdf.origin[0]) / cs  # col coordinate
    y = (point[..., 1] - sdf.origin[1]) / cs  # row coordinate

    in_range = (
        (x >= 0.0) & (x <= cols - 1.0) & (y >= 0.0) & (y <= rows - 1.0)
    )

    # clamp the LOW cell corner to size-2 and take the fraction against it:
    # at the exact top boundary fx/fy become 1.0, so the interpolation uses
    # the last interior cell (one-sided) — every corner index is genuinely
    # in-bounds and the interpolant's gradient stays meaningful there (the
    # reference indexes one past the end in that case, which is UB).
    xc = jnp.clip(x, 0.0, cols - 1.0)
    yc = jnp.clip(y, 0.0, rows - 1.0)
    lci = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, cols - 2)
    lri = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, rows - 2)

    fx = xc - lci.astype(xc.dtype)  # in [0, 1]
    fy = yc - lri.astype(yc.dtype)

    # fused 4-corner gather from the flattened field (see the 3D variant
    # for the boundary-safety argument); one row gather when packed
    base = lri * cols + lci
    if sdf.packed is not None and _planar_packed_corner_major(sdf.packed):
        # corner-major table: one gather, each corner a contiguous slice
        vals = jnp.take(sdf.packed.reshape(4, -1), base, axis=1,
                        mode="clip")
        d00, d10, d01, d11 = vals[0], vals[1], vals[2], vals[3]
    elif sdf.packed is not None:
        vals = jnp.take(sdf.packed.reshape(-1, 4), base, axis=0,
                        mode="clip")
        d00, d10, d01, d11 = (
            vals[..., 0], vals[..., 1], vals[..., 2], vals[..., 3],
        )
    else:
        flat = sdf.data.reshape(-1)
        corner_offs = jnp.asarray([0, cols, 1, cols + 1], jnp.int32)
        vals = jnp.take(flat, base[..., None] + corner_offs, mode="clip")
        d00, d10, d01, d11 = (
            vals[..., 0], vals[..., 1], vals[..., 2], vals[..., 3],
        )

    dist = (
        (1.0 - fy) * (1.0 - fx) * d00
        + fy * (1.0 - fx) * d10
        + (1.0 - fy) * fx * d01
        + fy * fx * d11
    )
    # gradient wrt cell index, then to world units; order (x, y)
    g_row = (1.0 - fx) * (d10 - d00) + fx * (d11 - d01)
    g_col = (1.0 - fy) * (d01 - d00) + fy * (d11 - d10)
    grad = jnp.stack([g_col, g_row], axis=-1) / cs
    return dist, grad, in_range


def sdf_lookup(sdf: SignedDistanceField, point, screen_thresh=None):
    """Trilinear signed distance + world gradient + in-range mask.

    point: (..., 3) world (x, y, z). Matches
    SignedDistanceField::getSignedDistance(point, g) (SDF.h:92-167).

    `screen_thresh` (hinge activation threshold, broadcastable to the
    query shape) enables the coarse screen when `sdf.coarse` is present:
    queries whose conservative coarse bound exceeds the threshold skip the
    random fine gather (index collapsed to row 0) and return the bound
    with zero gradient — exact for the hinge, which is zero there anyway.
    """
    point = jnp.asarray(point)
    nz, rows, cols = sdf.data.shape[-3], sdf.data.shape[-2], sdf.data.shape[-1]
    cs = sdf.cell_size
    x = (point[..., 0] - sdf.origin[0]) / cs
    y = (point[..., 1] - sdf.origin[1]) / cs
    z = (point[..., 2] - sdf.origin[2]) / cs

    in_range = (
        (x >= 0.0)
        & (x <= cols - 1.0)
        & (y >= 0.0)
        & (y <= rows - 1.0)
        & (z >= 0.0)
        & (z <= nz - 1.0)
    )

    # low corner clamped to size-2, fraction against it (see the 2D variant
    # for the boundary rationale) — all 8 corners genuinely in-bounds
    xc = jnp.clip(x, 0.0, cols - 1.0)
    yc = jnp.clip(y, 0.0, rows - 1.0)
    zc = jnp.clip(z, 0.0, nz - 1.0)
    lci = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, cols - 2)
    lri = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, rows - 2)
    lzi = jnp.clip(jnp.floor(zc).astype(jnp.int32), 0, nz - 2)

    fx = xc - lci.astype(xc.dtype)
    fy = yc - lri.astype(yc.dtype)
    fz = zc - lzi.astype(zc.dtype)

    # One fused gather of all 8 cell corners: either a single row gather
    # from the corner-packed table (fastest, ~memory bandwidth), or one
    # 1-D take of 8 scattered elements (one gather instead of 8
    # multi-dim advanced-indexing gathers).
    base = (lzi * rows + lri) * cols + lci

    maybe = None
    bound = None
    if screen_thresh is not None and sdf.screen_boxes is not None:
        # analytic box-hull screen (see SignedDistanceField.screen_boxes):
        # bound = min_k dist(p, hull_k) - sqrt(3)*cell; bound > thresh >= 0
        # proves the hinge inactive. Proof: bound > 0 puts every corner of
        # p's cell strictly outside all hulls (corners are within
        # sqrt(3)*cell of p), so each corner is a FREE voxel whose EDT
        # value >= dist(corner, occupied centers) >= dist(corner, hull) >=
        # bound, and the trilerp is a convex combination of corner values.
        # The bound is NOT a field lower bound where it is <= 0 (inside
        # obstacles the field goes more negative) — clamp the threshold at
        # 0 so such queries are never screened.
        lo = sdf.screen_boxes[..., 0, :]  # (K, 3)
        hi = sdf.screen_boxes[..., 1, :]
        dxyz = jnp.maximum(
            jnp.maximum(lo - point[..., None, :], point[..., None, :] - hi),
            0.0,
        )  # (..., K, 3)
        hull_d = jnp.sqrt(jnp.sum(dxyz * dxyz, axis=-1))  # (..., K)
        bound = jnp.min(hull_d, axis=-1) - jnp.sqrt(3.0) * cs
        maybe = bound <= jnp.maximum(screen_thresh, 0.0)
        base = jnp.where(maybe, base, 0)
    elif screen_thresh is not None and sdf.coarse is not None:
        zc, rc, cc = sdf.coarse.shape[-3:]
        ccell = sdf.coarse_cell
        cxi = jnp.clip((point[..., 0] - sdf.origin[0]) / ccell, 0, cc - 1
                       ).astype(jnp.int32)
        cyi = jnp.clip((point[..., 1] - sdf.origin[1]) / ccell, 0, rc - 1
                       ).astype(jnp.int32)
        czi = jnp.clip((point[..., 2] - sdf.origin[2]) / ccell, 0, zc - 1
                       ).astype(jnp.int32)
        bound = jnp.take(
            sdf.coarse.reshape(sdf.coarse.shape[:-3] + (-1,)),
            (czi * rc + cyi) * cc + cxi, axis=-1, mode="clip",
        )
        maybe = bound <= screen_thresh
        base = jnp.where(maybe, base, 0)

    if sdf.packed is not None:
        # corner-packed table: ONE row gather instead of 8 scattered
        # element gathers (see module docstring); dequantize narrow tables
        # to the compute dtype after the gather
        vals = jnp.take(sdf.packed.reshape(-1, 8), base, axis=0,
                        mode="clip").astype(point.dtype)
    else:
        flat = sdf.data.reshape(-1)
        corner_offs = jnp.asarray(_corner_offsets_3d(rows, cols), jnp.int32)
        vals = jnp.take(flat, base[..., None] + corner_offs,
                        mode="clip")  # (..., 8)
    d000, d010, d001, d011, d100, d110, d101, d111 = (
        vals[..., 0], vals[..., 1], vals[..., 2], vals[..., 3],
        vals[..., 4], vals[..., 5], vals[..., 6], vals[..., 7],
    )

    w000 = (1 - fy) * (1 - fx) * (1 - fz)
    w010 = fy * (1 - fx) * (1 - fz)
    w001 = (1 - fy) * fx * (1 - fz)
    w011 = fy * fx * (1 - fz)
    w100 = (1 - fy) * (1 - fx) * fz
    w110 = fy * (1 - fx) * fz
    w101 = (1 - fy) * fx * fz
    w111 = fy * fx * fz

    dist = (
        w000 * d000 + w010 * d010 + w001 * d001 + w011 * d011
        + w100 * d100 + w110 * d110 + w101 * d101 + w111 * d111
    )

    # gradient of the trilinear interpolant (SDF.h:146-167), world units
    g_row = (
        (1 - fx) * (1 - fz) * (d010 - d000)
        + fx * (1 - fz) * (d011 - d001)
        + (1 - fx) * fz * (d110 - d100)
        + fx * fz * (d111 - d101)
    )
    g_col = (
        (1 - fy) * (1 - fz) * (d001 - d000)
        + fy * (1 - fz) * (d011 - d010)
        + (1 - fy) * fz * (d101 - d100)
        + fy * fz * (d111 - d110)
    )
    g_z = (
        (1 - fy) * (1 - fx) * (d100 - d000)
        + fy * (1 - fx) * (d110 - d010)
        + (1 - fy) * fx * (d101 - d001)
        + fy * fx * (d111 - d011)
    )
    grad = jnp.stack([g_col, g_row, g_z], axis=-1) / cs
    if maybe is not None:
        dist = jnp.where(maybe, dist, bound)
        grad = jnp.where(maybe[..., None], grad, 0.0)
    return dist, grad, in_range


def planar_sdf_lookup_components(sdf, px, py):
    """Planar bilinear lookup on COMPONENT arrays of any shape: returns
    (dist, gx, gy, ok). Same math as obstacle/sdf.py:planar_sdf_lookup."""
    rows, cols = sdf.data.shape[-2], sdf.data.shape[-1]
    cs = sdf.cell_size
    x = (px - sdf.origin[0]) / cs
    y = (py - sdf.origin[1]) / cs
    ok = (x >= 0.0) & (x <= cols - 1.0) & (y >= 0.0) & (y <= rows - 1.0)
    xc = jnp.clip(x, 0.0, cols - 1.0)
    yc = jnp.clip(y, 0.0, rows - 1.0)
    lci = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, cols - 2)
    lri = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, rows - 2)
    fx = xc - lci.astype(xc.dtype)
    fy = yc - lri.astype(yc.dtype)
    base = lri * cols + lci
    shape = base.shape
    flat = base.reshape(-1)
    if sdf.packed is not None and _planar_packed_corner_major(sdf.packed):
        # corner-major table ((4, cells)): corner rows come out of the
        # gather contiguous — no relayout copy of the gather output
        vals = jnp.take(sdf.packed.reshape(4, -1), flat, axis=1,
                        mode="clip")
        v = [vals[k].reshape(shape).astype(px.dtype) for k in range(4)]
    elif sdf.packed is not None:
        vals = jnp.take(sdf.packed.reshape(-1, 4), flat, axis=0,
                        mode="clip")
        v = [vals[:, k].reshape(shape).astype(px.dtype) for k in range(4)]
    else:
        data = sdf.data.reshape(-1)
        offs = (0, cols, 1, cols + 1)
        v = [jnp.take(data, flat + o, mode="clip").reshape(shape)
             for o in offs]
    d00, d10, d01, d11 = v
    dist = ((1 - fy) * (1 - fx) * d00 + fy * (1 - fx) * d10
            + (1 - fy) * fx * d01 + fy * fx * d11)
    g_row = (1 - fx) * (d10 - d00) + fx * (d11 - d01)
    g_col = (1 - fy) * (d01 - d00) + fy * (d11 - d10)
    return dist, g_col / cs, g_row / cs, ok


def sdf_lookup_components(sdf, px, py, pz):
    """3D trilinear lookup on COMPONENT arrays of any shape: returns
    (dist, gx, gy, gz, ok). Same math as obstacle/sdf.py:sdf_lookup
    (without the opt-in screens). The corner gather runs on the FLAT
    query vector so its output keeps the gather engine's corner-major
    layout; each corner column is then a contiguous slice."""
    nz, rows, cols = sdf.data.shape[-3:]
    cs = sdf.cell_size
    x = (px - sdf.origin[0]) / cs
    y = (py - sdf.origin[1]) / cs
    z = (pz - sdf.origin[2]) / cs
    ok = ((x >= 0.0) & (x <= cols - 1.0) & (y >= 0.0) & (y <= rows - 1.0)
          & (z >= 0.0) & (z <= nz - 1.0))
    xc = jnp.clip(x, 0.0, cols - 1.0)
    yc = jnp.clip(y, 0.0, rows - 1.0)
    zc = jnp.clip(z, 0.0, nz - 1.0)
    lci = jnp.clip(jnp.floor(xc).astype(jnp.int32), 0, cols - 2)
    lri = jnp.clip(jnp.floor(yc).astype(jnp.int32), 0, rows - 2)
    lzi = jnp.clip(jnp.floor(zc).astype(jnp.int32), 0, nz - 2)
    fx = xc - lci.astype(xc.dtype)
    fy = yc - lri.astype(yc.dtype)
    fz = zc - lzi.astype(zc.dtype)
    base = (lzi * rows + lri) * cols + lci
    shape = base.shape
    flat = base.reshape(-1)
    if sdf.packed is not None:
        vals = jnp.take(sdf.packed.reshape(-1, 8), flat, axis=0, mode="clip")
        v = [vals[:, k].reshape(shape).astype(px.dtype) for k in range(8)]
    else:
        data = sdf.data.reshape(-1)
        v = [jnp.take(data, flat + o, mode="clip").reshape(shape)
             for o in _corner_offsets_3d(rows, cols)]
    d000, d010, d001, d011, d100, d110, d101, d111 = v
    dist = ((1 - fy) * (1 - fx) * (1 - fz) * d000
            + fy * (1 - fx) * (1 - fz) * d010
            + (1 - fy) * fx * (1 - fz) * d001
            + fy * fx * (1 - fz) * d011
            + (1 - fy) * (1 - fx) * fz * d100
            + fy * (1 - fx) * fz * d110
            + (1 - fy) * fx * fz * d101
            + fy * fx * fz * d111)
    g_row = ((1 - fx) * (1 - fz) * (d010 - d000)
             + fx * (1 - fz) * (d011 - d001)
             + (1 - fx) * fz * (d110 - d100)
             + fx * fz * (d111 - d101))
    g_col = ((1 - fy) * (1 - fz) * (d001 - d000)
             + fy * (1 - fz) * (d011 - d010)
             + (1 - fy) * fz * (d101 - d100)
             + fy * fz * (d111 - d110))
    g_z = ((1 - fy) * (1 - fx) * (d100 - d000)
           + fy * (1 - fx) * (d110 - d010)
           + (1 - fy) * fx * (d101 - d001)
           + fy * fx * (d111 - d011))
    return dist, g_col / cs, g_row / cs, g_z / cs, ok
