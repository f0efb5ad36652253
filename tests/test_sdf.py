"""SDF lookup tests: exact-cell and fractional-cell interpolation values,
gradients of the interpolant, out-of-range masking.

Mirrors /root/reference/gpmp2/obstacle/tests/testPlanarSDF.cpp and
testSignedDistanceField.cpp (hand-built in-memory grids, no data files)."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.obstacle.factors import hinge_loss
from gpmp2_jax.obstacle.sdf import (
    PlanarSDF,
    SignedDistanceField,
    planar_sdf_lookup,
    sdf_lookup,
)


def make_planar():
    # 4x5 field (rows x cols), origin (-1, -2), cell 0.5
    r = np.random.default_rng(0)
    data = r.normal(size=(4, 5))
    return PlanarSDF(
        origin=jnp.asarray([-1.0, -2.0]),
        cell_size=jnp.asarray(0.5),
        data=jnp.asarray(data),
    ), data


def make_3d():
    r = np.random.default_rng(1)
    data = r.normal(size=(3, 4, 5))  # (z, rows, cols)
    return SignedDistanceField(
        origin=jnp.asarray([-1.0, -2.0, 0.5]),
        cell_size=jnp.asarray(0.5),
        data=jnp.asarray(data),
    ), data


class TestPlanar:
    def test_exact_cell(self):
        sdf, data = make_planar()
        # cell (row 2, col 3): world (x, y) = origin + (3, 2)*cell
        pt = jnp.asarray([-1.0 + 3 * 0.5, -2.0 + 2 * 0.5])
        d, g, ok = planar_sdf_lookup(sdf, pt)
        assert bool(ok)
        np.testing.assert_allclose(float(d), data[2, 3], atol=1e-12)

    def test_bilinear_fractional(self):
        sdf, data = make_planar()
        # halfway between 4 cells (rows 1-2, cols 2-3)
        pt = jnp.asarray([-1.0 + 2.5 * 0.5, -2.0 + 1.5 * 0.5])
        d, g, ok = planar_sdf_lookup(sdf, pt)
        expect = 0.25 * (data[1, 2] + data[1, 3] + data[2, 2] + data[2, 3])
        np.testing.assert_allclose(float(d), expect, atol=1e-12)

    def test_gradient_matches_ad(self):
        """The returned analytic gradient equals AD through the lookup."""
        sdf, _ = make_planar()
        pt = jnp.asarray([-0.3, -0.8])

        def dist(p):
            return planar_sdf_lookup(sdf, p)[0]

        g_ad = jax.grad(dist)(pt)
        _, g, _ = planar_sdf_lookup(sdf, pt)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad), atol=1e-10)

    def test_out_of_range(self):
        sdf, _ = make_planar()
        for pt in ([-1.1, -2.0], [10.0, 0.0], [0.0, -2.5], [0.0, 5.0]):
            _, _, ok = planar_sdf_lookup(sdf, jnp.asarray(pt))
            assert not bool(ok)
        # boundary point is in range (reference uses <= on the far edge)
        _, _, ok = planar_sdf_lookup(sdf, jnp.asarray([-1.0 + 4 * 0.5, -2.0 + 3 * 0.5]))
        assert bool(ok)

    def test_batched(self):
        sdf, data = make_planar()
        pts = jnp.asarray([[-1.0, -2.0], [-0.5, -2.0], [99.0, 99.0]])
        d, g, ok = planar_sdf_lookup(sdf, pts)
        assert d.shape == (3,) and g.shape == (3, 2) and ok.shape == (3,)
        np.testing.assert_allclose(np.asarray(d[:2]), [data[0, 0], data[0, 1]], atol=1e-12)
        assert not bool(ok[2])


class Test3D:
    def test_exact_cell(self):
        sdf, data = make_3d()
        # cell (z=1, row=2, col=3)
        pt = jnp.asarray([-1.0 + 3 * 0.5, -2.0 + 2 * 0.5, 0.5 + 1 * 0.5])
        d, g, ok = sdf_lookup(sdf, pt)
        assert bool(ok)
        np.testing.assert_allclose(float(d), data[1, 2, 3], atol=1e-12)

    def test_trilinear_fractional(self):
        sdf, data = make_3d()
        pt = jnp.asarray([-1.0 + 2.5 * 0.5, -2.0 + 1.5 * 0.5, 0.5 + 0.5 * 0.5])
        d, _, _ = sdf_lookup(sdf, pt)
        expect = data[0:2, 1:3, 2:4].mean()
        np.testing.assert_allclose(float(d), expect, atol=1e-12)

    def test_gradient_matches_ad(self):
        sdf, _ = make_3d()
        pt = jnp.asarray([-0.3, -0.8, 0.9])

        def dist(p):
            return sdf_lookup(sdf, p)[0]

        g_ad = jax.grad(dist)(pt)
        _, g, _ = sdf_lookup(sdf, pt)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad), atol=1e-10)

    def test_out_of_range_zero_cost(self):
        """Out-of-range => cost 0, grad 0 (ObstacleCost.h:31-38)."""
        sdf, _ = make_3d()
        pt = jnp.asarray([100.0, 0.0, 0.0])

        def cost(p):
            d, _, ok = sdf_lookup(sdf, p)
            return jnp.sum(hinge_loss(d, 1.0, ok))

        assert float(cost(pt)) == 0.0
        np.testing.assert_allclose(np.asarray(jax.grad(cost)(pt)), np.zeros(3), atol=0)


class TestHinge:
    def test_hinge_values_and_grad(self):
        """err = eps - d for d <= eps (boundary included), else 0
        (ObstacleCost.h:41-49)."""
        d = jnp.asarray([-0.5, 0.0, 0.19, 0.2, 0.2000001, 1.0])
        err = hinge_loss(d, 0.2, jnp.ones_like(d, dtype=bool))
        np.testing.assert_allclose(
            np.asarray(err), [0.7, 0.2, 0.01, 0.0, 0.0, 0.0], atol=1e-9
        )

        g = jax.grad(lambda x: hinge_loss(x, 0.2, jnp.asarray(True)))(jnp.asarray(0.1))
        assert float(g) == -1.0
        g0 = jax.grad(lambda x: hinge_loss(x, 0.2, jnp.asarray(True)))(jnp.asarray(0.5))
        assert float(g0) == 0.0


class TestPacked:
    """Corner-packed layout must reproduce the scattered-gather lookup
    exactly, everywhere in range (including the clamped top boundary)."""

    def test_packed_3d_matches_unpacked(self):
        from gpmp2_jax.obstacle.sdf import pack_sdf

        sdf, data = make_3d()
        packed = pack_sdf(sdf)
        assert packed.packed.shape == (3 * 4 * 5, 8)
        r = np.random.default_rng(7)
        # interior, boundary-exact, and out-of-range points
        pts = np.concatenate([
            r.uniform([-1.0, -2.0, 0.5], [1.0, -0.5, 1.5], size=(64, 3)),
            [[-1.0 + 4 * 0.5, -2.0 + 3 * 0.5, 0.5 + 2 * 0.5]],  # top corner
            [[5.0, 0.0, 0.0]],
        ])
        d0, g0, ok0 = sdf_lookup(sdf, jnp.asarray(pts))
        d1, g1, ok1 = sdf_lookup(packed, jnp.asarray(pts))
        np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok1))
        m = np.asarray(ok0)
        np.testing.assert_allclose(np.asarray(d0)[m], np.asarray(d1)[m],
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(g0)[m], np.asarray(g1)[m],
                                   atol=1e-12)

    def test_packed_planar_matches_unpacked(self):
        from gpmp2_jax.obstacle.sdf import pack_planar_sdf

        sdf, data = make_planar()
        packed = pack_planar_sdf(sdf)
        assert packed.packed.shape == (4 * 5, 4)
        # corner-major opt-in layout: identical lookups
        packed_cm = pack_planar_sdf(sdf._replace(packed=None),
                                    corner_major=True)
        assert packed_cm.packed.shape == (4, 4 * 5)
        r = np.random.default_rng(8)
        pts = np.concatenate([
            r.uniform([-1.0, -2.0], [1.0, -0.5], size=(64, 2)),
            [[-1.0 + 4 * 0.5, -2.0 + 3 * 0.5]],  # exact top corner
        ])
        d0, g0, ok0 = planar_sdf_lookup(sdf, jnp.asarray(pts))
        d1, g1, ok1 = planar_sdf_lookup(packed, jnp.asarray(pts))
        np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok1))
        m = np.asarray(ok0)
        np.testing.assert_allclose(np.asarray(d0)[m], np.asarray(d1)[m],
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(g0)[m], np.asarray(g1)[m],
                                   atol=1e-12)
        d2, g2, ok2 = planar_sdf_lookup(packed_cm, jnp.asarray(pts))
        np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok2))
        np.testing.assert_allclose(np.asarray(d0)[m], np.asarray(d2)[m],
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(g0)[m], np.asarray(g2)[m],
                                   atol=1e-12)
        # component lookup agrees on both layouts too
        from gpmp2_jax.obstacle.sdf import planar_sdf_lookup_components
        for pk in (packed, packed_cm):
            dc, gx, gy, okc = planar_sdf_lookup_components(
                pk, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
            np.testing.assert_array_equal(np.asarray(ok0), np.asarray(okc))
            np.testing.assert_allclose(np.asarray(d0)[m],
                                       np.asarray(dc)[m], atol=1e-12)

    def test_make_problem_autopacks(self):
        from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
        from gpmp2_jax.robots import generate_arm

        arm = generate_arm("SimpleTwoLinksArm")
        sdf, _ = make_planar()
        setting = TrajOptimizerSetting(dof=2)
        prob = make_problem(arm, sdf, jnp.zeros(2), jnp.zeros(2),
                            jnp.ones(2), jnp.zeros(2), setting)
        assert prob.sdf.packed is not None
        prob2 = make_problem(arm, sdf, jnp.zeros(2), jnp.zeros(2),
                             jnp.ones(2), jnp.zeros(2), setting,
                             sdf_pack=False)
        assert prob2.sdf.packed is None


class TestScreened:
    """Coarse-screen table (screen_sdf): the screened hinge must be
    EXACTLY the unscreened hinge — the bound is conservative, so every
    query it skips was provably inactive."""

    def _field(self, n=96):
        rng = np.random.default_rng(11)
        cell = 2.0 / (n - 1)
        g = -1.0 + cell * np.arange(n)
        Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
        c = np.array([0.3, -0.2, 0.1])
        dist = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - 0.25
        # a second blob to break symmetry
        dist = np.minimum(
            dist, np.sqrt((X + 0.5) ** 2 + (Y + 0.5) ** 2 + Z**2) - 0.15
        )
        return SignedDistanceField(
            origin=jnp.asarray([-1.0, -1.0, -1.0]),
            cell_size=jnp.asarray(cell), data=jnp.asarray(dist),
        )

    def test_bound_is_conservative(self):
        from gpmp2_jax.obstacle.sdf import screen_sdf

        sdf = self._field()
        s = screen_sdf(sdf, factor=8)
        rng = np.random.default_rng(3)
        pts = jnp.asarray(rng.uniform(-0.99, 0.99, (512, 3)))
        dist, _, _ = sdf_lookup(sdf, pts)
        ccell = float(s.coarse_cell)
        idx = jnp.clip(
            ((pts - s.origin) / ccell).astype(jnp.int32), 0,
            jnp.asarray(s.coarse.shape[::-1]) - 1,
        )
        zc, rc, cc = s.coarse.shape
        bound = s.coarse.reshape(-1)[(idx[:, 2] * rc + idx[:, 1]) * cc + idx[:, 0]]
        assert bool(jnp.all(bound <= dist + 1e-6))

    def test_screened_hinge_exact(self):
        from gpmp2_jax.obstacle.factors import hinge_loss
        from gpmp2_jax.obstacle.sdf import screen_sdf

        sdf = self._field()
        s = screen_sdf(sdf, factor=8)
        rng = np.random.default_rng(4)
        pts = jnp.asarray(rng.uniform(-1.2, 1.2, (2048, 3)))  # incl. out-of-range
        thresh = 0.3
        d0, g0, ok0 = sdf_lookup(sdf, pts)
        d1, g1, ok1 = sdf_lookup(s, pts, screen_thresh=thresh)
        np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok1))
        h0 = hinge_loss(d0, thresh, ok0)
        h1 = hinge_loss(d1, thresh, ok1)
        np.testing.assert_allclose(np.asarray(h1), np.asarray(h0), atol=1e-7)
        # gradients agree wherever the hinge is active
        active = np.asarray(h0) > 0
        np.testing.assert_allclose(
            np.asarray(g1)[active], np.asarray(g0)[active], atol=1e-7
        )
        # and the screen actually skips a nontrivial fraction
        skipped = np.asarray(d1 != d0).mean()
        assert skipped > 0.3, f"screen skipped only {skipped:.0%}"

    def test_planner_parity_with_screen(self):
        """End-to-end: a WAM-style solve with and without the screen lands
        on identical errors (the screen is invisible to the optimizer)."""
        import dataclasses as dc

        from gpmp2_jax.obstacle.sdf import screen_sdf
        from gpmp2_jax.planner import TrajOptimizerSetting, Trajectory, make_problem
        from gpmp2_jax.planner.problem import traj_linearize
        from gpmp2_jax.planner.traj_utils import init_traj_straight_line
        from gpmp2_jax.robots import generate_arm

        robot = generate_arm("WAMArm")
        sdf = self._field(64)
        setting = TrajOptimizerSetting(
            dof=7, total_step=6, total_time=2.0, epsilon=0.2,
            cost_sigma=0.02, obs_check_inter=3, Qc=np.eye(7),
        )
        start = jnp.asarray([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
        goal = jnp.asarray([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
        z = jnp.zeros(7)
        p_plain = make_problem(robot, sdf, start, z, goal, z, setting,
                               sdf_pack=False)
        p_scr = dc.replace(p_plain, sdf=screen_sdf(sdf, factor=8))
        traj = init_traj_straight_line(robot.space, start, goal, 6, 2.0)
        for f0, f1 in zip(traj_linearize(p_plain, traj),
                          traj_linearize(p_scr, traj)):
            np.testing.assert_allclose(np.asarray(f1), np.asarray(f0),
                                       atol=1e-6)


class TestBoxScreen:
    """Analytic box-hull screen (SignedDistanceField.screen_boxes): a
    compute-only lower bound on the EDT field collapses provably-inactive
    queries' gather indices — the screened hinge must be EXACTLY the
    unscreened hinge."""

    def _built(self):
        from gpmp2_jax.datasets.generate3d import Dataset3D, add_obstacle_3d
        from gpmp2_jax.datasets.sdf_gen import (
            dataset_screen_boxes,
            sdf_from_occupancy,
        )

        n = 64
        occ = np.zeros((n, n, n))
        occ, corner = add_obstacle_3d([20, 30, 25], [9, 13, 7], occ)
        occ, corner = add_obstacle_3d([45, 18, 40], [11, 5, 15], occ, corner)
        ds = Dataset3D(occ, n, n, n, -0.64, -0.64, -0.64, 0.02, corner)
        boxes = dataset_screen_boxes(ds)
        plain = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
        screened = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map,
                                      screen_boxes=boxes)
        return plain, screened

    def test_bound_is_conservative(self):
        """Where the bound is positive (the only region the screen can
        fire: thresh >= 0), it lower-bounds the trilinear field. Inside
        obstacles the bound is not a lower bound — and is never used."""
        plain, screened = self._built()
        rng = np.random.default_rng(5)
        pts = jnp.asarray(rng.uniform(-0.7, 0.7, (4096, 3)))
        lo = screened.screen_boxes[:, 0, :]
        hi = screened.screen_boxes[:, 1, :]
        dxyz = jnp.maximum(
            jnp.maximum(lo - pts[:, None, :], pts[:, None, :] - hi), 0.0)
        bound = (jnp.min(jnp.sqrt(jnp.sum(dxyz**2, -1)), -1)
                 - np.sqrt(3.0) * float(plain.cell_size))
        dist, _, ok = sdf_lookup(plain, pts)
        sel = np.asarray(ok) & (np.asarray(bound) > 0)
        assert sel.sum() > 100
        assert bool(jnp.all(bound[sel] <= dist[sel] + 1e-6))

    def test_screened_hinge_exact(self):
        from gpmp2_jax.obstacle.factors import hinge_loss

        plain, screened = self._built()
        rng = np.random.default_rng(6)
        pts = jnp.asarray(rng.uniform(-0.8, 0.8, (4096, 3)))  # incl. OOR
        thresh = 0.25
        d0, g0, ok0 = sdf_lookup(plain, pts)
        d1, g1, ok1 = sdf_lookup(screened, pts, screen_thresh=thresh)
        np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok1))
        h0 = hinge_loss(d0, thresh, ok0)
        h1 = hinge_loss(d1, thresh, ok1)
        np.testing.assert_allclose(np.asarray(h1), np.asarray(h0), atol=1e-7)
        active = np.asarray(h0) > 0
        np.testing.assert_allclose(
            np.asarray(g1)[active], np.asarray(g0)[active], atol=1e-7)
        skipped = np.asarray(d1 != d0).mean()
        assert skipped > 0.3, f"box screen skipped only {skipped:.0%}"

    def test_per_sphere_thresholds(self):
        """screen_thresh broadcast over a trailing sphere axis (the
        planner's (..., S) eps_total shape)."""
        from gpmp2_jax.obstacle.factors import hinge_loss

        plain, screened = self._built()
        rng = np.random.default_rng(7)
        pts = jnp.asarray(rng.uniform(-0.6, 0.6, (512, 4, 3)))
        thresh = jnp.asarray([0.1, 0.2, 0.3, 0.05])
        d0, _, ok0 = sdf_lookup(plain, pts)
        d1, _, ok1 = sdf_lookup(screened, pts, screen_thresh=thresh)
        np.testing.assert_allclose(
            np.asarray(hinge_loss(d1, thresh, ok1)),
            np.asarray(hinge_loss(d0, thresh, ok0)), atol=1e-7)
