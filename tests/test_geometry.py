"""Geometry layer tests: exp/log roundtrips, group axioms, chart consistency.

Mirrors the correctness bar of /root/reference/gpmp2/geometry/tests (which
check gtsam-trait conformance of the dynamic Lie types)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax.geometry import se2, se3, so3
from gpmp2_jax.geometry.statespace import SE2Space, SE2VectorSpace, SE3Space, VectorSpace


def rng(seed=0):
    return np.random.default_rng(seed)


class TestSO3:
    def test_exp_log_roundtrip(self):
        r = rng(1)
        for _ in range(20):
            w = r.normal(size=3)
            # keep below pi to stay in the injectivity radius
            w = w / np.linalg.norm(w) * r.uniform(0.01, 3.1)
            R = so3.expmap(jnp.asarray(w))
            np.testing.assert_allclose(so3.logmap(R), w, atol=1e-8)

    def test_small_angle(self):
        w = jnp.asarray([1e-9, -2e-9, 3e-10])
        R = so3.expmap(w)
        np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-8)
        np.testing.assert_allclose(so3.logmap(R), w, atol=1e-12)

    def test_near_pi(self):
        r = rng(2)
        for _ in range(10):
            axis = r.normal(size=3)
            axis /= np.linalg.norm(axis)
            w = axis * (np.pi - 1e-6)
            R = so3.expmap(jnp.asarray(w))
            w_back = np.asarray(so3.logmap(R))
            np.testing.assert_allclose(w_back, w, atol=1e-4)

    def test_rotation_matrix_properties(self):
        w = jnp.asarray([0.3, -0.2, 0.9])
        R = np.asarray(so3.expmap(w))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)

    def test_ypr_matches_composition(self):
        y, p, r_ = 0.3, -0.4, 1.1
        R = np.asarray(so3.ypr(y, p, r_))
        expect = np.asarray(so3.rotz(y)) @ np.asarray(so3.roty(p)) @ np.asarray(so3.rotx(r_))
        np.testing.assert_allclose(R, expect, atol=1e-12)

    def test_left_jacobian_fd(self):
        w = jnp.asarray([0.4, -0.7, 0.2])
        J = np.asarray(so3.left_jacobian(w))
        # J_l columns: d/deps Log(Exp(w + eps e_i) Exp(w)^-1) ~ J_l e_i
        eps = 1e-7
        for i in range(3):
            dw = np.zeros(3)
            dw[i] = eps
            delta = so3.logmap(so3.expmap(w + jnp.asarray(dw)) @ so3.expmap(w).T)
            np.testing.assert_allclose(np.asarray(delta) / eps, J[:, i], atol=1e-5)

    def test_left_jacobian_inverse(self):
        w = jnp.asarray([0.4, -0.7, 0.2])
        J = np.asarray(so3.left_jacobian(w))
        Jinv = np.asarray(so3.left_jacobian_inverse(w))
        np.testing.assert_allclose(J @ Jinv, np.eye(3), atol=1e-10)


class TestSE3:
    def test_exp_log_roundtrip(self):
        r = rng(3)
        for _ in range(20):
            xi = r.normal(size=6)
            xi[:3] = xi[:3] / np.linalg.norm(xi[:3]) * r.uniform(0.01, 3.0)
            p = se3.expmap(jnp.asarray(xi))
            np.testing.assert_allclose(se3.logmap(p), xi, atol=1e-8)

    def test_compose_inverse(self):
        r = rng(4)
        a = se3.expmap(jnp.asarray(r.normal(size=6)))
        b = se3.expmap(jnp.asarray(r.normal(size=6)))
        ab = se3.compose(a, b)
        back = se3.compose(ab, se3.inverse(b))
        np.testing.assert_allclose(np.asarray(back.rot), np.asarray(a.rot), atol=1e-12)
        np.testing.assert_allclose(np.asarray(back.trans), np.asarray(a.trans), atol=1e-12)

    def test_retract_local_inverse(self):
        r = rng(5)
        p = se3.expmap(jnp.asarray(r.normal(size=6)))
        xi = jnp.asarray(0.3 * r.normal(size=6))
        q = se3.retract(p, xi)
        np.testing.assert_allclose(se3.local(p, q), xi, atol=1e-8)

    def test_adjoint_vs_conjugation(self):
        r = rng(6)
        p = se3.expmap(jnp.asarray(r.normal(size=6)))
        xi = jnp.asarray(r.normal(size=6))
        # Exp(Ad_p xi) == p Exp(xi) p^-1
        lhs = se3.expmap(se3.adjoint(p) @ xi)
        rhs = se3.compose(se3.compose(p, se3.expmap(xi)), se3.inverse(p))
        np.testing.assert_allclose(np.asarray(lhs.rot), np.asarray(rhs.rot), atol=1e-9)
        np.testing.assert_allclose(np.asarray(lhs.trans), np.asarray(rhs.trans), atol=1e-9)

    def test_transform_from(self):
        p = se3.Pose3(np.asarray(so3.rotz(jnp.pi / 2)), jnp.asarray([1.0, 2.0, 3.0]))
        out = se3.transform_from(p, jnp.asarray([1.0, 0.0, 0.0]))
        np.testing.assert_allclose(np.asarray(out), [1.0, 3.0, 3.0], atol=1e-12)


class TestSE2:
    def test_exp_log_roundtrip(self):
        r = rng(7)
        for _ in range(20):
            xi = r.normal(size=3)
            xi[2] = r.uniform(-3.0, 3.0)
            p = se2.expmap(jnp.asarray(xi))
            np.testing.assert_allclose(se2.logmap(p), xi, atol=1e-9)

    def test_compose_matches_matrix(self):
        r = rng(8)
        a = jnp.asarray(r.normal(size=3))
        b = jnp.asarray(r.normal(size=3))
        c = se2.compose(a, b)

        def mat(p):
            t = p[2]
            return np.asarray(
                [
                    [np.cos(t), -np.sin(t), p[0]],
                    [np.sin(t), np.cos(t), p[1]],
                    [0, 0, 1],
                ]
            )

        np.testing.assert_allclose(mat(np.asarray(c)), mat(np.asarray(a)) @ mat(np.asarray(b)), atol=1e-10)

    def test_zero_rotation_exp(self):
        xi = jnp.asarray([1.0, 2.0, 0.0])
        p = se2.expmap(xi)
        np.testing.assert_allclose(np.asarray(p), [1.0, 2.0, 0.0], atol=1e-12)


class TestStateSpaces:
    @pytest.mark.parametrize(
        "space",
        [VectorSpace(4), SE2Space(), SE2VectorSpace(2)],
        ids=["vector4", "se2", "se2xR2"],
    )
    def test_retract_local(self, space):
        r = rng(9)
        x = jnp.asarray(r.normal(size=space.storage_dim))
        delta = jnp.asarray(0.3 * r.normal(size=space.dim))
        y = space.retract(x, delta)
        np.testing.assert_allclose(space.local(x, y), delta, atol=1e-9)

    def test_product_structure(self):
        space = SE2VectorSpace(2)
        x = jnp.asarray([1.0, 2.0, 0.5, 0.1, 0.2])
        y = jnp.asarray([0.3, -1.0, -0.2, 1.0, 2.0])
        comp = space.compose(x, y)
        np.testing.assert_allclose(
            np.asarray(comp[:3]), np.asarray(se2.compose(x[:3], y[:3])), atol=1e-12
        )
        np.testing.assert_allclose(np.asarray(comp[3:]), [1.1, 2.2], atol=1e-12)

    def test_vmap_batch(self):
        space = SE2Space()
        r = rng(10)
        xs = jnp.asarray(r.normal(size=(16, 3)))
        deltas = jnp.asarray(0.1 * r.normal(size=(16, 3)))
        ys = jax.vmap(space.retract)(xs, deltas)
        back = jax.vmap(space.local)(xs, ys)
        np.testing.assert_allclose(np.asarray(back), np.asarray(deltas), atol=1e-9)


class TestSE3Space:
    """StateSpace kind 'se3' — gtsam::Pose3 trajectory states
    (reference typedefs gp/GaussianProcessPriorPose3.h:15)."""

    def test_retract_local_roundtrip(self):
        space = SE3Space()
        r = rng(11)
        x = space.retract(space.identity(jnp.float64),
                          jnp.asarray(r.normal(size=6)))
        delta = jnp.asarray(0.4 * r.normal(size=6))
        y = space.retract(x, delta)
        np.testing.assert_allclose(np.asarray(space.local(x, y)), delta, atol=1e-9)
        # storage stays a valid rotation
        R = np.asarray(y[:9]).reshape(3, 3)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)

    def test_matches_se3_module(self):
        from gpmp2_jax.geometry import se3

        space = SE3Space()
        r = rng(12)
        xi = jnp.asarray(r.normal(size=6))
        flat = space.expmap(xi)
        p = se3.expmap(xi)
        np.testing.assert_allclose(np.asarray(flat[:9]).reshape(3, 3),
                                   np.asarray(p.rot), atol=1e-12)
        np.testing.assert_allclose(np.asarray(flat[9:]), np.asarray(p.trans),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(space.logmap(flat)),
                                   np.asarray(xi), atol=1e-9)

    def test_vmap_batch(self):
        space = SE3Space()
        r = rng(13)
        xs = jax.vmap(space.expmap)(jnp.asarray(r.normal(size=(8, 6))))
        deltas = jnp.asarray(0.2 * r.normal(size=(8, 6)))
        ys = jax.vmap(space.retract)(xs, deltas)
        back = jax.vmap(space.local)(xs, ys)
        np.testing.assert_allclose(np.asarray(back), np.asarray(deltas), atol=1e-9)
