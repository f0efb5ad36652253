"""GP prior / interpolation tests.

Mirrors /root/reference/gpmp2/gp/tests: Q*Qinv identity, Lambda/Psi
endpoint properties, prior residual values, constant-velocity trajectories
interpolating exactly, and AD-vs-finite-difference Jacobian checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax.geometry import se2, se3
from gpmp2_jax.geometry.statespace import (
    SE2Space,
    SE2VectorSpace,
    SE3Space,
    VectorSpace,
)
from gpmp2_jax.gp import (
    calc_lambda,
    calc_phi,
    calc_psi,
    calc_Q,
    calc_Q_inv,
    gp_prior_error,
    gp_prior_jacobians_linear,
    interp_coeffs,
    interpolate_state,
)


class TestGPUtils:
    def test_Q_inverse_closed_form(self):
        r = np.random.default_rng(0)
        A = r.normal(size=(3, 3))
        Qc = jnp.asarray(A @ A.T + 3 * np.eye(3))
        Q = calc_Q(Qc, 0.7)
        Qinv = calc_Q_inv(Qc, 0.7)
        np.testing.assert_allclose(np.asarray(Q @ Qinv), np.eye(6), atol=1e-10)

    def test_phi(self):
        phi = np.asarray(calc_phi(2, 0.5, jnp.float64))
        expect = np.eye(4)
        expect[0, 2] = expect[1, 3] = 0.5
        np.testing.assert_allclose(phi, expect)

    def test_lambda_psi_endpoints(self):
        """At tau=0 interpolation returns state 1; at tau=dt state 2."""
        Qc = jnp.eye(2, dtype=jnp.float64)
        dt = 1.3
        lam0 = np.asarray(calc_lambda(Qc, dt, 0.0))
        psi0 = np.asarray(calc_psi(Qc, dt, 0.0))
        np.testing.assert_allclose(lam0, np.eye(4), atol=1e-12)
        np.testing.assert_allclose(psi0, np.zeros((4, 4)), atol=1e-12)
        lam1 = np.asarray(calc_lambda(Qc, dt, dt))
        psi1 = np.asarray(calc_psi(Qc, dt, dt))
        np.testing.assert_allclose(lam1, np.zeros((4, 4)), atol=1e-10)
        np.testing.assert_allclose(psi1, np.eye(4), atol=1e-10)

    @pytest.mark.parametrize("fn", [calc_lambda, calc_psi],
                             ids=["lambda", "psi"])
    def test_interpolation_products_at_full_f32(self, fn):
        """The interpolation matrices' products ask for full float32: at
        DEFAULT precision a GPU may compute them in TF32."""
        text = str(jax.make_jaxpr(lambda tau: fn(jnp.eye(7), 0.2, tau))(
            jnp.float32(0.05)))
        n_dot = text.count("dot_general[")
        assert n_dot > 0 and n_dot == text.count(
            "precision=(Precision.HIGHEST, Precision.HIGHEST)")


class TestGPPrior:
    def test_linear_zero_on_constant_velocity(self):
        space = VectorSpace(3)
        x1 = jnp.asarray([0.0, 1.0, -2.0])
        v = jnp.asarray([0.5, -0.2, 0.1])
        dt = 0.4
        x2 = x1 + dt * v
        err = gp_prior_error(space, x1, v, x2, v, dt)
        np.testing.assert_allclose(np.asarray(err), np.zeros(6), atol=1e-12)

    def test_linear_jacobians_match_ad(self):
        space = VectorSpace(2)
        r = np.random.default_rng(1)
        x1, v1, x2, v2 = (jnp.asarray(r.normal(size=2)) for _ in range(4))
        dt = 0.3

        def err_z1(z):
            return gp_prior_error(space, z[:2], z[2:], x2, v2, dt)

        def err_z2(z):
            return gp_prior_error(space, x1, v1, z[:2], z[2:], dt)

        H1_ad = jax.jacfwd(err_z1)(jnp.concatenate([x1, v1]))
        H2_ad = jax.jacfwd(err_z2)(jnp.concatenate([x2, v2]))
        H1, H2 = gp_prior_jacobians_linear(2, dt, jnp.float64)
        np.testing.assert_allclose(np.asarray(H1_ad), np.asarray(H1), atol=1e-12)
        np.testing.assert_allclose(np.asarray(H2_ad), np.asarray(H2), atol=1e-12)

    def test_lie_zero_on_exp_trajectory(self):
        """SE(2) GP prior is zero when x2 = x1 * Exp(v dt) with v2 = v1.

        Matches GaussianProcessPriorLie error = [Log(x1^-1 x2) - v1 dt,
        v2 - v1] (GaussianProcessPriorLie.h:71-85)."""
        space = SE2Space()
        x1 = jnp.asarray([1.0, 2.0, 0.3])
        v = jnp.asarray([0.5, 0.0, 0.8])
        dt = 0.6
        x2 = se2.compose(x1, se2.expmap(v * dt))
        err = gp_prior_error(space, x1, v, x2, v, dt)
        np.testing.assert_allclose(np.asarray(err), np.zeros(6), atol=1e-10)

    def test_se3_zero_on_exp_trajectory(self):
        """Pose3 GP prior is zero on a constant-twist trajectory —
        mirrors GaussianProcessPriorPose3.h:15 (the Lie template on
        gtsam::Pose3, error GaussianProcessPriorLie.h:71-85)."""
        space = SE3Space()
        x1 = space.retract(
            space.identity(jnp.float64),
            jnp.asarray([0.2, -0.1, 0.4, 1.0, 2.0, -0.5]),
        )
        v = jnp.asarray([0.3, 0.1, -0.2, 0.5, 0.0, 0.8])
        dt = 0.6
        x2 = space.compose(x1, space.expmap(v * dt))
        err = gp_prior_error(space, x1, v, x2, v, dt)
        np.testing.assert_allclose(np.asarray(err), np.zeros(12), atol=1e-10)

    @pytest.mark.parametrize(
        "space",
        [SE2Space(), SE2VectorSpace(2), SE3Space()],
        ids=["se2", "se2xR2", "se3"],
    )
    def test_lie_jacobians_vs_fd(self, space):
        d = space.dim
        r = np.random.default_rng(2)
        x1 = space.retract(space.identity(jnp.float64), jnp.asarray(r.normal(size=d)))
        x2 = space.retract(space.identity(jnp.float64), jnp.asarray(r.normal(size=d)))
        v1 = jnp.asarray(r.normal(size=d))
        v2 = jnp.asarray(r.normal(size=d))
        dt = 0.5

        def err(dx1, dv1, dx2, dv2):
            return gp_prior_error(
                space,
                space.retract(x1, dx1), v1 + dv1,
                space.retract(x2, dx2), v2 + dv2,
                dt,
            )

        zeros = jnp.zeros(d, dtype=jnp.float64)
        jacs = jax.jacfwd(err, argnums=(0, 1, 2, 3))(zeros, zeros, zeros, zeros)
        # finite differences
        eps = 1e-7
        for argi in range(4):
            fd = np.zeros((2 * d, d))
            for k in range(d):
                dvec = np.zeros(d)
                dvec[k] = eps
                args_p = [zeros] * 4
                args_m = [zeros] * 4
                args_p[argi] = jnp.asarray(dvec)
                args_m[argi] = jnp.asarray(-dvec)
                fd[:, k] = (np.asarray(err(*args_p)) - np.asarray(err(*args_m))) / (2 * eps)
            np.testing.assert_allclose(np.asarray(jacs[argi]), fd, atol=1e-6)


class TestInterpolation:
    def test_linear_constant_velocity_exact(self):
        """Constant-velocity trajectories interpolate exactly
        (testTrajUtils.cpp:26-55 semantics)."""
        Qc = jnp.eye(2, dtype=jnp.float64)
        dt, tau = 0.8, 0.3
        coeffs = interp_coeffs(Qc, dt, tau)
        space = VectorSpace(2)
        x1 = jnp.asarray([1.0, -1.0])
        v = jnp.asarray([2.0, 0.5])
        x2 = x1 + dt * v
        pose, vel = interpolate_state(space, coeffs, x1, v, x2, v)
        np.testing.assert_allclose(np.asarray(pose), np.asarray(x1 + tau * v), atol=1e-10)
        np.testing.assert_allclose(np.asarray(vel), np.asarray(v), atol=1e-10)

    def test_lie_constant_velocity_exact(self):
        space = SE2Space()
        Qc = jnp.eye(3, dtype=jnp.float64)
        dt, tau = 1.0, 0.4
        coeffs = interp_coeffs(Qc, dt, tau)
        x1 = jnp.asarray([0.5, -0.5, 0.2])
        v = jnp.asarray([1.0, 0.0, 0.7])
        x2 = se2.compose(x1, se2.expmap(v * dt))
        pose, vel = interpolate_state(space, coeffs, x1, v, x2, v)
        expect = se2.compose(x1, se2.expmap(v * tau))
        np.testing.assert_allclose(np.asarray(pose), np.asarray(expect), atol=1e-8)
        np.testing.assert_allclose(np.asarray(vel), np.asarray(v), atol=1e-8)

    def test_se3_constant_velocity_exact(self):
        """Pose3 interpolation mirrors GaussianProcessInterpolatorPose3.h:15
        (Lie template, GaussianProcessInterpolatorLie.h:64-146)."""
        space = SE3Space()
        Qc = jnp.eye(6, dtype=jnp.float64)
        dt, tau = 1.0, 0.4
        coeffs = interp_coeffs(Qc, dt, tau)
        x1 = space.retract(
            space.identity(jnp.float64),
            jnp.asarray([0.1, 0.5, -0.3, 1.0, -2.0, 0.4]),
        )
        v = jnp.asarray([0.2, -0.1, 0.3, 1.0, 0.0, 0.7])
        x2 = space.compose(x1, space.expmap(v * dt))
        pose, vel = interpolate_state(space, coeffs, x1, v, x2, v)
        expect = space.compose(x1, space.expmap(v * tau))
        np.testing.assert_allclose(np.asarray(pose), np.asarray(expect), atol=1e-8)
        np.testing.assert_allclose(np.asarray(vel), np.asarray(v), atol=1e-8)

    def test_endpoint_consistency(self):
        Qc = 2.0 * jnp.eye(2, dtype=jnp.float64)
        dt = 0.8
        space = VectorSpace(2)
        r = np.random.default_rng(3)
        x1, v1, x2, v2 = (jnp.asarray(r.normal(size=2)) for _ in range(4))
        p0, ve0 = interpolate_state(space, interp_coeffs(Qc, dt, 0.0), x1, v1, x2, v2)
        np.testing.assert_allclose(np.asarray(p0), np.asarray(x1), atol=1e-9)
        np.testing.assert_allclose(np.asarray(ve0), np.asarray(v1), atol=1e-9)
        p1, ve1 = interpolate_state(space, interp_coeffs(Qc, dt, dt), x1, v1, x2, v2)
        np.testing.assert_allclose(np.asarray(p1), np.asarray(x2), atol=1e-8)
        np.testing.assert_allclose(np.asarray(ve1), np.asarray(v2), atol=1e-8)


class TestSE3Chain:
    """End-to-end Pose3 GP chain: endpoint priors + GP priors on SE(3)
    optimize to machine precision (the reference's Pose3 typedef use case,
    gpmp2.h:77-99; optimization pattern of
    gp/tests/testGaussianProcessPriorPose3.cpp)."""

    def test_pose3_gp_chain_optimizes(self):
        from gpmp2_jax.gp import calc_Q_inv
        from gpmp2_jax.planner.batch import _retract_traj
        from gpmp2_jax.planner.problem import Trajectory
        from gpmp2_jax.planner.traj_utils import init_traj_straight_line
        from gpmp2_jax.solver.optimize import OptimizerParams, optimize_batch

        space = SE3Space()
        d, n = 6, 6
        m = 2 * d
        dt = jnp.asarray(0.4, jnp.float64)
        Qc = jnp.eye(6, dtype=jnp.float64)
        W_gp = calc_Q_inv(Qc, dt)
        L_gp = jnp.linalg.cholesky(W_gp)
        sqrt_wp = 1e2  # prior sigma 1e-2

        start = space.retract(
            space.identity(jnp.float64),
            jnp.asarray([0.3, -0.2, 0.5, 1.0, 2.0, -1.0]),
        )
        goal = space.retract(
            space.identity(jnp.float64),
            jnp.asarray([-0.4, 0.3, 1.2, 3.0, -1.0, 0.5]),
        )
        # endpoint velocities consistent with a constant-twist path, so the
        # global minimum is exactly zero error (all residuals vanish on
        # x_{i+1} = x_i Exp(v dt))
        total_time = (n - 1) * float(dt)
        v_const = space.local(start, goal) / total_time

        def linearize(traj: Trajectory):
            pose, vel = traj.pose[0], traj.vel[0]

            def res(dz):
                p = jax.vmap(space.retract)(pose, dz[:, :d])
                v = vel + dz[:, d:]
                gp = jax.vmap(
                    lambda a, va, b, vb: gp_prior_error(space, a, va, b, vb, dt)
                )(p[:-1], v[:-1], p[1:], v[1:])
                return jnp.concatenate([
                    sqrt_wp * space.local(start, p[0]),
                    sqrt_wp * (v[0] - v_const),
                    sqrt_wp * space.local(goal, p[-1]),
                    sqrt_wp * (v[-1] - v_const),
                    (gp @ L_gp.T).reshape(-1),
                ])

            z0 = jnp.zeros((n, m), jnp.float64)
            J = jax.jacfwd(res)(z0).reshape(-1, n * m)
            r = res(z0)
            H = J.T @ J
            b = -(J.T @ r)
            err = 0.5 * jnp.sum(r * r)
            H_diag = jnp.stack(
                [H[i * m:(i + 1) * m, i * m:(i + 1) * m] for i in range(n)]
            )
            H_off = jnp.stack(
                [H[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] for i in range(n - 1)]
            )
            return H_diag[None], H_off[None], b.reshape(n, m)[None], err[None]

        init = init_traj_straight_line(space, start, goal, n - 1, total_time)
        # perturb the init so the solve does real work
        r = np.random.default_rng(0)
        init = Trajectory(
            jax.vmap(space.retract)(
                init.pose, jnp.asarray(0.2 * r.normal(size=(n, d)))
            )[None],
            (init.vel + jnp.asarray(0.1 * r.normal(size=(n, d))))[None],
        )

        res = optimize_batch(
            linearize, None, lambda t, dlt: _retract_traj(space, t, dlt),
            init,
            # errorTol (GTSAM errorTol semantics): reaching the machine
            # floor counts as converged, not gave-up
            OptimizerParams(method="lm", rel_thresh=1e-14, abs_thresh=1e-15,
                            err_thresh=1e-9, max_iter=100, loop="dynamic"),
        )
        assert bool(res.converged[0]) and not bool(res.gave_up[0])
        # endpoints recovered to prior precision; total error near machine 0
        assert float(res.error[0]) < 1e-9
        p = res.traj.pose[0]
        np.testing.assert_allclose(
            np.asarray(space.local(start, p[0])), 0.0, atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(space.local(goal, p[-1])), 0.0, atol=1e-8
        )
        # rotation blocks stay on SO(3)
        R = np.asarray(p[:, :9]).reshape(n, 3, 3)
        np.testing.assert_allclose(
            R @ np.transpose(R, (0, 2, 1)), np.broadcast_to(np.eye(3), (n, 3, 3)),
            atol=1e-10,
        )
