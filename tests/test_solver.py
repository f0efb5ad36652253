"""Block-tridiagonal solver and batched optimizer tests."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
from dataclasses import replace as dataclasses_replace

from gpmp2_jax.solver.blocktridiag import block_tridiag_solve
from gpmp2_jax.solver.optimize import OptimizerParams, optimize_batch


def random_block_tridiag(rng, n, m, cond_boost=0.0):
    """Random SPD block-tridiagonal system (dense reference assembled too)."""
    A = rng.normal(size=(n * m, n * m))
    H_dense = A @ A.T + (n * m + cond_boost) * np.eye(n * m)
    # zero out everything beyond the block tridiagonal
    for i in range(n):
        for j in range(n):
            if abs(i - j) > 1:
                H_dense[i * m : (i + 1) * m, j * m : (j + 1) * m] = 0.0
    D = np.stack([H_dense[i * m : (i + 1) * m, i * m : (i + 1) * m] for i in range(n)])
    U = np.stack(
        [H_dense[i * m : (i + 1) * m, (i + 1) * m : (i + 2) * m] for i in range(n - 1)]
    )
    b = rng.normal(size=(n, m))
    return H_dense, D, U, b


class TestBlockTridiag:
    def test_matches_dense_solve(self):
        rng = np.random.default_rng(0)
        n, m = 7, 4
        H, D, U, b = random_block_tridiag(rng, n, m)
        x = block_tridiag_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b))
        x_dense = np.linalg.solve(H, b.reshape(-1)).reshape(n, m)
        np.testing.assert_allclose(np.asarray(x), x_dense, atol=1e-9)

    def test_no_scaling_matches(self):
        rng = np.random.default_rng(1)
        n, m = 5, 3
        H, D, U, b = random_block_tridiag(rng, n, m)
        x = block_tridiag_solve(
            jnp.asarray(D), jnp.asarray(U), jnp.asarray(b), jacobi_scaling=False
        )
        x_dense = np.linalg.solve(H, b.reshape(-1)).reshape(n, m)
        np.testing.assert_allclose(np.asarray(x), x_dense, atol=1e-9)

    def test_single_block(self):
        rng = np.random.default_rng(2)
        m = 4
        A = rng.normal(size=(m, m))
        D = (A @ A.T + m * np.eye(m))[None]
        b = rng.normal(size=(1, m))
        x = block_tridiag_solve(
            jnp.asarray(D), jnp.zeros((0, m, m)), jnp.asarray(b)
        )
        np.testing.assert_allclose(np.asarray(x[0]), np.linalg.solve(D[0], b[0]), atol=1e-10)

    def test_batched_vmap(self):
        rng = np.random.default_rng(3)
        n, m, B = 6, 3, 4
        Ds, Us, bs, xs_expect = [], [], [], []
        for _ in range(B):
            H, D, U, b = random_block_tridiag(rng, n, m)
            Ds.append(D)
            Us.append(U)
            bs.append(b)
            xs_expect.append(np.linalg.solve(H, b.reshape(-1)).reshape(n, m))
        xs = jax.vmap(block_tridiag_solve)(
            jnp.asarray(Ds), jnp.asarray(Us), jnp.asarray(bs)
        )
        np.testing.assert_allclose(np.asarray(xs), np.stack(xs_expect), atol=1e-8)

    def test_ill_conditioned_prior_scale(self):
        """Mix of 1e8 (prior) and 1e2 (obstacle) precisions: Jacobi scaling
        keeps the solve accurate — the float32-critical case."""
        rng = np.random.default_rng(4)
        n, m = 5, 4
        H, D, U, b = random_block_tridiag(rng, n, m)
        D[0] += 1e8 * np.eye(m)
        D[-1] += 1e8 * np.eye(m)
        Hd = H.copy()
        Hd[:m, :m] += 1e8 * np.eye(m)
        Hd[-m:, -m:] += 1e8 * np.eye(m)
        x = block_tridiag_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b))
        x_dense = np.linalg.solve(Hd, b.reshape(-1)).reshape(n, m)
        np.testing.assert_allclose(np.asarray(x), x_dense, rtol=1e-6, atol=1e-10)


class TestOptimizer:
    """Optimize tiny quadratic/nonlinear problems through the generic
    batched optimizer using a dense->block wrapper."""

    def _setup_quadratic(self, B=3, n=4, m=2, seed=0):
        """Problem: min 0.5 sum ((x - target)^2) with a smoothness coupling:
        r_i = x_i - t_i (unary), r'_i = x_{i+1} - x_i (binary)."""
        rng = np.random.default_rng(seed)
        targets = jnp.asarray(rng.normal(size=(B, n, m)))

        def error_fn(x):
            unary = 0.5 * jnp.sum((x - targets) ** 2, axis=(1, 2))
            smooth = 0.5 * jnp.sum((x[:, 1:] - x[:, :-1]) ** 2, axis=(1, 2))
            return unary + smooth

        def linearize_fn(x):
            B_, n_, m_ = x.shape
            eye = jnp.eye(m_)
            H_diag = jnp.zeros((B_, n_, m_, m_)) + eye  # unary
            # smoothness contributions
            H_diag = H_diag.at[:, :-1].add(eye)
            H_diag = H_diag.at[:, 1:].add(eye)
            H_off = jnp.broadcast_to(-eye, (B_, n_ - 1, m_, m_))
            r_u = x - targets
            r_s = x[:, 1:] - x[:, :-1]
            b = -r_u
            b = b.at[:, :-1].add(r_s)
            b = b.at[:, 1:].add(-r_s)
            return H_diag, H_off, b, error_fn(x)

        def retract_fn(x, delta):
            return x + delta

        x0 = jnp.zeros((B, n, m))
        return linearize_fn, error_fn, retract_fn, x0, targets

    def test_gn_one_step_exact(self):
        lin, err, ret, x0, targets = self._setup_quadratic()
        res = optimize_batch(lin, err, ret, x0, OptimizerParams(method="gaussnewton"))
        # quadratic: GN converges in one step to the global optimum
        g = jax.grad(lambda x: jnp.sum(err(x)))(res.traj)
        np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-9)
        assert bool(jnp.all(res.converged))
        assert int(jnp.max(res.iterations)) <= 2

    def test_lm_reaches_same_optimum(self):
        lin, err, ret, x0, targets = self._setup_quadratic()
        res = optimize_batch(
            lin, err, ret, x0,
            OptimizerParams(method="lm", rel_thresh=1e-10, abs_thresh=1e-12, max_iter=100),
        )
        g = jax.grad(lambda x: jnp.sum(err(x)))(res.traj)
        np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-6)

    def test_dogleg_reaches_same_optimum(self):
        lin, err, ret, x0, targets = self._setup_quadratic()
        res = optimize_batch(
            lin, err, ret, x0,
            OptimizerParams(method="dogleg", rel_thresh=1e-10, abs_thresh=1e-12,
                            max_iter=100),
        )
        g = jax.grad(lambda x: jnp.sum(err(x)))(res.traj)
        np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-6)

    def test_error_never_increases_lm(self):
        lin, err, ret, x0, _ = self._setup_quadratic(seed=5)
        res = optimize_batch(lin, err, ret, x0, OptimizerParams(method="lm"))
        assert bool(jnp.all(res.error <= err(x0) + 1e-12))

    def _setup_mixed_infeasible(self):
        """Lane 0: easy quadratic. Lane 1: constant error with a bogus
        gradient — no step can ever decrease it, so LM must raise lambda
        past lambda_max and report gave_up (NOT converged)."""
        n, m = 2, 1
        target = jnp.ones((n, m))

        def error_fn(x):
            e0 = 0.5 * jnp.sum((x[0] - target) ** 2)
            e1 = jnp.asarray(1.0, x.dtype)
            return jnp.stack([e0, e1])

        def linearize_fn(x):
            eye = jnp.broadcast_to(jnp.eye(m), (2, n, m, m))
            b0 = -(x[0] - target)
            b1 = jnp.ones((n, m))  # bogus: points nowhere useful
            b = jnp.stack([b0, b1])
            H_off = jnp.zeros((2, n - 1, m, m))
            return eye, H_off, b, error_fn(x)

        return linearize_fn, error_fn, lambda x, d: x + d, jnp.zeros((2, n, m))

    def test_gave_up_separated_from_converged(self):
        lin, err, ret, x0 = self._setup_mixed_infeasible()
        for loop in ("chunked", "static", "dynamic"):
            res = optimize_batch(
                lin, err, ret, x0, OptimizerParams(method="lm", loop=loop)
            )
            conv = np.asarray(res.converged)
            gave = np.asarray(res.gave_up)
            assert conv[0] and not gave[0], loop
            assert gave[1] and not conv[1], loop
            # the infeasible lane's error is untouched
            np.testing.assert_allclose(float(res.error[1]), 1.0)

    def test_gave_up_dogleg_radius_collapse(self):
        lin, err, ret, x0 = self._setup_mixed_infeasible()
        res = optimize_batch(
            lin, err, ret, x0,
            OptimizerParams(method="dogleg", max_iter=60, reject_budget=30),
        )
        assert bool(res.gave_up[1]) and not bool(res.converged[1])
        assert bool(res.converged[0]) and not bool(res.gave_up[0])

    def test_verbosity_error_trace(self, capfd):
        lin, err, ret, x0, _ = self._setup_quadratic()
        res = optimize_batch(
            lin, err, ret, x0,
            OptimizerParams(method="lm", verbosity="error"),
        )
        jax.effects_barrier()
        out = capfd.readouterr().out
        assert "[optimize]" in out and "err(mean)" in out


# Compaction must be invisible: bitwise on CPU, where batch size never
# changes kernel tiling; on accelerator backends different batch shapes may
# compile to differently tiled kernels, so allow a tiny float tolerance
# there instead of flaking.
_EXACT = jax.default_backend() == "cpu"
_C_TOL = dict(rtol=0, atol=0) if _EXACT else dict(rtol=1e-12, atol=1e-12)


class TestCompaction:
    """Straggler compaction in chunked mode (OptimizerParams.compact):
    between chunks, active lanes are gathered into a smaller batch. The
    compaction must be invisible — results identical to the static loop."""

    def _setup_cubic(self, B=16, n=3, m=2):
        """Per-lane data convention (data, traj): r = x^3 - t. Larger |t|
        needs more Newton steps, so lanes converge at different chunks."""
        rng = np.random.default_rng(7)
        targets = jnp.asarray(
            rng.uniform(1.0, 50.0, size=(B, n, m)) * (1.0 + 9.0 * (rng.random((B, 1, 1)) > 0.7))
        )

        def lin(data, x):
            r = x**3 - data
            j = 3.0 * x**2  # elementwise Jacobian
            H_diag = jnp.einsum(
                "bnm,mk->bnmk", j * j, jnp.eye(m)
            )  # diag blocks of J^T J
            H_off = jnp.zeros((x.shape[0], n - 1, m, m), x.dtype)
            b = -(j * r)
            return H_diag, H_off, b, 0.5 * jnp.sum(r * r, axis=(1, 2))

        ret = lambda x, d: x + d  # noqa: E731
        x0 = jnp.ones((B, n, m))
        data_axes = 0
        return lin, ret, x0, targets, data_axes

    def test_compacted_matches_static(self):
        lin, ret, x0, data, axes = self._setup_cubic()
        base = OptimizerParams(
            method="lm", rel_thresh=1e-12, abs_thresh=1e-14, max_iter=40,
            reject_budget=20,
        )
        res_static = optimize_batch(
            lin, None, ret, x0, dataclasses_replace(base, loop="static"),
            data=data, data_axes=axes,
        )
        res_comp = optimize_batch(
            lin, None, ret, x0,
            dataclasses_replace(
                base, loop="chunked", chunk_size=2, compact=True,
                compact_floor=2,
            ),
            data=data, data_axes=axes,
        )
        np.testing.assert_array_equal(
            np.asarray(res_comp.converged), np.asarray(res_static.converged)
        )
        np.testing.assert_array_equal(
            np.asarray(res_comp.iterations), np.asarray(res_static.iterations)
        )
        np.testing.assert_allclose(
            np.asarray(res_comp.traj), np.asarray(res_static.traj),
            **_C_TOL,
        )
        np.testing.assert_allclose(
            np.asarray(res_comp.error), np.asarray(res_static.error),
            **_C_TOL,
        )

    def test_tail_growth_matches(self):
        """Geometric tail growth (tail_growth) is pure scheduling: results
        are bit-identical to the uniform-tail chunked loop and the static
        loop regardless of growth factor."""
        lin, ret, x0, data, axes = self._setup_cubic()
        base = OptimizerParams(
            method="lm", rel_thresh=1e-12, abs_thresh=1e-14, max_iter=40,
            reject_budget=20, loop="chunked", chunk_size=2, tail_chunk=1,
            compact=True, compact_floor=2,
        )
        res_uniform = optimize_batch(
            lin, None, ret, x0, base, data=data, data_axes=axes)
        res_grow = optimize_batch(
            lin, None, ret, x0, dataclasses_replace(base, tail_growth=2.0),
            data=data, data_axes=axes)
        np.testing.assert_array_equal(
            np.asarray(res_grow.converged), np.asarray(res_uniform.converged))
        np.testing.assert_array_equal(
            np.asarray(res_grow.iterations),
            np.asarray(res_uniform.iterations))
        np.testing.assert_allclose(
            np.asarray(res_grow.traj), np.asarray(res_uniform.traj),
            **_C_TOL)

    def test_compaction_disabled_matches(self):
        lin, ret, x0, data, axes = self._setup_cubic()
        base = OptimizerParams(method="lm", max_iter=40, reject_budget=20)
        res_on = optimize_batch(
            lin, None, ret, x0,
            dataclasses_replace(base, chunk_size=2, compact=True, compact_floor=2),
            data=data, data_axes=axes,
        )
        res_off = optimize_batch(
            lin, None, ret, x0,
            dataclasses_replace(base, chunk_size=2, compact=False),
            data=data, data_axes=axes,
        )
        np.testing.assert_allclose(
            np.asarray(res_on.traj), np.asarray(res_off.traj), **_C_TOL
        )


def test_optimizer_traces_contractions_at_full_f32():
    """Every contraction the optimizer traces, the caller's own linearize
    included, asks for full float32 whatever the caller's default."""
    from gpmp2_jax.solver.optimize import _build_fns

    B, n, m = 2, 3, 2

    def lin(data, x):
        J = jnp.broadcast_to(jnp.eye(m), (B, n, m, m))
        H = J @ J  # no precision given: the optimizer supplies it
        r = jnp.einsum("bnij,bnj->bni", J, x)
        return H, jnp.zeros((B, n - 1, m, m)), -r, jnp.sum(r * r, (1, 2))

    make_init, step = _build_fns(lin, lambda x, d: x + d,
                                 OptimizerParams(method="lm"))
    text = str(jax.make_jaxpr(
        lambda x: step(None, make_init(None, x)))(jnp.ones((B, n, m))))
    n_dot = text.count("dot_general[")
    assert n_dot > 0 and n_dot == text.count(
        "precision=(Precision.HIGHEST, Precision.HIGHEST)")


class TestFlatLayout:
    """lin_layout='flat' (block-flattened normal equations, which
    plan_batch picks for LM/GN) must match the (B, n, m, m) batch layout
    on every loop mode."""

    def _setup(self):
        import numpy as np

        from gpmp2_jax.kinematics.fk import PointRobotFK
        from gpmp2_jax.kinematics.robot import make_robot_model
        from gpmp2_jax.obstacle.sdf import PlanarSDF
        from gpmp2_jax.planner import TrajOptimizerSetting
        from gpmp2_jax.planner.batch import (
            infer_batch_axes,
            make_problem,
            optimizer_params_from_setting,
        )
        from gpmp2_jax.planner.traj_utils import init_traj_straight_line

        ys = -1.5 + 3.0 / 95 * np.arange(96)
        X, Y = np.meshgrid(ys, ys)
        sdf = PlanarSDF(
            origin=jnp.asarray([-1.5, -1.5]), cell_size=jnp.asarray(3.0 / 95),
            data=jnp.asarray(np.sqrt(X**2 + (Y - 0.12) ** 2) - 0.3),
        )
        robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))])
        setting = TrajOptimizerSetting(
            dof=2, total_step=10, total_time=5.0, obs_check_inter=3,
            opt_type="lm", max_iter=30, rel_thresh=1e-5, Qc=np.eye(2),
        )
        B = 5
        rng = np.random.default_rng(3)
        starts = jnp.asarray(
            np.stack([[-0.8, dy] for dy in rng.uniform(-0.3, 0.3, B)]),
            jnp.float32)
        goals = jnp.asarray(
            np.stack([[0.8, dy] for dy in rng.uniform(-0.3, 0.3, B)]),
            jnp.float32)
        zeros = jnp.zeros((B, 2), jnp.float32)
        probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
        tmpl = make_problem(robot, sdf, starts[0], zeros[0], goals[0],
                            zeros[0], setting)
        axes = infer_batch_axes(probs, tmpl)
        init = jax.vmap(
            lambda s, g: init_traj_straight_line(robot.space, s, g, 10, 5.0)
        )(starts, goals)
        return probs, axes, init, optimizer_params_from_setting(setting)

    @pytest.mark.parametrize("loop", ["chunked", "static"])
    @pytest.mark.parametrize("method", ["lm", "gaussnewton"])
    def test_flat_matches_batch(self, loop, method):
        import dataclasses

        from gpmp2_jax.planner.batch import (_retract_for, _vmapped_lin_err,
                                             plan_batch)

        probs, axes, init, params = self._setup()
        params = dataclasses.replace(params, loop=loop, method=method,
                                     max_iter=12, chunk_size=4)
        r_f = plan_batch(probs, init, params, axes)
        lin, err = _vmapped_lin_err(axes)
        r_b = optimize_batch(lin, err, _retract_for(probs.space), init,
                             params, data=probs, data_axes=axes)
        np.testing.assert_allclose(np.asarray(r_f.error),
                                   np.asarray(r_b.error), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(r_f.traj.pose),
                                   np.asarray(r_b.traj.pose), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(r_f.iterations),
                                      np.asarray(r_b.iterations))

    def test_flat_rejects_dogleg(self):
        import dataclasses

        from gpmp2_jax.planner.batch import plan_batch

        probs, axes, init, params = self._setup()
        params = dataclasses.replace(params, method="dogleg",
                                     lin_layout="flat")
        with pytest.raises(ValueError, match="flat"):
            plan_batch(probs, init, params, axes)

    def test_flat_compaction_path(self):
        """Compaction's gather/scatter of the flat lin triple returns the
        same result as no compaction."""
        import dataclasses

        from gpmp2_jax.planner.batch import plan_batch

        probs, axes, init, params = self._setup()
        base = dataclasses.replace(params, loop="chunked", chunk_size=2,
                                   compact_floor=2)
        r_nc = plan_batch(probs, init,
                          dataclasses.replace(base, compact=False), axes)
        r_c = plan_batch(probs, init,
                         dataclasses.replace(base, compact=True), axes)
        np.testing.assert_allclose(np.asarray(r_c.error),
                                   np.asarray(r_nc.error), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(r_c.traj.pose),
                                   np.asarray(r_nc.traj.pose), atol=1e-6)
