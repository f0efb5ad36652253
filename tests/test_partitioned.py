"""Trajectory-axis-parallel block-tridiagonal solve (solver/partitioned.py)
vs the sequential scan solver — exact decomposition, tight f64 parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax.parallel import make_mesh
from gpmp2_jax.solver import (
    block_tridiag_solve,
    block_tridiag_solve_partitioned,
    block_tridiag_solve_ts_sharded,
)
from gpmp2_jax.solver.partitioned import block_tridiag_solve_matrhs


def _system(n, m, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, m)).astype(dtype)
    D = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(m, dtype=dtype)
    U = (0.3 * rng.normal(size=(n - 1, m, m))).astype(dtype)
    b = rng.normal(size=(n, m)).astype(dtype)
    return jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)


class TestMatRHS:
    def test_matches_vector_solver_per_column(self):
        D, U, b = _system(9, 4)
        B = jnp.stack([b, 2 * b, -b], axis=-1)
        X = block_tridiag_solve_matrhs(D, U, B)
        for k, scale in enumerate([1.0, 2.0, -1.0]):
            ref = block_tridiag_solve(D, U, scale * b, jacobi_scaling=False)
            np.testing.assert_allclose(np.asarray(X[..., k]),
                                       np.asarray(ref), rtol=1e-9, atol=1e-9)


class TestPartitioned:
    @pytest.mark.parametrize("n,m,P", [
        (11, 14, 2),    # WAM bench shape
        (23, 4, 4),
        (101, 6, 8),    # long horizon over 8 parts
        (97, 3, 6),     # padding path (n not P*Li + P-1)
        (15, 2, 1),     # fallback to the scan solver
    ])
    def test_matches_sequential(self, n, m, P):
        D, U, b = _system(n, m, seed=n + m + P)
        x_ref = block_tridiag_solve(D, U, b)
        x_par = block_tridiag_solve_partitioned(D, U, b, P)
        np.testing.assert_allclose(np.asarray(x_par), np.asarray(x_ref),
                                   rtol=1e-8, atol=1e-8)

    def test_solves_the_system(self):
        n, m, P = 31, 5, 4
        D, U, b = _system(n, m, seed=5)
        x = np.asarray(block_tridiag_solve_partitioned(D, U, b, P))
        # residual check against the dense assembled H
        H = np.zeros((n * m, n * m))
        for i in range(n):
            H[i*m:(i+1)*m, i*m:(i+1)*m] = np.asarray(D[i])
            if i < n - 1:
                H[i*m:(i+1)*m, (i+1)*m:(i+2)*m] = np.asarray(U[i])
                H[(i+1)*m:(i+2)*m, i*m:(i+1)*m] = np.asarray(U[i]).T
        r = H @ x.reshape(-1) - np.asarray(b).reshape(-1)
        assert np.max(np.abs(r)) < 1e-8


class TestTsSharded:
    def test_sharded_matches_sequential(self):
        mesh = make_mesh(axis_names=("ts",))
        n, m, P = 127, 6, 8
        D, U, b = _system(n, m, seed=9)
        x_ref = block_tridiag_solve(D, U, b)

        @jax.jit
        def solve(D, U, b):
            return block_tridiag_solve_ts_sharded(mesh, D, U, b, P)

        x = solve(D, U, b)
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                                   rtol=1e-8, atol=1e-8)

    def test_axis_divisibility_enforced(self):
        mesh = make_mesh(axis_names=("ts",))
        D, U, b = _system(31, 3, seed=2)
        with pytest.raises(AssertionError):
            block_tridiag_solve_ts_sharded(mesh, D, U, b, n_parts=6)


class TestDispatch:
    def test_long_horizon_default_scan(self):
        """Default long-horizon dispatch stays on the scan."""
        from gpmp2_jax.solver.blocktridiag import batched_block_tridiag_solve

        D, U, b = _system(300, 4, seed=12)
        x = batched_block_tridiag_solve(D[None], U[None], b[None])
        x_ref = block_tridiag_solve(D, U, b)
        np.testing.assert_allclose(np.asarray(x[0]), np.asarray(x_ref),
                                   rtol=1e-8, atol=1e-8)
