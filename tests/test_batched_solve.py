"""The optimizer's batched block-tridiagonal solve
(solver/blocktridiag.py `batched_block_tridiag_solve`) against a dense
float64 solve: damping and Jacobi scaling on and off, both the
(B, n, m, m) and the block-flattened layout, and both linearize layouts
the optimizer accepts.

m = 34 (the mobile-two-arm block) is checked on the card by chip_smoke.py:
its unrolled Cholesky takes minutes to compile for the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax.solver.blocktridiag import batched_block_tridiag_solve


def random_system(B, n, m, seed=0):
    """SPD block-tridiagonal batch (float64) whose diagonal spans several
    orders of magnitude, like the planner's priors against its factors."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, m, m))
    D = A @ np.swapaxes(A, -1, -2) / m + (m + 2) * np.eye(m)
    s = 10.0 ** rng.uniform(-2, 2, size=(B, n, m))
    U = 0.3 * rng.normal(size=(B, n - 1, m, m))
    D = D * s[..., :, None] * s[..., None, :]
    U = U * s[:, :-1, :, None] * s[:, 1:, None, :]
    b = rng.normal(size=(B, n, m)) * s
    lam = np.abs(rng.normal(size=(B,)))
    return D, U, b, lam


def dense_solve(D, U, b, lam):
    """float64 dense solve of (H + lam I) x = b, lane by lane."""
    B, n, m = b.shape
    out = np.empty_like(b)
    for k in range(B):
        H = np.zeros((n * m, n * m))
        for i in range(n):
            H[i * m:(i + 1) * m, i * m:(i + 1) * m] = D[k, i]
        for i in range(n - 1):
            H[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = U[k, i]
            H[(i + 1) * m:(i + 2) * m, i * m:(i + 1) * m] = U[k, i].T
        H += lam[k] * np.eye(n * m)
        out[k] = np.linalg.solve(H, b[k].reshape(-1)).reshape(n, m)
    return out


def rel_residual(D, U, b, lam, x):
    """Per-lane ||(H + lam I) x - b|| / ||b|| in float64."""
    x = np.asarray(x, np.float64)
    Hx = np.einsum("bnij,bnj->bni", D, x) + lam[:, None, None] * x
    Hx[:, :-1] += np.einsum("bnij,bnj->bni", U, x[:, 1:])
    Hx[:, 1:] += np.einsum("bnji,bnj->bni", U, x[:, :-1])
    r = (Hx - b).reshape(b.shape[0], -1)
    return np.linalg.norm(r, axis=-1) / np.linalg.norm(
        b.reshape(b.shape[0], -1), axis=-1)


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("damped", [True, False])
@pytest.mark.parametrize("B,n,m", [(3, 5, 4), (7, 4, 6), (5, 11, 14)])
def test_dispatch_matches_dense_f64(B, n, m, damped, scale):
    D, U, b, lam = random_system(B, n, m, seed=m)
    if not damped:
        lam = np.zeros_like(lam)
    x_ref = dense_solve(D, U, b, lam)
    x = batched_block_tridiag_solve(jnp.asarray(D), jnp.asarray(U),
                                    jnp.asarray(b), jacobi_scaling=scale,
                                    lam=jnp.asarray(lam) if damped else None)
    assert x.shape == (B, n, m) and x.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-8,
                               atol=1e-10 * np.abs(x_ref).max())


@pytest.mark.parametrize("B,n,m", [(6, 11, 14), (4, 6, 4)])
def test_dispatch_float32_residual(B, n, m):
    """float32, the planner's dtype: per-lane relative residual against
    the float64 system, with the Jacobi scaling that keeps float32 viable
    on this conditioning (the bound chip_smoke.py holds the card to)."""
    D, U, b, lam = random_system(B, n, m, seed=100 + m)
    x = batched_block_tridiag_solve(
        jnp.asarray(D, jnp.float32), jnp.asarray(U, jnp.float32),
        jnp.asarray(b, jnp.float32), lam=jnp.asarray(lam, jnp.float32))
    assert x.dtype == jnp.float32
    assert rel_residual(D, U, b, lam, x).max() < 1e-3


def test_dispatch_takes_flat_blocks():
    """The optimizer's flat layout (B, n, m*m) solves like (B, n, m, m)."""
    B, n, m = 4, 6, 5
    D, U, b, lam = random_system(B, n, m, seed=3)
    x4 = batched_block_tridiag_solve(jnp.asarray(D), jnp.asarray(U),
                                     jnp.asarray(b), lam=jnp.asarray(lam))
    xf = batched_block_tridiag_solve(
        jnp.asarray(D.reshape(B, n, m * m)),
        jnp.asarray(U.reshape(B, n - 1, m * m)), jnp.asarray(b),
        lam=jnp.asarray(lam))
    np.testing.assert_array_equal(np.asarray(xf), np.asarray(x4))


@pytest.mark.parametrize("layout", ["batch", "flat"])
def test_optimizer_layouts_solve_alike(layout):
    """The optimizer's damped solve takes both linearize layouts and
    returns the same step."""
    from gpmp2_jax.solver.optimize import OptimizerParams, _build_fns

    B, n, m = 3, 5, 4
    D, U, b, lam = random_system(B, n, m, seed=8)
    x_ref = dense_solve(D, U, b, lam)
    lin = {"batch": (D, U, b),
           "flat": (D.reshape(B, n, m * m), U.reshape(B, n - 1, m * m),
                    b)}[layout]
    err = np.ones(B)
    params = OptimizerParams(method="lm", lin_layout=layout, max_iter=1)
    seen = {}

    def linearize(data, traj):
        return tuple(jnp.asarray(a) for a in lin) + (jnp.asarray(err),)

    def retract(traj, delta):
        seen["delta"] = delta
        return traj

    make_init, step = _build_fns(linearize, retract, params)
    st = make_init(None, jnp.zeros((B, n, m)))
    step(None, st._replace(tr=jnp.asarray(lam)))
    np.testing.assert_allclose(np.asarray(seen["delta"]), x_ref, rtol=1e-8,
                               atol=1e-10 * np.abs(x_ref).max())


def dot_precisions(fn, *args):
    """(number of dot_general ops, number at HIGHEST) in fn's jaxpr."""
    import jax

    text = str(jax.make_jaxpr(fn)(*args))
    return (text.count("dot_general["),
            text.count("precision=(Precision.HIGHEST, Precision.HIGHEST)"))


def test_scan_products_at_full_f32():
    """Every product of the solve's scan asks for full float32: at DEFAULT
    precision a GPU may run the batched Schur product in TF32."""
    D, U, b, lam = (jnp.asarray(a, jnp.float32)
                    for a in random_system(4, 5, 6, seed=4))
    n_dot, n_high = dot_precisions(
        lambda D, U, b: batched_block_tridiag_solve(D, U, b), D, U, b)
    assert n_dot > 0 and n_high == n_dot
