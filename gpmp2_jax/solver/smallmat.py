"""Batch-major small-matrix algebra, unrolled at trace time.

XLA's generic `cholesky` / `triangular_solve` lower to blocked
LAPACK-style loops, built for large matrices; the 2*dof x 2*dof blocks here
are 4-34 wide. This formulation is BATCH-MAJOR: unroll the factorization
at trace time into O(m^2) elementwise ops, each operating on the whole
problem batch at once, so every step is a large fused elementwise op. The
unrolled program grows as m^3: at m = 34 it compiles for minutes.

Used by the block-tridiagonal solver; matrices are (..., m, m) with any
leading batch shape, m static (unrolled).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["cholesky_unrolled", "solve_triangular_unrolled", "chol_solve_unrolled"]


def cholesky_unrolled(A):
    """Lower Cholesky factor of SPD (..., m, m), Cholesky-Banachiewicz
    unrolled over the (static) m. Returns L with zeros above the diagonal."""
    m = A.shape[-1]
    # cols[j] holds column j entries L[i, j] for i >= j as (...,) arrays
    L = [[None] * m for _ in range(m)]  # L[i][j]
    for j in range(m):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = jnp.sqrt(s)
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, m):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv
    zero = jnp.zeros_like(A[..., 0, 0])
    rows = [
        jnp.stack([L[i][j] if j <= i else zero for j in range(m)], axis=-1)
        for i in range(m)
    ]
    return jnp.stack(rows, axis=-2)


def solve_triangular_unrolled(L, B, lower=True, trans=False):
    """Solve T X = B with T = L (lower) or L^T (trans=True), B (..., m, k)
    or (..., m). Forward/back substitution unrolled over rows; each row
    update is a batched vector op."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    m = L.shape[-1]
    X = [None] * m

    if lower and not trans:
        for i in range(m):
            t = B[..., i, :]
            for k in range(i):
                t = t - L[..., i, k, None] * X[k]
            X[i] = t / L[..., i, i, None]
    elif lower and trans:
        # (L^T) X = B: back substitution, L^T[i, k] = L[k, i] for k >= i
        for i in reversed(range(m)):
            t = B[..., i, :]
            for k in range(i + 1, m):
                t = t - L[..., k, i, None] * X[k]
            X[i] = t / L[..., i, i, None]
    else:
        raise NotImplementedError("upper triangular not needed")

    out = jnp.stack(X, axis=-2)
    if vec:
        out = out[..., 0]
    return out


def chol_solve_unrolled(L, B):
    """Solve (L L^T) X = B given the Cholesky factor."""
    Y = solve_triangular_unrolled(L, B, lower=True, trans=False)
    return solve_triangular_unrolled(L, Y, lower=True, trans=True)
