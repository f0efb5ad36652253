"""Batched block-tridiagonal SPD solver (block-Thomas / block-Cholesky).

This is the replacement for GTSAM's sparse variable elimination
in the reference's optimize() hot loop
(/root/reference/gpmp2/planner/BatchTrajOptimizer.cpp:212-308). Because the
trajectory state layout is regular (z_i = [pose tangent_i, vel_i]) and the
Markov GP prior couples only adjacent states, the Gauss-Newton normal
equations are block-tridiagonal BY CONSTRUCTION — exact structure, not an
approximation (SURVEY.md section 2.11/7).

  H = [[D_0, U_0,   0, ...],
       [U_0^T, D_1, U_1, ...],
       [ ...            ],
       [ ..., U_{n-2}^T, D_{n-1}]]

Factorization (block LDL^T):
  C_0 = D_0;  C_i = D_i - U_{i-1}^T C_{i-1}^{-1} U_{i-1}
Solve:
  z_i = b_i - U_{i-1}^T C_{i-1}^{-1} z_{i-1}     (forward)
  x_{n-1} = C_{n-1}^{-1} z_{n-1}
  x_i = C_i^{-1} z_i - C_i^{-1} U_i x_{i+1}       (backward)

The sequential dimension is the trajectory (n = total_step+1, typically
11-101); each step is a batch of small (m = 2*dof <= ~34) Cholesky solves,
batched over problems with vmap/leading axes. O(n m^3) instead of
O((nm)^3) dense.

Conditioning: trajectory problems mix precisions across ~8 orders of
magnitude (start/goal priors sigma=1e-4 vs obstacle sigma~0.1,
TrajOptimizerSetting.cpp:36-56), so a symmetric Jacobi (diagonal)
rescaling is applied by default to keep float32 viable.

`batched_block_tridiag_solve` is the optimizer's entry: a batch of damped
systems in the batch-major layout the linearize emits, block-flattened or
not. A fused GPU kernel for it (Pallas, Triton route) measured slower than
this vmapped scan on an H100 and was removed; see PERF.md.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .smallmat import chol_solve_unrolled, cholesky_unrolled

__all__ = ["batched_block_tridiag_solve", "block_tridiag_solve",
           "block_tridiag_chol"]

# beyond this block size the unrolled batch-major kernels stop paying off
# and XLA's native routines take over
_UNROLL_LIMIT = 48


def _chol(C, m):
    if m <= _UNROLL_LIMIT:
        return cholesky_unrolled(C)
    return jnp.linalg.cholesky(C)


def _chol_solve(L, rhs, m):
    """Solve (L L^T) x = rhs for rhs of shape (m,) or (m, k)."""
    if m <= _UNROLL_LIMIT:
        return chol_solve_unrolled(L, rhs)
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


def block_tridiag_chol(D, U, b):
    """Factor-and-forward-solve pass.

    D: (n, m, m) diagonal blocks; U: (n-1, m, m) upper off-diagonal blocks
    (H[i, i+1] = U[i]); b: (n, m).
    Returns (w, G) with w: (n, m) = C_i^{-1} z_i and G: (n-1, m, m) =
    C_i^{-1} U_i, ready for the backward substitution.
    """
    n, m = D.shape[0], D.shape[1]
    # pad U with a zero block so scan inputs align: U_pad[i] couples i -> i+1
    U_pad = jnp.concatenate([U, jnp.zeros((1, m, m), U.dtype)], axis=0)

    def fwd(carry, inp):
        P_C, P_z = carry  # contributions U_{i-1}^T C_{i-1}^{-1} {U_{i-1}, z_{i-1}}
        D_i, U_i, b_i = inp
        C_i = D_i - P_C
        z_i = b_i - P_z
        L_i = _chol(C_i, m)
        w_i = _chol_solve(L_i, z_i, m)
        G_i = _chol_solve(L_i, U_i, m)
        # full float32: at DEFAULT precision XLA ran this batched product
        # on the H100 as a TF32 GEMM, which rounds to ~3 digits and, with
        # its tiling chosen by batch size, sent a few per cent of WAM lanes
        # to other LM paths at another batch size
        carry = (jnp.matmul(U_i.T, G_i, precision=lax.Precision.HIGHEST),
                 jnp.matmul(U_i.T, w_i, precision=lax.Precision.HIGHEST))
        return carry, (w_i, G_i)

    init = (jnp.zeros((m, m), D.dtype), jnp.zeros((m,), D.dtype))
    _, (w, G) = lax.scan(fwd, init, (D, U_pad, b))
    return w, G[:-1]


def block_tridiag_solve(D, U, b, jacobi_scaling: bool = True):
    """Solve the SPD block-tridiagonal system H x = b.

    D: (n, m, m), U: (n-1, m, m), b: (n, m) -> x: (n, m).
    Batched via vmap over leading axes.

    jacobi_scaling: symmetric diagonal rescaling H' = S H S with
    S = diag(H)^{-1/2}; recommended (and default) for float32.
    """
    if jacobi_scaling:
        diag = jnp.diagonal(D, axis1=-2, axis2=-1)  # (n, m)
        s = lax.rsqrt(jnp.maximum(diag, 1e-30))
        D = D * s[:, :, None] * s[:, None, :]
        U = U * s[:-1, :, None] * s[1:, None, :]
        b = b * s

    w, G = block_tridiag_chol(D, U, b)

    def bwd(x_next, inp):
        w_i, G_i = inp
        x_i = w_i - jnp.matmul(G_i, x_next, precision=lax.Precision.HIGHEST)
        return x_i, x_i

    m = D.shape[1]
    G_pad = jnp.concatenate([G, jnp.zeros((1, m, m), D.dtype)], axis=0)
    _, xs = lax.scan(bwd, jnp.zeros((m,), D.dtype), (w, G_pad), reverse=True)
    x = xs
    if jacobi_scaling:
        x = x * s
    return x


def batched_block_tridiag_solve(D, U, b, jacobi_scaling: bool = True,
                                lam=None):
    """Solve (H + lam I) x = b for a batch of block-tridiagonal systems.

    D: (B, n, m, m) or block-flattened (B, n, m*m); U: the same with n-1
    blocks (H[i, i+1] = U[i]); b: (B, n, m); lam: (B,) per-problem LM
    damping (None = 0). Returns x: (B, n, m).
    """
    B, n, m = b.shape
    D = D.reshape(B, n, m, m)
    U = U.reshape(B, n - 1, m, m)
    if lam is not None:
        D = D + lam[:, None, None, None] * jnp.eye(m, dtype=D.dtype)
    return jax.vmap(
        lambda d, u, bb: block_tridiag_solve(d, u, bb,
                                             jacobi_scaling=jacobi_scaling)
    )(D, U, b)
