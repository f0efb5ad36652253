"""Gauss-Newton accumulation helpers: residual groups -> block-tridiagonal
normal equations.

This replaces GTSAM's per-factor linearize + sparse assembly
(graph.linearize(values) in the reference hot loop, SURVEY.md section 3.1)
with structure-of-arrays einsum accumulation. Each factor *type* is one
batched residual kernel; its Jacobian blocks are contracted into

  H_diag[i] += J_i^T W J_i        (m x m per state, m = 2*dof)
  H_off[i]  += J_i^T W J_{i+1}    (coupling i -> i+1)
  b[i]      -= J_i^T W r
  err       += 0.5 r^T W r        (GTSAM 0.5-whitened-norm convention)

Weights W are precisions (inverse covariances). Two explicit kinds —
mirroring gtsam Isotropic/Diagonal vs full Gaussian noise models:
  diag: scalar () or per-residual-dim array broadcastable against r
  full: (R, R) matrix over the residual dimension (last axis of r)

Every contraction that builds the normal equations asks for full float32
(`HIGHEST`): on a GPU a float32 product may otherwise run in TF32, about
three decimal digits, while H's entries span ~8 orders of magnitude (start
and goal priors at sigma 1e-4 against obstacle factors at ~0.1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "HIGHEST", "full_f32", "apply_W_diag", "apply_W_full",
    "quad_err_diag", "quad_err_full",
    "jtwj_diag", "jtwj_full",
    "jtwr_diag", "jtwr_full",
]

HIGHEST = jax.lax.Precision.HIGHEST


def full_f32(fn):
    """`fn`, traced with every float32 contraction at HIGHEST precision,
    its callees' included (the optimizer's step, the partitioned solves).
    On a GPU, XLA may run a DEFAULT-precision float32 GEMM in TF32, and
    then its rounding depends on the tiling, which depends on the batch
    size."""

    @functools.wraps(fn)
    def traced_at_highest(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return traced_at_highest


# ---- diagonal / isotropic precision --------------------------------------


def apply_W_diag(W, r):
    return jnp.asarray(W) * r


def quad_err_diag(W, r):
    """0.5 * sum W r^2 over all axes."""
    return 0.5 * jnp.sum(jnp.asarray(W) * r * r)


def jtwj_diag(JA, W, JB):
    """J_A^T diag(W) J_B; J: (..., R, m) -> (..., m, m)."""
    W = jnp.asarray(W)
    WJB = W[..., None] * JB if W.ndim > 0 else W * JB
    return jnp.matmul(jnp.swapaxes(JA, -1, -2), WJB, precision=HIGHEST)


def jtwr_diag(J, W, r):
    """J^T diag(W) r; J: (..., R, m), r: (..., R) -> (..., m)."""
    Wr = apply_W_diag(W, r)
    return jnp.einsum("...rm,...r->...m", J, Wr, precision=HIGHEST)


# ---- full precision matrix over the residual dimension -------------------


def apply_W_full(W, r):
    return jnp.einsum("...rs,...s->...r", jnp.asarray(W), r,
                      precision=HIGHEST)


def quad_err_full(W, r):
    return 0.5 * jnp.sum(r * apply_W_full(W, r))


def jtwj_full(JA, W, JB):
    WJB = jnp.matmul(jnp.asarray(W), JB, precision=HIGHEST)
    return jnp.matmul(jnp.swapaxes(JA, -1, -2), WJB, precision=HIGHEST)


def jtwr_full(J, W, r):
    return jnp.einsum("...rm,...r->...m", J, apply_W_full(W, r),
                      precision=HIGHEST)
