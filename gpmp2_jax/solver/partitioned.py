"""Trajectory-axis-parallel block-tridiagonal solve (Schur domain
decomposition).

The sequential block-Thomas scan (blocktridiag.py) is optimal for the
bench's short horizons (n ~ 11-101), but its critical path is O(n) — for
LONG horizons (dense replanning windows, n in the thousands; SURVEY.md
section 5's long-context analog) the trajectory axis itself must
parallelize. This module implements the classic separator/Schur
decomposition, which maps cleanly onto a device mesh axis:

  1. split the n states into P segments separated by P-1 separator states;
  2. each segment solves its local block-tridiagonal system against
     [b, E_first, E_last] (matrix RHS, one fused scan) — independent
     across segments -> vmap locally, shard over the mesh 'ts' axis;
  3. the Schur complement over separators is again block-tridiagonal but
     only (P-1) blocks long — gather it (tiny: (P-1) m x m blocks) and
     solve sequentially;
  4. per-segment back-substitution against the two separator values —
     again embarrassingly parallel.

Sequential critical path drops from n to n/P + P. Exact (no iteration);
identical answer to the scan solver up to roundoff.

`block_tridiag_solve_partitioned` is the pure single-device form (vmapped
segments — XLA also overlaps them on one chip, which already speeds up
very long chains). `block_tridiag_solve_ts_sharded` runs the segment
stages under shard_map over a mesh axis, with one all_gather for the
reduced system.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .blocktridiag import block_tridiag_solve
from .linearize import full_f32

__all__ = [
    "block_tridiag_solve_matrhs",
    "block_tridiag_solve_partitioned",
    "block_tridiag_solve_ts_sharded",
    "batched_block_tridiag_solve_ts_sharded",
]


def _chol_solve(L, rhs):
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


@full_f32
def block_tridiag_solve_matrhs(D, U, B):
    """Block-Thomas with matrix RHS: D (n, m, m), U (n-1, m, m),
    B (n, m, k) -> X (n, m, k)."""
    n, m = D.shape[0], D.shape[1]
    k = B.shape[-1]
    U_pad = jnp.concatenate([U, jnp.zeros((1, m, m), U.dtype)], axis=0)

    def fwd(carry, inp):
        P_C, P_z = carry
        D_i, U_i, B_i = inp
        C_i = D_i - P_C
        Z_i = B_i - P_z
        L_i = jnp.linalg.cholesky(C_i)
        W_i = _chol_solve(L_i, Z_i)
        G_i = _chol_solve(L_i, U_i)
        return (U_i.T @ G_i, U_i.T @ W_i), (W_i, G_i)

    init = (jnp.zeros((m, m), D.dtype), jnp.zeros((m, k), D.dtype))
    _, (W, G) = lax.scan(fwd, init, (D, U_pad, B))

    def bwd(x_next, inp):
        W_i, G_i = inp
        x_i = W_i - G_i @ x_next
        return x_i, x_i

    G_pad = jnp.concatenate([G[:-1], jnp.zeros((1, m, m), D.dtype)], axis=0)
    _, X = lax.scan(bwd, jnp.zeros((m, k), D.dtype), (W, G_pad),
                    reverse=True)
    return X


def _segment_stage(D_seg, U_seg, b_seg):
    """Per-segment local solves against [E_first | E_last | b].

    D_seg (Li, m, m), U_seg (Li-1, m, m), b_seg (Li, m).
    Returns Y (Li, m, 2m+1): columns 0:m = H^-1 E_first, m:2m = H^-1
    E_last, last = H^-1 b."""
    Li, m = D_seg.shape[0], D_seg.shape[1]
    dtype = D_seg.dtype
    Rf = jnp.zeros((Li, m, m), dtype).at[0].set(jnp.eye(m, dtype=dtype))
    Rl = jnp.zeros((Li, m, m), dtype).at[Li - 1].set(jnp.eye(m, dtype=dtype))
    RHS = jnp.concatenate([Rf, Rl, b_seg[..., None]], axis=-1)
    return block_tridiag_solve_matrhs(D_seg, U_seg, RHS)


def _partition(D, U, b, n_parts):
    """Split (D, U, b) into P segments + P-1 separators, padding n up to
    P*Li + (P-1) with identity diagonal blocks (decoupled -> x = 0)."""
    n, m = D.shape[0], D.shape[1]
    P = n_parts
    Li = -(-(n - (P - 1)) // P)  # ceil interior length
    assert Li >= 1, f"n={n} too short for {P} partitions (need n >= 2P-1)"
    n_pad = P * Li + (P - 1)
    pad = n_pad - n
    if pad:
        eye = jnp.broadcast_to(jnp.eye(m, dtype=D.dtype), (pad, m, m))
        D = jnp.concatenate([D, eye], axis=0)
        U = jnp.concatenate([U, jnp.zeros((pad, m, m), D.dtype)], axis=0)
        b = jnp.concatenate([b, jnp.zeros((pad, m), b.dtype)], axis=0)
    else:
        U = jnp.concatenate([U, jnp.zeros((0, m, m), D.dtype)], axis=0)

    stride = Li + 1
    seg_start = stride * jnp.arange(P)
    idx_int = seg_start[:, None] + jnp.arange(Li)[None, :]  # (P, Li)
    sep = stride * jnp.arange(1, P) - 1  # (P-1,) global separator indices

    D_seg = D[idx_int]  # (P, Li, m, m)
    b_seg = b[idx_int]  # (P, Li, m)
    # U within a segment: between consecutive interior states
    idx_u = seg_start[:, None] + jnp.arange(Li - 1)[None, :]
    U_full = jnp.concatenate([U, jnp.zeros((1, m, m), D.dtype)], axis=0)
    U_seg = U_full[idx_u]  # (P, Li-1, m, m)
    # couplings: a_t = U[sep_t - 1] (segment t last state -> separator t),
    #            c_t = U[sep_t]     (separator t -> segment t+1 first state)
    a = U_full[sep - 1]  # (P-1, m, m)
    c = U_full[sep]  # (P-1, m, m)
    D_sep = D[sep]  # (P-1, m, m)
    b_sep = b[sep]  # (P-1, m)
    return (D_seg, U_seg, b_seg, a, c, D_sep, b_sep, idx_int, sep, n, Li, P)


def _schur_reduce(Y, a, c, D_sep, b_sep):
    """Build the (P-1)-block reduced separator system from the per-segment
    solutions Y (P, Li, m, 2m+1)."""
    m = D_sep.shape[-1]
    Ff_f = Y[:, 0, :, :m]  # (P, m, m)  (H^-1)[first, first]
    Fl_f = Y[:, 0, :, m:2 * m]  # (H^-1)[first, last]
    Ff_l = Y[:, -1, :, :m]  # (H^-1)[last, first]
    Fl_l = Y[:, -1, :, m:2 * m]  # (H^-1)[last, last]
    y_f = Y[:, 0, :, -1]  # (P, m)
    y_l = Y[:, -1, :, -1]

    # diag: D_sep - a^T (H_t^-1)[l,l] a - c (H_{t+1}^-1)[f,f] c^T
    at = jnp.swapaxes(a, -1, -2)
    SD = (D_sep
          - at @ Fl_l[:-1] @ a
          - c @ Ff_f[1:] @ jnp.swapaxes(c, -1, -2))
    # off-diag t -> t+1 through segment t+1: -c_t (H^-1)[f,l] a_{t+1}
    SU = -c[:-1] @ Fl_f[1:-1] @ a[1:]
    Sb = b_sep - jnp.einsum("tij,ti->tj", a, y_l[:-1]) \
        - jnp.einsum("tij,tj->ti", c, y_f[1:])
    return SD, SU, Sb


def _back_substitute(Y, a, c, x_sep):
    """x_I per segment: y - (H^-1 E_first) c^T x_left - (H^-1 E_last) a x_right."""
    P, Li, m, _ = Y.shape
    dtype = Y.dtype
    ct = jnp.swapaxes(c, -1, -2)
    gl = jnp.concatenate([jnp.zeros((1, m), dtype),
                          jnp.einsum("tij,tj->ti", ct, x_sep)], axis=0)
    gr = jnp.concatenate([jnp.einsum("tij,tj->ti", a, x_sep),
                          jnp.zeros((1, m), dtype)], axis=0)
    Ff = Y[..., :m]  # (P, Li, m, m)
    Fl = Y[..., m:2 * m]
    y = Y[..., -1]
    return (y
            - jnp.einsum("plij,pj->pli", Ff, gl)
            - jnp.einsum("plij,pj->pli", Fl, gr))


def _jacobi_scale(D, U, b):
    diag = jnp.diagonal(D, axis1=-2, axis2=-1)
    s = lax.rsqrt(jnp.maximum(diag, 1e-30))
    D = D * s[:, :, None] * s[:, None, :]
    U = U * s[:-1, :, None] * s[1:, None, :]
    b = b * s
    return D, U, b, s


@full_f32
def block_tridiag_solve_partitioned(D, U, b, n_parts: int,
                                    jacobi_scaling: bool = True):
    """Exact H x = b via P-way separator decomposition (single device;
    segments vmapped). D (n, m, m), U (n-1, m, m), b (n, m) -> x (n, m).

    Requires n >= 2 * n_parts - 1 (each segment needs >= 1 interior
    state). For n_parts == 1, falls back to the sequential scan."""
    if n_parts <= 1:
        return block_tridiag_solve(D, U, b, jacobi_scaling=jacobi_scaling)
    s = None
    if jacobi_scaling:
        D, U, b, s = _jacobi_scale(D, U, b)
    (D_seg, U_seg, b_seg, a, c, D_sep, b_sep,
     idx_int, sep, n, Li, P) = _partition(D, U, b, n_parts)

    Y = jax.vmap(_segment_stage)(D_seg, U_seg, b_seg)  # (P, Li, m, 2m+1)
    SD, SU, Sb = _schur_reduce(Y, a, c, D_sep, b_sep)
    x_sep = block_tridiag_solve(SD, SU, Sb, jacobi_scaling=False)  # (P-1, m)
    x_int = _back_substitute(Y, a, c, x_sep)  # (P, Li, m)

    m = D.shape[-1]
    x = jnp.zeros((P * Li + (P - 1), m), D.dtype)
    x = x.at[idx_int.reshape(-1)].set(x_int.reshape(-1, m))
    x = x.at[sep].set(x_sep)
    x = x[:n]
    if s is not None:
        x = x * s
    return x


@full_f32
def batched_block_tridiag_solve_ts_sharded(mesh, D, U, b, n_parts: int,
                                           dp_axis: str = "dp",
                                           ts_axis: str = "ts",
                                           jacobi_scaling: bool = True):
    """BATCHED trajectory-axis-sharded exact solve over a 2-axis
    (dp x ts) mesh — the form the planner's damped-solve consumes
    (optimize_batch with OptimizerParams.ts_mesh/ts_parts).

    D (B, n, m, m), U (B, n-1, m, m), b (B, n, m) -> x (B, n, m). The
    problem batch B shards over `dp_axis`; each problem's trajectory axis
    decomposes into `n_parts` segments sharded over `ts_axis` (per-segment
    scans device-local), the tiny (P-1)-block separator system solves
    dp-replicated after one ts-gather of interface slices, and
    back-substitution partitions back with no further communication —
    sequential critical path n/P + P per problem."""
    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    ax_size = mesh.shape[ts_axis]
    assert n_parts % ax_size == 0, (
        f"n_parts={n_parts} must divide over mesh axis '{ts_axis}' "
        f"(size {ax_size})"
    )
    seg_sh = NamedSharding(mesh, Pspec(dp_axis, ts_axis))
    dp_sh = NamedSharding(mesh, Pspec(dp_axis))
    constrain = lax.with_sharding_constraint

    B, n, m = D.shape[0], D.shape[1], D.shape[-1]
    P = n_parts
    dtype = D.dtype
    s = None
    if jacobi_scaling:
        D, U, b, s = jax.vmap(_jacobi_scale)(D, U, b)

    # partition plan (host-side, static)
    Li = -(-(n - (P - 1)) // P)
    assert Li >= 1, f"n={n} too short for {P} partitions (need n >= 2P-1)"
    n_pad = P * Li + (P - 1)
    pad = n_pad - n
    if pad:
        eye = jnp.broadcast_to(jnp.eye(m, dtype=dtype), (B, pad, m, m))
        D = jnp.concatenate([D, eye], axis=1)
        b = jnp.concatenate([b, jnp.zeros((B, pad, m), dtype)], axis=1)
    U_full = jnp.concatenate(
        [U, jnp.zeros((B, n_pad - (n - 1), m, m), dtype)], axis=1
    )
    stride = Li + 1
    seg_start = stride * np.arange(P)
    idx_int = jnp.asarray(seg_start[:, None] + np.arange(Li)[None, :])
    idx_u = jnp.asarray(seg_start[:, None] + np.arange(max(Li - 1, 0))[None, :])
    sep = jnp.asarray(stride * np.arange(1, P) - 1)

    D_seg = constrain(D[:, idx_int], seg_sh)  # (B, P, Li, m, m)
    U_seg = constrain(U_full[:, idx_u], seg_sh)
    b_seg = constrain(b[:, idx_int], seg_sh)
    a = U_full[:, sep - 1]  # (B, P-1, m, m)
    c = U_full[:, sep]
    D_sep = D[:, sep]
    b_sep = b[:, sep]

    Y = jax.vmap(jax.vmap(_segment_stage))(D_seg, U_seg, b_seg)
    Y = constrain(Y, seg_sh)  # (B, P, Li, m, 2m+1)

    SD, SU, Sb = jax.vmap(_schur_reduce)(Y, a, c, D_sep, b_sep)
    SD, SU, Sb = (constrain(SD, dp_sh), constrain(SU, dp_sh),
                  constrain(Sb, dp_sh))
    x_sep = jax.vmap(
        lambda sd, su, sb: block_tridiag_solve(sd, su, sb,
                                               jacobi_scaling=False)
    )(SD, SU, Sb)  # (B, P-1, m)
    x_sep = constrain(x_sep, dp_sh)

    x_int = jax.vmap(_back_substitute)(Y, a, c, x_sep)  # (B, P, Li, m)
    x_int = constrain(x_int, seg_sh)

    x = jnp.zeros((B, n_pad, m), dtype)
    x = x.at[:, idx_int.reshape(-1)].set(x_int.reshape(B, -1, m))
    x = x.at[:, sep].set(x_sep)
    x = x[:, :n]
    if s is not None:
        x = x * s
    return x


@full_f32
def block_tridiag_solve_ts_sharded(mesh, D, U, b, n_parts: int,
                                   axis: str = "ts",
                                   jacobi_scaling: bool = True):
    """Trajectory-axis-SHARDED exact solve, GSPMD style: segments carry a
    sharding constraint over the mesh `axis`, so the per-segment scans run
    device-local, XLA inserts one small all_gather of the (P, 2, m, 2m+1)
    interface slices for the reduced separator solve (computed replicated
    — cheaper than a host roundtrip), and the back-substitution partitions
    back over the axis with no further communication.

    n_parts must be a multiple of the mesh axis size. Call under jit with
    the mesh's devices visible."""
    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    ax_size = mesh.shape[axis]
    assert n_parts % ax_size == 0, (
        f"n_parts={n_parts} must divide over mesh axis '{axis}' "
        f"(size {ax_size})"
    )
    seg_sh = NamedSharding(mesh, Pspec(axis))
    repl = NamedSharding(mesh, Pspec())
    constrain = lax.with_sharding_constraint

    s = None
    if jacobi_scaling:
        D, U, b, s = _jacobi_scale(D, U, b)
    (D_seg, U_seg, b_seg, a, c, D_sep, b_sep,
     idx_int, sep, n, Li, P) = _partition(D, U, b, n_parts)

    D_seg = constrain(D_seg, seg_sh)
    U_seg = constrain(U_seg, seg_sh)
    b_seg = constrain(b_seg, seg_sh)

    Y = jax.vmap(_segment_stage)(D_seg, U_seg, b_seg)  # (P, Li, m, 2m+1)
    Y = constrain(Y, seg_sh)

    # reduced separator system: tiny, solve replicated (XLA gathers the
    # P interface slices of Y, ~P * 2m(2m+1) floats)
    SD, SU, Sb = _schur_reduce(Y, a, c, D_sep, b_sep)
    SD, SU, Sb = constrain(SD, repl), constrain(SU, repl), constrain(Sb, repl)
    x_sep = block_tridiag_solve(SD, SU, Sb, jacobi_scaling=False)
    x_sep = constrain(x_sep, repl)

    x_int = _back_substitute(Y, a, c, x_sep)  # (P, Li, m), sharded by P
    x_int = constrain(x_int, seg_sh)

    m = D.shape[-1]
    x = jnp.zeros((P * Li + (P - 1), m), D.dtype)
    x = x.at[idx_int.reshape(-1)].set(x_int.reshape(-1, m))
    x = x.at[sep].set(x_sep)
    x = x[:n]
    if s is not None:
        x = x * s
    return x
