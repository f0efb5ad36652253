"""Long-horizon solve evidence: sequential scan vs Schur-partitioned
block-tridiagonal solve on one device, at n in {65, 129, 257, 1025}.

The scan's critical path is n sequential block steps; the separator
(Schur) decomposition (solver/partitioned.py) cuts it to n/P + P at the
cost of extra FLOPs. Random SPD block-tridiagonal systems at the WAM block
size (m = 14), B = 256 lanes.

Prints one JSON line per (n, solver) with ms per solve (best of 3, host
materialization as the barrier) and the residual norm of the worst lane,
after a line naming the device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from gpmp2_jax.compile_cache import configure_compile_cache

    configure_compile_cache()
    from gpmp2_jax.solver.blocktridiag import block_tridiag_solve
    from gpmp2_jax.solver.partitioned import block_tridiag_solve_partitioned

    B = int(os.environ.get("LH_BATCH", "256"))
    m = int(os.environ.get("LH_M", "14"))
    dtype = jnp.float32
    rng = np.random.default_rng(0)
    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "device_kind": dev.device_kind,
                      "device_count": len(jax.devices())}), flush=True)

    def make_system(n):
        # SPD block-tridiag: D_i = A A^T + (m + 2) I, U_i random with
        # bounded norm -> diagonally dominant, well conditioned
        A = rng.normal(size=(B, n, m, m)).astype(np.float32)
        D = A @ np.swapaxes(A, -1, -2) / m + (m + 2) * np.eye(
            m, dtype=np.float32)
        U = 0.3 * rng.normal(size=(B, n - 1, m, m)).astype(np.float32)
        b = rng.normal(size=(B, n, m)).astype(np.float32)
        return jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)

    def residual(D, U, b, x):
        Hx = jnp.einsum("bnij,bnj->bni", D, x)
        Hx = Hx.at[:, :-1].add(jnp.einsum("bnij,bnj->bni", U, x[:, 1:]))
        Hx = Hx.at[:, 1:].add(jnp.einsum("bnji,bnj->bni", U, x[:, :-1]))
        r = Hx - b
        return float(jnp.max(jnp.linalg.norm(r.reshape(B, -1), axis=-1)
                             / jnp.linalg.norm(b.reshape(B, -1), axis=-1)))

    def timed(fn, *args):
        out = fn(*args)
        np.asarray(out)
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(*args)
            np.asarray(out)
            best = min(best, time.perf_counter() - t0)
        return best, out

    for n in (65, 129, 257, 1025):
        D, U, b = make_system(n)
        scan = jax.jit(lambda d, u, bb: jax.vmap(
            lambda dd, uu, bbb: block_tridiag_solve(dd, uu, bbb))(d, u, bb))
        t_scan, x_scan = timed(scan, D, U, b)
        row = {"n": n, "m": m, "B": B, "solver": "scan",
               "ms": round(t_scan * 1e3, 2),
               "rel_residual": residual(D, U, b, x_scan)}
        print(json.dumps(row), flush=True)

        P = max(2, min(64, n // 64))
        part = jax.jit(lambda d, u, bb: jax.vmap(
            lambda dd, uu, bbb: block_tridiag_solve_partitioned(
                dd, uu, bbb, P))(d, u, bb))
        t_part, x_part = timed(part, D, U, b)
        row = {"n": n, "m": m, "B": B, "solver": f"partitioned(P={P})",
               "ms": round(t_part * 1e3, 2),
               "rel_residual": residual(D, U, b, x_part)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
