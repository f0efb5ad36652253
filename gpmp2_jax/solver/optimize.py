"""Batched nonlinear least-squares optimizer (Gauss-Newton / LM / Dogleg).

Replacement for the reference's optimize() driver around GTSAM
(/root/reference/gpmp2/planner/BatchTrajOptimizer.cpp:212-308), preserving
its semantics:

  - LM with lambda_0 = 100, factor 10 (BatchTrajOptimizer.cpp:226, GTSAM
    defaults), damping H + lambda*I, give-up when lambda exceeds 1e5.
  - Dogleg with Delta_0 = 0.2 (BatchTrajOptimizer.cpp:222), classic
    gain-ratio trust-region update.
  - GTSAM checkConvergence: converged when newErr <= errTol, or absolute
    decrease <= absTol (1e-5), or relative decrease <= relTol.
  - `iter_no_increase` (BatchTrajOptimizer.cpp:273-305): accepted steps
    never increase the error (LM/Dogleg reject increases; GN tracks and
    reverts a final increasing step).

Everything is batched: a whole batch of problems runs in ONE loop with
per-problem convergence masks, per-problem lambda / trust radius, and
frozen (masked) updates for converged lanes.

Loop modes (params.loop):
  - 'chunked' (default): jit a fixed chunk of
    `chunk_size` steps, then check the batch's all-converged flag ON HOST
    between chunks. One device->host sync per chunk instead of per
    iteration; with typical convergence in ~4 accepted steps the whole
    batch finishes in 1-2 chunks instead of the full max_iter schedule.
    Host-driven — under an enclosing jit it silently degrades to 'static'.
    When `data` is passed (and `linearize_fn`/`retract_fn` are stable
    across calls, see plan_batch), the jitted chunk callables are cached
    module-wide so repeat solves skip retracing entirely.
  - 'static': a `lax.fori_loop` with a STATIC trip count
    (max_iter + reject_budget steps). Each step is one linearize + one
    damped solve + one accept test. Fully jit-composable; pays the full
    schedule regardless of convergence. Static trip counts avoid
    data-dependent `while_loop` conditions, which sync device and host
    every iteration.
  - 'dynamic': `lax.while_loop` with early exit when every problem has
    converged — fewer FLOPs, host syncs per iteration; the right choice on
    CPU and for very long max_iter.

GTSAM counts an outer iterate() (with its internal lambda retries) as one
iteration; here `iterations` counts accepted steps, and `max_iter` bounds
accepted steps in all modes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .blocktridiag import batched_block_tridiag_solve
from .linearize import full_f32

__all__ = ["OptimizerParams", "OptResult", "optimize_batch"]


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    method: str = "lm"  # 'gaussnewton' | 'lm' | 'dogleg'
    max_iter: int = 50
    rel_thresh: float = 1e-2  # relativeErrorTol
    abs_thresh: float = 1e-5  # absoluteErrorTol (GTSAM default)
    err_thresh: float = 0.0  # errorTol (GTSAM default)
    iter_no_increase: bool = True
    # LM
    lambda_init: float = 100.0
    lambda_factor: float = 10.0
    lambda_max: float = 1e5
    lambda_min: float = 0.0
    # Dogleg
    delta_init: float = 0.2
    delta_min: float = 1e-5
    # loop structure
    loop: str = "chunked"  # 'chunked' | 'static' | 'dynamic'
    reject_budget: int = 14  # extra steps to absorb rejected attempts
    # steps per host round-trip ('chunked' mode). 12 covers the typical
    # accepted+rejected attempt count of an LM solve in ONE chunk, so most
    # batches never dispatch a second full-size chunk (results are
    # identical across schedules — chunking is pure scheduling).
    chunk_size: int = 12
    # steps per chunk AFTER the first chunk (0 = same as chunk_size).
    # The first chunk covers the typical full solve; later chunks only
    # mop up stragglers (usually compacted to a small batch), where a
    # shorter trip count re-checks the all-done flag sooner.
    tail_chunk: int = 0
    # geometric growth of successive tail chunks (1.0 = every tail uses
    # tail_chunk steps). Each chunk boundary costs a host round trip;
    # with a long convergence tail, growing the k-th tail to
    # tail_chunk*growth^k steps (capped at 4x chunk_size) covers the same
    # attempts in O(log) dispatches while still exiting early when the
    # fleet finishes fast. Each distinct tail size compiles its own chunk
    # program once (persistently cached).
    tail_growth: float = 1.0
    # straggler compaction ('chunked' mode with data_axes): between chunks,
    # gather still-active lanes into a power-of-two batch so late
    # iterations don't pay full-batch linearize cost for converged lanes.
    # Each new compacted size compiles its own chunk program (cached
    # persistently), so sizes are restricted to powers of two >= the floor.
    compact: bool = True
    # smallest compacted batch; each compacted size compiles its own chunk
    # program. The value is from the previous accelerator, not re-measured.
    compact_floor: int = 128
    # per-iteration trace, mirroring the reference verbosity enum
    # (TrajOptimizerSetting.h:21): 'none' | 'error' (prints batch error
    # stats per attempted step via jax.debug.print; works under jit)
    verbosity: str = "none"
    # trajectory-axis (sequence-parallel) solve: when `ts_mesh` is a
    # jax.sharding.Mesh with a 'ts' axis and ts_parts > 1, the damped
    # block-tridiagonal solve routes through the Schur-partitioned
    # ts-sharded solver (solver/partitioned.py) — each trajectory's n
    # states decompose into ts_parts segments sharded over the mesh's
    # 'ts' axis while the batch shards over 'dp'. For long horizons
    # (n >= ~257) this cuts the solve's sequential critical path from n
    # to n/P + P per problem. Mesh objects are hashable, so params with a
    # ts_mesh still key the chunk/static jit caches.
    ts_mesh: object = None
    ts_parts: int = 0
    # layout of the (H_diag, H_off, b) triple emitted by linearize_fn:
    #   'batch' (default): H_diag (B, n, m, m), H_off (B, n-1, m, m),
    #       b (B, n, m) — the natural vmap layout, accepted everywhere.
    #   'flat': H_diag (B, n, m*m), H_off (B, n-1, m*m) — block dims
    #       merged so the minor dimension is m*m (e.g. 196) instead of m
    #       (e.g. 14), which a tiled device memory pads far less (the
    #       reason on the previous accelerator). The solve takes it as it
    #       is. plan_batch selects this for LM/GN. b and err keep their
    #       shapes.
    #   Dogleg requires 'batch'.
    lin_layout: str = "batch"
    # float64 give-up rescue (planner.batch.plan_batch only): after the
    # solve, lanes that STOPPED without converging (gave_up) are re-solved
    # from the initial trajectory in double precision on the host CPU
    # backend and scattered back. It was written for a device without
    # float64; the GPU has float64, and moving the rescue onto it is open
    # work. The reference runs GTSAM in f64 throughout; in f32 the LM
    # lambda escalation can hit the rounding floor on the hardest draws
    # (on the previous accelerator: the entire Arm3Limits2D
    # converged-fraction gap vs the C++ oracle). Cost is proportional to
    # the give-up count plus a host transfer of the gathered lanes'
    # problem data, so keep it off for latency-critical fleets with large
    # shared SDF worlds.
    rescue_f64: bool = False


class OptResult(NamedTuple):
    traj: object  # optimized state pytree (batched)
    error: jnp.ndarray  # (B,) final graph error
    iterations: jnp.ndarray  # (B,) accepted steps taken
    converged: jnp.ndarray  # (B,) bool: GTSAM checkConvergence fired
    # True when the lane STOPPED without converging: LM lambda exceeded
    # lambda_max, Dogleg radius collapsed below delta_min, or a non-finite
    # step appeared. GTSAM stopping != GTSAM converging — a gave_up lane
    # must never be counted as a converged plan (headline metrics exclude
    # it; see bench.py).
    gave_up: jnp.ndarray = None  # (B,) bool


class _State(NamedTuple):
    traj: object
    lin: tuple  # (H_diag, H_off, b, err_leaf) linearization at traj
    err: jnp.ndarray  # (B,)
    tr: jnp.ndarray  # (B,) lambda (LM) or trust radius (dogleg)
    converged: jnp.ndarray  # (B,)
    gave_up: jnp.ndarray  # (B,)
    iters: jnp.ndarray  # (B,) accepted steps
    prev_traj: object  # pre-step values (for GN iter_no_increase)
    prev_err: jnp.ndarray


def _mask_tree(mask, new, old):
    """Per-lane select over a batched pytree; mask: (B,)."""

    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.ndim - 1))
        return jnp.where(m, a, b)

    return jax.tree_util.tree_map(sel, new, old)


def _build_fns(linearize_fn: Callable, retract_fn: Callable,
               params: OptimizerParams):
    """Build `(make_init, step)` over a two-arg linearize_fn(data, traj).

    Every shape/dtype is derived from runtime arguments (not captured), so
    the returned functions are pure in `data` and reusable across problem
    batches — the basis for the chunked-mode jit cache."""
    method = params.method
    if params.lin_layout == "flat" and method == "dogleg":
        raise ValueError(
            f"lin_layout={params.lin_layout!r} supports lm/gaussnewton "
            "only; dogleg's trust-region algebra runs on the batch-major "
            "layout"
        )

    def check_convergence(cur, new):
        """GTSAM checkConvergence (NonlinearOptimizer.cpp)."""
        abs_dec = cur - new
        rel_dec = abs_dec / jnp.maximum(cur, jnp.asarray(1e-30, cur.dtype))
        return (
            (new <= params.err_thresh)
            | (abs_dec <= params.abs_thresh)
            | (rel_dec <= params.rel_thresh)
        )

    def damped_solve(H_diag, H_off, b, lam):
        if params.ts_mesh is not None and params.ts_parts > 1:
            # sequence-parallel long-horizon path: Schur decomposition
            # sharded over the mesh's 'ts' axis (partitioned.py)
            from .partitioned import batched_block_tridiag_solve_ts_sharded

            B_, n_, m_ = b.shape
            eye = jnp.eye(m_, dtype=H_diag.dtype)
            Hd = H_diag.reshape(B_, n_, m_, m_) + lam[:, None, None, None] * eye
            return batched_block_tridiag_solve_ts_sharded(
                params.ts_mesh, Hd, H_off.reshape(B_, n_ - 1, m_, m_), b,
                params.ts_parts
            )
        # the vmapped scan; takes the 'batch' and 'flat' layouts as they are
        return batched_block_tridiag_solve(H_diag, H_off, b, lam=lam)

    def apply_H(H_diag, H_off, v):
        Hv = jnp.einsum("bnij,bnj->bni", H_diag, v)
        Hv = Hv.at[:, :-1].add(jnp.einsum("bnij,bnj->bni", H_off, v[:, 1:]))
        Hv = Hv.at[:, 1:].add(jnp.einsum("bnji,bnj->bni", H_off, v[:, :-1]))
        return Hv

    def model_decrease(H_diag, H_off, b, delta):
        """Predicted error decrease b^T d - 0.5 d^T H d (per lane)."""
        bd = jnp.sum(b * delta, axis=(-2, -1))
        dHd = jnp.sum(delta * apply_H(H_diag, H_off, delta), axis=(-2, -1))
        return bd - 0.5 * dHd

    def dogleg_delta(H_diag, H_off, b, radius):
        """Classic dogleg point for trust radius (B,)."""
        B, dtype = b.shape[0], b.dtype
        d_gn = damped_solve(H_diag, H_off, b, jnp.zeros((B,), dtype))
        g = b  # negative gradient
        gHg = jnp.sum(g * apply_H(H_diag, H_off, g), axis=(-2, -1))
        gg = jnp.sum(g * g, axis=(-2, -1))
        alpha = gg / jnp.maximum(gHg, 1e-30)
        d_sd = alpha[:, None, None] * g
        norm = lambda v: jnp.sqrt(jnp.sum(v * v, axis=(-2, -1)))
        n_gn, n_sd = norm(d_gn), norm(d_sd)
        use_gn = n_gn <= radius
        use_sd = n_sd >= radius
        d_sd_clip = d_sd * (radius / jnp.maximum(n_sd, 1e-30))[:, None, None]
        diff = d_gn - d_sd
        a_ = jnp.sum(diff * diff, axis=(-2, -1))
        b_ = 2.0 * jnp.sum(d_sd * diff, axis=(-2, -1))
        c_ = n_sd**2 - radius**2
        disc = jnp.maximum(b_ * b_ - 4 * a_ * c_, 0.0)
        t = (-b_ + jnp.sqrt(disc)) / jnp.maximum(2 * a_, 1e-30)
        d_mix = d_sd + t[:, None, None] * diff
        return jnp.where(use_gn[:, None, None], d_gn,
                         jnp.where(use_sd[:, None, None], d_sd_clip, d_mix))

    def make_init(data, traj) -> _State:
        lin0 = linearize_fn(data, traj)
        err0 = lin0[3]
        B, dtype = err0.shape[0], err0.dtype
        if method == "lm":
            tr0 = jnp.full((B,), params.lambda_init, dtype)
        elif method == "dogleg":
            tr0 = jnp.full((B,), params.delta_init, dtype)
        else:
            tr0 = jnp.zeros((B,), dtype)
        init_conv = err0 <= params.err_thresh
        return _State(
            traj, lin0, err0, tr0, init_conv, jnp.zeros((B,), bool),
            jnp.zeros((B,), jnp.int32), traj, err0,
        )

    def step(data, st: _State) -> _State:
        """One attempt: solve at the carried linearization, linearize the
        candidate (which yields its error as a byproduct — halving the
        residual/gather work vs a separate error evaluation), accept/reject
        per lane."""
        B, dtype = st.err.shape[0], st.err.dtype
        active = ~st.converged & ~st.gave_up & (st.iters < params.max_iter)
        H_diag, H_off, b, _ = st.lin

        if method == "gaussnewton":
            delta = damped_solve(H_diag, H_off, b, jnp.zeros((B,), dtype))
        elif method == "lm":
            delta = damped_solve(H_diag, H_off, b, st.tr)
        else:  # dogleg
            delta = dogleg_delta(H_diag, H_off, b, st.tr)

        ok = jnp.all(jnp.isfinite(delta.reshape(B, -1)), axis=-1)
        delta = jnp.where(ok[:, None, None], delta, 0.0)
        cand = retract_fn(st.traj, delta)
        cand_lin = linearize_fn(data, cand)
        new_err = cand_lin[3]
        finite = ok & jnp.isfinite(new_err)

        if method == "gaussnewton":
            accept = active & finite
            gave_up = active & ~finite
            tr = st.tr
        elif method == "lm":
            better = finite & (new_err < st.err)
            accept = active & better
            reject = active & ~better
            tr = jnp.where(
                accept,
                jnp.maximum(st.tr / params.lambda_factor, params.lambda_min),
                jnp.where(reject, st.tr * params.lambda_factor, st.tr),
            )
            gave_up = reject & (tr > params.lambda_max)
        else:  # dogleg
            # GTSAM DoglegOptimizerImpl trust-region rule: rho >= 0.75 ->
            # Delta = max(Delta, 3*||dx_d||) (the Powell growth GTSAM uses
            # verbatim; cross-checked against tools/gtsam_oracle.py
            # dogleg_iterate), rho < 0.25 -> halve. Documented deviation:
            # GTSAM's SEARCH_EACH_ITERATION retries grown/shrunk radii
            # within one iterate(); the batched loop takes ONE attempt per
            # step (a retry is just the next fixed-shape step), which the
            # dogleg parity fixtures show lands within 1% of the oracle.
            pred = model_decrease(H_diag, H_off, b, delta)
            rho = (st.err - new_err) / jnp.maximum(pred, 1e-30)
            better = finite & (new_err < st.err) & (pred > 0)
            accept = active & better
            reject = active & ~better
            dnorm = jnp.sqrt(jnp.sum(delta * delta, axis=(-2, -1)))
            grow = accept & (rho > 0.75)
            shrink = (rho < 0.25) & active
            tr = jnp.where(
                grow, jnp.maximum(st.tr, 3.0 * dnorm),
                jnp.where(shrink, 0.5 * st.tr, st.tr),
            )
            gave_up = reject & (tr < params.delta_min)

        prev_traj = _mask_tree(accept, st.traj, st.prev_traj)
        prev_err = jnp.where(accept, st.err, st.prev_err)
        traj = _mask_tree(accept, cand, st.traj)
        lin = _mask_tree(accept, cand_lin, st.lin)
        err = jnp.where(accept, new_err, st.err)
        conv_now = accept & check_convergence(st.err, new_err)
        converged = st.converged | conv_now
        gave = st.gave_up | gave_up
        iters = st.iters + accept.astype(jnp.int32)
        if params.verbosity == "error":
            # per-attempt trace (reference verbosity 'Error':
            # TrajOptimizerSetting.h:21, BatchTrajOptimizer.cpp:235-282) —
            # works in every loop mode via jax.debug.print.
            jax.debug.print(
                "[optimize] accepted {a}/{n} err(mean) {e:.6g} "
                "tr(mean) {t:.4g} active {act} converged {c} gave_up {g}",
                a=jnp.sum(accept), n=B, e=jnp.mean(err), t=jnp.mean(tr),
                act=jnp.sum(active), c=jnp.sum(converged), g=jnp.sum(gave),
            )
        return _State(traj, lin, err, tr, converged, gave, iters,
                      prev_traj, prev_err)

    # traced at HIGHEST: at DEFAULT, XLA on the H100 ran some float32
    # products of the WAM solve as TF32 GEMMs, and 268 of 2048 lanes ended
    # at another converged cost (PERF.md, Findings)
    return full_f32(make_init), full_f32(step)


def _make_chunk(step: Callable, params: OptimizerParams):
    csize = max(1, params.chunk_size)

    def chunk(data, st: _State):
        st = lax.fori_loop(0, csize, lambda i, s: step(data, s), st)
        # return the per-lane active mask alongside the all-done flag: the
        # host reads both in ONE transfer, so compaction needs no second
        # device round trip to fetch the mask
        active = ~st.converged & ~st.gave_up & (st.iters < params.max_iter)
        return st, ~jnp.any(active), active

    return chunk


@jax.jit
def _gather_state(st: _State, idx) -> _State:
    """Select lanes `idx` (with possible duplicates) from a batched state."""
    return jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), st)


@jax.jit
def _scatter_state(full: _State, abs_idx, st: _State) -> _State:
    """Write compacted lanes back into the full-size state snapshot."""
    return jax.tree_util.tree_map(
        lambda f, c: f.at[abs_idx].set(c), full, st)


def _scatter_state_unique(full: _State, abs_idx: np.ndarray,
                          st: _State) -> _State:
    """Scatter compacted lanes back, writing each absolute index exactly
    once. Compaction pads with duplicate lanes; `.at[].set` with duplicate
    indices is undefined in JAX, so dedupe (keep first occurrence) before
    scattering rather than relying on the copies staying bitwise equal."""
    uniq, first = np.unique(abs_idx, return_index=True)
    if uniq.size != abs_idx.size:
        st = _gather_state(st, jnp.asarray(first.astype(np.int32)))
    return _scatter_state(full, jnp.asarray(uniq.astype(np.int32)), st)


def _gather_data(data, data_axes, idx):
    """Index per-lane data leaves (axis from data_axes; None = shared).
    Mapped over the axes tree first so None (shared leaf) is a leaf."""
    return jax.tree_util.tree_map(
        lambda ax, a: a if ax is None else jnp.take(a, idx, axis=ax),
        data_axes, data,
        is_leaf=lambda x: x is None,
    )


# chunked-mode jit cache: (linearize_fn, retract_fn, params) -> callables.
# Entries hold only function objects (no device arrays) — callers who want
# cache hits must pass identical function objects each time (plan_batch
# does, via its own lru caches over axes/space).
_CHUNK_CACHE: dict = {}
# structural-key -> weakrefs of the last function identities, to detect
# callers that rebuild equivalent closures per call (each one re-jits
# silently). Weakrefs + a size bound keep the diagnostic from pinning
# caller closures (and their captured arrays) for the process lifetime.
_CHUNK_IDENTITY_SEEN: dict = {}
_CHUNK_IDENTITY_MAX = 64


def _fn_code(f):
    """Best-effort structural identity of a callable (its code object)."""
    code = getattr(f, "__code__", None)
    if code is not None:
        return code
    inner = getattr(f, "func", None)  # functools.partial
    if inner is not None:
        return _fn_code(inner)
    return type(f)


def _data_fingerprint(data):
    """Hashable shape/dtype signature of a data pytree (None-safe)."""
    if data is None:
        return None
    return tuple(
        (getattr(leaf, "shape", ()), str(getattr(leaf, "dtype", type(leaf))))
        for leaf in jax.tree_util.tree_leaves(data)
    )


def _warn_unstable_identity(linearize_fn, retract_fn, params, data):
    """One-line notice when a cache miss is caused by a NEW function object
    with the SAME code AND the same problem shapes as a previously cached
    one — the caller is constructing fresh linearize/retract closures per
    call and every solve re-traces (plan_batch avoids this via its own lru
    caches). Distinct configs (different shapes) never trigger it."""
    import warnings
    import weakref

    skey = (_fn_code(linearize_fn), _fn_code(retract_fn), params,
            _data_fingerprint(data))
    prev = _CHUNK_IDENTITY_SEEN.get(skey)
    if len(_CHUNK_IDENTITY_SEEN) >= _CHUNK_IDENTITY_MAX:
        _CHUNK_IDENTITY_SEEN.clear()
    try:
        _CHUNK_IDENTITY_SEEN[skey] = (weakref.ref(linearize_fn),
                                      weakref.ref(retract_fn))
    except TypeError:  # non-weakrefable callables (e.g. C extensions)
        _CHUNK_IDENTITY_SEEN.pop(skey, None)
        return
    if prev is not None and (prev[0](), prev[1]()) != (linearize_fn,
                                                       retract_fn):
        warnings.warn(
            "gpmp2_jax.optimize_batch: chunk-cache miss — linearize_fn/"
            "retract_fn are new function objects with identical code on an "
            "identically-shaped problem; each call re-jits the solve. Pass "
            "stable function objects (or use planner.batch.plan_batch) to "
            "reuse the compiled chunks.",
            RuntimeWarning,
            stacklevel=3,
        )


def _chunked_callables(linearize_fn, retract_fn, params, data=None):
    key = (linearize_fn, retract_fn, params)
    hit = _CHUNK_CACHE.get(key)
    if hit is not None:
        return hit
    _warn_unstable_identity(linearize_fn, retract_fn, params, data)
    make_init, step = _build_fns(linearize_fn, retract_fn, params)
    chunk = _make_chunk(step, params)

    def first_chunk(data, traj0):
        # init linearize + first chunk in ONE dispatch: a separate init
        # call would cost a host round trip of its own
        return chunk(data, make_init(data, traj0))

    fns = (
        jax.jit(make_init),
        jax.jit(chunk, donate_argnums=1),
        jax.jit(first_chunk),
    )
    _CHUNK_CACHE[key] = fns
    return fns


def _static_callable(linearize_fn, retract_fn, params):
    """One fully-jitted static-schedule solve (init + fori_loop in a single
    dispatch). Without this, the static path's make_init would execute
    EAGERLY — hundreds of per-op dispatches instead of one compiled
    call. Cached like the chunked
    callables so repeat solves (e.g. ISAM2 warm updates) skip retracing."""
    key = ("static", linearize_fn, retract_fn, params)
    hit = _CHUNK_CACHE.get(key)
    if hit is not None:
        return hit
    make_init, step = _build_fns(linearize_fn, retract_fn, params)
    total = params.max_iter + (
        0 if params.method == "gaussnewton" else params.reject_budget
    )

    def run(data, traj0):
        return lax.fori_loop(
            0, total, lambda i, s: step(data, s), make_init(data, traj0)
        )

    fn = jax.jit(run)
    _CHUNK_CACHE[key] = fn
    return fn


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _any_leaf_sharded(*trees) -> bool:
    """True when any array leaf carries a non-replicated multi-device
    sharding. Compaction gathers/scatters lanes by dynamic index, which
    forces resharding collectives on every chunk boundary — silently
    disable it for sharded batches (the dryrun previously had to pass
    compact=False by hand)."""
    for tree in trees:
        if tree is None:
            continue
        for leaf in jax.tree_util.tree_leaves(tree):
            s = getattr(leaf, "sharding", None)
            if s is None:
                continue
            try:
                if s.num_devices > 1 and not s.is_fully_replicated:
                    return True
            except Exception:
                return True  # unknown sharding type: be conservative
    return False


def optimize_batch(
    linearize_fn: Callable,
    error_fn: Callable,  # unused; errors come from linearize_fn
    retract_fn: Callable,  # (traj, delta (B,n,m)) -> traj
    traj0,
    params: OptimizerParams,
    data=None,
    data_axes=None,
) -> OptResult:
    """Run the batched optimizer to per-problem convergence.

    Two calling conventions:
      - `data is None`: linearize_fn(traj) -> (H_diag (B,n,m,m), H_off, b,
        err (B,)) with problem data closed over (legacy; chunked mode works
        but re-jits per call).
      - `data` given: linearize_fn(data, traj); `data` is threaded through
        the jit boundary as an argument, enabling the module-wide chunk
        cache when linearize_fn/retract_fn are stable objects.

    `error_fn` is retained in the signature for API compatibility but the
    loop derives errors from `linearize_fn`'s error output (one fused
    residual+Jacobian evaluation per step)."""
    del error_fn
    leaf0 = jax.tree_util.tree_leaves(traj0)[0]

    if data is None:
        lin2 = lambda _d, traj: linearize_fn(traj)  # noqa: E731
        cacheable = False
    else:
        lin2 = linearize_fn
        cacheable = True

    total = params.max_iter + (
        0 if params.method == "gaussnewton" else params.reject_budget
    )

    loop = params.loop
    if loop == "chunked" and isinstance(leaf0, jax.core.Tracer):
        # under an enclosing jit/vmap a host-driven loop is impossible;
        # degrade to the fully-traced static schedule
        loop = "static"

    if loop == "chunked":
        if cacheable:
            _init_jit, run_chunk, run_first = _chunked_callables(
                lin2, retract_fn, params, data=data)
        else:
            make_init, step = _build_fns(lin2, retract_fn, params)
            chunkf = _make_chunk(step, params)
            run_chunk = jax.jit(chunkf, donate_argnums=1)
            run_first = jax.jit(
                lambda d, t0: chunkf(d, make_init(d, t0)))
        csize = max(1, params.chunk_size)
        tail0 = max(1, params.tail_chunk or csize)
        growth = max(1.0, params.tail_growth)
        tail_cap = max(tail0, 4 * csize)
        _tail_cache: dict = {}

        def tail_runner(size):
            if size == csize:
                return run_chunk
            hit = _tail_cache.get(size)
            if hit is not None:
                return hit
            tail_params = dataclasses.replace(params, chunk_size=size)
            if cacheable:
                fn = _chunked_callables(
                    lin2, retract_fn, tail_params, data=data)[1]
            else:
                fn = jax.jit(_make_chunk(step, tail_params),
                             donate_argnums=1)
            _tail_cache[size] = fn
            return fn
        st, done0, active0 = run_first(data, traj0)
        B0 = int(st.err.shape[0])
        # straggler compaction: active-lane gather between chunks. The
        # host sync is already paid by the all-done check; shrinking to the
        # next power of two >= the active count makes late chunks cost
        # O(active) instead of O(B). Needs `data`+`data_axes` to know which
        # data leaves are per-lane. Compaction can only ever fire when the
        # target (>= compact_floor) is at most half the current batch, so
        # the effective enabling threshold is B0 >= 2*compact_floor.
        can_compact = (
            params.compact and data is not None and data_axes is not None
            and B0 >= 2 * params.compact_floor
            and not _any_leaf_sharded(data, traj0)
        )
        full_st = None  # full-size snapshot once compacted (final values
        abs_idx = None  # for finished lanes); abs_idx maps lane -> 0..B0
        data_cur = data
        attempts = csize
        tail_k = 0
        done_dev, active_dev = done0, active0
        while True:
            # one transfer fetches the all-done flag AND the per-lane
            # active mask (computed in-chunk) — no extra round trip
            done_h, active = jax.device_get((done_dev, active_dev))
            if bool(done_h) or attempts >= total:
                break
            if can_compact:
                tgt = max(params.compact_floor,
                          _next_pow2(int(active.sum())))
                Bcur = int(st.err.shape[0])
                if tgt <= Bcur // 2:
                    if full_st is None:
                        full_st, abs_idx = st, np.arange(B0)
                    else:
                        full_st = _scatter_state_unique(full_st, abs_idx, st)
                    lanes = np.nonzero(active)[0]
                    # pad with a duplicate of an active lane: the copies
                    # evolve identically, so the final scatter writes
                    # consistent values
                    idx = np.concatenate(
                        [lanes, np.full(tgt - lanes.size, lanes[0])]
                    ).astype(np.int32)
                    st = _gather_state(st, jnp.asarray(idx))
                    abs_idx = abs_idx[idx]
                    data_cur = _gather_data(data, data_axes,
                                            jnp.asarray(abs_idx))
            tail = max(1, min(int(tail0 * growth**tail_k), tail_cap))
            tail_k += 1
            st, done_dev, active_dev = tail_runner(tail)(data_cur, st)
            attempts += tail
        if full_st is not None:
            st = _scatter_state_unique(full_st, abs_idx, st)
    elif loop == "static" and cacheable:
        st = _static_callable(lin2, retract_fn, params)(data, traj0)
    else:
        make_init, step = _build_fns(lin2, retract_fn, params)
        if loop == "static":
            st = lax.fori_loop(
                0, total, lambda i, s: step(data, s), make_init(data, traj0)
            )
        else:
            def cond(s):
                return jnp.any(
                    ~s.converged & ~s.gave_up & (s.iters < params.max_iter)
                )

            st = lax.while_loop(
                cond, lambda s: step(data, s), make_init(data, traj0)
            )

    traj, err = st.traj, st.err
    if params.iter_no_increase and params.method == "gaussnewton":
        increased = st.err > st.prev_err
        traj = _mask_tree(increased, st.prev_traj, traj)
        err = jnp.where(increased, st.prev_err, err)

    # lanes still unconverged after the loop: report converged=False;
    # gave_up lanes (lambda blow-up / radius collapse / non-finite step)
    # are reported separately and never as converged.
    return OptResult(traj, err, st.iters, st.converged, st.gave_up)
