"""Device-mesh scale-out for batched planning.

The reference has no distributed layer (SURVEY.md section 2.11): users run
the C++ planner in a loop. Here, scale-out is first-class: the problem
batch shards across a `jax.sharding.Mesh` ('dp' axis over the local
cards), the jitted batched solve partitions automatically under GSPMD, and
cross-problem reductions (the `any(active)` convergence test inside the
optimizer while_loop, cost statistics) become XLA collectives over the
mesh, which XLA hands to NCCL on GPUs. Planning problems are
embarrassingly parallel, so the only communication is these small
reductions. The cards of one host reach each other all to all, so the
mesh's shape follows the algorithm ('dp', or 'dp' x 'ts' for long
horizons), not the interconnect.

Typical use:
    mesh = make_mesh()                       # all local devices on 'dp'
    probs, axes = ...                        # from make_problem/infer_batch_axes
    probs, traj = shard_problems(mesh, probs, traj, axes)
    res = jax.jit(lambda p, t: plan_batch(p, t, params, axes))(probs, traj)
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_problems", "replicate", "batch_sharding",
           "fleet_stats"]


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a device mesh. Default: all devices on a single 'dp' axis.

    Multi-axis example (future trajectory-axis sharding):
        make_mesh(shape=(4, 2), axis_names=('dp', 'ts'))
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding that partitions the leading (problem-batch) axis."""
    return NamedSharding(mesh, P(axis))


def replicate(mesh: Mesh):
    return NamedSharding(mesh, P())


def shard_problems(mesh: Mesh, problems, traj, problem_axes, axis: str = "dp"):
    """Place a problem batch on the mesh: batched leaves (axis 0 in
    `problem_axes`) shard over `axis`; shared leaves (None) replicate.

    Returns (problems, traj) device-put onto the mesh.
    """
    shard = batch_sharding(mesh, axis)
    repl = replicate(mesh)

    def place(leaf, ax):
        return jax.device_put(leaf, shard if ax == 0 else repl)

    # problem_axes is a matching pytree of {0, None}; None collapses to an
    # empty subtree under tree_map, so walk leaves with a paired traversal.
    leaves, treedef = jax.tree_util.tree_flatten(problems)
    ax_flat = _flatten_axes_like(problem_axes, problems)
    placed = [place(l, a) for l, a in zip(leaves, ax_flat)]
    problems = jax.tree_util.tree_unflatten(treedef, placed)
    traj = jax.tree_util.tree_map(lambda x: jax.device_put(x, shard), traj)
    return problems, traj


def fleet_stats(mesh: Mesh, result, axis: str = "dp"):
    """Fleet-wide statistics of a sharded OptResult, reduced ON DEVICE with
    explicit `psum` collectives over the mesh axis (each device reduces its
    local shard, then one small all-reduce — no gather of the full batch
    to any host).

    Returns a dict of replicated scalars:
      n, converged, gave_up, mean_error, mean_iters.
    """
    import jax.numpy as jnp
    from jax import lax, shard_map

    spec = P(axis)

    def stats(err, conv, gave, iters):
        local = jnp.stack([
            jnp.sum(conv.astype(err.dtype)),
            jnp.sum(gave.astype(err.dtype)),
            jnp.sum(err),
            jnp.sum(iters.astype(err.dtype)),
            jnp.asarray(err.shape[0], err.dtype),  # local shard size
        ])
        return lax.psum(local, axis)

    tot = shard_map(
        stats, mesh=mesh, in_specs=(spec, spec, spec, spec), out_specs=P()
    )(result.error, result.converged, result.gave_up, result.iterations)
    n = tot[4]
    return {
        "n": n,
        "converged": tot[0],
        "gave_up": tot[1],
        "mean_error": tot[2] / n,
        "mean_iters": tot[3] / n,
    }


def _flatten_axes_like(axes_tree, value_tree):
    """Flatten an in_axes tree (None leaves mean broadcast) against the
    value pytree, exactly as vmap does — robust to None VALUE leaves (e.g.
    an unpacked SDF's `packed=None`), which vanish from the value pytree
    but not from a naive is_leaf=None flatten of the axes tree."""
    from jax.api_util import flatten_axes

    treedef = jax.tree_util.tree_flatten(value_tree)[1]
    return flatten_axes("shard_problems problem_axes", treedef, axes_tree)
