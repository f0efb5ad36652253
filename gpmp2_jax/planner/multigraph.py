"""Multi-chain planner graphs: joint optimization over a DAG of candidate
trajectories + shortest-path extraction.

Redesign of the reference Python toolbox's multi-graph machinery
(/root/reference/gpmp2_python/examples/multi_graph/graph_utils.py):

  - `sample_initializations` — get_initializations (graph_utils.py:91-160):
    optimize the prior-only GP chain, then draw candidate trajectories from
    the GP posterior over poses. Here the posterior is the exact Gaussian of
    the linear chain, sampled in one shot on device (mean + L^-T z with the
    dense Cholesky of the joint precision) instead of GTSAM Marginals.
  - `build_planner_graph` — get_planner_graph (graph_utils.py:287-341):
    node 0 = start, node 1 = goal, nodes 2.. = chain interiors; chain edges
    plus random inter-chain connections added with probability
    `connect_prob` ("dropout_prob" in the reference).
  - `MultiGraphProblem` + `multigraph_error` / `optimize_multigraph` —
    get_gtsam_graph (graph_utils.py:344-421) + the example's Dogleg/GN
    optimize: per-node unary obstacle factors, per-edge GP priors and
    GP-interpolated obstacle factors, start/goal priors. The graph is NOT
    chain-structured, so instead of the block-tridiagonal solver the
    normal equations are built densely (the joint graph is small — tens of
    nodes — and a dense (M*2d)^2 solve is MXU-friendly); the whole
    linearize+solve+retract iteration is one jittable program, vmappable
    over batches of graphs with the same topology.
  - `edge_costs` / `shortest_path` — Planner.get_edge_cost /
    get_shortest_path (graph_utils.py:431-480): ALL edge costs (GP +
    interpolated-obstacle factor errors) and node obstacle costs evaluate
    on device in one batched pass; the tiny Dijkstra over those scalars
    runs on host. Deviation from the reference: nodes are finalized when
    POPPED (textbook Dijkstra), not when pushed — the reference's
    mark-on-push variant can return suboptimal paths.

Costs follow gtsam::NonlinearFactorGraph::error semantics: 0.5 * sum of
weighted squared residuals, identical to planner/problem.py.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.statespace import StateSpace
from ..gp.interpolator import InterpCoeffs, interpolate_pose
from ..gp.prior import gp_prior_error
from ..gp.gputils import calc_Q_inv, calc_lambda, calc_psi
from ..kinematics.robot import RobotModel
from ..obstacle.factors import obstacle_factor_error, obstacle_planar_factor_error
from ..obstacle.sdf import PlanarSDF
from ..solver.linearize import quad_err_diag, quad_err_full

__all__ = [
    "MultiGraphProblem",
    "sample_initializations",
    "build_planner_graph",
    "make_multigraph_problem",
    "multigraph_error",
    "optimize_multigraph",
    "edge_costs",
    "shortest_path",
]


@dataclasses.dataclass(frozen=True)
class MultiGraphProblem:
    """A factor graph over M free nodes with an arbitrary edge set.

    Values are flat node arrays (pose (M, P), vel (M, d)); `edges` (E, 2)
    holds (parent, child) node-index pairs carrying a GP prior and the
    interpolated obstacle factors. Unary obstacle factors sit on every
    node except node 0 (get_gtsam_graph adds them for i > 0)."""

    robot: RobotModel
    sdf: object
    dt: jnp.ndarray  # () per-edge GP time step
    Qc: jnp.ndarray  # (d, d)
    obs_w: jnp.ndarray  # () 1/cost_sigma^2
    eps: jnp.ndarray  # ()
    taus: jnp.ndarray  # (inter,) interpolation offsets within an edge
    edges: jnp.ndarray  # (E, 2) int32
    prior_pose: jnp.ndarray  # (2, P) start/goal anchors (nodes 0, 1)
    prior_vel: jnp.ndarray  # (2, d)
    pose_prior_w: jnp.ndarray  # (d,)
    vel_prior_w: jnp.ndarray  # (d,)
    planar: bool = True

    @property
    def space(self) -> StateSpace:
        return self.robot.space


jax.tree_util.register_dataclass(
    MultiGraphProblem,
    data_fields=["robot", "sdf", "dt", "Qc", "obs_w", "eps", "taus",
                 "edges", "prior_pose", "prior_vel", "pose_prior_w",
                 "vel_prior_w"],
    meta_fields=["planar"],
)


# --------------------------------------------------------------------------
# initialization sampling (graph_utils.py get_initializations)
# --------------------------------------------------------------------------


def sample_initializations(space: StateSpace, start, end, n_steps: int,
                           total_time: float, Qc, n_chains: int, key,
                           prior_sigma: float = 1e-4):
    """Draw `n_chains` candidate trajectories from the GP posterior of the
    prior-only chain (endpoint priors + GP factors; graph_utils.py:91-160).

    Vector spaces only (the reference samples gtsam VectorValues). The
    chain is linear, so the posterior is exactly Gaussian: mean = the
    straight line, covariance = H^-1 with H the (dense) joint precision.
    Samples fix the start/goal rows afterwards, as the reference does.
    Returns (n_chains, n_steps+1, d) poses."""
    assert space.kind == "vector", "sampling requires a vector space"
    d = space.dim
    n = n_steps + 1
    dt = total_time / n_steps
    start = jnp.asarray(start)
    end = jnp.asarray(end)
    dtype = start.dtype

    # mean: straight line (the linear chain's MAP)
    ts = jnp.arange(n, dtype=dtype)[:, None] / n_steps
    mean_pose = start[None] * (1 - ts) + end[None] * ts
    avg_vel = (end - start) / total_time
    mean = jnp.concatenate(
        [jnp.concatenate([mean_pose, jnp.tile(avg_vel, (n, 1))], axis=1)
         .reshape(-1)]
    )

    # joint precision H (dense (n*2d)^2): GP factors + endpoint priors.
    # Phi maps state i to i+1; residual r = x_{i+1} - Phi x_i with weight
    # Q_inv (GPutils.h:41-58).
    Qinv = calc_Q_inv(jnp.asarray(Qc, dtype), jnp.asarray(dt, dtype))
    eye = jnp.eye(d, dtype=dtype)
    Phi = jnp.block([[eye, dt * eye], [jnp.zeros((d, d), dtype), eye]])
    H = jnp.zeros((n * 2 * d, n * 2 * d), dtype)
    A = jnp.concatenate([-Phi, jnp.eye(2 * d, dtype=dtype)], axis=1)
    blk = A.T @ Qinv @ A  # (4d, 4d) contribution of one GP factor
    for i in range(n_steps):
        s = i * 2 * d
        H = H.at[s:s + 4 * d, s:s + 4 * d].add(blk)
    wp = 1.0 / prior_sigma ** 2
    pr = jnp.full((2 * d,), wp, dtype)
    H = H.at[jnp.arange(2 * d), jnp.arange(2 * d)].add(pr)
    last = (n - 1) * 2 * d + jnp.arange(2 * d)
    H = H.at[last, last].add(pr)

    # sample x = mean + L^-T z  (cov = H^-1 = L^-T L^-1)
    L = jnp.linalg.cholesky(H)
    z = jax.random.normal(key, (n_chains, n * 2 * d), dtype)
    dev = jax.scipy.linalg.solve_triangular(L.T, z.T, lower=False).T
    samples = (mean[None] + dev).reshape(n_chains, n, 2 * d)[..., :d]
    samples = samples.at[:, 0].set(start)
    samples = samples.at[:, -1].set(end)
    return samples


# --------------------------------------------------------------------------
# planner-graph construction (host-side; topology is static data)
# --------------------------------------------------------------------------


def build_planner_graph(chains, avg_vel, connect_prob: float = 0.0,
                        seed: Optional[int] = None):
    """Nodes + edges of the multi-chain planner graph
    (get_planner_graph, graph_utils.py:287-341).

    chains: (n_chains, T+1, d) candidate trajectories sharing endpoints.
    Node 0 = shared start, node 1 = shared goal, then chain interiors in
    chain-major order. Chain edges connect consecutive states; random
    inter-chain edges (i, j) -> (k, j+1) are added with probability
    `connect_prob` for k != i.

    Returns (node_pose (M, d) np.ndarray, node_vel (M, d), edges (E, 2))."""
    chains = np.asarray(chains)
    n_chains, n, d = chains.shape
    T = n - 1
    avg_vel = np.broadcast_to(np.asarray(avg_vel), (d,))

    poses = [chains[0, 0], chains[0, -1]]
    index = {}
    for c in range(n_chains):
        for j in range(1, T):
            index[(c, j)] = len(poses)
            poses.append(chains[c, j])
    node_pose = np.stack(poses)
    node_vel = np.tile(avg_vel, (len(poses), 1))

    edges = []
    for c in range(n_chains):
        for j in range(T):
            a = 0 if j == 0 else index[(c, j)]
            b = 1 if j == T - 1 else index[(c, j + 1)]
            edges.append((a, b))
    rng = np.random.default_rng(seed)
    for c in range(n_chains):
        for j in range(1, T - 1):
            for k in range(n_chains):
                if k == c:
                    continue
                if rng.random() < connect_prob:
                    edges.append((index[(c, j)], index[(k, j + 1)]))
    return node_pose, node_vel, np.asarray(edges, np.int32)


def make_multigraph_problem(robot: RobotModel, sdf, edges, start_pose,
                            start_vel, goal_pose, goal_vel, *,
                            dt, Qc, cost_sigma: float, epsilon: float,
                            obs_check_inter: int = 0,
                            fix_sigma: float = 1e-4,
                            dtype=jnp.float32) -> MultiGraphProblem:
    """Assemble the factor-graph program over a planner graph
    (get_gtsam_graph, graph_utils.py:344-421)."""
    d = robot.space.dim
    f = lambda x: jnp.asarray(x, dtype)
    inter = int(obs_check_inter)
    taus = (jnp.arange(1, inter + 1, dtype=dtype)) * (dt / (inter + 1))
    return MultiGraphProblem(
        robot=robot, sdf=sdf, dt=f(dt), Qc=f(Qc),
        obs_w=f(1.0 / cost_sigma ** 2), eps=f(epsilon), taus=taus,
        edges=jnp.asarray(edges, jnp.int32),
        prior_pose=jnp.stack([f(start_pose), f(goal_pose)]),
        prior_vel=jnp.stack([f(start_vel), f(goal_vel)]),
        pose_prior_w=jnp.full((d,), 1.0 / fix_sigma ** 2, dtype),
        vel_prior_w=jnp.full((d,), 1.0 / fix_sigma ** 2, dtype),
        planar=isinstance(sdf, PlanarSDF),
    )


# --------------------------------------------------------------------------
# factor evaluation
# --------------------------------------------------------------------------


def _obs_res(prob: MultiGraphProblem, q):
    fn = obstacle_planar_factor_error if prob.planar else obstacle_factor_error
    return fn(prob.robot, prob.sdf, q, prob.eps)


def _edge_residuals(prob: MultiGraphProblem, pose, vel):
    """Per-edge GP residuals (E, 2d) and interpolated-obstacle residuals
    (E, inter, S)."""
    space = prob.space
    p1, v1 = pose[prob.edges[:, 0]], vel[prob.edges[:, 0]]
    p2, v2 = pose[prob.edges[:, 1]], vel[prob.edges[:, 1]]
    gp_r = jax.vmap(
        lambda a, va, b, vb: gp_prior_error(space, a, va, b, vb, prob.dt)
    )(p1, v1, p2, v2)
    if prob.taus.shape[0] == 0:
        obs_r = jnp.zeros((prob.edges.shape[0], 0, prob.robot.num_spheres),
                          pose.dtype)
        return gp_r, obs_r
    lam = jax.vmap(lambda t: calc_lambda(prob.Qc, prob.dt, t))(prob.taus)
    psi = jax.vmap(lambda t: calc_psi(prob.Qc, prob.dt, t))(prob.taus)

    def one_edge(a, va, b, vb):
        def at_tau(l, ps):
            pt = interpolate_pose(space, InterpCoeffs(l, ps), a, va, b, vb)
            return _obs_res(prob, pt)

        return jax.vmap(at_tau)(lam, psi)

    obs_r = jax.vmap(one_edge)(p1, v1, p2, v2)
    return gp_r, obs_r


def multigraph_error(prob: MultiGraphProblem, pose, vel):
    """Total graph error (gtsam::NonlinearFactorGraph::error semantics)."""
    err = jnp.zeros((), pose.dtype)
    space = prob.space
    for k in range(2):
        err += quad_err_diag(prob.pose_prior_w,
                             space.local(prob.prior_pose[k], pose[k]))
        err += quad_err_diag(prob.vel_prior_w, vel[k] - prob.prior_vel[k])
    # unary obstacle on nodes 1..M-1 (reference: i > 0)
    node_obs = jax.vmap(lambda q: _obs_res(prob, q))(pose[1:])
    err += quad_err_diag(prob.obs_w, node_obs)
    gp_r, obs_r = _edge_residuals(prob, pose, vel)
    err += quad_err_full(calc_Q_inv(prob.Qc, prob.dt), gp_r)
    err += quad_err_diag(prob.obs_w, obs_r)
    return err


def edge_costs(prob: MultiGraphProblem, pose, vel):
    """(edge_cost (E,), node_obs_cost (M,)) — the per-edge GP +
    interpolated-obstacle factor errors and per-node unary obstacle errors
    Dijkstra consumes (Planner.get_edge_cost, graph_utils.py:437-445).
    One batched device pass; no per-edge host calls."""
    gp_r, obs_r = _edge_residuals(prob, pose, vel)
    Qinv = calc_Q_inv(prob.Qc, prob.dt)
    e_gp = 0.5 * jnp.einsum("ei,ij,ej->e", gp_r, Qinv, gp_r)
    e_obs = 0.5 * prob.obs_w * jnp.sum(obs_r ** 2, axis=(1, 2))
    node_r = jax.vmap(lambda q: _obs_res(prob, q))(pose)
    node_cost = 0.5 * prob.obs_w * jnp.sum(node_r ** 2, axis=1)
    return e_gp + e_obs, node_cost


# --------------------------------------------------------------------------
# dense GN/LM optimization (arbitrary topology -> dense normal equations)
# --------------------------------------------------------------------------


def _flat_residual_fn(prob: MultiGraphProblem, pose0, vel0):
    """Whitened residual vector as a function of a flat tangent update
    dz (M*2d,) around (pose0, vel0); 0.5*|r(dz)|^2 == graph error."""
    space = prob.space
    M = pose0.shape[0]
    d = space.dim
    Qinv = calc_Q_inv(prob.Qc, prob.dt)
    # sqrt-information whiteners
    Lgp = jnp.linalg.cholesky(Qinv).T  # upper: |Lgp r|^2 = r^T Qinv r
    sw_pose = jnp.sqrt(prob.pose_prior_w)
    sw_vel = jnp.sqrt(prob.vel_prior_w)
    sw_obs = jnp.sqrt(prob.obs_w)

    def residuals(dz):
        dz = dz.reshape(M, 2 * d)
        pose = jax.vmap(space.retract)(pose0, dz[:, :d])
        vel = vel0 + dz[:, d:]
        parts = []
        for k in range(2):
            parts.append(sw_pose * space.local(prob.prior_pose[k], pose[k]))
            parts.append(sw_vel * (vel[k] - prob.prior_vel[k]))
        node_obs = jax.vmap(lambda q: _obs_res(prob, q))(pose[1:])
        parts.append((sw_obs * node_obs).reshape(-1))
        gp_r, obs_r = _edge_residuals(prob, pose, vel)
        parts.append((gp_r @ Lgp.T).reshape(-1))
        parts.append((sw_obs * obs_r).reshape(-1))
        return jnp.concatenate([p.reshape(-1) for p in parts])

    return residuals


def optimize_multigraph(prob: MultiGraphProblem, pose, vel, *,
                        max_iter: int = 100, lambda_init: float = 100.0,
                        lambda_factor: float = 10.0, lambda_max: float = 1e7,
                        rel_thresh: float = 1e-5, abs_thresh: float = 1e-5):
    """Batched-lambda LM on the dense normal equations. One jittable
    lax.scan over LM steps with accept/reject masking (same GTSAM
    semantics as solver/optimize.py, specialized to a dense solve).

    Returns (pose, vel, final_error, iters, converged)."""
    import warnings

    space = prob.space
    M, d = pose.shape[0], space.dim
    nvar = M * 2 * d
    dtype = pose.dtype
    # the dense jacfwd + (nvar x nvar) Cholesky are O(nvar^2) memory /
    # O(nvar^3) work — right for the reference's tens-of-nodes planner
    # DAGs, quadratic blow-up beyond. Warn loudly instead of silently
    # compiling a monster; chain-structured problems belong to plan_batch.
    if nvar > 2048:
        warnings.warn(
            f"optimize_multigraph: dense normal equations with "
            f"{nvar} variables ({M} nodes x {2 * d}) — O(nvar^2) memory "
            f"and O(nvar^3) solve. Multi-chain planner graphs are meant "
            f"to stay at tens of nodes (graph_utils.py semantics); for "
            f"long chain-structured problems use plan_batch's "
            f"block-tridiagonal solver instead.",
            stacklevel=2,
        )

    def err_of(p, v):
        return multigraph_error(prob, p, v)

    def step(carry, _):
        p, v, err, lam, done, iters = carry
        res_fn = _flat_residual_fn(prob, p, v)
        z0 = jnp.zeros((nvar,), dtype)
        r0 = res_fn(z0)
        J = jax.jacfwd(res_fn)(z0)  # (R, nvar) dense; graphs are small
        H = J.T @ J
        g = -J.T @ r0
        Hd = H + lam * jnp.eye(nvar, dtype=dtype)
        L = jnp.linalg.cholesky(Hd)
        delta = jax.scipy.linalg.cho_solve((L, True), g)
        dz = delta.reshape(M, 2 * d)
        p_new = jax.vmap(space.retract)(p, dz[:, :d])
        v_new = v + dz[:, d:]
        err_new = err_of(p_new, v_new)
        ok = jnp.isfinite(err_new) & (err_new < err)
        accept = ok & ~done
        p = jnp.where(accept, p_new, p)
        v = jnp.where(accept, v_new, v)
        err2 = jnp.where(accept, err_new, err)
        lam = jnp.where(accept, jnp.maximum(lam / lambda_factor, 1e-10),
                        jnp.where(done, lam, lam * lambda_factor))
        conv = accept & (
            (err - err2 <= abs_thresh)
            | ((err - err2) / jnp.maximum(err, 1e-30) <= rel_thresh)
        )
        gave_up = (~ok) & (lam > lambda_max)
        done2 = done | conv | gave_up
        iters = iters + jnp.where(accept, 1, 0)
        return (p, v, err2, lam, done2, iters), err2

    err0 = err_of(pose, vel)
    lam0 = jnp.asarray(lambda_init, dtype)
    carry = (pose, vel, err0, lam0, jnp.asarray(False), jnp.asarray(0))
    (pose, vel, err, _lam, done, iters), _ = jax.lax.scan(
        step, carry, None, length=max_iter)
    return pose, vel, err, iters, done


# --------------------------------------------------------------------------
# shortest-path extraction (host-side Dijkstra over device-computed costs)
# --------------------------------------------------------------------------


def shortest_path(edges, edge_cost, node_cost, start: int = 0,
                  goal: int = 1):
    """Dijkstra over the planner graph. Edge (i -> j) weight =
    edge_cost + node_cost[j] (the unary obstacle error of the entered
    node; skipped when j is the goal, matching get_edge_cost's
    `second_idx != 1` guard). Returns the node-id path start..goal."""
    edges = np.asarray(edges)
    edge_cost = np.asarray(edge_cost, np.float64)
    node_cost = np.asarray(node_cost, np.float64)
    adj = {}
    for (a, b), c in zip(edges, edge_cost):
        w = c + (node_cost[b] if b != goal else 0.0)
        adj.setdefault(int(a), []).append((int(b), float(w)))

    dist = {start: 0.0}
    parent = {start: None}
    finalized = set()
    pq = [(0.0, start)]
    while pq:
        dcur, u = heapq.heappop(pq)
        if u in finalized:
            continue
        finalized.add(u)
        if u == goal:
            break
        for v, w in adj.get(u, ()):
            nd = dcur + w
            if v not in dist or nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(pq, (nd, v))
    if goal not in finalized:
        raise ValueError("no path from start to goal in the planner graph")
    path = []
    u = goal
    while u is not None:
        path.append(u)
        u = parent[u]
    return path[::-1]
