"""Multi-chain planner graph on the 2D point robot.

Mirror of /root/reference/gpmp2_python/examples/multi_graph/
graph_pointRobot.py: sample candidate trajectories from the GP posterior,
build a planner DAG with random inter-chain connections, jointly optimize
EVERY node in one factor graph, then extract the best hybrid path by
Dijkstra over the optimized factor costs.

Run: PYTHONPATH=. python examples/multi_graph_point_robot.py
"""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax import PointRobotFK, make_robot_model
from gpmp2_jax.datasets import generate_2d_dataset, planar_sdf_from_occupancy
from gpmp2_jax.planner import (
    build_planner_graph,
    edge_costs,
    make_multigraph_problem,
    multigraph_error,
    optimize_multigraph,
    sample_initializations,
    shortest_path,
)


def main():
    # world + robot (graph_pointRobot.py:21-45)
    ds = generate_2d_dataset("MultiObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    robot = make_robot_model(PointRobotFK(), [(0, 1.5, (0.0, 0.0, 0.0))])

    # settings (lines 30-67)
    total_time, n_steps = 10.0, 20
    dt = total_time / n_steps
    check_inter = 1  # int(total_check_step / total_time_step - 1)
    cost_sigma, eps = 0.5, 4.0
    start = jnp.asarray([0.0, 0.0])
    goal = jnp.asarray([17.0, 14.0])
    zero = jnp.zeros(2)
    avg_vel = (goal / n_steps) / dt

    # candidate chains from the GP posterior (get_initializations)
    from gpmp2_jax.geometry.statespace import StateSpace

    space = StateSpace("vector", 2)
    chains = sample_initializations(
        space, start, goal, n_steps, total_time, np.eye(2), n_chains=4,
        key=jax.random.PRNGKey(42),
    )

    # planner DAG with random inter-chain edges (dropout_prob = 0.5,
    # seed_val = 1; graph_pointRobot.py:72-74)
    pose0, vel0, edges = build_planner_graph(
        chains, avg_vel, connect_prob=0.5, seed=1)
    print(f"planner graph: {pose0.shape[0]} nodes, {edges.shape[0]} edges")

    prob = make_multigraph_problem(
        robot, sdf, edges, start, zero, goal, zero,
        dt=dt, Qc=np.eye(2), cost_sigma=cost_sigma, epsilon=eps,
        obs_check_inter=check_inter,
    )
    pose0 = jnp.asarray(pose0, jnp.float32)
    vel0 = jnp.asarray(vel0, jnp.float32)

    e0 = float(multigraph_error(prob, pose0, vel0))
    print(f"Initial Error = {e0:.1f}")
    pose, vel, err, iters, _ = optimize_multigraph(prob, pose0, vel0)
    print(f"Final Error = {float(err):.1f}  ({int(iters)} accepted steps)")

    # best path through the optimized DAG (Planner.get_shortest_path)
    ec, nc = edge_costs(prob, pose, vel)
    path = shortest_path(prob.edges, ec, nc)
    pts = np.asarray(pose)[path]
    print(f"extracted path through {len(path)} nodes:")
    for i, p in enumerate(pts):
        print(f"  {i:2d}: ({p[0]:7.3f}, {p[1]:7.3f})")

    # sanity: the path is collision-free under the planning margin
    assert len(path) == n_steps + 1
    path_cost = float(np.asarray(nc)[path].sum())
    print(f"path obstacle cost: {path_cost:.4f}")
    print("ok")


if __name__ == "__main__":
    main()
