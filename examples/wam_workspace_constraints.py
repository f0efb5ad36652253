"""WAM 7-DOF planning with workspace constraints.

Mirror of matlab/WAMWorkspaceConstraintsExample.m:14-137: the end-effector
must stay horizontal along the whole trajectory (workspace ORIENTATION
prior at every intermediate state) and reach a goal given as a workspace
POSE (not a goal configuration — the end-config prior is removed and
replaced by a GaussianPriorWorkspacePoseArm on the last state,
WAMWorkspaceConstraintsExample.m:94-102).

Run: PYTHONPATH=. python examples/wam_workspace_constraints.py
"""

import dataclasses
import jax

# the workspace-pose goal carries a 1e8 precision against a ~1.2 m initial
# EE error: the normal equations need double (the reference runs GTSAM in
# double throughout)
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_3d_dataset, sdf_from_occupancy
from gpmp2_jax.kinematics.fk import link_poses
from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
from gpmp2_jax.planner.batch import (
    infer_batch_axes,
    optimizer_params_from_setting,
    plan_batch,
    set_workspace_prior,
)
from gpmp2_jax.planner.problem import Trajectory, collision_cost
from gpmp2_jax.robots import generate_arm


def main():
    robot = generate_arm("WAMArm")
    dof = 7
    ee_link = dof - 1  # end-effector frame (arm.dof()-1 in the reference)

    print("building WAMDeskDataset + signed distance field ...")
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    # reference example's configs (WAMWorkspaceConstraintsExample.m:16-17;
    # note it plans FROM the horizontal-EE pose TO the over-desk config)
    start_conf = jnp.asarray([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    end_conf = jnp.asarray([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    zero = jnp.zeros(dof)

    # workspace targets from FK (lines 21-25): keep the EE orientation it
    # has at the start; the goal is the EE *pose* at end_conf
    frames_start = link_poses(robot.fk, start_conf)
    traj_orien = frames_start.rot[ee_link]
    frames_end = link_poses(robot.fk, end_conf)
    end_rot = frames_end.rot[ee_link]
    end_point = frames_end.trans[ee_link]

    n_steps = 10
    setting = TrajOptimizerSetting(
        dof=dof, total_step=n_steps, total_time=2.0,
        epsilon=0.15, cost_sigma=0.005, obs_check_inter=5,
        Qc=0.1 * np.eye(dof), opt_type="lm", max_iter=200, rel_thresh=1e-5,
    )

    # one workspace slot per state 1..N: orientation-only at 1..N-1,
    # full pose at N (the goal)
    prob = make_problem(
        robot, sdf, start_conf, zero, end_conf, zero, setting,
        num_ws=n_steps,
    )
    for i in range(1, n_steps):
        prob = set_workspace_prior(
            prob, i - 1, i, ee_link, rot=traj_orien, rot_sigma=1e-2
        )
    prob = set_workspace_prior(
        prob, n_steps - 1, n_steps, ee_link,
        point=end_point, rot=end_rot, pos_sigma=1e-4, rot_sigma=1e-4,
    )
    # the goal lives in workspace: remove the end-CONFIG prior (the
    # reference adds none at i==total_time_step), keep the zero-velocity
    # goal prior
    prob = dataclasses.replace(
        prob, goal_pose_w=jnp.zeros((dof,), prob.goal_pose_w.dtype)
    )

    # reference init: constant at start_conf (initArmTrajStraightLine with
    # start == end, line 82)
    init = Trajectory(
        pose=jnp.tile(start_conf, (n_steps + 1, 1)),
        vel=jnp.zeros((n_steps + 1, dof)),
    )

    probs = jax.tree_util.tree_map(lambda x: x[None], prob)
    axes = infer_batch_axes(probs, prob)
    # the reference example runs raw GTSAM LM with lambdaInitial = 1000
    # (WAMWorkspaceConstraintsExample.m:136), not gpmp2 optimize()'s 100.
    # lambda_max is raised above GTSAM's 1e5 bound: this graph's stiff
    # region (1e8-precision workspace pose against a 1.2 m initial EE
    # error) needs lambda ~1e6 transiently; at GTSAM's bound LM declares
    # give-up there and returns the partial trajectory.
    params = dataclasses.replace(
        optimizer_params_from_setting(setting),
        lambda_init=1000.0, lambda_max=1e9, chunk_size=16,
    )
    res = plan_batch(
        probs, Trajectory(init.pose[None], init.vel[None]), params, axes,
    )
    traj = Trajectory(res.traj.pose[0], res.traj.vel[0])

    # report: goal pose reached in workspace + EE kept horizontal
    frames = jax.vmap(lambda q: link_poses(robot.fk, q))(traj.pose)
    ee_pos = frames.trans[:, ee_link]
    ee_rot = frames.rot[:, ee_link]
    goal_pos_err = float(jnp.linalg.norm(ee_pos[-1] - end_point))
    # orientation deviation along the trajectory: angle of R_des^T R
    rel = jnp.einsum("ji,njk->nik", traj_orien, ee_rot[1:-1])
    cos_ang = jnp.clip((jnp.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    max_tilt_deg = float(jnp.rad2deg(jnp.arccos(cos_ang)).max())
    cc = float(collision_cost(prob, traj.pose))

    print(f"converged: {bool(res.converged[0])}  iters: {int(res.iterations[0])}")
    print(f"graph error: {float(res.error[0]):.4f}")
    print(f"EE goal position error: {goal_pos_err * 1000:.2f} mm")
    print(f"max EE tilt vs horizontal along trajectory: {max_tilt_deg:.2f} deg")
    print(f"collision cost: {cc:.6f}")
    assert goal_pos_err < 0.02, "workspace goal not reached"
    assert cc == 0.0, "trajectory in collision"
    print("ok")


if __name__ == "__main__":
    main()
