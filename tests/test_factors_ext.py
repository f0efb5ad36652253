"""Self-collision, workspace-prior, and vehicle-dynamics factor tests
(mirroring testSelfCollision.cpp, testGaussianPriorWorkspace*.cpp,
testVehicleDynamics.cpp patterns: value checks + Jacobian-vs-AD + effect
on the optimized trajectory)."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.geometry import so3
from gpmp2_jax.kinematics.fk import link_poses
from gpmp2_jax.obstacle.sdf import PlanarSDF
from gpmp2_jax.planner import (
    TrajOptimizerSetting,
    batch_traj_optimize,
    make_problem,
    traj_error,
)
from gpmp2_jax.planner.batch import set_workspace_prior
from gpmp2_jax.planner.problem import (
    _selfcoll_res,
    _selfcoll_res_and_jac,
    _dyn_res,
)
from gpmp2_jax.robots import generate_arm, generate_mobile_base


def far_sdf():
    return PlanarSDF(
        origin=jnp.asarray([-50.0, -50.0]), cell_size=jnp.asarray(1.0),
        data=jnp.full((101, 101), 1000.0),
    )


class TestSelfCollision:
    def _prob(self):
        arm = generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
        # check first-link tip sphere vs last-link tip sphere
        pairs = [[4, 15, 0.1, 0.05], [0, 10, 0.05, 0.1]]
        setting = TrajOptimizerSetting(dof=3, Qc=np.eye(3))
        zero = jnp.zeros(3, jnp.float64)
        return make_problem(
            arm, far_sdf(), zero, zero, zero, zero, setting,
            self_collision_pairs=pairs, dtype=jnp.float64,
        )

    def test_values(self):
        prob = self._prob()
        # straight arm: spheres along a line, far apart -> zero residual
        r = _selfcoll_res(prob, jnp.zeros(3, jnp.float64))
        np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-12)
        # folded arm: joint 2 and 3 folded back -> spheres overlap
        r2 = _selfcoll_res(prob, jnp.asarray([0.0, np.pi, np.pi * 0.98]))
        assert float(r2.max()) > 0.0

    def test_jacobian_matches_ad(self):
        prob = self._prob()
        rng = np.random.default_rng(0)
        for _ in range(4):
            q = jnp.asarray(rng.normal(size=3))
            r, J = _selfcoll_res_and_jac(prob, q)
            r_ref = _selfcoll_res(prob, q)
            J_ad = jax.jacfwd(lambda qq: _selfcoll_res(prob, qq))(q)
            np.testing.assert_allclose(np.asarray(r), np.asarray(r_ref), atol=1e-12)
            np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), atol=1e-9)


class TestWorkspacePriors:
    def test_position_prior_pulls_link(self):
        """A strong workspace-position prior on the end-effector at the
        final state drags it to the target (WAMWorkspaceConstraintsExample
        pattern)."""
        arm = generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
        setting = TrajOptimizerSetting(
            dof=3, total_step=6, total_time=3.0, opt_type="lm",
            max_iter=100, rel_thresh=1e-8, Qc=np.eye(3),
        )
        start = jnp.zeros(3, jnp.float64)
        goal = jnp.asarray([0.4, 0.3, -0.2])
        zero = jnp.zeros(3, jnp.float64)
        prob = make_problem(arm, far_sdf(), start, zero, goal, zero, setting,
                            num_ws=1, dtype=jnp.float64)
        target = jnp.asarray([0.8, 0.9, 0.0])
        prob = set_workspace_prior(prob, 0, 3, 2, point=target, pos_sigma=1e-3)
        # soften the goal config prior so the workspace prior can win
        import dataclasses

        prob = dataclasses.replace(
            prob,
            goal_pose_w=jnp.full((3,), 1.0, jnp.float64),
            goal_vel_w=jnp.full((3,), 1.0, jnp.float64),
        )
        from gpmp2_jax.planner.batch import plan_batch, infer_batch_axes
        from gpmp2_jax.planner.traj_utils import init_traj_straight_line
        from gpmp2_jax.solver.optimize import OptimizerParams

        probs = jax.tree_util.tree_map(lambda x: x[None], prob)
        axes = jax.tree_util.tree_map(lambda x: 0, probs)
        t0 = init_traj_straight_line(arm.space, start, goal, 6, 3.0)
        from gpmp2_jax.planner.problem import Trajectory

        res = plan_batch(
            probs, Trajectory(t0.pose[None], t0.vel[None]),
            OptimizerParams(method="lm", max_iter=100, rel_thresh=1e-10), axes,
        )
        ee = link_poses(arm.fk, res.traj.pose[0, 3]).trans[-1]
        np.testing.assert_allclose(np.asarray(ee), np.asarray(target), atol=2e-3)

    def test_orientation_residual_zero_when_matched(self):
        arm = generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
        setting = TrajOptimizerSetting(dof=3, Qc=np.eye(3))
        zero = jnp.zeros(3, jnp.float64)
        prob = make_problem(arm, far_sdf(), zero, zero, zero, zero, setting,
                            num_ws=1, dtype=jnp.float64)
        q = jnp.asarray([0.3, -0.4, 0.2])
        R = link_poses(arm.fk, q).rot[2]
        prob = set_workspace_prior(prob, 0, 0, 2, rot=R, rot_sigma=1e-3)
        from gpmp2_jax.planner.problem import _ws_residuals

        r = _ws_residuals(prob, q[None])
        np.testing.assert_allclose(np.asarray(r[0, :3]), 0.0, atol=1e-10)


class TestVehicleDynamics:
    def test_body_frame_residual(self):
        """SE(2): err = v_y (VehicleDynamics.h:19-27)."""
        robot = generate_mobile_base(dtype=jnp.float64)
        setting = TrajOptimizerSetting(dof=3, Qc=np.eye(3))
        zero = jnp.zeros(3, jnp.float64)
        prob = make_problem(robot, far_sdf(), zero, zero, zero, zero, setting,
                            flag_vehicle_dynamics=True, dtype=jnp.float64)
        r = _dyn_res(prob, jnp.asarray([1.0, 2.0, 0.5]), jnp.asarray([0.7, -0.3, 0.1]))
        np.testing.assert_allclose(np.asarray(r), [-0.3], atol=1e-12)

    def test_planner_respects_nonholonomy(self):
        robot = generate_mobile_base(dtype=jnp.float64)
        setting = TrajOptimizerSetting(
            dof=3, total_step=8, total_time=8.0, opt_type="lm",
            max_iter=100, rel_thresh=1e-8, Qc=np.eye(3),
        )
        start = jnp.asarray([0.0, 0.0, 0.0])
        goal = jnp.asarray([2.0, 1.5, np.pi / 2])
        zero = jnp.zeros(3, jnp.float64)
        res = batch_traj_optimize(
            robot, far_sdf(), start, zero, goal, zero, setting,
            flag_vehicle_dynamics=True, dyn_sigma=1e-3,
        )
        assert float(jnp.abs(res.traj.vel[:, 1]).max()) < 1e-3
