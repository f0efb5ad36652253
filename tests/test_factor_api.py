"""Public config-space factor API tests (gpmp2_jax.kinematics.factors).

Mirrors the reference's per-factor test files (testJointLimitFactorVector.cpp,
testVelocityLimitFactorVector.cpp, testGoalFactorArm.cpp,
testGaussianPriorWorkspace{Position,Orientation,Pose}Arm.cpp): known-value
checks + Jacobian-vs-finite-difference through jax AD, and consistency with
the planner's internal residuals so the public kernels are the single
source of truth."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.geometry.statespace import SE2VectorSpace, VectorSpace
from gpmp2_jax.kinematics import (
    goal_factor_error,
    hinge_limit_cost,
    joint_limit_error,
    velocity_limit_error,
    workspace_orientation_error,
    workspace_pose_error,
    workspace_position_error,
)
from gpmp2_jax.kinematics.fk import link_poses
from gpmp2_jax.robots import generate_arm


def fd_jac(f, x, eps=1e-6):
    x = np.asarray(x, np.float64)
    cols = []
    for i in range(x.size):
        dx = np.zeros_like(x)
        dx[i] = eps
        cols.append((np.asarray(f(x + dx)) - np.asarray(f(x - dx))) / (2 * eps))
    return np.stack(cols, axis=-1)


class TestHinge:
    def test_values(self):
        # JointLimitCost.h:16-32: below / inside / above, slope -/0/+1
        p = jnp.asarray([-2.0, -0.4, 0.0, 0.4, 2.0])
        r = hinge_limit_cost(p, -1.0, 1.0, 0.5)
        np.testing.assert_allclose(r, [1.5, 0.0, 0.0, 0.0, 1.5], atol=1e-12)
        # threshold shrinks the free band: +/-0.6 is outside [-0.5, 0.5]
        r2 = hinge_limit_cost(jnp.asarray([-0.6, 0.6]), -1.0, 1.0, 0.5)
        np.testing.assert_allclose(r2, [0.1, 0.1], atol=1e-12)


class TestJointLimit:
    def test_vector_jacobian(self):
        space = VectorSpace(4)
        down = jnp.asarray([-1.0, -2.0, -1.0, -5.0])
        up = jnp.asarray([1.0, 2.0, 1.0, 5.0])
        thr = jnp.asarray([0.1, 0.2, 0.3, 0.4])
        q = jnp.asarray([-1.5, 0.0, 1.2, 10.0])
        f = lambda x: joint_limit_error(space, jnp.asarray(x), down, up, thr)
        J = jax.jacfwd(f)(q)
        np.testing.assert_allclose(J, fd_jac(f, q), atol=1e-6)
        np.testing.assert_allclose(
            f(q), [(-1.0 + 0.1) - (-1.5), 0.0, 1.2 - (1.0 - 0.3), 10.0 - (5.0 - 0.4)],
            atol=1e-12,
        )

    def test_se2_vector_masks_base(self):
        # JointLimitFactorPose2Vector.h:66-91: first 3 dims zero
        space = SE2VectorSpace(2)
        q = jnp.asarray([9.0, 9.0, 2.0, 5.0, -5.0])
        r = joint_limit_error(space, q, -jnp.ones(5), jnp.ones(5), 0.0)
        assert np.allclose(r[:3], 0.0)
        np.testing.assert_allclose(r[3:], [4.0, -(-5.0) - 1.0], atol=1e-12)


class TestVelocityLimit:
    def test_symmetric(self):
        v = jnp.asarray([-3.0, 0.0, 3.0])
        r = velocity_limit_error(v, 2.0 * jnp.ones(3), 0.5)
        np.testing.assert_allclose(r, [1.5, 0.0, 1.5], atol=1e-12)


class TestGoalFactor:
    def test_value_and_jacobian(self):
        arm = generate_arm("SimpleTwoLinksArm", dtype=jnp.float64)
        q = jnp.asarray([0.3, -0.4], jnp.float64)
        goal = jnp.asarray([1.0, 0.5, 0.0], jnp.float64)
        ee = link_poses(arm.fk, q).trans[-1]
        np.testing.assert_allclose(
            goal_factor_error(arm.fk, q, goal), ee - goal, atol=1e-12
        )
        f = lambda x: goal_factor_error(arm.fk, jnp.asarray(x), goal)
        np.testing.assert_allclose(jax.jacfwd(f)(q), fd_jac(f, q), atol=1e-6)


class TestWorkspacePriors:
    def test_pose_is_concat_of_parts(self):
        arm = generate_arm("WAMArm", dtype=jnp.float64)
        q = jnp.asarray([0.1, -0.2, 0.3, 1.0, -0.5, 0.2, 0.7], jnp.float64)
        des_R = np.asarray(link_poses(arm.fk, jnp.zeros(7, jnp.float64)).rot[5])
        des_t = jnp.asarray([0.1, 0.2, 0.9], jnp.float64)
        rp = workspace_position_error(arm.fk, q, 5, des_t)
        ro = workspace_orientation_error(arm.fk, q, 5, des_R)
        rf = workspace_pose_error(arm.fk, q, 5, des_R, des_t)
        np.testing.assert_allclose(rf, jnp.concatenate([ro, rp]), atol=1e-12)

    def test_zero_at_satisfied(self):
        arm = generate_arm("WAMArm", dtype=jnp.float64)
        q = jnp.asarray([0.1, -0.2, 0.3, 1.0, -0.5, 0.2, 0.7], jnp.float64)
        poses = link_poses(arm.fk, q)
        r = workspace_pose_error(arm.fk, q, 6, poses.rot[6], poses.trans[6])
        np.testing.assert_allclose(r, np.zeros(6), atol=1e-10)

    def test_jacobian(self):
        arm = generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
        q = jnp.asarray([0.2, 0.4, -0.3], jnp.float64)
        des_R = np.eye(3)
        des_t = np.asarray([0.5, 0.5, 0.0])
        f = lambda x: workspace_pose_error(arm.fk, jnp.asarray(x), 2, des_R, des_t)
        np.testing.assert_allclose(jax.jacfwd(f)(q), fd_jac(f, q), atol=1e-6)


class TestChunkedLoop:
    """The chunked host-driven loop must match the static schedule."""

    def _setup(self, method):
        import dataclasses

        from gpmp2_jax.kinematics import PointRobotFK, make_robot_model
        from gpmp2_jax.obstacle.sdf import PlanarSDF
        from gpmp2_jax.planner import TrajOptimizerSetting
        from gpmp2_jax.planner.batch import (
            infer_batch_axes, make_problem, optimizer_params_from_setting,
            plan_batch,
        )
        from gpmp2_jax.planner.traj_utils import init_traj_straight_line

        xs = np.linspace(-2, 2, 41)
        X, Y = np.meshgrid(xs, xs, indexing="xy")
        dist = np.sqrt(X**2 + Y**2) - 0.5
        sdf = PlanarSDF(
            origin=jnp.asarray([-2.0, -2.0]), cell_size=jnp.asarray(0.1),
            data=jnp.asarray(dist),
        )
        robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))])
        setting = TrajOptimizerSetting(
            dof=2, total_step=8, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
            obs_check_inter=3, opt_type=method, max_iter=20, rel_thresh=1e-4,
            Qc=np.eye(2),
        )
        B = 4
        rng = np.random.default_rng(3)
        starts = jnp.asarray([-1.5, -1.5]) + 0.1 * jnp.asarray(rng.normal(size=(B, 2)))
        goals = jnp.asarray([1.5, 1.5]) + 0.1 * jnp.asarray(rng.normal(size=(B, 2)))
        zeros = jnp.zeros((B, 2))
        probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
        tmpl = make_problem(robot, sdf, starts[0], zeros[0], goals[0], zeros[0], setting)
        axes = infer_batch_axes(probs, tmpl)
        init = jax.vmap(
            lambda s, g: init_traj_straight_line(robot.space, s, g, 8, 5.0)
        )(starts, goals)
        params = optimizer_params_from_setting(setting)
        return probs, init, params, axes, plan_batch, dataclasses

    def test_chunked_matches_static(self):
        for method in ("lm", "dogleg"):
            probs, init, params, axes, plan_batch, dc = self._setup(method)
            r_chunk = plan_batch(probs, init, dc.replace(params, loop="chunked", chunk_size=3), axes)
            r_static = plan_batch(probs, init, dc.replace(params, loop="static"), axes)
            np.testing.assert_allclose(
                np.asarray(r_chunk.error), np.asarray(r_static.error),
                rtol=1e-10,
            )
            assert np.array_equal(
                np.asarray(r_chunk.iterations), np.asarray(r_static.iterations)
            )
            assert bool(np.asarray(r_chunk.converged).all())

    def test_chunked_under_jit_degrades_to_static(self):
        probs, init, params, axes, plan_batch, dc = self._setup("lm")
        p = dc.replace(params, loop="chunked")
        r_jit = jax.jit(lambda pr, t: plan_batch(pr, t, p, axes))(probs, init)
        r_eager = plan_batch(probs, init, p, axes)
        np.testing.assert_allclose(
            np.asarray(r_jit.error), np.asarray(r_eager.error), rtol=1e-8
        )
