"""Analytic sphere/obstacle Jacobians vs AD (the hot-path kernels)."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.kinematics.fk import ArmFK, PointRobotFK
from gpmp2_jax.kinematics.robot import (
    make_robot_model,
    sphere_centers_and_jac,
    sphere_centers_world,
)
from gpmp2_jax.obstacle.sdf import PlanarSDF, SignedDistanceField
from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
from gpmp2_jax.planner.problem import _obs_res, _obs_res_and_jac
from gpmp2_jax.robots import generate_arm


class TestSphereJacobian:
    def test_arm_analytic_vs_ad(self):
        wam = generate_arm("WAMArm", dtype=jnp.float64)
        rng = np.random.default_rng(0)
        for _ in range(5):
            q = jnp.asarray(rng.normal(size=7))
            c, J = sphere_centers_and_jac(wam, q)
            c_ad = sphere_centers_world(wam, q)
            J_ad = jax.jacfwd(lambda qq: sphere_centers_world(wam, qq))(q)
            np.testing.assert_allclose(np.asarray(c), np.asarray(c_ad), atol=1e-12)
            np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), atol=1e-10)

    def test_arm_with_base_pose(self):
        from gpmp2_jax.geometry import so3
        from gpmp2_jax.geometry.se3 import Pose3

        base = Pose3(so3.ypr(0.7, -0.2, 0.4), jnp.asarray([1.0, -2.0, 0.5]))
        arm = ArmFK.create([0.5, 0.4, 0.3], [0.1, -0.2, 0.3], [0.0, 0.2, 0.0],
                           theta_bias=[0.1, 0.0, -0.4], base_pose=base,
                           dtype=jnp.float64)
        model = make_robot_model(
            arm, [(0, 0.05, (0.1, 0.2, 0.0)), (2, 0.05, (-0.1, 0.0, 0.3))],
            dtype=jnp.float64,
        )
        q = jnp.asarray([0.3, -0.5, 1.1])
        c, J = sphere_centers_and_jac(model, q)
        J_ad = jax.jacfwd(lambda qq: sphere_centers_world(model, qq))(q)
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), atol=1e-10)

    def test_point_robot(self):
        model = make_robot_model(PointRobotFK(), [(0, 0.1, (0.0, 0.0, 0.0))],
                                 dtype=jnp.float64)
        q = jnp.asarray([0.3, -0.6])
        c, J = sphere_centers_and_jac(model, q)
        J_ad = jax.jacfwd(lambda qq: sphere_centers_world(model, qq))(q)
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), atol=1e-12)


class TestObstacleJacobian:
    def _sdf3d(self):
        rng = np.random.default_rng(1)
        # smooth random field so gradients are informative
        from scipy.ndimage import gaussian_filter

        data = gaussian_filter(rng.normal(size=(24, 24, 24)), 3) * 5
        return SignedDistanceField(
            origin=jnp.asarray([-1.2, -1.2, -1.2]),
            cell_size=jnp.asarray(0.1),
            data=jnp.asarray(data),
        )

    def test_obstacle_jac_matches_ad_3d(self):
        wam = generate_arm("WAMArm", dtype=jnp.float64)
        sdf = self._sdf3d()
        setting = TrajOptimizerSetting(dof=7, cost_sigma=0.02, epsilon=0.2)
        zero = jnp.zeros(7, jnp.float64)
        prob = make_problem(wam, sdf, zero, zero, zero, zero, setting,
                            dtype=jnp.float64)
        rng = np.random.default_rng(2)
        for _ in range(3):
            q = jnp.asarray(0.5 * rng.normal(size=7))
            r, J = _obs_res_and_jac(prob, q)
            r_ref = _obs_res(prob, q)
            J_ad = jax.jacfwd(lambda qq: _obs_res(prob, qq))(q)
            np.testing.assert_allclose(np.asarray(r), np.asarray(r_ref), atol=1e-12)
            np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), atol=1e-9)

    def test_obstacle_jac_matches_ad_planar(self):
        arm = generate_arm("SimpleTwoLinksArm", dtype=jnp.float64)
        rng = np.random.default_rng(3)
        from scipy.ndimage import gaussian_filter

        data = gaussian_filter(rng.normal(size=(48, 48)), 4) * 3
        sdf = PlanarSDF(
            origin=jnp.asarray([-1.5, -1.5]), cell_size=jnp.asarray(0.0625),
            data=jnp.asarray(data),
        )
        setting = TrajOptimizerSetting(dof=2, cost_sigma=0.1, epsilon=0.2)
        zero = jnp.zeros(2, jnp.float64)
        prob = make_problem(arm, sdf, zero, zero, zero, zero, setting,
                            dtype=jnp.float64)
        for _ in range(3):
            q = jnp.asarray(rng.normal(size=2))
            r, J = _obs_res_and_jac(prob, q)
            J_ad = jax.jacfwd(lambda qq: _obs_res(prob, qq))(q)
            np.testing.assert_allclose(np.asarray(r), np.asarray(_obs_res(prob, q)), atol=1e-12)
            np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), atol=1e-9)


class TestMobileSphereJacobian:
    """Analytic sphere Jacobians for every mobile family vs AD through
    the retract-perturbed FK (the reference's Adjoint re-rooting path,
    Pose2MobileArm.cpp:96-106)."""

    def _check(self, model):
        import numpy as np

        space = model.space
        rng = np.random.default_rng(7)
        for _ in range(3):
            q = jnp.asarray(rng.normal(size=space.storage_dim))
            c, J = sphere_centers_and_jac(model, q)

            def centers_of(dz):
                return sphere_centers_world(model, space.retract(q, dz))

            J_ad = jax.jacfwd(centers_of)(jnp.zeros(space.dim, jnp.float64))
            np.testing.assert_allclose(
                np.asarray(c), np.asarray(sphere_centers_world(model, q)),
                atol=1e-12,
            )
            np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), atol=1e-9)

    def test_mobile_base(self):
        from gpmp2_jax.robots import generate_mobile_base

        self._check(generate_mobile_base(dtype=jnp.float64))

    def test_mobile_arm(self):
        from gpmp2_jax.robots import generate_mobile_arm

        self._check(generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64))

    def test_mobile_two_arms(self):
        from gpmp2_jax.robots import generate_mobile_arm

        self._check(generate_mobile_arm("SimpleTwoArms", dtype=jnp.float64))

    def test_vector_jaco(self):
        from gpmp2_jax.robots import generate_mobile_arm

        self._check(generate_mobile_arm("Vector", dtype=jnp.float64))

    def test_pr2_vetlin2arms(self):
        from gpmp2_jax.robots import generate_mobile_arm

        self._check(generate_mobile_arm("PR2", dtype=jnp.float64))

    def test_vetlin_reverse(self):
        from gpmp2_jax.geometry.se3 import Pose3
        from gpmp2_jax.kinematics.fk import ArmFK, Pose2MobileVetLinArmFK
        from gpmp2_jax.kinematics.robot import make_robot_model

        eye = jnp.eye(3, dtype=jnp.float64)
        arm = ArmFK.create([0.4, 0.3], [0.1, -0.2], [0.0, 0.1], dtype=jnp.float64)
        fk = Pose2MobileVetLinArmFK.create(
            arm, Pose3(eye, jnp.asarray([0.1, 0.0, 0.2])),
            Pose3(eye, jnp.asarray([0.0, 0.1, 0.0])), reverse_linact=True,
        )
        model = make_robot_model(
            fk,
            [(0, 0.1, (0.1, 0.0, 0.0)), (1, 0.1, (0.0, 0.1, 0.0)),
             (2, 0.05, (-0.2, 0.0, 0.0)), (3, 0.05, (0.0, 0.0, 0.1))],
            dtype=jnp.float64,
        )
        self._check(model)


class TestLimitLinearization:
    """Analytic -1/0/+1 hinge Jacobians (traj_linearize) must reproduce the
    AD gradient of traj_error: b == -grad_tangent(error)."""

    def test_limits_b_matches_ad_gradient(self):
        import dataclasses
        import jax
        from gpmp2_jax.planner import Trajectory, make_problem, traj_error
        from gpmp2_jax.planner.problem import traj_linearize
        from gpmp2_jax.obstacle.sdf import PlanarSDF

        from gpmp2_jax.robots import generate_arm
        robot = generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
        sdf = PlanarSDF(origin=jnp.asarray([-50.0, -50.0], jnp.float64),
                        cell_size=jnp.asarray(1.0, jnp.float64),
                        data=jnp.full((101, 101), 1000.0, jnp.float64))
        setting = TrajOptimizerSetting(
            dof=3, total_step=5, total_time=2.5, obs_check_inter=0,
            flag_pos_limit=True, flag_vel_limit=True,
            joint_pos_limits_down=np.full(3, -1.0),
            joint_pos_limits_up=np.full(3, 1.0),
            vel_limits=np.full(3, 0.8),
            pos_limit_thresh=np.full(3, 0.1),
            vel_limit_thresh=np.full(3, 0.1),
            Qc=np.eye(3),
        )
        start = jnp.asarray([-1.2, 0.0, 1.3], jnp.float64)  # outside limits
        goal = jnp.asarray([1.2, 0.5, -1.4], jnp.float64)
        zero = jnp.zeros(3, jnp.float64)
        prob = make_problem(robot, sdf, start, zero, goal, zero, setting,
                            dtype=jnp.float64)
        # a trajectory violating both position and velocity limits
        rng = np.random.default_rng(3)
        pose = jnp.asarray(np.linspace(start, goal, 6)
                           + 0.3 * rng.normal(size=(6, 3)), jnp.float64)
        vel = jnp.asarray(rng.normal(size=(6, 3)), jnp.float64)
        traj = Trajectory(pose, vel)

        H_diag, H_off, b, err = traj_linearize(prob, traj)

        space = robot.space

        def err_of_tangent(dz):
            p = jax.vmap(space.retract)(pose, dz[:, :3])
            v = vel + dz[:, 3:]
            return traj_error(prob, Trajectory(p, v))

        g = jax.grad(err_of_tangent)(jnp.zeros((6, 6), jnp.float64))
        np.testing.assert_allclose(np.asarray(b), -np.asarray(g),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(err), float(traj_error(prob, traj)),
                                   rtol=1e-12)


class TestGradientConsistency:
    """Global invariant: traj_linearize's b must equal -grad(traj_error)
    wrt the state tangent on a FULLY-featured problem (obstacle + GP-interp
    + limits + dynamics-off + self-collision + workspace + replan slots all
    active at once). This pins the whole assembly — slice adds, one-hot
    slot routing, widened Gram blocks — against AD of the scalar error,
    independently of the FactorGraph parity check. (Hinge kinks: the state
    is nudged so no residual sits exactly on a boundary.)"""

    def test_b_equals_minus_grad(self):
        import dataclasses as dc

        from gpmp2_jax.planner import Trajectory
        from gpmp2_jax.planner.batch import set_workspace_prior
        from gpmp2_jax.planner.problem import traj_error, traj_linearize
        from gpmp2_jax.planner.traj_utils import init_traj_straight_line

        F64 = jnp.float64
        robot = generate_arm("WAMArm", dtype=F64)
        n = 24
        cell = 3.0 / (n - 1)
        g = -1.5 + cell * np.arange(n)
        Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
        dist = np.sqrt(X**2 + Y**2 + (Z - 0.4) ** 2) - 0.35
        sdf = SignedDistanceField(
            origin=jnp.asarray([-1.5, -1.5, -1.5], F64),
            cell_size=jnp.asarray(cell, F64), data=jnp.asarray(dist, F64),
        )
        setting = TrajOptimizerSetting(
            dof=7, total_step=5, total_time=2.0, epsilon=0.25,
            cost_sigma=0.05, obs_check_inter=3, Qc=np.eye(7),
            flag_pos_limit=True,
            joint_pos_limits_down=-1.1 * np.ones(7),
            joint_pos_limits_up=1.1 * np.ones(7),
            flag_vel_limit=True, vel_limits=0.9 * np.ones(7),
        )
        start = jnp.asarray([-0.8, -1.0, 1.2, 1.29, 1.1, -0.106, 1.4], F64)
        goal = jnp.asarray([-0.0, 0.94, 0.0, 1.3, 0.0, -0.919, 1.2], F64)
        z = jnp.zeros(7, F64)
        prob = make_problem(
            robot, sdf, start, z, goal, z, setting, dtype=F64,
            sdf_pack=False, num_extra=2, num_ws=1,
            self_collision_pairs=[(0, 10, 0.3, 0.5), (1, 15, 0.25, 0.5)],
        )
        prob = set_workspace_prior(prob, 0, 2, 5, point=[0.2, 0.1, 0.7],
                                   pos_sigma=0.05)
        prob = dc.replace(
            prob,
            extra_idx=prob.extra_idx.at[0].set(1).at[1].set(3),
            extra_pose=prob.extra_pose.at[0].set(start).at[1].set(goal),
            extra_pose_w=prob.extra_pose_w + 25.0,
            extra_vel_w=prob.extra_vel_w + 9.0,
        )
        rng = np.random.default_rng(0)
        traj = init_traj_straight_line(robot.space, start, goal, 5, 2.0)
        traj = Trajectory(
            traj.pose + 0.0137 * jnp.asarray(rng.normal(size=traj.pose.shape)),
            traj.vel + 0.0091 * jnp.asarray(rng.normal(size=traj.vel.shape)),
        )

        H_diag, H_off, b, err = traj_linearize(prob, traj)

        def err_of(flat):
            dp = flat.reshape(6, 14)
            return traj_error(
                prob,
                Trajectory(traj.pose + dp[:, :7], traj.vel + dp[:, 7:]),
            )

        # error value agrees between the two paths
        np.testing.assert_allclose(
            float(err), float(err_of(jnp.zeros(84, F64))), rtol=1e-12
        )
        grad = jax.grad(err_of)(jnp.zeros(84, F64)).reshape(6, 14)
        np.testing.assert_allclose(np.asarray(b), -np.asarray(grad),
                                   rtol=1e-7, atol=1e-8)
