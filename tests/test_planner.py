"""End-to-end planner tests: the PointRobot2D slice (reference
PointRobot2DFactorGraphExample semantics), GP-only exact recovery, batching,
and the WAM 3D pipeline."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmp2_jax.kinematics.fk import ArmFK, PointRobotFK
from gpmp2_jax.kinematics.robot import make_robot_model
from gpmp2_jax.obstacle.sdf import PlanarSDF, SignedDistanceField
from gpmp2_jax.planner import (
    TrajOptimizerSetting,
    Trajectory,
    batch_traj_optimize,
    collision_cost_batch,
    infer_batch_axes,
    interpolate_traj,
    make_problem,
    traj_error,
)
from gpmp2_jax.planner.batch import optimizer_params_from_setting, plan_batch
from gpmp2_jax.planner.problem import collision_cost
from gpmp2_jax.planner.traj_utils import init_traj_straight_line


def circle_sdf_2d(rows=96, cols=96, origin=(-1.5, -1.5), cell=3.0 / 95,
                  center=(0.0, 0.12), radius=0.3):
    """Analytic SDF of a disc (exact signed distance, not EDT).

    The disc sits slightly OFF the straight start->goal line: dead-center
    symmetric setups put the midpoint state exactly at the obstacle center
    where the hinge gradient vanishes (a local-minimum trap the reference
    planner shares)."""
    ys = origin[1] + cell * np.arange(rows)
    xs = origin[0] + cell * np.arange(cols)
    X, Y = np.meshgrid(xs, ys)
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2) - radius
    return PlanarSDF(
        origin=jnp.asarray(origin, jnp.float64),
        cell_size=jnp.asarray(cell, jnp.float64),
        data=jnp.asarray(dist),
    )


def point_robot_model(r=0.05):
    return make_robot_model(PointRobotFK(), [(0, r, (0.0, 0.0, 0.0))],
                            dtype=jnp.float64)


def make_setting(**kw):
    defaults = dict(
        dof=2, total_step=10, total_time=5.0, epsilon=0.2, cost_sigma=0.1,
        obs_check_inter=3, opt_type="lm", max_iter=100, rel_thresh=1e-6,
        Qc=np.eye(2),
    )
    defaults.update(kw)
    return TrajOptimizerSetting(**defaults)


class TestGPOnlyRecovery:
    def test_no_obstacle_straight_line_is_optimal(self):
        """With no obstacle in range, the optimum is the straight
        constant-velocity line (GP prior + priors only) and the error -> ~0."""
        sdf = PlanarSDF(
            origin=jnp.asarray([-1.0, -1.0]),
            cell_size=jnp.asarray(0.1),
            data=jnp.full((21, 21), 10.0),  # far from everything
        )
        robot = point_robot_model()
        setting = make_setting()
        start = jnp.asarray([-0.8, -0.8])
        goal = jnp.asarray([0.8, 0.8])
        # boundary velocities equal to the average velocity -> the constant
        # velocity straight line is an exact zero of every factor
        v_avg = (goal - start) / setting.total_time
        res = batch_traj_optimize(robot, sdf, start, v_avg, goal, v_avg, setting)
        assert bool(res.converged)
        n = setting.total_step + 1
        expect = np.linspace(np.asarray(start), np.asarray(goal), n)
        np.testing.assert_allclose(np.asarray(res.traj.pose), expect, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(res.traj.vel), np.tile(np.asarray(v_avg), (n, 1)), atol=1e-5
        )
        assert float(res.error) < 1e-10


class TestPointRobot2D:
    def test_plans_around_obstacle(self):
        sdf = circle_sdf_2d()
        robot = point_robot_model()
        setting = make_setting()
        start = jnp.asarray([-0.8, 0.0])
        goal = jnp.asarray([0.8, 0.0])
        zero = jnp.zeros(2)
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)

        # start/goal pinned
        np.testing.assert_allclose(np.asarray(res.traj.pose[0]), np.asarray(start), atol=1e-3)
        np.testing.assert_allclose(np.asarray(res.traj.pose[-1]), np.asarray(goal), atol=1e-3)

        # trajectory clears the obstacle: all states at least radius+margin out
        d = np.sqrt(((np.asarray(res.traj.pose) - np.array([0.0, 0.12])) ** 2).sum(-1))
        assert d.min() > 0.3 + 0.05 - 1e-3, f"min clearance {d.min()}"

        # collision cost (eps=0 metric) is zero
        prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
        cc = collision_cost(prob, res.traj.pose)
        assert float(cc) == 0.0

        # the initial straight line DOES collide (so the planner did work)
        t0 = init_traj_straight_line(robot.space, start, goal, 10, 5.0)
        cc0 = collision_cost(prob, t0.pose)
        assert float(cc0) > 0.0

    def test_dogleg_and_gn_also_solve(self):
        sdf = circle_sdf_2d()
        robot = point_robot_model()
        start = jnp.asarray([-0.8, 0.0])
        goal = jnp.asarray([0.8, 0.0])
        zero = jnp.zeros(2)
        for opt in ("dogleg", "gaussnewton"):
            setting = make_setting(opt_type=opt)
            res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
            prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
            cc = collision_cost(prob, res.traj.pose)
            assert float(cc) < 1e-4, f"{opt}: collision cost {float(cc)}"

    def test_batched_matches_single(self):
        sdf = circle_sdf_2d()
        robot = point_robot_model()
        setting = make_setting()
        zero = jnp.zeros(2)
        starts = jnp.asarray([[-0.8, 0.0], [-0.8, 0.45], [-0.7, -0.4]])
        goals = jnp.asarray([[0.8, 0.0], [0.8, -0.2], [0.75, 0.5]])
        zeros = jnp.zeros_like(starts)
        res_b = batch_traj_optimize(robot, sdf, starts, zeros, goals, zeros, setting)
        assert res_b.traj.pose.shape == (3, 11, 2)
        for i in range(3):
            res_1 = batch_traj_optimize(
                robot, sdf, starts[i], zero, goals[i], zero, setting
            )
            np.testing.assert_allclose(
                np.asarray(res_b.traj.pose[i]), np.asarray(res_1.traj.pose),
                atol=1e-8,
            )
            np.testing.assert_allclose(
                float(res_b.error[i]), float(res_1.error), rtol=1e-10
            )

    def test_error_decreases_from_init(self):
        sdf = circle_sdf_2d()
        robot = point_robot_model()
        setting = make_setting()
        start = jnp.asarray([-0.8, 0.0])
        goal = jnp.asarray([0.8, 0.0])
        zero = jnp.zeros(2)
        prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
        t0 = init_traj_straight_line(robot.space, start, goal, 10, 5.0)
        e0 = float(traj_error(prob, t0))
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
        assert float(res.error) < e0

    def test_densification(self):
        sdf = circle_sdf_2d()
        robot = point_robot_model()
        setting = make_setting()
        zero = jnp.zeros(2)
        start, goal = jnp.asarray([-0.8, 0.0]), jnp.asarray([0.8, 0.0])
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
        dense = interpolate_traj(
            robot.space, res.traj, jnp.eye(2, dtype=jnp.float64),
            setting.total_time / setting.total_step, 4,
        )
        assert dense.pose.shape == (10 * 5 + 1, 2)
        # support states preserved at stride 5
        np.testing.assert_allclose(
            np.asarray(dense.pose[::5]), np.asarray(res.traj.pose), atol=1e-12
        )
        # densified trajectory is still collision-free
        prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
        assert float(collision_cost(prob, dense.pose)) < 1e-6


class TestWAM3D:
    """WAM 7-DOF in a 3D SDF: the full headline pipeline (WAMPlannerExample)."""

    def _wam(self):
        arm = ArmFK.create(
            a=[0.0, 0.0, 0.045, -0.045, 0.0, 0.0, 0.0],
            alpha=[-np.pi / 2, np.pi / 2, -np.pi / 2, np.pi / 2, -np.pi / 2,
                   np.pi / 2, 0.0],
            d=[0.0, 0.0, 0.55, 0.0, 0.3, 0.0, 0.06],
            dtype=jnp.float64,
        )
        spheres = [
            (0, 0.15, (0.0, 0.0, 0.0)),
            (1, 0.06, (0.0, 0.0, 0.2)), (1, 0.06, (0.0, 0.0, 0.3)),
            (1, 0.06, (0.0, 0.0, 0.4)), (1, 0.06, (0.0, 0.0, 0.5)),
            (2, 0.06, (0.0, 0.0, 0.0)),
            (3, 0.06, (0.0, 0.0, 0.1)), (3, 0.06, (0.0, 0.0, 0.2)),
            (3, 0.06, (0.0, 0.0, 0.3)),
            (5, 0.06, (0.0, 0.0, 0.1)),
            (6, 0.04, (0.1, -0.025, 0.08)), (6, 0.04, (0.1, 0.025, 0.08)),
            (6, 0.04, (-0.1, 0.0, 0.08)), (6, 0.04, (0.15, -0.025, 0.13)),
            (6, 0.04, (0.15, 0.025, 0.13)), (6, 0.04, (-0.15, 0.0, 0.13)),
        ]
        return make_robot_model(arm, spheres, dtype=jnp.float64)

    def _sphere_world(self):
        """Analytic 3D SDF: ball obstacle at (0.45, 0.0, 0.6), r=0.2."""
        n = 32
        cell = 2.0 / (n - 1)
        origin = np.array([-1.0, -1.0, -0.2])
        zs = origin[2] + cell * np.arange(n)
        ys = origin[1] + cell * np.arange(n)
        xs = origin[0] + cell * np.arange(n)
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        c = np.array([0.45, 0.0, 0.6])
        dist = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) - 0.2
        return SignedDistanceField(
            origin=jnp.asarray(origin), cell_size=jnp.asarray(cell),
            data=jnp.asarray(dist),
        )

    def test_wam_plan(self):
        robot = self._wam()
        sdf = self._sphere_world()
        setting = TrajOptimizerSetting(
            dof=7, total_step=10, total_time=2.0, epsilon=0.2,
            cost_sigma=0.02, obs_check_inter=5, opt_type="lm",
            max_iter=100, rel_thresh=1e-5, Qc=np.eye(7),
        )
        start = jnp.asarray([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2],
                            dtype=jnp.float64)
        goal = jnp.asarray([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55],
                           dtype=jnp.float64)
        zero = jnp.zeros(7, dtype=jnp.float64)
        res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
        prob = make_problem(robot, sdf, start, zero, goal, zero, setting)
        t0 = init_traj_straight_line(robot.space, start, goal, 10, 2.0)
        e0 = float(traj_error(prob, t0))
        assert float(res.error) < e0
        np.testing.assert_allclose(np.asarray(res.traj.pose[0]), np.asarray(start), atol=1e-3)
        np.testing.assert_allclose(np.asarray(res.traj.pose[-1]), np.asarray(goal), atol=1e-3)
        # dense-check final trajectory clearance via collision cost
        dense = interpolate_traj(robot.space, res.traj, jnp.eye(7, dtype=jnp.float64),
                                 0.2, 9)
        cc = collision_cost(prob, dense.pose)
        assert float(cc) < 1e-3, f"collision cost {float(cc)}"


class TestPlannerCompaction:
    """End-to-end straggler compaction through plan_batch: results must be
    identical to the uncompacted chunked solve (compaction only regroups
    lanes between chunks)."""

    def test_compacted_plan_batch_matches(self):
        import dataclasses

        from gpmp2_jax.planner.batch import (
            infer_batch_axes, optimizer_params_from_setting, plan_batch,
        )

        sdf = circle_sdf_2d()
        robot = point_robot_model()
        setting = make_setting()
        rng = np.random.default_rng(11)
        B = 12
        starts = jnp.asarray(
            np.array([-0.8, 0.0]) + 0.1 * rng.normal(size=(B, 2))
        )
        goals = jnp.asarray(
            np.array([0.8, 0.0]) + 0.1 * rng.normal(size=(B, 2))
        )
        zeros = jnp.zeros_like(starts)
        probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
        template = make_problem(
            robot, probs.sdf, starts[0], zeros[0], goals[0], zeros[0], setting
        )
        axes = infer_batch_axes(probs, template)
        init = jax.vmap(
            lambda s, g: init_traj_straight_line(robot.space, s, g, 10, 5.0)
        )(starts, goals)
        base = optimizer_params_from_setting(setting)

        res_off = plan_batch(
            probs, init,
            dataclasses.replace(base, chunk_size=2, compact=False), axes,
        )
        res_on = plan_batch(
            probs, init,
            dataclasses.replace(
                base, chunk_size=2, compact=True, compact_floor=2
            ),
            axes,
        )
        np.testing.assert_array_equal(
            np.asarray(res_on.converged), np.asarray(res_off.converged)
        )
        np.testing.assert_allclose(
            np.asarray(res_on.traj.pose), np.asarray(res_off.traj.pose),
            rtol=0, atol=0,
        )
        np.testing.assert_allclose(
            np.asarray(res_on.error), np.asarray(res_off.error),
            rtol=0, atol=0,
        )


class TestInterpolateTrajLie:
    """SE(2) / SE(2)xR^n trajectory densification (interpolatePose2Traj /
    interpolatePose2MobileArmTraj, TrajUtils.cpp:200-275; reference test
    testTrajUtils.cpp:26-55)."""

    def test_se2_constant_twist_exact(self):
        """A constant-body-twist trajectory is in the GP mean's null space:
        densified states must lie exactly on the geodesic
        p(t) = p0 * Exp(t w), v(t) = w."""
        from gpmp2_jax.geometry.statespace import SE2Space

        space = SE2Space()
        dt = 0.5
        n_steps = 4
        w = jnp.asarray([0.4, -0.2, 0.7], jnp.float64)  # (vx, vy, omega)
        p0 = jnp.asarray([0.3, -0.1, 0.25], jnp.float64)
        poses = jnp.stack(
            [space.retract(p0, (i * dt) * w) for i in range(n_steps + 1)])
        vels = jnp.tile(w, (n_steps + 1, 1))
        traj = Trajectory(poses, vels)

        inter = 3
        dense = interpolate_traj(space, traj, jnp.eye(3, dtype=jnp.float64),
                                 dt, inter)
        num_int = inter + 1
        assert dense.pose.shape == (n_steps * num_int + 1, 3)

        tau_step = dt / num_int
        expect = jnp.stack([
            space.retract(p0, (k * tau_step) * w)
            for k in range(n_steps * num_int + 1)
        ])
        np.testing.assert_allclose(np.asarray(dense.pose),
                                   np.asarray(expect), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(dense.vel), np.tile(np.asarray(w),
                                           (n_steps * num_int + 1, 1)),
            atol=1e-12)

    def test_se2_support_states_preserved(self):
        """Non-trivial (non-geodesic) SE(2) trajectory: densification keeps
        every original support state bit-exactly at stride (inter+1) and
        matches the GP interpolator state-by-state."""
        from gpmp2_jax.geometry.statespace import SE2Space
        from gpmp2_jax.gp.interpolator import (interp_coeffs,
                                               interpolate_state)

        space = SE2Space()
        rng = np.random.default_rng(2)
        n = 5
        dt = 0.8
        Qc = jnp.asarray(np.diag([1.0, 2.0, 0.5]), jnp.float64)
        poses = jnp.asarray(rng.normal(size=(n, 3)), jnp.float64)
        vels = jnp.asarray(rng.normal(size=(n, 3)), jnp.float64)
        traj = Trajectory(poses, vels)
        inter = 2
        dense = interpolate_traj(space, traj, Qc, dt, inter)
        num_int = inter + 1
        np.testing.assert_allclose(
            np.asarray(dense.pose[::num_int]), np.asarray(poses), atol=0)
        np.testing.assert_allclose(
            np.asarray(dense.vel[::num_int]), np.asarray(vels), atol=0)
        # every interpolated state == the Lie GP interpolator's output
        for i in range(n - 1):
            for j in range(1, num_int):
                tau = j * dt / num_int
                ip, iv = interpolate_state(
                    space, interp_coeffs(Qc, dt, tau),
                    poses[i], vels[i], poses[i + 1], vels[i + 1])
                np.testing.assert_allclose(
                    np.asarray(dense.pose[i * num_int + j]),
                    np.asarray(ip), atol=1e-12)
                np.testing.assert_allclose(
                    np.asarray(dense.vel[i * num_int + j]),
                    np.asarray(iv), atol=1e-12)

    def test_se2_vector_blockwise(self):
        """SE(2) x R^2 densification decomposes: with block-diagonal Qc the
        base block matches pure-SE(2) densification and the arm block
        matches pure-vector densification (interpolatePose2MobileArmTraj
        semantics, TrajUtils.cpp:236-275)."""
        from gpmp2_jax.geometry.statespace import (SE2Space, SE2VectorSpace,
                                                   VectorSpace)

        rng = np.random.default_rng(5)
        n = 4
        dt = 0.6
        space = SE2VectorSpace(2)
        poses = jnp.asarray(rng.normal(size=(n, 5)), jnp.float64)
        vels = jnp.asarray(rng.normal(size=(n, 5)), jnp.float64)
        inter = 3
        dense = interpolate_traj(space, Trajectory(poses, vels),
                                 jnp.eye(5, dtype=jnp.float64), dt, inter)

        dense_se2 = interpolate_traj(
            SE2Space(), Trajectory(poses[:, :3], vels[:, :3]),
            jnp.eye(3, dtype=jnp.float64), dt, inter)
        dense_vec = interpolate_traj(
            VectorSpace(2), Trajectory(poses[:, 3:], vels[:, 3:]),
            jnp.eye(2, dtype=jnp.float64), dt, inter)
        np.testing.assert_allclose(np.asarray(dense.pose[:, :3]),
                                   np.asarray(dense_se2.pose), atol=1e-12)
        np.testing.assert_allclose(np.asarray(dense.pose[:, 3:]),
                                   np.asarray(dense_vec.pose), atol=1e-12)
        np.testing.assert_allclose(np.asarray(dense.vel[:, :3]),
                                   np.asarray(dense_se2.vel), atol=1e-12)
        np.testing.assert_allclose(np.asarray(dense.vel[:, 3:]),
                                   np.asarray(dense_vec.vel), atol=1e-12)
