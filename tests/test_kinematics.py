"""Forward kinematics tests.

Golden values from /root/reference/gpmp2/kinematics/tests/testArm.cpp
(hand-computed 2-link planar arm with a rotated/translated base), AD
Jacobians checked against finite differences, and structural checks for
every mobile-base family (mirroring testPose2MobileArm.cpp etc.)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax.geometry import se3, so3
from gpmp2_jax.geometry.se3 import Pose3
from gpmp2_jax.kinematics.fk import (
    ArmFK,
    PointRobotFK,
    Pose2Mobile2ArmsFK,
    Pose2MobileArmFK,
    Pose2MobileBaseFK,
    Pose2MobileVetLin2ArmsFK,
    Pose2MobileVetLinArmFK,
    arm_link_velocities,
    base_pose3,
    dof_of,
    link_poses,
    num_links_of,
    state_space_of,
)
from gpmp2_jax.kinematics.robot import make_robot_model, sphere_centers_world


def fd_jacobian(f, x, eps=1e-7):
    x = np.asarray(x, dtype=np.float64)
    y0 = np.asarray(f(jnp.asarray(x)))
    J = np.zeros(y0.shape + (x.size,))
    for i in range(x.size):
        dx = np.zeros_like(x)
        dx[i] = eps
        yp = np.asarray(f(jnp.asarray(x + dx)))
        ym = np.asarray(f(jnp.asarray(x - dx)))
        J[..., i] = (yp - ym) / (2 * eps)
    return J


class TestArm2Link:
    """Golden values from testArm.cpp:37-120 (2-link planar, rotated base)."""

    def setup_method(self):
        base = Pose3(so3.ypr(np.pi / 4.0, 0.0, 0.0), jnp.asarray([2.0, 1.0, -1.0]))
        self.arm = ArmFK.create(
            a=[1.0, 1.0], alpha=[0.0, 0.0], d=[0.0, 0.0],
            base_pose=base, dtype=jnp.float64,
        )

    def test_fk_at_zero(self):
        poses = link_poses(self.arm, jnp.zeros(2, dtype=jnp.float64))
        np.testing.assert_allclose(
            np.asarray(poses.trans[0]),
            [2.707106781186548, 1.707106781186548, -1.0],
            atol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(poses.trans[1]),
            [3.414213562373095, 2.414213562373095, -1.0],
            atol=1e-9,
        )
        expect_rot = np.asarray(so3.ypr(np.pi / 4.0, 0.0, 0.0))
        np.testing.assert_allclose(np.asarray(poses.rot[0]), expect_rot, atol=1e-9)
        np.testing.assert_allclose(np.asarray(poses.rot[1]), expect_rot, atol=1e-9)

    def test_velocity_at_zero(self):
        """qdot = (1, 0) gives v = (-0.7071, 0.7071, 0) and (-1.414, 1.414, 0)
        (testArm.cpp:93-103)."""
        q = jnp.zeros(2, dtype=jnp.float64)
        qdot = jnp.asarray([1.0, 0.0])
        vel = arm_link_velocities(self.arm, q, qdot)
        np.testing.assert_allclose(
            np.asarray(vel[0]), [-0.707106781186548, 0.707106781186548, 0.0], atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(vel[1]), [-1.414213562373095, 1.414213562373095, 0.0], atol=1e-9
        )

    def test_position_jacobian_fd(self):
        r = np.random.default_rng(0)
        q = r.normal(size=2)

        def positions(qq):
            return link_poses(self.arm, qq).trans

        J_ad = np.asarray(jax.jacfwd(positions)(jnp.asarray(q)))
        J_fd = fd_jacobian(positions, q)
        np.testing.assert_allclose(J_ad, J_fd, atol=1e-6)


class TestArmWAM:
    """WAM DH parameters (generateArm.py:96-101 / testArm.cpp:283)."""

    def setup_method(self):
        self.arm = ArmFK.create(
            a=[0.0, 0.0, 0.045, -0.045, 0.0, 0.0, 0.0],
            alpha=[-np.pi / 2, np.pi / 2, -np.pi / 2, np.pi / 2, -np.pi / 2, np.pi / 2, 0.0],
            d=[0.0, 0.0, 0.55, 0.0, 0.3, 0.0, 0.06],
            dtype=jnp.float64,
        )

    def test_reach_at_zero(self):
        """At q=0 the WAM end-effector is at z = 0.55 + 0.3 + 0.06 = 0.91
        (straight-up pose), x = 0 (the 0.045/-0.045 elbow offsets cancel)."""
        poses = link_poses(self.arm, jnp.zeros(7, dtype=jnp.float64))
        np.testing.assert_allclose(np.asarray(poses.trans[6]), [0.0, 0.0, 0.91], atol=1e-12)

    def test_jacobian_fd(self):
        r = np.random.default_rng(1)
        q = r.normal(size=7)

        def ee(qq):
            return link_poses(self.arm, qq).trans[6]

        J_ad = np.asarray(jax.jacfwd(ee)(jnp.asarray(q)))
        J_fd = fd_jacobian(ee, q)
        np.testing.assert_allclose(J_ad, J_fd, atol=1e-6)

    def test_rotation_jacobian_fd(self):
        """Full pose Jacobian in the local (body) tangent, vs FD of
        se3.local — matches the reference J_jpx_jp convention (Arm.cpp:105)."""
        r = np.random.default_rng(2)
        q = jnp.asarray(r.normal(size=7))
        base_poses = link_poses(self.arm, q)
        p6 = Pose3(base_poses.rot[6], base_poses.trans[6])

        def local6(qq):
            poses = link_poses(self.arm, qq)
            return se3.local(p6, Pose3(poses.rot[6], poses.trans[6]))

        J_ad = np.asarray(jax.jacfwd(local6)(q))
        J_fd = fd_jacobian(local6, np.asarray(q))
        np.testing.assert_allclose(J_ad, J_fd, atol=1e-6)


class TestPointRobot:
    def test_fk(self):
        fk = PointRobotFK()
        poses = link_poses(fk, jnp.asarray([1.5, -2.5]))
        np.testing.assert_allclose(np.asarray(poses.trans[0]), [1.5, -2.5, 0.0])
        np.testing.assert_allclose(np.asarray(poses.rot[0]), np.eye(3))


class TestMobileBases:
    def _two_link(self):
        return ArmFK.create([1.0, 1.0], [0.0, 0.0], [0.0, 0.0], dtype=jnp.float64)

    def test_base_pose3(self):
        p = base_pose3(jnp.asarray([1.0, 2.0, np.pi / 2]))
        np.testing.assert_allclose(np.asarray(p.trans), [1.0, 2.0, 0.0], atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(p.rot), np.asarray(so3.rotz(np.pi / 2)), atol=1e-12
        )

    def test_mobile_arm_links(self):
        """Base at (1, 0, pi/2) with arm mounted at +x0.2: arm extends along
        world +y after the base rotation."""
        arm = self._two_link()
        fk = Pose2MobileArmFK.create(
            arm, Pose3(jnp.eye(3, dtype=jnp.float64), jnp.asarray([0.2, 0.0, 0.0]))
        )
        assert dof_of(fk) == 5 and num_links_of(fk) == 3
        q = jnp.asarray([1.0, 0.0, np.pi / 2, 0.0, 0.0])
        poses = link_poses(fk, q)
        np.testing.assert_allclose(np.asarray(poses.trans[0]), [1.0, 0.0, 0.0], atol=1e-12)
        # arm base at (1, 0.2, 0); links extend +1, +2 along world y
        np.testing.assert_allclose(np.asarray(poses.trans[1]), [1.0, 1.2, 0.0], atol=1e-12)
        np.testing.assert_allclose(np.asarray(poses.trans[2]), [1.0, 2.2, 0.0], atol=1e-12)

    def test_vetlin_arm_lift(self):
        arm = self._two_link()
        eye = jnp.eye(3, dtype=jnp.float64)
        zero3 = jnp.zeros(3, dtype=jnp.float64)
        fk = Pose2MobileVetLinArmFK.create(
            arm, Pose3(eye, zero3), Pose3(eye, zero3), reverse_linact=False
        )
        assert dof_of(fk) == 6 and num_links_of(fk) == 4
        # lift = 0.7 raises torso and arm links by 0.7
        q = jnp.asarray([0.0, 0.0, 0.0, 0.7, 0.0, 0.0])
        poses = link_poses(fk, q)
        np.testing.assert_allclose(np.asarray(poses.trans[0]), [0.0, 0.0, 0.0], atol=1e-12)
        np.testing.assert_allclose(np.asarray(poses.trans[1]), [0.0, 0.0, 0.7], atol=1e-12)
        np.testing.assert_allclose(np.asarray(poses.trans[2]), [1.0, 0.0, 0.7], atol=1e-12)

        fk_rev = Pose2MobileVetLinArmFK.create(
            arm, Pose3(eye, zero3), Pose3(eye, zero3), reverse_linact=True
        )
        poses = link_poses(fk_rev, q)
        np.testing.assert_allclose(np.asarray(poses.trans[1]), [0.0, 0.0, -0.7], atol=1e-12)

    @pytest.mark.parametrize("family", ["base", "arm", "2arms", "vetlin", "vetlin2"])
    def test_jacobians_fd_all_families(self, family):
        arm = self._two_link()
        eye = jnp.eye(3, dtype=jnp.float64)
        off = Pose3(eye, jnp.asarray([0.1, -0.2, 0.3]))
        fk = {
            "base": Pose2MobileBaseFK(),
            "arm": Pose2MobileArmFK.create(arm, off),
            "2arms": Pose2Mobile2ArmsFK.create(arm, arm, off, Pose3(eye, jnp.asarray([-0.1, 0.2, 0.0]))),
            "vetlin": Pose2MobileVetLinArmFK.create(arm, off, Pose3(eye, jnp.asarray([0.0, 0.0, 0.1]))),
            "vetlin2": Pose2MobileVetLin2ArmsFK.create(
                arm, arm, off, Pose3(eye, jnp.asarray([0.0, 0.1, 0.0])), Pose3(eye, jnp.asarray([0.1, 0.0, 0.0]))
            ),
        }[family]
        space = state_space_of(fk)
        r = np.random.default_rng(3)
        q0 = jnp.asarray(r.normal(size=space.storage_dim))

        def positions(delta):
            q = space.retract(q0, delta)
            return link_poses(fk, q).trans

        zeros = jnp.zeros(space.dim, dtype=jnp.float64)
        J_ad = np.asarray(jax.jacfwd(positions)(zeros))
        J_fd = fd_jacobian(positions, np.zeros(space.dim))
        np.testing.assert_allclose(J_ad, J_fd, atol=1e-6)


class TestRobotModel:
    def test_sphere_centers_2link(self):
        """Spheres along the links of the SimpleTwoLinksArm preset
        (generateArm.py:22-50): sphere at (-0.5, 0, 0) on link 0 sits at the
        arm base when q = 0."""
        arm = ArmFK.create([0.5, 0.5], [0.0, 0.0], [0.0, 0.0], dtype=jnp.float64)
        model = make_robot_model(
            arm,
            [(0, 0.01, (-0.5, 0.0, 0.0)), (0, 0.01, (0.0, 0.0, 0.0)),
             (1, 0.01, (0.0, 0.0, 0.0))],
            dtype=jnp.float64,
        )
        centers = sphere_centers_world(model, jnp.zeros(2, dtype=jnp.float64))
        np.testing.assert_allclose(np.asarray(centers[0]), [0.0, 0.0, 0.0], atol=1e-12)
        np.testing.assert_allclose(np.asarray(centers[1]), [0.5, 0.0, 0.0], atol=1e-12)
        np.testing.assert_allclose(np.asarray(centers[2]), [1.0, 0.0, 0.0], atol=1e-12)

        # rotate first joint 90deg: all spheres rotate about origin
        centers = sphere_centers_world(
            model, jnp.asarray([np.pi / 2, 0.0], dtype=jnp.float64)
        )
        np.testing.assert_allclose(np.asarray(centers[1]), [0.0, 0.5, 0.0], atol=1e-12)
        np.testing.assert_allclose(np.asarray(centers[2]), [0.0, 1.0, 0.0], atol=1e-12)

    def test_sphere_jacobian_fd(self):
        arm = ArmFK.create([0.5, 0.5], [0.0, 0.0], [0.0, 0.0], dtype=jnp.float64)
        model = make_robot_model(
            arm, [(0, 0.01, (-0.3, 0.0, 0.0)), (1, 0.01, (-0.1, 0.2, 0.0))],
            dtype=jnp.float64,
        )
        r = np.random.default_rng(4)
        q = r.normal(size=2)

        def centers(qq):
            return sphere_centers_world(model, qq)

        J_ad = np.asarray(jax.jacfwd(centers)(jnp.asarray(q)))
        J_fd = fd_jacobian(centers, q)
        np.testing.assert_allclose(J_ad, J_fd, atol=1e-6)
