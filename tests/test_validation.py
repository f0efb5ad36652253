"""Constructor-time input validation (VERDICT r2 item 9).

The reference throws from factor constructors on dimension mismatches
(/root/reference/gpmp2/kinematics/JointLimitFactorVector.h:52-56,
VelocityLimitFactorVector.h:49-55). Here the checks live at the data entry
points — make_robot_model and make_problem — so bad inputs raise
ValueError with shapes in the message instead of surfacing as XLA trace
errors mid-solve.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpmp2_jax.kinematics.fk import ArmFK
from gpmp2_jax.kinematics.robot import make_robot_model
from gpmp2_jax.obstacle.sdf import SignedDistanceField
from gpmp2_jax.planner import TrajOptimizerSetting, make_problem
from gpmp2_jax.robots import generate_arm


def small_sdf_3d(n=8):
    cell = 2.0 / (n - 1)
    origin = np.array([-1.0, -1.0, -1.0])
    g = origin[0] + cell * np.arange(n)
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    dist = np.sqrt(X**2 + Y**2 + Z**2) - 0.3
    return SignedDistanceField(
        origin=jnp.asarray(origin), cell_size=jnp.asarray(cell),
        data=jnp.asarray(dist),
    )


def _two_link_fk():
    return ArmFK.create(a=[0.5, 0.5], alpha=[0.0, 0.0], d=[0.0, 0.0])


class TestRobotModelValidation:
    def test_empty_sphere_table(self):
        with pytest.raises(ValueError, match="empty"):
            make_robot_model(_two_link_fk(), [])

    def test_bad_sphere_tuple(self):
        with pytest.raises(ValueError, match="sphere 0"):
            make_robot_model(_two_link_fk(), [(0, 0.1)])
        with pytest.raises(ValueError, match="x, y, z"):
            make_robot_model(_two_link_fk(), [(0, 0.1, (0.0, 0.0))])

    def test_link_id_out_of_range(self):
        with pytest.raises(ValueError, match="link ids"):
            make_robot_model(_two_link_fk(), [(5, 0.1, (0.0, 0.0, 0.0))])
        with pytest.raises(ValueError, match="link ids"):
            make_robot_model(_two_link_fk(), [(-1, 0.1, (0.0, 0.0, 0.0))])

    def test_negative_radius(self):
        with pytest.raises(ValueError, match="radii"):
            make_robot_model(_two_link_fk(), [(0, -0.1, (0.0, 0.0, 0.0))])

    def test_valid_table_passes(self):
        model = make_robot_model(
            _two_link_fk(), [(0, 0.1, (0.0, 0.0, 0.0)), (1, 0.1, (0.0, 0.0, 0.0))]
        )
        assert model.num_spheres == 2


class TestProblemValidation:
    def _setup(self, **setting_kw):
        robot = generate_arm("WAMArm")
        sdf = small_sdf_3d()
        setting = TrajOptimizerSetting(dof=setting_kw.pop("dof", 7), **setting_kw)
        return robot, sdf, setting

    def test_dof_mismatch(self):
        robot, sdf, setting = self._setup(dof=6)
        z = np.zeros(6)
        with pytest.raises(ValueError, match="setting.dof=6"):
            make_problem(robot, sdf, z, z, z, z, setting)

    def test_wrong_pose_shape(self):
        robot, sdf, setting = self._setup()
        z7, z6 = np.zeros(7), np.zeros(6)
        with pytest.raises(ValueError, match=r"start_pose.*\(7,\)"):
            make_problem(robot, sdf, z6, z7, z7, z7, setting)
        with pytest.raises(ValueError, match=r"end_vel"):
            make_problem(robot, sdf, z7, z7, z7, z6, setting)

    def test_inconsistent_batch(self):
        robot, sdf, setting = self._setup()
        with pytest.raises(ValueError, match="batch sizes"):
            make_problem(
                robot, sdf, np.zeros((4, 7)), np.zeros((4, 7)),
                np.zeros((3, 7)), np.zeros((3, 7)), setting,
            )

    def test_bad_Qc_shape(self):
        robot, sdf, setting = self._setup()
        setting.Qc = np.eye(6)
        z = np.zeros(7)
        with pytest.raises(ValueError, match=r"Qc.*\(7, 7\)"):
            make_problem(robot, sdf, z, z, z, z, setting)

    def test_nonpositive_vel_limit(self):
        robot, sdf, setting = self._setup(
            flag_vel_limit=True, vel_limits=np.zeros(7)
        )
        z = np.zeros(7)
        with pytest.raises(ValueError, match="strictly positive"):
            make_problem(robot, sdf, z, z, z, z, setting)

    def test_inverted_pos_limits(self):
        robot, sdf, setting = self._setup(
            flag_pos_limit=True,
            joint_pos_limits_down=np.ones(7),
            joint_pos_limits_up=-np.ones(7),
        )
        z = np.zeros(7)
        with pytest.raises(ValueError, match="down"):
            make_problem(robot, sdf, z, z, z, z, setting)

    def test_limit_vector_wrong_length_in_setting(self):
        with pytest.raises(AssertionError, match=r"\(7,\)"):
            TrajOptimizerSetting(dof=7, vel_limits=np.ones(6))

    def test_valid_passes(self):
        robot, sdf, setting = self._setup()
        z = np.zeros(7)
        prob = make_problem(robot, sdf, z, z, z, z, setting)
        assert prob.start_pose.shape == (7,)
