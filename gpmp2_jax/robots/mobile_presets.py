"""Mobile-manipulator model presets.

Port of matlab/+gpmp2/generateMobileArm.m:20-244 /
gpmp2_python/robots/generateMobileArm.py: SimpleTwoLinksArm (mobile),
SimpleTwoArms, 2DMobileArm2, Vector (omni base + JACO2), PR2 (base + torso
lift + two 7-DOF arms). Sphere tables are robot geometry data.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..geometry import se3, so3
from ..geometry.se3 import Pose3
from ..kinematics.fk import (
    ArmFK,
    Pose2Mobile2ArmsFK,
    Pose2MobileArmFK,
    Pose2MobileBaseFK,
    Pose2MobileVetLin2ArmsFK,
)
from ..kinematics.robot import RobotModel, make_robot_model
from .presets import _JACO2_SPHERES  # same arm sphere layout, link ids shift

__all__ = ["generate_mobile_arm", "generate_mobile_base", "MOBILE_PRESETS"]

_PI = np.pi

_SIMPLE_MOBILE_SPHERES = [
    [0, -0.1, 0.0, 0.0, 0.12], [0, 0.0, 0.0, 0.0, 0.12],
    [0, 0.1, 0.0, 0.0, 0.12],
    [1, -0.3, 0.0, 0.0, 0.05], [1, -0.2, 0.0, 0.0, 0.05],
    [1, -0.1, 0.0, 0.0, 0.05],
    [2, -0.3, 0.0, 0.0, 0.05], [2, -0.2, 0.0, 0.0, 0.05],
    [2, -0.1, 0.0, 0.0, 0.05], [2, 0.0, 0.0, 0.0, 0.05],
]

_TWO_ARMS_SPHERES = [
    [0, -0.2, 0.0, 0.0, 0.24], [0, 0.0, 0.0, 0.0, 0.24],
    [0, 0.2, 0.0, 0.0, 0.24],
    [1, -0.6, 0.0, 0.0, 0.1], [1, -0.4, 0.0, 0.0, 0.1],
    [1, -0.2, 0.0, 0.0, 0.1],
    [2, -0.6, 0.0, 0.0, 0.1], [2, -0.4, 0.0, 0.0, 0.1],
    [2, -0.2, 0.0, 0.0, 0.1], [2, 0.0, 0.0, 0.0, 0.1],
    [3, -0.6, 0.0, 0.0, 0.1], [3, -0.4, 0.0, 0.0, 0.1],
    [3, -0.2, 0.0, 0.0, 0.1],
    [4, -0.6, 0.0, 0.0, 0.1], [4, -0.4, 0.0, 0.0, 0.1],
    [4, -0.2, 0.0, 0.0, 0.1], [4, 0.0, 0.0, 0.0, 0.1],
]

_MOBILE_ARM2_SPHERES = [
    [0, 0.2, 0.0, 0.0, 0.35], [0, -0.2, 0.0, 0.0, 0.35],
    [1, -0.05, 0.0, 0.0, 0.1], [1, -0.25, 0.0, 0.0, 0.1],
    [1, -0.45, 0.0, 0.0, 0.1],
    [2, -0.05, 0.0, 0.0, 0.1], [2, -0.25, 0.0, 0.0, 0.1],
    [2, -0.45, 0.0, 0.0, 0.1], [2, -0.65, 0.0, 0.0, 0.1],
    [2, -0.85, 0.0, 0.0, 0.1],
]

_VECTOR_BASE_SPHERES = [
    [0, -0.01, 0, 0, 0.005],
    [0, -0.26, -0.01, 0.08, 0.08], [0, -0.26, 0.15, 0.08, 0.08],
    [0, -0.26, -0.17, 0.08, 0.08], [0, 0.24, -0.01, 0.08, 0.08],
    [0, 0.24, 0.15, 0.08, 0.08], [0, 0.24, -0.17, 0.08, 0.08],
    [0, 0.04, -0.01, 0.6, 0.18],
    [0, -0.2, -0.06, 0.45, 0.1], [0, -0.2, 0.04, 0.45, 0.1],
    [0, 0.16, -0.07, 0.41, 0.06], [0, 0.16, 0.05, 0.41, 0.06],
    [0, 0.16, -0.18, 0.41, 0.06], [0, 0.16, 0.16, 0.41, 0.06],
    [0, 0.33, -0.01, 0.29, 0.05],
    [0, -0.01, -0.24, 0.31, 0.05], [0, -0.12, -0.24, 0.31, 0.05],
    [0, -0.22, -0.24, 0.31, 0.05], [0, -0.32, -0.24, 0.31, 0.05],
    [0, 0.1, -0.24, 0.31, 0.05], [0, 0.2, -0.24, 0.31, 0.05],
    [0, 0.3, -0.24, 0.31, 0.05],
    [0, -0.01, 0.22, 0.31, 0.05], [0, -0.12, 0.22, 0.31, 0.05],
    [0, -0.22, 0.22, 0.31, 0.05], [0, -0.32, 0.22, 0.31, 0.05],
    [0, 0.1, 0.22, 0.31, 0.05], [0, 0.2, 0.22, 0.31, 0.05],
    [0, 0.3, 0.22, 0.31, 0.05],
    [0, -0.32, -0.01, 0.31, 0.05], [0, -0.32, 0.10, 0.31, 0.05],
    [0, -0.32, -0.13, 0.31, 0.05], [0, 0.32, -0.01, 0.31, 0.05],
    [0, 0.32, 0.10, 0.31, 0.05], [0, 0.32, -0.13, 0.31, 0.05],
    [0, 0.12, -0.01, 0.87, 0.1], [0, 0.14, -0.11, 0.78, 0.08],
    [0, 0.14, 0.09, 0.78, 0.08], [0, 0.19, -0.01, 1.07, 0.08],
    [0, 0.14, -0.11, 0.97, 0.08], [0, 0.14, 0.09, 0.97, 0.08],
    [0, 0.175, -0.01, 1.2, 0.05], [0, 0.175, -0.01, 1.3, 0.05],
    [0, 0.175, -0.01, 1.4, 0.05], [0, 0.175, -0.01, 1.5, 0.05],
    [0, 0.175, -0.01, 1.62, 0.07], [0, 0.27, -0.01, 1.5, 0.05],
    [0, 0.37, -0.01, 1.5, 0.05], [0, 0.37, -0.01, 1.6, 0.05],
    [0, 0.37, -0.01, 1.66, 0.045], [0, 0.37, -0.1, 1.66, 0.045],
    [0, 0.37, 0.08, 1.66, 0.045],
]

_PR2_BASE_SPHERES = [
    [0, 0.0, 0.0, 0.13, 0.17], [0, 0.23, 0.0, 0.13, 0.17],
    [0, -0.23, 0.0, 0.13, 0.17], [0, 0.23, 0.23, 0.13, 0.17],
    [0, 0.0, 0.23, 0.13, 0.17], [0, 0.0, -0.23, 0.13, 0.17],
    [0, 0.23, -0.23, 0.13, 0.17], [0, -0.23, -0.23, 0.13, 0.17],
    [0, -0.23, 0.23, 0.13, 0.17],
    [0, -0.27, 0.0, 0.38, 0.08], [0, -0.27, 0.16, 0.38, 0.08],
    [0, -0.27, -0.16, 0.38, 0.08], [0, -0.27, 0.0, 0.54, 0.08],
    [0, -0.27, 0.14, 0.54, 0.08], [0, -0.27, -0.14, 0.54, 0.08],
    [1, -0.11, 0.0, 0.1, 0.25], [1, -0.09, -0.12, -0.34, 0.2],
    [1, -0.09, 0.12, -0.34, 0.2], [1, -0.02, 0.0, 0.37, 0.17],
]

_PR2_ARM_SPHERES_REL = [  # link ids relative to the arm's first link
    [0, -0.010, 0.0, 0.0, 0.18],
    [2, 0.015, 0.22, 0.0, 0.11], [2, 0.035, 0.14, 0.0, 0.08],
    [2, 0.035, 0.0725, 0.0, 0.08], [2, 0.0, 0.0, 0.0, 0.105],
    [4, -0.005, 0.321 - 0.13, 0.0, 0.075],
    [4, 0.01, 0.321 - 0.2, -0.025, 0.055], [4, 0.01, 0.321 - 0.2, 0.025, 0.055],
    [4, 0.015, 0.321 - 0.265, -0.0275, 0.05],
    [4, 0.015, 0.321 - 0.265, 0.0275, 0.05],
    [4, 0.005, 0.321 - 0.32, -0.0225, 0.05],
    [4, 0.005, 0.321 - 0.32, 0.0225, 0.05],
    [6, 0, -0.0175, 0.0725, 0.04], [6, 0, 0.0175, 0.0725, 0.04],
    [6, 0, 0, 0.0925, 0.04], [6, 0, 0.036, 0.11, 0.04],
    [6, 0, 0.027, 0.155, 0.035], [6, 0, 0.009, 0.18, 0.03],
    [6, 0, 0.0095, 0.205, 0.02], [6, 0, -0.036, 0.11, 0.04],
    [6, 0, -0.027, 0.155, 0.035], [6, 0, -0.009, 0.18, 0.03],
    [6, 0, -0.0095, 0.205, 0.02],
]


def _spheres(rows):
    return [(int(r[0]), float(r[4]), (float(r[1]), float(r[2]), float(r[3])))
            for r in rows]


def _shift(rows, offset):
    return [[r[0] + offset] + list(r[1:]) for r in rows]


MOBILE_PRESETS = ("SimpleTwoLinksArm", "SimpleTwoArms", "2DMobileArm2",
                  "Vector", "PR2")


def generate_mobile_base(dtype=jnp.float32) -> RobotModel:
    """Plain SE(2) base with a single body sphere (for
    MobileBaseFactorGraphExample-style problems)."""
    return make_robot_model(
        Pose2MobileBaseFK(), [(0, 0.35, (0.0, 0.0, 0.0))], dtype=dtype
    )


def generate_mobile_arm(name: str, base_T_arm: Pose3 = None,
                        dtype=jnp.float32) -> RobotModel:
    """Build a mobile-manipulator RobotModel by preset name
    (generateMobileArm.m:20-244)."""
    eye = jnp.eye(3, dtype=dtype)
    zero3 = jnp.zeros(3, dtype=dtype)
    identity = Pose3(eye, zero3)

    if name == "SimpleTwoLinksArm":
        arm = ArmFK.create([0.3, 0.3], [0.0, 0.0], [0.0, 0.0], dtype=dtype)
        fk = Pose2MobileArmFK.create(arm, identity)
        return make_robot_model(fk, _spheres(_SIMPLE_MOBILE_SPHERES), dtype=dtype)

    if name == "SimpleTwoArms":
        arm = ArmFK.create([0.6, 0.6], [0.0, 0.0], [0.0, 0.0], dtype=dtype)
        left = Pose3(jnp.asarray(so3.rotz(-_PI / 3), dtype), zero3)
        right = Pose3(jnp.asarray(so3.rotz(_PI / 3), dtype), zero3)
        fk = Pose2Mobile2ArmsFK.create(arm, arm, left, right)
        return make_robot_model(fk, _spheres(_TWO_ARMS_SPHERES), dtype=dtype)

    if name == "2DMobileArm2":
        arm = ArmFK.create([1.0, 1.0], [0.0, 0.0], [0.0, 0.0], dtype=dtype)
        fk = Pose2MobileArmFK.create(arm, identity)
        return make_robot_model(fk, _spheres(_MOBILE_ARM2_SPHERES), dtype=dtype)

    if name == "Vector":
        arm = ArmFK.create(
            [0, 0.41, 0, 0, 0, 0],
            [_PI / 2, _PI, _PI / 2, 1.0472, 1.0472, _PI],
            [0.2755, 0, -0.0098, -0.2501, -0.0856, -0.2228],
            dtype=dtype,
        )
        if base_T_arm is None:
            base_T_arm = identity
        fk = Pose2MobileArmFK.create(arm, base_T_arm)
        spheres = _spheres(_VECTOR_BASE_SPHERES) + _spheres(
            _shift(_JACO2_SPHERES, 1)
        )
        return make_robot_model(fk, spheres, dtype=dtype)

    if name == "PR2":
        arm = ArmFK.create(
            [0.1, 0, 0, 0, 0, 0, 0],
            [-1.5708, 1.5708, -1.5708, 1.5708, -1.5708, 1.5708, 0],
            [0, 0, 0.4, 0, 0.321, 0, 0],
            theta_bias=[0, 1.5708, 0, 0, 0, 0, 0],
            dtype=dtype,
        )
        base_T_torso = Pose3(eye, jnp.asarray([-0.05, 0.0, 0.790675], dtype))
        torso_T_arm_l = Pose3(eye, jnp.asarray([0.0, 0.188, 0.0], dtype))
        torso_T_arm_r = Pose3(eye, jnp.asarray([0.0, -0.188, 0.0], dtype))
        fk = Pose2MobileVetLin2ArmsFK.create(
            arm, arm, base_T_torso, torso_T_arm_l, torso_T_arm_r,
            reverse_linact=False,
        )
        # link layout: 0 base, 1 torso, 2-8 left arm, 9-15 right arm
        spheres = (
            _spheres(_PR2_BASE_SPHERES)
            + _spheres(_shift(_PR2_ARM_SPHERES_REL, 2))
            + _spheres(_shift(_PR2_ARM_SPHERES_REL, 9))
        )
        return make_robot_model(fk, spheres, dtype=dtype)

    raise NameError(f"No such mobile arm '{name}'; available: {MOBILE_PRESETS}")
