"""Forward kinematics for all robot families, as pure JAX functions.

Replacement for /root/reference/gpmp2/kinematics/{Arm,PointRobot,
Pose2MobileBase,Pose2MobileArm,Pose2Mobile2Arms,Pose2MobileVetLinArm,
Pose2MobileVetLin2Arms}.{h,cpp}. Key differences from the reference:

  - FK is a pure function of (static robot description, configuration); the
    reference's `updateBasePose` const-mutation wart
    (/root/reference/gpmp2/kinematics/Arm.h:80) disappears: mobile bases
    simply pass a base pose argument.
  - Jacobians come from JAX AD (jacfwd) through these functions instead of
    the reference's hand-derived O(dof^2) dHo_dq caches (Arm.cpp:85-137);
    tests check them against finite differences and reference golden values.
  - Everything is fixed-shape: a robot family + dof compiles to one XLA
    program, vmappable over configurations and problems.

DH convention (Arm.cpp:22-27, Spong eq. 3.10):
  H_j(theta) = Rz(theta_j + bias_j) * Tz(d_j) * Tx(a_j) * Rx(alpha_j)
  link_pose[j] = base * H_0 * ... * H_j
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..geometry import se3, so3
from ..geometry.se3 import Pose3
from ..geometry.statespace import SE2Space, SE2VectorSpace, StateSpace, VectorSpace

__all__ = [
    "ArmFK",
    "PointRobotFK",
    "Pose2MobileBaseFK",
    "Pose2MobileArmFK",
    "Pose2Mobile2ArmsFK",
    "Pose2MobileVetLinArmFK",
    "Pose2MobileVetLin2ArmsFK",
    "link_poses",
    "state_space_of",
    "dof_of",
    "num_links_of",
    "base_pose3",
    "arm_link_velocities",
]


def _register(cls, data_fields, meta_fields=()):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@dataclasses.dataclass(frozen=True)
class ArmFK:
    """DH-parameter revolute manipulator (reference Arm.h:27-146)."""

    a: jnp.ndarray  # (dof,)
    alpha: jnp.ndarray  # (dof,)
    d: jnp.ndarray  # (dof,)
    theta_bias: jnp.ndarray  # (dof,)
    base_rot: jnp.ndarray  # (3, 3)
    base_trans: jnp.ndarray  # (3,)

    @staticmethod
    def create(a, alpha, d, theta_bias=None, base_pose: Optional[Pose3] = None,
               dtype=jnp.float32) -> "ArmFK":
        a = jnp.asarray(a, dtype)
        alpha = jnp.asarray(alpha, dtype)
        d = jnp.asarray(d, dtype)
        if theta_bias is None:
            theta_bias = jnp.zeros_like(a)
        else:
            theta_bias = jnp.asarray(theta_bias, dtype)
        if base_pose is None:
            base_pose = se3.identity(dtype)
        return ArmFK(a, alpha, d, theta_bias, base_pose.rot, base_pose.trans)

    @property
    def dof(self) -> int:
        return self.a.shape[-1]

    @property
    def base_pose(self) -> Pose3:
        return Pose3(self.base_rot, self.base_trans)


_register(ArmFK, ["a", "alpha", "d", "theta_bias", "base_rot", "base_trans"])


@dataclasses.dataclass(frozen=True)
class PointRobotFK:
    """Planar translating point robot (reference PointRobot.h:25-63).

    A single link whose pose is identity rotation at (x, y, 0). dof
    defaults to 2 (x, y); the reference also instantiates PointRobot(3, 1)
    (x, y, theta — FK ignores the extra dofs), e.g.
    gpmp2_python/examples/pointRobot3FactorExample_rh.py.
    """

    dof: int = 2


_register(PointRobotFK, [], ["dof"])


@dataclasses.dataclass(frozen=True)
class Pose2MobileBaseFK:
    """SE(2) base only (reference Pose2MobileBase.h). 3 dof, 1 link."""


_register(Pose2MobileBaseFK, [])


@dataclasses.dataclass(frozen=True)
class Pose2MobileArmFK:
    """SE(2) base + arm (reference Pose2MobileArm.cpp:28-108)."""

    arm: ArmFK
    base_T_arm_rot: jnp.ndarray
    base_T_arm_trans: jnp.ndarray

    @staticmethod
    def create(arm: ArmFK, base_T_arm: Optional[Pose3] = None) -> "Pose2MobileArmFK":
        if base_T_arm is None:
            base_T_arm = se3.identity(arm.a.dtype)
        return Pose2MobileArmFK(arm, base_T_arm.rot, base_T_arm.trans)

    @property
    def base_T_arm(self) -> Pose3:
        return Pose3(self.base_T_arm_rot, self.base_T_arm_trans)


_register(Pose2MobileArmFK, ["arm", "base_T_arm_rot", "base_T_arm_trans"])


@dataclasses.dataclass(frozen=True)
class Pose2Mobile2ArmsFK:
    """SE(2) base + two arms (reference Pose2Mobile2Arms.cpp)."""

    arm1: ArmFK
    arm2: ArmFK
    base_T_arm1_rot: jnp.ndarray
    base_T_arm1_trans: jnp.ndarray
    base_T_arm2_rot: jnp.ndarray
    base_T_arm2_trans: jnp.ndarray

    @staticmethod
    def create(arm1, arm2, base_T_arm1, base_T_arm2) -> "Pose2Mobile2ArmsFK":
        return Pose2Mobile2ArmsFK(
            arm1, arm2, base_T_arm1.rot, base_T_arm1.trans,
            base_T_arm2.rot, base_T_arm2.trans,
        )


_register(
    Pose2Mobile2ArmsFK,
    ["arm1", "arm2", "base_T_arm1_rot", "base_T_arm1_trans",
     "base_T_arm2_rot", "base_T_arm2_trans"],
)


@dataclasses.dataclass(frozen=True)
class Pose2MobileVetLinArmFK:
    """SE(2) base + vertical linear actuator (torso) + arm
    (reference Pose2MobileVetLinArm.cpp:20-98). Configuration is
    [lift, arm joints]; dof = 3 + 1 + arm dof."""

    arm: ArmFK
    base_T_torso_rot: jnp.ndarray
    base_T_torso_trans: jnp.ndarray
    torso_T_arm_rot: jnp.ndarray
    torso_T_arm_trans: jnp.ndarray
    reverse_linact: bool = False

    @staticmethod
    def create(arm, base_T_torso, torso_T_arm, reverse_linact=False):
        return Pose2MobileVetLinArmFK(
            arm, base_T_torso.rot, base_T_torso.trans,
            torso_T_arm.rot, torso_T_arm.trans, reverse_linact,
        )


_register(
    Pose2MobileVetLinArmFK,
    ["arm", "base_T_torso_rot", "base_T_torso_trans",
     "torso_T_arm_rot", "torso_T_arm_trans"],
    ["reverse_linact"],
)


@dataclasses.dataclass(frozen=True)
class Pose2MobileVetLin2ArmsFK:
    """SE(2) base + torso + two arms (reference Pose2MobileVetLin2Arms.cpp).
    Configuration is [lift, arm1 joints, arm2 joints]."""

    arm1: ArmFK
    arm2: ArmFK
    base_T_torso_rot: jnp.ndarray
    base_T_torso_trans: jnp.ndarray
    torso_T_arm1_rot: jnp.ndarray
    torso_T_arm1_trans: jnp.ndarray
    torso_T_arm2_rot: jnp.ndarray
    torso_T_arm2_trans: jnp.ndarray
    reverse_linact: bool = False

    @staticmethod
    def create(arm1, arm2, base_T_torso, torso_T_arm1, torso_T_arm2,
               reverse_linact=False):
        return Pose2MobileVetLin2ArmsFK(
            arm1, arm2, base_T_torso.rot, base_T_torso.trans,
            torso_T_arm1.rot, torso_T_arm1.trans,
            torso_T_arm2.rot, torso_T_arm2.trans, reverse_linact,
        )


_register(
    Pose2MobileVetLin2ArmsFK,
    ["arm1", "arm2", "base_T_torso_rot", "base_T_torso_trans",
     "torso_T_arm1_rot", "torso_T_arm1_trans",
     "torso_T_arm2_rot", "torso_T_arm2_trans"],
    ["reverse_linact"],
)


# --------------------------------------------------------------------------
# core FK
# --------------------------------------------------------------------------


def _dh_fixed_pose(fk: ArmFK, j: int) -> Pose3:
    """Theta-independent part of the DH transform for joint j:
    Tz(d_j) * Tx(a_j) * Rx(alpha_j) (Arm.cpp:22-27)."""
    dtype = fk.a.dtype
    rot = so3.rotx(fk.alpha[j])
    trans = jnp.stack([fk.a[j], jnp.zeros((), dtype), fk.d[j]])
    # Tz(d) * Tx(a) * Rx(alpha): translation is (a, 0, d) then rotation Rx.
    return Pose3(rot, trans)


def _arm_link_poses_from(fk: ArmFK, q, base: Pose3) -> Pose3:
    """Stacked link poses (dof, 3, 3) / (dof, 3) for an arm rooted at base."""
    rots = []
    transs = []
    cur = base
    for j in range(fk.dof):
        rz = so3.rotz(q[j] + fk.theta_bias[j])
        m = _dh_fixed_pose(fk, j)
        hj = Pose3(rz @ m.rot, (rz @ m.trans[..., None])[..., 0])
        cur = se3.compose(cur, hj)
        rots.append(cur.rot)
        transs.append(cur.trans)
    return Pose3(jnp.stack(rots), jnp.stack(transs))


def base_pose3(pose2) -> Pose3:
    """Lift a Pose2 [x, y, theta] into Pose3 (mobileBaseUtils.cpp:18-31)."""
    pose2 = jnp.asarray(pose2)
    rot = so3.rotz(pose2[..., 2])
    trans = jnp.stack(
        [pose2[..., 0], pose2[..., 1], jnp.zeros_like(pose2[..., 0])], axis=-1
    )
    return Pose3(rot, trans)


def _lift_pose(lift, reverse: bool, dtype) -> Pose3:
    z = -lift if reverse else lift
    return Pose3(
        jnp.eye(3, dtype=dtype),
        jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), z], axis=-1),
    )


def link_poses(fk, q) -> Pose3:
    """Stacked world link poses for any robot family.

    q is the full configuration in the family's StateSpace storage layout.
    Returns Pose3 with leading axis = number of links (see num_links_of).
    """
    if isinstance(fk, ArmFK):
        return _arm_link_poses_from(fk, q, fk.base_pose)

    if isinstance(fk, PointRobotFK):
        # PointRobot.cpp:15-50: single link at (x, y, 0), identity rotation
        q = jnp.asarray(q)
        rot = jnp.eye(3, dtype=q.dtype)[None]
        trans = jnp.stack([q[0], q[1], jnp.zeros_like(q[0])])[None]
        return Pose3(rot, trans)

    if isinstance(fk, Pose2MobileBaseFK):
        b = base_pose3(q)
        return Pose3(b.rot[None], b.trans[None])

    if isinstance(fk, Pose2MobileArmFK):
        pose2, conf = q[:3], q[3:]
        veh = base_pose3(pose2)
        arm_base = se3.compose(veh, fk.base_T_arm)
        arm_links = _arm_link_poses_from(fk.arm, conf, arm_base)
        return Pose3(
            jnp.concatenate([veh.rot[None], arm_links.rot]),
            jnp.concatenate([veh.trans[None], arm_links.trans]),
        )

    if isinstance(fk, Pose2Mobile2ArmsFK):
        d1 = fk.arm1.dof
        pose2, conf = q[:3], q[3:]
        veh = base_pose3(pose2)
        base1 = se3.compose(veh, Pose3(fk.base_T_arm1_rot, fk.base_T_arm1_trans))
        base2 = se3.compose(veh, Pose3(fk.base_T_arm2_rot, fk.base_T_arm2_trans))
        l1 = _arm_link_poses_from(fk.arm1, conf[:d1], base1)
        l2 = _arm_link_poses_from(fk.arm2, conf[d1:], base2)
        return Pose3(
            jnp.concatenate([veh.rot[None], l1.rot, l2.rot]),
            jnp.concatenate([veh.trans[None], l1.trans, l2.trans]),
        )

    if isinstance(fk, Pose2MobileVetLinArmFK):
        pose2, conf = q[:3], q[3:]
        veh = base_pose3(pose2)
        # liftBasePose3 (mobileBaseUtils.cpp:51-86): lift * (veh * base_T_torso)
        torso = se3.compose(
            _lift_pose(conf[0], fk.reverse_linact, pose2.dtype),
            se3.compose(veh, Pose3(fk.base_T_torso_rot, fk.base_T_torso_trans)),
        )
        arm_base = se3.compose(torso, Pose3(fk.torso_T_arm_rot, fk.torso_T_arm_trans))
        links = _arm_link_poses_from(fk.arm, conf[1:], arm_base)
        return Pose3(
            jnp.concatenate([veh.rot[None], torso.rot[None], links.rot]),
            jnp.concatenate([veh.trans[None], torso.trans[None], links.trans]),
        )

    if isinstance(fk, Pose2MobileVetLin2ArmsFK):
        d1 = fk.arm1.dof
        pose2, conf = q[:3], q[3:]
        veh = base_pose3(pose2)
        torso = se3.compose(
            _lift_pose(conf[0], fk.reverse_linact, pose2.dtype),
            se3.compose(veh, Pose3(fk.base_T_torso_rot, fk.base_T_torso_trans)),
        )
        base1 = se3.compose(torso, Pose3(fk.torso_T_arm1_rot, fk.torso_T_arm1_trans))
        base2 = se3.compose(torso, Pose3(fk.torso_T_arm2_rot, fk.torso_T_arm2_trans))
        l1 = _arm_link_poses_from(fk.arm1, conf[1 : 1 + d1], base1)
        l2 = _arm_link_poses_from(fk.arm2, conf[1 + d1 :], base2)
        return Pose3(
            jnp.concatenate([veh.rot[None], torso.rot[None], l1.rot, l2.rot]),
            jnp.concatenate([veh.trans[None], torso.trans[None], l1.trans, l2.trans]),
        )

    raise TypeError(f"unknown FK type {type(fk)}")


def arm_link_velocities(fk: ArmFK, q, qdot):
    """Workspace linear velocities of each arm link (Arm.cpp:71-75).

    Returns (dof, 3) array: v_i = J_i(q) qdot via AD (equivalent to the
    geometric Jacobian z_j x (o_i - o_j) construction).
    """

    def positions(qq):
        return link_poses(fk, qq).trans

    _, vel = jax.jvp(positions, (q,), (qdot,))
    return vel


# --------------------------------------------------------------------------
# static descriptors
# --------------------------------------------------------------------------


def dof_of(fk) -> int:
    if isinstance(fk, ArmFK):
        return fk.dof
    if isinstance(fk, PointRobotFK):
        return fk.dof
    if isinstance(fk, Pose2MobileBaseFK):
        return 3
    if isinstance(fk, Pose2MobileArmFK):
        return 3 + fk.arm.dof
    if isinstance(fk, Pose2Mobile2ArmsFK):
        return 3 + fk.arm1.dof + fk.arm2.dof
    if isinstance(fk, Pose2MobileVetLinArmFK):
        return 4 + fk.arm.dof
    if isinstance(fk, Pose2MobileVetLin2ArmsFK):
        return 4 + fk.arm1.dof + fk.arm2.dof
    raise TypeError(type(fk))


def num_links_of(fk) -> int:
    if isinstance(fk, ArmFK):
        return fk.dof
    if isinstance(fk, (PointRobotFK, Pose2MobileBaseFK)):
        return 1
    if isinstance(fk, Pose2MobileArmFK):
        return 1 + fk.arm.dof
    if isinstance(fk, Pose2Mobile2ArmsFK):
        return 1 + fk.arm1.dof + fk.arm2.dof
    if isinstance(fk, Pose2MobileVetLinArmFK):
        return 2 + fk.arm.dof
    if isinstance(fk, Pose2MobileVetLin2ArmsFK):
        return 2 + fk.arm1.dof + fk.arm2.dof
    raise TypeError(type(fk))


def state_space_of(fk) -> StateSpace:
    """The configuration StateSpace of a robot family (its 'Pose' type)."""
    if isinstance(fk, (ArmFK, PointRobotFK)):
        return VectorSpace(dof_of(fk))
    if isinstance(fk, Pose2MobileBaseFK):
        return SE2Space()
    return SE2VectorSpace(dof_of(fk) - 3)
