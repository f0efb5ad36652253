"""Sphere-based collision robot model.

Port of /root/reference/gpmp2/kinematics/RobotModel.h (+ -inl.h):
an FK model plus a set of body spheres (link id, radius, center in link
frame). The per-sphere chain rule J_point_conf = J_point_pose * J_pose_jp
(RobotModel-inl.h:28-39) is replaced by AD through `sphere_centers_world`.

The 7 reference model typedefs (ArmModel, PointRobotModel, Pose2Mobile*Model)
are all `RobotModel` instances with the corresponding FK type.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from ..geometry.statespace import StateSpace
from . import fk as fk_mod

__all__ = ["RobotModel", "make_robot_model"]


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """FK + body spheres. Vmappable pytree; `fk` carries the static family."""

    fk: object
    sphere_link_ids: jnp.ndarray  # (S,) int32
    sphere_radii: jnp.ndarray  # (S,)
    sphere_centers: jnp.ndarray  # (S, 3) in link frames

    @property
    def num_spheres(self) -> int:
        return self.sphere_radii.shape[-1]

    @property
    def dof(self) -> int:
        return fk_mod.dof_of(self.fk)

    @property
    def space(self) -> StateSpace:
        return fk_mod.state_space_of(self.fk)


jax.tree_util.register_dataclass(
    RobotModel,
    data_fields=["fk", "sphere_link_ids", "sphere_radii", "sphere_centers"],
    meta_fields=[],
)


def make_robot_model(fk, spheres: Sequence[Tuple[int, float, Tuple[float, float, float]]],
                     dtype=jnp.float32) -> RobotModel:
    """Build a RobotModel from (link_id, radius, center_xyz) tuples,
    mirroring BodySphereVector construction (RobotModel.h:20-31).

    Validates the sphere table at construction time (the reference throws
    from factor constructors, e.g. JointLimitFactorVector.h:52-56; here the
    checks live where the data enters so bad inputs fail with shapes in the
    message instead of as XLA trace errors)."""
    import numpy as np

    if len(spheres) == 0:
        raise ValueError("make_robot_model: sphere table is empty")
    for i, s in enumerate(spheres):
        if len(s) != 3 or len(tuple(s[2])) != 3:
            raise ValueError(
                f"make_robot_model: sphere {i} must be (link_id, radius, "
                f"(x, y, z)), got {s!r}"
            )
    ids_np = np.asarray([s[0] for s in spheres], np.int32)
    radii_np = np.asarray([float(s[1]) for s in spheres])
    n_links = fk_mod.num_links_of(fk)
    if ids_np.min() < 0 or ids_np.max() >= n_links:
        raise ValueError(
            f"make_robot_model: sphere link ids must be in [0, {n_links}) "
            f"for this FK family, got range [{ids_np.min()}, {ids_np.max()}]"
        )
    if (radii_np < 0).any():
        raise ValueError(
            f"make_robot_model: sphere radii must be >= 0, got "
            f"{radii_np[radii_np < 0].tolist()}"
        )
    ids = jnp.asarray(ids_np)
    radii = jnp.asarray(radii_np, dtype)
    centers = jnp.asarray([tuple(s[2]) for s in spheres], dtype)
    return RobotModel(fk, ids, radii, centers)


def sphere_centers_world(model: RobotModel, q):
    """World positions of all body spheres, shape (S, 3).

    Matches RobotModel::sphereCenters (RobotModel-inl.h:12-40): gather the
    link pose for each sphere and map the local center through it.
    """
    poses = fk_mod.link_poses(model.fk, q)
    rot = poses.rot[model.sphere_link_ids]  # (S, 3, 3)
    trans = poses.trans[model.sphere_link_ids]  # (S, 3)
    return (rot @ model.sphere_centers[..., None])[..., 0] + trans


def sphere_centers_and_jac(model: RobotModel, q):
    """Sphere centers (S, 3) plus the analytic position Jacobian (S, 3, d)
    wrt the configuration tangent.

    For revolute DH arms this is the geometric Jacobian
    dp/dtheta_j = z_j x (p - o_j) for j <= link (the reference computes the
    same quantity through its dHo_dq caches, Arm.cpp:85-115 +
    RobotModel-inl.h:28-39); one FK pass instead of dof+1 under AD — the
    hot-path form for the obstacle factors. Families without an analytic
    path fall back to jacfwd.
    """
    import jax

    fk = model.fk
    d = model.dof

    if isinstance(fk, fk_mod.PointRobotFK):
        centers = sphere_centers_world(model, q)
        S = model.num_spheres
        J = jnp.zeros((S, 3, d), q.dtype)
        J = J.at[:, 0, 0].set(1.0).at[:, 1, 1].set(1.0)
        return centers, J

    if isinstance(fk, fk_mod.ArmFK):
        poses = fk_mod.link_poses(fk, q)
        rot = poses.rot[model.sphere_link_ids]
        trans = poses.trans[model.sphere_link_ids]
        centers = (rot @ model.sphere_centers[..., None])[..., 0] + trans  # (S,3)

        # joint j rotates about the z axis of the frame BEFORE it: base for
        # j = 0, link frame j-1 otherwise.
        base = fk.base_pose
        frame_rots = jnp.concatenate([base.rot[None], poses.rot[:-1]], axis=0)
        frame_trans = jnp.concatenate([base.trans[None], poses.trans[:-1]], axis=0)
        z_axes = frame_rots[..., :, 2]  # (d, 3)
        # dp/dtheta_j = z_j x (p - o_j), masked to j <= sphere link id
        rel = centers[:, None, :] - frame_trans[None, :, :]  # (S, d, 3)
        crosses = jnp.cross(z_axes[None, :, :], rel)  # (S, d, 3)
        jmask = (
            jnp.arange(d)[None, :] <= model.sphere_link_ids[:, None]
        )  # (S, d)
        J = jnp.where(jmask[..., None], crosses, 0.0)  # (S, d, 3)
        return centers, jnp.swapaxes(J, -1, -2)  # (S, 3, d)

    if isinstance(
        fk,
        (fk_mod.Pose2MobileBaseFK, fk_mod.Pose2MobileArmFK,
         fk_mod.Pose2Mobile2ArmsFK, fk_mod.Pose2MobileVetLinArmFK,
         fk_mod.Pose2MobileVetLin2ArmsFK),
    ):
        return _mobile_sphere_jac(model, q)

    # generic fallback: AD through the FK composition
    def f(qq):
        return sphere_centers_world(model, qq)

    J = jax.jacfwd(f)(q)
    return f(q), J


def arm_fk_spheres_batched(model: RobotModel, qs):
    """Sphere centers and geometric Jacobians for a stack of
    configurations: qs (..., d) -> centers (..., S, 3), J (..., S, 3, d).

    One vectorized FK pass over every configuration (support and
    interpolated states alike), which XLA fuses; any robot family."""
    lead = qs.shape[:-1]
    d = qs.shape[-1]
    centers, J = jax.vmap(lambda q: sphere_centers_and_jac(model, q))(
        qs.reshape(-1, d))
    S = centers.shape[1]
    return centers.reshape(lead + (S, 3)), J.reshape(lead + (S, 3, d))


def sphere_centers_axes(model: RobotModel, q):
    """ArmFK hot-path form: centers (S, 3), joint z-axes (d, 3), joint
    origins (d, 3) — WITHOUT materializing the (S, 3, d) Jacobian.

    The obstacle factor only ever consumes grad_sdf @ J; by the scalar
    triple-product identity

        g . (z_j x (p - o_j)) = z_j . (p x g) - g . (z_j x o_j)

    the row-wise chain rule becomes one small contraction against these
    per-config axis frames (see problem.py:_obs_res_jac_arm_fused), so
    the (S, d, 3) cross-product intermediates of `sphere_centers_and_jac`
    (the dominant FK-side traffic at bench shape) never exist.
    """
    fk = model.fk
    poses = fk_mod.link_poses(fk, q)
    rot = poses.rot[model.sphere_link_ids]
    trans = poses.trans[model.sphere_link_ids]
    centers = (rot @ model.sphere_centers[..., None])[..., 0] + trans
    base = fk.base_pose
    frame_rots = jnp.concatenate([base.rot[None], poses.rot[:-1]], axis=0)
    frame_trans = jnp.concatenate([base.trans[None], poses.trans[:-1]], axis=0)
    z_axes = frame_rots[..., :, 2]  # (d, 3)
    return centers, z_axes, frame_trans


def sphere_centers_axes_batched(model: RobotModel, qs):
    """Batched `sphere_centers_axes` in batch-major unrolled form:
    qs (N, d) -> centers (N, S, 3), z (N, d, 3), o (N, d, 3).

    The per-config Pose3 chain under vmap lowers to 7 sequential batched
    3x3 matmuls with tiny contraction dims. Here the rotation is NINE (N,)
    arrays and the chain is unrolled at trace time into pure elementwise
    FMAs over the config axis (the `solver/smallmat.py` formulation), so
    XLA fuses the whole chain into a handful of kernels. The sphere
    link frames are gathered.
    Identical math to `sphere_centers_axes` (DH Spong eq. 3.10 chain,
    Arm.cpp:23-27); bit-level differences are reassociation only.
    """
    fk = model.fk
    d = fk.dof
    N = qs.shape[0]
    dtype = qs.dtype
    a = jnp.asarray(fk.a, dtype)
    dz = jnp.asarray(fk.d, dtype)
    bias = jnp.asarray(fk.theta_bias, dtype)
    ca = jnp.cos(jnp.asarray(fk.alpha, dtype))
    sa = jnp.sin(jnp.asarray(fk.alpha, dtype))
    bp = fk.base_pose

    R = [[jnp.broadcast_to(bp.rot[r, c], (N,)) for c in range(3)]
         for r in range(3)]
    t = [jnp.broadcast_to(bp.trans[r], (N,)) for r in range(3)]
    z_rows, o_rows, frames = [], [], []
    for j in range(d):
        # joint j rotates about the z axis of the frame BEFORE it
        z_rows.append(jnp.stack([R[0][2], R[1][2], R[2][2]], axis=-1))
        o_rows.append(jnp.stack(t, axis=-1))
        ct = jnp.cos(qs[:, j] + bias[j])
        st = jnp.sin(qs[:, j] + bias[j])
        # DH transform A = RotZ(theta) * [Rx(alpha) | (a, 0, dz)]:
        # A[:,0] = (ct, st, 0); A[:,1] = (-st*ca, ct*ca, sa);
        # A[:,2] = (st*sa, -ct*sa, ca); A[:,3] = (a*ct, a*st, dz)
        A10, A11, A12 = -st * ca[j], ct * ca[j], sa[j]
        A20, A21, A22 = st * sa[j], -ct * sa[j], ca[j]
        T0, T1 = a[j] * ct, a[j] * st
        Rn = [[None] * 3 for _ in range(3)]
        tn = [None] * 3
        for r in range(3):
            Rn[r][0] = R[r][0] * ct + R[r][1] * st
            Rn[r][1] = R[r][0] * A10 + R[r][1] * A11 + R[r][2] * A12
            Rn[r][2] = R[r][0] * A20 + R[r][1] * A21 + R[r][2] * A22
            tn[r] = t[r] + R[r][0] * T0 + R[r][1] * T1 + R[r][2] * dz[j]
        R, t = Rn, tn
        frames.append(jnp.stack(
            [R[0][0], R[0][1], R[0][2], R[1][0], R[1][1], R[1][2],
             R[2][0], R[2][1], R[2][2], t[0], t[1], t[2]], axis=-1))

    z = jnp.stack(z_rows, axis=1)  # (N, d, 3)
    o = jnp.stack(o_rows, axis=1)
    M = jnp.stack(frames, axis=1)  # (N, d, 12) = [R row-major | t]
    # each sphere's link frame by a gather: exact, where a one-hot matmul
    # would round the frames it routes under TF32
    A_s = jnp.take(M, model.sphere_link_ids, axis=1)  # (N, S, 12)
    Rs = A_s[..., :9].reshape(N, -1, 3, 3)
    centers = (
        jnp.einsum("nsij,sj->nsi", Rs, model.sphere_centers,
                   precision=jax.lax.Precision.HIGHEST)  # full f32
        + A_s[..., 9:]
    )
    return centers, z, o


def _mobile_sphere_jac(model: RobotModel, q):
    """Analytic sphere Jacobians for SE(2)-based mobile families.

    Tangent layout [vx, vy, omega, (lift,) q_arm1 (, q_arm2)] (right SE(2)
    retract). The base columns follow from the exact embedding of the
    SE(2) exponential into SE(3):

      dp/dvx = R_B e_x,  dp/dvy = R_B e_y,  dp/domega = e_z x (p - t_B)

    (base rotation is about world z, so the omega column reduces to a
    world-frame cross product); the prismatic torso gives +-e_z for links
    at/above it (liftBasePose3, mobileBaseUtils.cpp:51-86), and revolute
    arm joints give z_j x (p - o_j) using the re-rooted world frames — the
    analytic equivalent of the reference's Adjoint re-rooting
    (Pose2MobileArm.cpp:96-106). Verified against AD in tests.
    """
    fk = model.fk
    d = model.dof
    S = model.num_spheres
    dtype = q.dtype

    poses = fk_mod.link_poses(fk, q)  # world link frames
    link_ids = model.sphere_link_ids
    rot = poses.rot[link_ids]
    trans = poses.trans[link_ids]
    centers = (rot @ model.sphere_centers[..., None])[..., 0] + trans

    th = q[2]
    c, s = jnp.cos(th), jnp.sin(th)
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    col_vx = jnp.broadcast_to(jnp.stack([c, s, zero]), (S, 3))
    col_vy = jnp.broadcast_to(jnp.stack([-s, c, zero]), (S, 3))
    tB = jnp.stack([q[0], q[1], zero])
    rel = centers - tB  # (S, 3)
    ez = jnp.stack([zero, zero, one])
    col_w = jnp.cross(jnp.broadcast_to(ez, (S, 3)), rel)

    cols = [col_vx[:, :, None], col_vy[:, :, None], col_w[:, :, None]]

    # family-specific assembly of the remaining columns
    if isinstance(fk, fk_mod.Pose2MobileBaseFK):
        J = jnp.concatenate(cols, axis=-1)
        return centers, J

    from ..geometry import se3
    from ..geometry.se3 import Pose3

    veh = fk_mod.base_pose3(q[:3])

    def revolute_cols(arm_base: Pose3, arm: fk_mod.ArmFK, arm_links: Pose3,
                      local_ids):
        """(S, 3, A) columns for a revolute chain rooted at arm_base.
        local_ids: (S,) local link index (or -1 when sphere not on arm)."""
        A = arm.dof
        frame_rots = jnp.concatenate([arm_base.rot[None], arm_links.rot[:-1]])
        frame_trans = jnp.concatenate(
            [arm_base.trans[None], arm_links.trans[:-1]]
        )
        z_axes = frame_rots[..., :, 2]  # (A, 3)
        relj = centers[:, None, :] - frame_trans[None, :, :]  # (S, A, 3)
        crosses = jnp.cross(z_axes[None], relj)  # (S, A, 3)
        mask = (
            (jnp.arange(A)[None, :] <= local_ids[:, None]) & (local_ids >= 0)[:, None]
        )
        return jnp.swapaxes(jnp.where(mask[..., None], crosses, 0.0), -1, -2)

    def slice_links(lo, hi):
        return Pose3(poses.rot[lo:hi], poses.trans[lo:hi])

    if isinstance(fk, fk_mod.Pose2MobileArmFK):
        arm_base = se3.compose(veh, fk.base_T_arm)
        local = jnp.where(link_ids >= 1, link_ids - 1, -1)
        cols.append(revolute_cols(arm_base, fk.arm, slice_links(1, 1 + fk.arm.dof), local))

    elif isinstance(fk, fk_mod.Pose2Mobile2ArmsFK):
        A1 = fk.arm1.dof
        base1 = se3.compose(veh, Pose3(fk.base_T_arm1_rot, fk.base_T_arm1_trans))
        base2 = se3.compose(veh, Pose3(fk.base_T_arm2_rot, fk.base_T_arm2_trans))
        local1 = jnp.where((link_ids >= 1) & (link_ids <= A1), link_ids - 1, -1)
        local2 = jnp.where(link_ids > A1, link_ids - A1 - 1, -1)
        cols.append(revolute_cols(base1, fk.arm1, slice_links(1, 1 + A1), local1))
        cols.append(
            revolute_cols(base2, fk.arm2,
                          slice_links(1 + A1, 1 + A1 + fk.arm2.dof), local2)
        )

    elif isinstance(fk, fk_mod.Pose2MobileVetLinArmFK):
        sign = -1.0 if fk.reverse_linact else 1.0
        on_torso = link_ids >= 1
        col_lift = jnp.where(
            on_torso[:, None], sign * jnp.broadcast_to(ez, (S, 3)), 0.0
        )
        cols.append(col_lift[:, :, None])
        torso = Pose3(poses.rot[1], poses.trans[1])
        arm_base = se3.compose(torso, Pose3(fk.torso_T_arm_rot, fk.torso_T_arm_trans))
        local = jnp.where(link_ids >= 2, link_ids - 2, -1)
        cols.append(revolute_cols(arm_base, fk.arm, slice_links(2, 2 + fk.arm.dof), local))

    elif isinstance(fk, fk_mod.Pose2MobileVetLin2ArmsFK):
        A1 = fk.arm1.dof
        sign = -1.0 if fk.reverse_linact else 1.0
        on_torso = link_ids >= 1
        col_lift = jnp.where(
            on_torso[:, None], sign * jnp.broadcast_to(ez, (S, 3)), 0.0
        )
        cols.append(col_lift[:, :, None])
        torso = Pose3(poses.rot[1], poses.trans[1])
        base1 = se3.compose(torso, Pose3(fk.torso_T_arm1_rot, fk.torso_T_arm1_trans))
        base2 = se3.compose(torso, Pose3(fk.torso_T_arm2_rot, fk.torso_T_arm2_trans))
        local1 = jnp.where((link_ids >= 2) & (link_ids <= 1 + A1), link_ids - 2, -1)
        local2 = jnp.where(link_ids > 1 + A1, link_ids - 2 - A1, -1)
        cols.append(revolute_cols(base1, fk.arm1, slice_links(2, 2 + A1), local1))
        cols.append(
            revolute_cols(base2, fk.arm2,
                          slice_links(2 + A1, 2 + A1 + fk.arm2.dof), local2)
        )

    J = jnp.concatenate(cols, axis=-1)
    assert J.shape == (S, 3, d)
    return centers, J
