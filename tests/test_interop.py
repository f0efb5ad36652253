"""Flat-buffer trajectory interop (reference OpenRAVEutils.cpp:15-104)."""

import numpy as np
import pytest

from gpmp2_jax.planner.problem import Trajectory
from gpmp2_jax.utils import buffer_to_trajectory, trajectory_to_buffer


def test_roundtrip_and_clamp():
    rng = np.random.default_rng(3)
    n, dof = 6, 4
    pose = rng.normal(size=(n, dof))
    vel = rng.normal(size=(n, dof))
    lo = -0.5 * np.ones(dof)
    hi = 0.5 * np.ones(dof)

    buf = trajectory_to_buffer(Trajectory(pose=pose, vel=vel), lo, hi)
    assert buf.shape == (2 * n, dof)
    # confs clamped (OpenRAVEutils.cpp:70-76), velocities untouched
    np.testing.assert_allclose(buf[:n], np.clip(pose, lo, hi))
    np.testing.assert_allclose(buf[n:], vel)

    conf2, vel2 = buffer_to_trajectory(buf, dof)
    np.testing.assert_allclose(conf2, np.clip(pose, lo, hi))
    np.testing.assert_allclose(vel2, vel)

    # flat buffer accepted too
    conf3, vel3 = buffer_to_trajectory(buf.ravel(), dof)
    np.testing.assert_allclose(conf3, conf2)
    np.testing.assert_allclose(vel3, vel2)


def test_limit_size_mismatch_raises():
    traj = Trajectory(pose=np.zeros((3, 4)), vel=np.zeros((3, 4)))
    with pytest.raises(ValueError):
        trajectory_to_buffer(traj, np.zeros(3), np.zeros(4))
    with pytest.raises(ValueError):
        buffer_to_trajectory(np.zeros((5, 4)), 4)
