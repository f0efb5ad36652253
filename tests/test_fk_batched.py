"""Batched sphere FK (`kinematics.robot.arm_fk_spheres_batched`) against
the per-configuration path, at multi-dimensional leading shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax.kinematics.robot import (
    arm_fk_spheres_batched,
    sphere_centers_and_jac,
)
from gpmp2_jax.robots import generate_arm, generate_mobile_arm


def _reference(model, qs):
    lead = qs.shape[:-1]
    flat = qs.reshape(-1, qs.shape[-1])
    c, J = jax.vmap(lambda q: sphere_centers_and_jac(model, q))(flat)
    return (c.reshape(lead + c.shape[1:]), J.reshape(lead + J.shape[1:]))


class TestBatchedDispatch:
    def test_fallback_path_multidim(self):
        """Arbitrary leading dims flatten through one vectorized pass."""
        model = generate_arm("WAMArm")
        rng = np.random.default_rng(2)
        qs = jnp.asarray(rng.uniform(-1, 1, (4, 5, 7)).astype(np.float32))
        c, J = arm_fk_spheres_batched(model, qs)
        c_r, J_r = _reference(model, qs)
        np.testing.assert_allclose(np.asarray(c), np.asarray(c_r), atol=1e-6)
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_r), atol=1e-6)


@pytest.mark.parametrize("lead", [(3,), (2, 3), (2, 1, 4)])
@pytest.mark.parametrize("robot", ["WAMArm", "SimpleTwoLinksArm"])
def test_matches_per_config_path(robot, lead):
    """Each configuration of a (lead..., d) stack gives exactly what one
    call of the per-config path gives, in float64."""
    model = generate_arm(robot, dtype=jnp.float64)
    d = model.dof
    rng = np.random.default_rng(len(lead))
    qs = jnp.asarray(rng.uniform(-2, 2, lead + (d,)))
    c, J = arm_fk_spheres_batched(model, qs)
    S = model.num_spheres
    assert c.shape == lead + (S, 3) and J.shape == lead + (S, 3, d)
    flat_q = np.asarray(qs).reshape(-1, d)
    flat_c = np.asarray(c).reshape(-1, S, 3)
    flat_J = np.asarray(J).reshape(-1, S, 3, d)
    for k in range(flat_q.shape[0]):
        ck, Jk = sphere_centers_and_jac(model, jnp.asarray(flat_q[k]))
        np.testing.assert_allclose(flat_c[k], np.asarray(ck), atol=1e-12)
        np.testing.assert_allclose(flat_J[k], np.asarray(Jk), atol=1e-12)


def test_mobile_family_under_vmap():
    """A non-arm family (SE(2) base + arm) batched under an outer vmap,
    the planner's problem-batch shape."""
    model = generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64)
    d = model.dof
    rng = np.random.default_rng(7)
    qs = jnp.asarray(rng.uniform(-1, 1, (3, 6, d)))
    c, J = jax.vmap(lambda q: arm_fk_spheres_batched(model, q))(qs)
    c_r, J_r = _reference(model, qs)
    np.testing.assert_allclose(np.asarray(c), np.asarray(c_r), atol=1e-12)
    np.testing.assert_allclose(np.asarray(J), np.asarray(J_r), atol=1e-12)
