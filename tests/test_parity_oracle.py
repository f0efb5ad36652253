"""GTSAM-semantics parity: framework vs committed oracle fixtures.

North-star target (BASELINE.md): trajectory cost within 1% of GTSAM LM on
identical factor graphs. Real GTSAM is unobtainable here (no network
egress, no system lib — see tools/gtsam_oracle.py docstring), so the
golden values come from two independent oracles that share no code with
this framework:

  - tools/gtsam_oracle.py — float64 NumPy/SciPy implementation of the
    reference's factor graphs and GTSAM LevenbergMarquardtOptimizer
    semantics (BatchTrajOptimizer.cpp:212-308), written from the reference
    sources; dumps tests/fixtures/oracle_*.npz.
  - tools/oracle/gpmp2_oracle.cpp — single-threaded C++ re-implementation
    of the WAM benchmark path; cross-validated against the numpy oracle
    (identical init cost to 1e-9 rel) and used as bench.py's measured
    baseline denominator.

Each fixture checks three independent things:
  1. graph-cost parity at the initial trajectory (validates EVERY factor's
     residual + weight at a generic state — tight f64 tolerance);
  2. graph-cost parity at the oracle's OPTIMIZED trajectory (a second,
     qualitatively different state: obstacle hinges partially active);
  3. optimizer parity: this framework's LM, Dogleg (the reference default,
     Delta_0=0.2) and Gauss-Newton, run on the same graph from the same
     init, each reach a final cost within 1% of the corresponding oracle
     optimizer's (the north-star acceptance rule), converged, not gave_up.

Regenerate fixtures with: python tools/gtsam_oracle.py
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from gpmp2_jax import (
    PlanarSDF,
    Pose2MobileBaseFK,
    PointRobotFK,
    Trajectory,
    TrajOptimizerSetting,
    batch_traj_optimize,
    generate_arm,
    make_problem,
    make_robot_model,
)
from gpmp2_jax.planner.problem import traj_error
from gpmp2_jax.datasets import (
    generate_3d_dataset,
    planar_sdf_from_occupancy,
    sdf_from_occupancy,
)
from gpmp2_jax.planner.traj_utils import init_traj_straight_line

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")

F64 = jnp.float64


def load(name):
    return np.load(os.path.join(FIXDIR, f"oracle_{name}.npz"),
                   allow_pickle=True)


def planar_sdf_from_box(shape, box, origin, cell, dtype=F64):
    """Rebuild the oracle's occupancy (one axis-aligned block) and SDF."""
    occ = np.zeros(shape)
    r0, r1, c0, c1 = box
    occ[r0:r1, c0:c1] = 1.0
    return planar_sdf_from_occupancy(origin, cell, occ, dtype=dtype)


def check_costs_and_opt(fx, robot, sdf, setting, problem_kwargs,
                        rel_opt=0.01):
    prob = make_problem(
        robot, sdf, fx["meta_start"], np.zeros(robot.dof), fx["meta_end"],
        np.zeros(robot.dof), setting, dtype=F64, sdf_pack=False,
        **problem_kwargs)
    init = Trajectory(jnp.asarray(fx["init_pose"], F64),
                      jnp.asarray(fx["init_vel"], F64))
    opt = Trajectory(jnp.asarray(fx["opt_pose"], F64),
                     jnp.asarray(fx["opt_vel"], F64))

    # 1. every-factor parity at the initial state
    e0 = float(traj_error(prob, init))
    assert e0 == pytest.approx(float(fx["init_error"]), rel=1e-8)

    # 2. parity at the oracle's optimized state (different hinge pattern)
    e1 = float(traj_error(prob, opt))
    assert e1 == pytest.approx(float(fx["final_error"]), rel=1e-6)

    # 3. the framework's straight-line init reproduces the oracle's
    space = robot.space
    mine = init_traj_straight_line(space,
                                   jnp.asarray(fx["meta_start"], F64),
                                   jnp.asarray(fx["meta_end"], F64),
                                   int(fx["meta_n_steps"]),
                                   float(fx["meta_total_time"]))
    np.testing.assert_allclose(np.asarray(mine.pose),
                               fx["init_pose"], atol=1e-12)
    np.testing.assert_allclose(np.asarray(mine.vel),
                               fx["init_vel"], atol=1e-12)

    # 4. optimizer parity: each optimizer within 1% of the oracle's final
    # cost on the same graph from the same init. LM is the north-star rule;
    # dogleg is the reference's DEFAULT optimizer
    # (TrajOptimizerSetting.cpp:41, Delta_0=0.2 BatchTrajOptimizer.cpp:222)
    # and GN the examples' choice — their oracle finals live under
    # dogleg_*/gn_* fixture keys (tools/gtsam_oracle.py).
    results = {}
    for opt_type, err_key in (("lm", "final_error"),
                              ("dogleg", "dogleg_final_error"),
                              ("gaussnewton", "gn_final_error")):
        if err_key not in fx:
            continue  # older fixture without dogleg/gn keys
        import dataclasses as _dc

        s = _dc.replace(setting) if _dc.is_dataclass(setting) else setting
        s.opt_type = opt_type
        if opt_type != "lm":
            # trust-region paths differ legitimately mid-descent; compare
            # tightly-converged endpoints (fixture generated at the same
            # rel_tol, tools/gtsam_oracle.py)
            s.rel_thresh = (float(fx["trust_rel_tol"])
                            if "trust_rel_tol" in fx else 1e-4)
            s.max_iter = 200
        res = batch_traj_optimize(
            robot, sdf,
            jnp.asarray(fx["meta_start"], F64), jnp.zeros_like(mine.vel[0]),
            jnp.asarray(fx["meta_end"], F64), jnp.zeros_like(mine.vel[0]),
            s, dtype=F64, sdf_pack=False, **problem_kwargs,
        )
        assert bool(res.converged), f"framework {opt_type} failed to converge"
        assert not bool(res.gave_up)
        oracle_final = float(fx[err_key])
        ours = float(res.error)
        assert ours <= oracle_final * (1.0 + rel_opt) + 1e-9, (
            f"{opt_type}: final cost {ours} not within {rel_opt:.0%} of "
            f"oracle {oracle_final}"
        )
        results[opt_type] = (ours, oracle_final)
    return results["lm"]


class TestPointRobot2D:
    """BASELINE config 1 (pointRobot examples; OneObstacleDataset-style)."""

    def build(self, dtype=F64):
        fx = load("pointrobot2d")
        sdf = planar_sdf_from_box((300, 300), fx["meta_occ_box"],
                                  fx["meta_origin"], float(fx["meta_cell"]),
                                  dtype)
        robot = make_robot_model(PointRobotFK(), [(0, 0.15, (0.0, 0.0, 0.0))],
                                 dtype=dtype)
        setting = TrajOptimizerSetting(
            dof=2, total_step=int(fx["meta_n_steps"]),
            total_time=float(fx["meta_total_time"]),
            obs_check_inter=int(fx["meta_inter"]),
            cost_sigma=float(fx["meta_cost_sigma"]),
            epsilon=float(fx["meta_eps"]),
            opt_type="lm", max_iter=100,
        )
        return fx, robot, sdf, setting, {}

    def test_parity(self):
        check_costs_and_opt(*self.build())


class TestArm3Planar:
    """BASELINE config 3: planar 3-link arm + joint limits."""

    def build(self, dtype=F64):
        fx = load("arm3_planar")
        sdf = planar_sdf_from_box((300, 300), fx["meta_occ_box"],
                                  fx["meta_origin"], float(fx["meta_cell"]),
                                  dtype)
        robot = generate_arm("SimpleThreeLinksArm", dtype=dtype)
        setting = TrajOptimizerSetting(
            dof=3, total_step=int(fx["meta_n_steps"]),
            total_time=float(fx["meta_total_time"]),
            obs_check_inter=int(fx["meta_inter"]),
            cost_sigma=float(fx["meta_cost_sigma"]),
            epsilon=float(fx["meta_eps"]),
            flag_pos_limit=True,
            joint_pos_limits_down=fx["meta_lim_down"],
            joint_pos_limits_up=fx["meta_lim_up"],
            pos_limit_thresh=fx["meta_lim_thresh"],
            pos_limit_sigma=float(fx["meta_lim_sigma"]),
            opt_type="lm", max_iter=100,
        )
        return fx, robot, sdf, setting, {}

    def test_parity(self):
        check_costs_and_opt(*self.build())


class TestMobileBaseSE2:
    """BASELINE config 2: SE(2) base, Lie GP prior + vehicle dynamics."""

    def build(self, dtype=F64):
        fx = load("mobilebase_se2")
        sdf = planar_sdf_from_box((500, 500), fx["meta_occ_box"],
                                  fx["meta_origin"], float(fx["meta_cell"]),
                                  dtype)
        robot = make_robot_model(Pose2MobileBaseFK(),
                                 [(0, 0.25, (0.0, 0.0, 0.0))], dtype=dtype)
        setting = TrajOptimizerSetting(
            dof=3, total_step=int(fx["meta_n_steps"]),
            total_time=float(fx["meta_total_time"]),
            obs_check_inter=int(fx["meta_inter"]),
            cost_sigma=float(fx["meta_cost_sigma"]),
            epsilon=float(fx["meta_eps"]),
            opt_type="lm", max_iter=100,
        )
        return fx, robot, sdf, setting, dict(
            flag_vehicle_dynamics=True,
            dyn_sigma=float(fx["meta_dyn_sigma"]))

    def test_parity(self):
        check_costs_and_opt(*self.build())


class TestWAM7:
    """BASELINE config 4: the canonical WAM benchmark
    (WAMPlannerExample.m:13-66, WAMDeskDataset)."""

    def build(self, dtype=F64):
        fx = load("wam7_3d")
        ds = generate_3d_dataset("WAMDeskDataset")
        sdf = sdf_from_occupancy(
            np.array([ds.origin_x, ds.origin_y, ds.origin_z]),
            ds.cell_size, ds.map, dtype=dtype,
        )
        robot = generate_arm("WAMArm", dtype=dtype)
        setting = TrajOptimizerSetting(
            dof=7, total_step=int(fx["meta_n_steps"]),
            total_time=float(fx["meta_total_time"]),
            obs_check_inter=int(fx["meta_inter"]),
            cost_sigma=float(fx["meta_cost_sigma"]),
            epsilon=float(fx["meta_eps"]),
            opt_type="lm", max_iter=100,
        )
        return fx, robot, sdf, setting, {}

    def test_parity(self):
        check_costs_and_opt(*self.build())


def lm_float32_within(case, rel_opt=0.01):
    """The planner's own dtype against the float64 oracle: `case`'s graph
    built in float32 and solved by LM from the straight-line init must
    converge, not give up, and end within `rel_opt` of the oracle's
    float64 LM cost (the north-star rule). Returns (ours, oracle)."""
    fx, robot, sdf, setting, kw = case.build(jnp.float32)
    f32 = jnp.float32
    res = batch_traj_optimize(
        robot, sdf, jnp.asarray(fx["meta_start"], f32),
        jnp.zeros(robot.dof, f32), jnp.asarray(fx["meta_end"], f32),
        jnp.zeros(robot.dof, f32), setting, dtype=f32, sdf_pack=False, **kw)
    ours, oracle = float(res.error), float(fx["final_error"])
    assert bool(res.converged) and not bool(res.gave_up), (
        f"float32 LM: converged {bool(res.converged)}, gave_up "
        f"{bool(res.gave_up)}")
    assert ours <= oracle * (1.0 + rel_opt) + 1e-9, (
        f"float32 LM: final cost {ours} not within {rel_opt:.0%} of the "
        f"float64 oracle {oracle}")
    return ours, oracle


@pytest.mark.parametrize("case", [TestArm3Planar, TestMobileBaseSE2, TestWAM7],
                         ids=lambda c: c.__name__)
def test_lm_float32_within_oracle(case):
    lm_float32_within(case())
