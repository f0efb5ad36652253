"""gpmp2_jax: a batched Gaussian Process Motion Planner 2 in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of ori-drs/gpmp2
(GTSAM-based C++ trajectory optimization as inference on factor graphs),
re-architected for batched accelerator execution:

  - factor graphs become structure-of-arrays factor programs; the
    Gauss-Newton normal equations are block-tridiagonal by construction and
    solved with a batched block-Cholesky scan instead of sparse elimination;
  - thousands of planning problems batch via vmap and shard over device
    meshes via jax.sharding; collectives reduce convergence statistics;
  - robot kinematics, GP priors, and SDF collision checks are fixed-shape,
    differentiable kernels.

See SURVEY.md for the reference layer map this framework mirrors.
"""

__version__ = "0.1.0"

from . import (  # noqa: F401
    datasets,
    dynamics,
    geometry,
    gp,
    kinematics,
    obstacle,
    parallel,
    planner,
    robots,
    solver,
    utils,
)

# Flat convenience API mirroring the reference's single `gpmp2` namespace
# (gpmp2.h is the authoritative export list, SURVEY.md section 2.8).
from .geometry import Pose3, SE2Space, SE2VectorSpace, SE3Space, StateSpace, VectorSpace  # noqa: F401
from .kinematics import (  # noqa: F401
    ArmFK,
    PointRobotFK,
    Pose2Mobile2ArmsFK,
    Pose2MobileArmFK,
    Pose2MobileBaseFK,
    Pose2MobileVetLin2ArmsFK,
    Pose2MobileVetLinArmFK,
    RobotModel,
    goal_factor_error,
    hinge_limit_cost,
    joint_limit_error,
    make_robot_model,
    sphere_centers_world,
    velocity_limit_error,
    workspace_orientation_error,
    workspace_pose_error,
    workspace_position_error,
)
from .obstacle import (  # noqa: F401
    PlanarSDF,
    SignedDistanceField,
    hinge_loss,
    obstacle_factor_error,
    obstacle_planar_factor_error,
    planar_sdf_lookup,
    sdf_lookup,
    self_collision_error,
)
from .planner import (  # noqa: F401
    FactorGraph,
    ISAM2TrajOptimizer,
    TrajOptimizerSetting,
    Trajectory,
    TrajProblem,
    batch_traj_optimize,
    collision_cost,
    collision_cost_batch,
    make_problem,
    plan_batch,
)
from .planner.traj_utils import (  # noqa: F401
    init_traj_straight_line,
    interpolate_traj,
)
from .robots import (  # noqa: F401
    ARM_PRESETS,
    MOBILE_PRESETS,
    generate_arm,
    generate_mobile_arm,
    generate_mobile_base,
)
from .solver import (  # noqa: F401
    OptimizerParams,
    OptResult,
    batched_block_tridiag_solve,
    block_tridiag_solve,
    optimize_batch,
)
from .utils import (  # noqa: F401
    buffer_to_trajectory,
    load_sdf,
    read_sdf_vol_file,
    save_sdf,
    trajectory_to_buffer,
)
