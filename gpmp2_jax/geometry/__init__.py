"""Lie-group geometry for the JAX GPMP2 rebuild.

Replaces /root/reference/gpmp2/geometry (dynamic-size gtsam Lie types) with
fixed-shape, vmappable JAX operations.
"""

from . import se2, se3, so3
from .se3 import Pose3
from .statespace import SE2Space, SE2VectorSpace, SE3Space, StateSpace, VectorSpace

__all__ = [
    "se2",
    "se3",
    "so3",
    "Pose3",
    "StateSpace",
    "VectorSpace",
    "SE2Space",
    "SE2VectorSpace",
    "SE3Space",
]
