"""Smoke tests for the matplotlib visualization helpers.

Mirrors the reference toolbox plot surface (matlab/+gpmp2/plot*.m,
gpmp2_python/utils/plot_utils.py): every helper must run on real robot
models / fields without raising.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest

from gpmp2_jax.datasets import (
    generate_2d_dataset,
    generate_3d_dataset,
    planar_sdf_from_occupancy,
    sdf_from_occupancy,
)
from gpmp2_jax.robots import generate_arm, generate_mobile_arm
from gpmp2_jax.utils import plot as gplot


@pytest.fixture(scope="module")
def ds2d():
    return generate_2d_dataset("OneObstacleDataset")


def test_2d_map_and_sdf_plots(ds2d):
    sdf = planar_sdf_from_occupancy(ds2d.origin, ds2d.cell_size, ds2d.map)
    fig, ax = plt.subplots()
    gplot.plot_evidence_map_2d(ax, ds2d.map, float(ds2d.origin[0]),
                               float(ds2d.origin[1]), float(ds2d.cell_size))
    gplot.plot_signed_distance_field_2d(
        ax, np.asarray(sdf.data), float(ds2d.origin[0]),
        float(ds2d.origin[1]), float(ds2d.cell_size))
    plt.close(fig)


def test_planar_robot_plots():
    arm = generate_arm("SimpleThreeLinksArm")
    fig, ax = plt.subplots()
    gplot.plot_planar_arm(ax, arm.fk, np.zeros(3))
    gplot.plot_robot_model_2d(ax, arm, np.zeros(3))
    gplot.plot_planar_mobile_base(ax, np.array([1.0, 0.5, 0.3]))
    mob = generate_mobile_arm("SimpleTwoLinksArm")
    gplot.plot_planar_mobile_arm(ax, mob, np.zeros(5))
    mob2 = generate_mobile_arm("SimpleTwoArms")
    gplot.plot_planar_mobile_2arms(ax, mob2, np.zeros(7), nr_links=(2, 2))
    plt.close(fig)


def test_3d_plots():
    ds = generate_3d_dataset("SmallDemo")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)
    wam = generate_arm("WAMArm")
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    gplot.plot_map_3d(ax, ds.corner_idx, ds.origin, float(ds.cell_size))
    gplot.plot_signed_distance_field_3d(
        ax, np.asarray(sdf.data), np.asarray(ds.origin), float(ds.cell_size))
    gplot.plot_arm(ax, wam.fk, np.zeros(7))
    gplot.plot_robot_model_3d(ax, wam, np.zeros(7))
    gplot.set_3d_plot_range(ax, (-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
    plt.close(fig)
