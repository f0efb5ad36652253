"""Build and checkpoint a signed distance field.

Mirror of matlab/SaveSDFExample.m (Boost-serialization save of the
WAMDeskDataset SDF): builds the field with the native EDT and saves/loads
it via npz; also demonstrates the .vol reader round trip.

Run: PYTHONPATH=. python examples/save_sdf.py
"""

import os
import tempfile

import jax.numpy as jnp
import numpy as np

from gpmp2_jax.datasets import generate_3d_dataset, sdf_from_occupancy
from gpmp2_jax.obstacle.sdf import sdf_lookup
from gpmp2_jax.utils import load_sdf, save_sdf


def main():
    print("building WAMDeskDataset SDF (native EDT) ...")
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map)

    path = os.path.join(tempfile.gettempdir(), "wam_desk_sdf.npz")
    save_sdf(path, sdf)
    print(f"saved {path} ({os.path.getsize(path)/1e6:.1f} MB)")

    sdf2 = load_sdf(path)
    q = jnp.asarray([0.2, 0.7, -0.2])  # inside the desk top
    d1, _, _ = sdf_lookup(sdf, q)
    d2, _, _ = sdf_lookup(sdf2, q)
    print(f"lookup before/after round trip: {float(d1):.4f} / {float(d2):.4f}")
    assert abs(float(d1) - float(d2)) < 1e-6
    print("round trip OK")


if __name__ == "__main__":
    main()
