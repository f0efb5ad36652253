"""Execute every example script headless (VERDICT r3: examples were the
only unverified layer — a script that no test runs can silently rot).

Each example runs as a fresh subprocess on the CPU (JAX_PLATFORMS=cpu; the
scripts themselves run on the default backend) with a tiny-workload env
override where the script supports one (FLEET_BATCH). batch_fleet.py gets
8 virtual CPU devices through XLA_FLAGS. The scripts only touch matplotlib
behind --plot flags (forced to the Agg backend here anyway).

Set GPMP2_SKIP_EXAMPLES=1 to skip this module (e.g. for a quick
iteration loop); CI runs it.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("*.py"))

pytestmark = pytest.mark.skipif(
    os.environ.get("GPMP2_SKIP_EXAMPLES") == "1",
    reason="GPMP2_SKIP_EXAMPLES=1",
)


@pytest.mark.parametrize("script", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_example_runs(script):
    env = dict(os.environ)
    env.update(
        PYTHONPATH=str(REPO),
        MPLBACKEND="Agg",
        JAX_PLATFORMS="cpu",
        FLEET_BATCH="8",  # batch_fleet.py: 256 -> 8 lanes for CI speed
    )
    if script.stem == "batch_fleet":
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    proc = subprocess.run(
        [sys.executable, str(script)],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, (
        f"{script.name} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-3000:]}\n"
        f"--- stderr ---\n{proc.stderr[-3000:]}"
    )
