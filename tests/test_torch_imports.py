"""The port, chip_smoke.py and the drivers it runs (tests/port_drive.py,
tests/port_shards.py) import nothing of JAX or of the JAX package (the
card's machine has no JAX, and slam_dynamic_tpu/__init__.py imports
it)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(ROOT)) for p in
               (ROOT / "slam_dynamic_tpu_torch").rglob("*.py")) + \
    ["chip_smoke.py", "tests/port_drive.py", "tests/port_shards.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_dynamic_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, slam_dynamic_tpu_torch.system, "
            "slam_dynamic_tpu_torch.convert, "
            "slam_dynamic_tpu_torch.bench, "
            "slam_dynamic_tpu_torch.frontend.dynamics, "
            "slam_dynamic_tpu_torch.frontend.dynamics_ops, "
            "slam_dynamic_tpu_torch.frontend.boxtrack, "
            "slam_dynamic_tpu_torch.ops.ransac, "
            "slam_dynamic_tpu_torch.ops.pointcloud, "
            "slam_dynamic_tpu_torch.ops.pnp, "
            "slam_dynamic_tpu_torch.ops.horn, "
            "slam_dynamic_tpu_torch.optim.sim3_opt, "
            "slam_dynamic_tpu_torch.optim.pose_graph, "
            "slam_dynamic_tpu_torch.utils.sim3, "
            "slam_dynamic_tpu_torch.backend.relocalization, "
            "slam_dynamic_tpu_torch.backend.loop_closing, "
            "slam_dynamic_tpu_torch.orbit_trace, "
            "slam_dynamic_tpu_torch.trace_track, "
            "slam_dynamic_tpu_torch.ops.stereo, "
            "slam_dynamic_tpu_torch.ops.twoview, "
            "slam_dynamic_tpu_torch.ops.orb_batched, "
            "slam_dynamic_tpu_torch.frontend.initializer, "
            "slam_dynamic_tpu_torch.io.datasets, "
            "slam_dynamic_tpu_torch.io.run, "
            "slam_dynamic_tpu_torch.models.detector, "
            "slam_dynamic_tpu_torch.ops.nms, "
            "slam_dynamic_tpu_torch.backend.dense_map, "
            "slam_dynamic_tpu_torch.worldmap.checkpoint, "
            "slam_dynamic_tpu_torch.viz.headless, "
            "slam_dynamic_tpu_torch.viz.ar, "
            "slam_dynamic_tpu_torch.parallel.sharded_ba, "
            "slam_dynamic_tpu_torch.parallel.multi_system, "
            "slam_dynamic_tpu_torch.parallel.mesh, "
            "slam_dynamic_tpu_torch.parallel.distributed, "
            "slam_dynamic_tpu_torch.parallel.sharded_pose_graph, "
            "slam_dynamic_tpu_torch.backend.global_ba, "
            "slam_dynamic_tpu_torch.io.rosbag, "
            "slam_dynamic_tpu_torch.io.live, "
            "slam_dynamic_tpu_torch.io.native_loader, "
            "slam_dynamic_tpu_torch.utils.debug, "
            "slam_dynamic_tpu_torch.utils.profiling, "
            "slam_dynamic_tpu_torch.utils.transport; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
