"""The benchmark's command on the card: each cell once, briefly, through
``python -m portbench.run``, with the contract's result line. Marked
``cuda``; the decision to skip is taken in a fixture."""
import json
import subprocess
import sys

import pytest

from portbench import spec
from portbench.run import ROOT

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2**31 + 99), "--seconds", "12", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    names = {m["name"] for m in spec.cell(spec.load_benchmark(), cell)[
        "end_to_end" if not trace else "per_layer"]}
    assert set(line["metrics"]) <= names
    if trace:
        assert line["device"]["busy_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
