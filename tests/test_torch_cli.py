"""The dataset CLI (``python -m slam_dynamic_tpu_torch.io.run``) in
process on the CPU against the JAX package's CLI, on the synthetic
640x480 world: 4 frames with ``--ply --save-map``, then the port resumed
from its checkpoint with ``--load-map --skip 4`` over the next 4.

Checks: the same files, ``summary.json`` keys, frame, LOST and keyframe
counts as the JAX CLI, the ATE within max(1 mm, 20%) of its;
``groundtruth.txt`` within 1e-6 of the JAX CLI's (the JAX package's
``_write_synth_groundtruth`` on the same sequence); the resumed run
starts LOST and relocalizes on its first frame; ``--help`` lists the JAX
CLI's options with ``--device`` in place of ``--cpu``; ``--dataset
rosbag`` raises naming its ROADMAP item; the default device is the card,
which this CPU has not.
"""
import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from slam_dynamic_tpu.io import run as jrun
from slam_dynamic_tpu_torch.io import run as trun
import torch_port_util  # noqa: F401  (one torch thread a test worker)

FRAMES = 4


def _main(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    lines = out.getvalue().splitlines()
    return rc, [json.loads(x) for x in lines if x.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    base = ["--dataset", "synthetic", "--frames", str(FRAMES), "--ply"]
    out = {}
    for name, mod, dev in (("jax", jrun, ["--cpu"]),
                           ("port", trun, ["--device", "cpu"])):
        o = d / name
        out[name] = (o, *_main(mod, base + dev + [
            "--save-map", str(o / "map.npz"), "--out", str(o)]))
    o = d / "resumed"
    out["resumed"] = (o, *_main(trun, [
        "--dataset", "synthetic", "--frames", str(2 * FRAMES), "--skip",
        str(FRAMES), "--load-map", str(out["port"][0] / "map.npz"),
        "--log-frames", "--device", "cpu", "--out", str(o)]))
    return out


def test_cli_writes_what_the_jax_cli_writes(runs):
    (oj, rcj, lj), (ot, rct, lt) = runs["jax"], runs["port"]
    assert rcj == rct == 0
    assert sorted(os.listdir(ot)) == sorted(os.listdir(oj))
    sj = json.loads((oj / "summary.json").read_text())
    st = json.loads((ot / "summary.json").read_text())
    assert sorted(st) == sorted(sj) and "ate_m" in st
    assert lt == [st] and lj == [sj]
    for k in ("frames", "lost", "keyframes"):
        assert st[k] == sj[k], k
    assert abs(st["ate_m"] - sj["ate_m"]) <= max(1e-3, 0.2 * sj["ate_m"])
    for f in ("map.ply", "map.pcd"):
        assert (ot / f).stat().st_size > 1000, f


def test_cli_groundtruth_matches_jax(runs):
    gj = np.loadtxt(runs["jax"][0] / "groundtruth.txt")
    gt = np.loadtxt(runs["port"][0] / "groundtruth.txt")
    assert gt.shape == gj.shape == (FRAMES, 8)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-6)


def test_cli_resumes_from_its_checkpoint(runs):
    o, rc, lines = runs["resumed"]
    assert rc == 0
    assert lines[0]["state"] == "LOST" and lines[0]["keyframes"] >= 1
    summary = lines[-1]
    assert summary["frames"] == FRAMES and summary["lost"] == 0
    rows = [json.loads(x) for x in (o / "frames.jsonl").read_text()
            .splitlines()]
    assert [r["i"] for r in rows] == list(range(FRAMES, 2 * FRAMES))
    assert all(r["state"] == "OK" for r in rows)
    assert summary["ate_m"] < 0.03


def _options(mod, capsys):
    with pytest.raises(SystemExit):
        mod.main(["--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out))


def test_cli_help_lists_the_jax_options(capsys):
    jopts, topts = _options(jrun, capsys), _options(trun, capsys)
    assert topts == (jopts - {"--cpu"}) | {"--device"}


def test_cli_rosbag_and_default_device(tmp_path):
    with pytest.raises(NotImplementedError, match="item 21"):
        trun.main(["--dataset", "rosbag", "--path", str(tmp_path),
                   "--device", "cpu", "--out", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trun.main(["--frames", "1", "--out", str(tmp_path)])
