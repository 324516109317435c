"""BENCHMARK.json against the contract's character rules, and the
harness finding a cell, a configuration and a metric from their files
alone."""
import json
import shutil

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
TEXT_LIMIT = 200


def _names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield w["name"]
        yield w["config"]
        yield w["traffic"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert spec.NAME.match(name), name


def test_units_texts_and_keys():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    texts = [w["why"] for w in BENCH["workloads"]] + \
        [c["why"] for c in BENCH["configs"]] + \
        [c["source"] for c in BENCH["configs"]] + \
        [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= TEXT_LIMIT and "\n" not in t and "\t" not in t
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_entry_has_its_files():
    for w in BENCH["workloads"]:
        c = spec.cell(BENCH, w["name"])
        assert c["workload"]["config"] == w["config"]
        assert c["end_to_end"] and c["per_layer"]
        for m in c["per_layer"]:
            assert callable(spec.load_reader(m["name"]))
    for c in BENCH["configs"]:
        cfg = spec.load_config(c["name"])
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced"]


def test_a_new_cell_and_metric_are_found_from_their_files(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE / "configs", base / "configs")
    shutil.copytree(spec.HERE / "workloads", base / "workloads")
    shutil.copytree(spec.HERE / "metrics", base / "metrics")
    wl = json.loads((base / "workloads" /
                     "tum3-rgbd.office.fleet16.json").read_text())
    wl["lanes"] = 8
    (base / "workloads" / "tum3-rgbd.office.fleet8.json").write_text(
        json.dumps(wl))
    (base / "metrics" / "slice_frames.py").write_text(
        "def read(ctx):\n    return ctx['slice_frames']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name="tum3-rgbd.office.fleet8", config="tum3-rgbd",
        traffic="office.fleet8", chips=1, why="a test cell"))
    bench["per_layer"].append(dict(
        name="slice_frames", unit="frames", better="higher",
        source="program_counter", layer="device", moves="fps",
        workloads=["tum3-rgbd.office.fleet8"]))
    c = spec.cell(bench, "tum3-rgbd.office.fleet8", base)
    assert c["workload"]["lanes"] == 8
    assert "slice_frames" in [m["name"] for m in c["per_layer"]]
    assert spec.load_reader("slice_frames", base)({"slice_frames": 7}) == 7
    other = spec.cell(bench, "tum3-rgbd.office.fleet16", base)
    assert "slice_frames" not in [m["name"] for m in other["per_layer"]]


@pytest.mark.parametrize("name, yaml_name", [("tum3-rgbd", "TUM3.yaml"),
                                             ("euroc-stereo", "EuRoC.yaml")])
def test_rig_keys_equal_the_sources_yaml(name, yaml_name):
    """A configuration's rig keys are its source yaml's, number for number,
    and the program's own loader reads the same tree from either."""
    C = pytest.importorskip("slam_dynamic_tpu_torch.config")
    path = spec.ROOT / "configs" / yaml_name
    if not path.exists():
        pytest.skip(f"{yaml_name} is not in this checkout")
    cfg = spec.load_config(name)
    ours = {ln.split(":", 1)[0]: ln.split(":", 1)[1].strip()
            for ln in spec.rig_yaml(cfg).splitlines()}
    theirs = {}
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        k, _, v = line.partition(":")
        if v.strip() and not v.strip().startswith("!!") and \
                not k.startswith(("LEFT.", "RIGHT.", "%")) and \
                "." in k or k in ("ThDepth", "DepthMapFactor"):
            theirs[k.strip()] = v.strip()
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert float(ours[k]) == float(v), k
    wl = {"pipeline_depth": 1}
    got = spec.system_config(cfg, wl)
    want = C.load_yaml(str(path))
    assert got.camera == want.camera and got.orb == want.orb
    assert got.pointcloud == want.pointcloud
    assert got.sensor == cfg["sensor"]
