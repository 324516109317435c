"""The benchmark's description, found by name: ``BENCHMARK.json`` at the
root of the checkout, each configuration in ``configs/<config>.json``,
each cell in ``workloads/<cell>.json`` and each per-layer metric's reader
in ``metrics/<metric>.py``. A cell, a configuration or a metric is added
by adding its file and its entry; no file here needs an edit."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str, base: Path = HERE) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a configuration name: {name!r}")
    with open(base / "configs" / f"{name}.json") as f:
        return json.load(f)


def load_workload(name: str, base: Path = HERE) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    with open(base / "workloads" / f"{name}.json") as f:
        return json.load(f)


def load_reader(name: str, base: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"not a metric name: {name!r}")
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, name: str, base: Path = HERE) -> dict:
    """The cell's entry of ``workloads``, its workload file, its
    configuration file and the metrics it reports (end to end, then per
    layer), each metric's entry as ``BENCHMARK.json`` has it."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    wl = load_workload(name, base)
    cfg = load_config(entry["config"], base)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(entry=entry, workload=wl, config=cfg,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def camera_dict(cfg: dict) -> dict:
    """The rig's intrinsics and frame rate from a configuration file."""
    return dict(fx=cfg["Camera.fx"], fy=cfg["Camera.fy"],
                cx=cfg["Camera.cx"], cy=cfg["Camera.cy"],
                width=int(cfg["Camera.width"]),
                height=int(cfg["Camera.height"]),
                fps=float(cfg["Camera.fps"]), bf=cfg["Camera.bf"])


def rig_yaml(cfg: dict) -> str:
    """The rig's keys of a configuration file (its numbers at the top
    level) as the lines of a dataset YAML."""
    return "".join(f"{k}: {v!r}\n" for k, v in cfg.items()
                   if isinstance(v, (int, float))
                   and not isinstance(v, bool))


def system_config(cfg: dict, wl: dict):
    """The program's ``SystemConfig`` for a configuration file: its rig
    keys read by the program's own ``config.load_yaml``, with the
    capacities the file assumes, its sensor and the cell's detector mode
    and pipeline depth."""
    import dataclasses
    import tempfile

    from slam_dynamic_tpu_torch import config as C

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rig.yaml"
        path.write_text(rig_yaml(cfg))
        out = C.load_yaml(str(path))
    out = out.replace(
        capacity=C.CapacityConfig(**cfg["assumed"]["capacity"]),
        detector=C.DetectorConfig(mode=wl.get("detector", "off")),
        sensor=cfg["sensor"])
    return out.replace(tracking=dataclasses.replace(
        out.tracking, pipeline_depth=int(wl.get("pipeline_depth", 1))))
