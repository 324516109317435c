"""The check that decides ``correct``, driven on the CPU through the
harness at a size a test run can hold (320x240, 500 features, two lanes
for the fleet): a sound run, the controls' readings against the limits,
and each fault that a cell can have planted under the timed path, which
must turn ``correct`` false."""
import copy

import pytest

from portbench import faults, run

SEED = 2**31 + 12345


def _small(lanes=2, limits=None, workload=None):
    def override(wl, cfg):
        wl, cfg = copy.deepcopy(wl), dict(cfg)
        wl.update(copy.deepcopy(workload or {}))
        for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy",
                  "Camera.bf"):
            cfg[k] = cfg[k] * 0.5
        cfg["Camera.width"] //= 2
        cfg["Camera.height"] //= 2
        cfg["ORBextractor.nFeatures"] = 500
        if wl["entry"] == "fleet":
            wl["lanes"] = lanes
            wl["warm_steps"] = 4
        wl["sample"].update(k1_share=1.0, k2_share=1.0, depth_share=1.0)
        # a CPU window holds a dozen frames: the camera moves three times
        # as fast, so that a trajectory left unchanged reads far off
        # (with little yaw: each keyframe costs seconds on the CPU)
        for axis in wl["world"]["camera"]["path"]:
            axis["cycles"] = [3 * k for k in axis["cycles"]]
        wl["world"]["camera"]["yaw"] = {"amp": [0.05], "cycles": [1]}
        # at this size the tracker is noisier than at the cells' own, and
        # a short window may hold no keyframe (and so no K2 call)
        wl["limits"]["ate_mm"] = {"max": 25.0}
        wl["limits"]["frames_checked"] = {"min": 3}
        wl["limits"]["k2_calls"] = {"min": 0}
        if limits:
            wl["limits"].update(limits)
        return wl, cfg
    return override


def _run(cell, seconds=20.0, **kw):
    return run.run_cell(cell, SEED, seconds, False, device="cpu",
                        override=_small(**kw))


def _failed(result):
    return {k for k, ch in result["checks"].items() if not run._holds(ch)}


@pytest.fixture(scope="module")
def sound():
    return _run("tum3-rgbd.office.fleet16")


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] > 0 and sound["failed"] == 0
    r = sound["readings"]
    assert r["untracked_frames"] == 0
    assert r["frames_checked"] == sound["attempted"]
    assert r["lane_frames_min"] * 2 == sound["attempted"]
    assert set(sound["metrics"]) == {"fps", "setup_s"}
    assert list(sound)[-1] == "forbidden_modules" and \
        list(sound)[-2] == "checks"


def test_controls_fail_the_limits(sound):
    r = sound["readings"]
    limits = _small()(*_cell_files("tum3-rgbd.office.fleet16"))[0]["limits"]
    assert r["control_k1_mismatch"] > limits["k1_mismatch"]["max"]
    assert r["control_k2_mismatch"] > limits["k2_mismatch"]["max"]
    assert r["control_depth_err_mm"] > limits["depth_err_mm"]["max"]


def _cell_files(name):
    from portbench import spec
    c = spec.cell(spec.load_benchmark(), name)
    return c["workload"], c["config"]


def test_state_left_unchanged_is_refused():
    with faults.planted("state"):
        r = _run("tum3-rgbd.office.fleet16", lanes=1)
    assert not r["correct"]
    assert "ate_mm" in _failed(r)


def test_half_the_batch_left_out_is_refused():
    with faults.planted("half"):
        r = _run("tum3-rgbd.office.fleet16")
    assert not r["correct"]
    assert "ate_mm" in _failed(r)


def test_lanes_whose_results_are_dropped_are_refused():
    with faults.planted("lanes"):
        r = _run("tum3-rgbd.office.fleet16")
    assert not r["correct"]
    assert {"failed", "untracked_frames", "ate_mm"} <= _failed(r)
    assert r["readings"]["lane_frames_min"] == 0


@pytest.mark.parametrize("fault", [None, "disparity"])
def test_stereo_disparity_check(fault):
    """The matcher's disparities pass when sound and fail one pixel off;
    at this size the trajectory alone would not notice."""
    if fault:
        with faults.planted(fault):
            r = _run("euroc-stereo.v1.frame")
    else:
        r = _run("euroc-stereo.v1.frame")
    assert r["readings"]["depth_keypoints"] > 100
    assert r["readings"]["control_disparity_err_px"] < \
        r["readings"]["disparity_err_px"]
    if fault:
        assert not r["correct"] and "disparity_err_px" in _failed(r)
    else:
        assert r["correct"], r["checks"]


WALKER = {"name": "walker", "size": [0.6, 1.6],
          "center": [-1.3, 0.0, 1.5],
          "walk": {"axis": 0, "amp": 0.96, "cycles": 9}}


def test_chunk_entry_with_boxes_runs_and_is_judged():
    """The ``chunk`` entry (``System.track_chunk``) with boxes handed over
    for a walking object and a static one: every window frame tracked,
    and the box statuses judged against which object the world moves."""
    wl, _ = _cell_files("tum3-rgbd.office.fleet16")
    objects = copy.deepcopy(wl["world"]["objects"]) + [WALKER]
    r = _run("tum3-rgbd.office.fleet16", workload=dict(
        entry="chunk", chunk=3, warm_steps=3, boxed=[0, len(objects) - 1],
        world=dict(wl["world"], objects=objects)))
    assert r["attempted"] > 0 and r["attempted"] % 3 == 0
    rd = r["readings"]
    assert rd["untracked_frames"] == 0 and rd["failed"] == 0
    assert "static_confirmed_dynamic" in rd
    assert "moving_confirmed_share" in rd


def test_fleet_entry_takes_chunks():
    """``chunk`` applies to the fleet entry (``track_rgbd_chunk_batch``):
    B lanes x C frames a step, each lane answering every frame. A lane of
    a chunked batch keeps no frame of its own, so such a cell compares no
    keypoint depths."""
    wl, _ = _cell_files("tum3-rgbd.office.fleet16")
    limits = {k: v for k, v in wl["limits"].items() if k != "depth_err_mm"}
    r = _run("tum3-rgbd.office.fleet16",
             workload=dict(chunk=2, limits=limits))
    assert r["readings"]["depth_keypoints"] == 0
    assert r["attempted"] % 4 == 0
    assert r["readings"]["untracked_frames"] == 0
    assert r["correct"], r["checks"]


def test_an_answer_altered_where_produced_is_refused():
    with faults.planted("altered"):
        r = _run("tum3-rgbd.office.fleet16", lanes=1)
    assert not r["correct"]
    assert "k1_mismatch" in _failed(r)
