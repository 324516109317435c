"""The reduction of a traced slice and the roofline arithmetic, on
synthetic event lists."""
import pytest

from portbench import peaks, spec
from portbench.trace import (HOST, K1_OP, K2_OP, Event, gaps,
                             innermost_spans, op_device_ns, summarize,
                             union_ns)


def test_union_of_intervals():
    assert union_ns([]) == 0
    assert union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert union_ns([(0, 100), (10, 20), (30, 40)]) == 100
    assert union_ns([(5, 6), (0, 1)]) == 2


def test_gaps():
    assert gaps([(10, 20), (15, 30), (40, 50)], 0, 60) == [
        (0, 10), (30, 40), (50, 60)]
    assert gaps([], 0, 5) == [(0, 5)]
    assert gaps([(0, 5)], 0, 5) == []


def _slice():
    return [
        Event("op", "mm_track", 0, 400, 1),
        Event("op", "local_track", 400, 1000, 1),
        Event("op", K1_OP, 50, 80, 1),
        Event("launch", "cudaLaunchKernel", 55, 56, 1, 7),
        Event("launch", "cudaLaunchKernel", 60, 61, 1, 8),
        Event("op", K2_OP, 500, 520, 1),
        Event("launch", "cudaLaunchKernelExC", 505, 506, 1, 9),
        Event("launch", "cudaLaunchKernel", 700, 701, 2, 10),
        Event("device", "k1_kernel", 100, 140, 0, 7),
        Event("device", "k1_tail", 150, 160, 0, 8),
        Event("device", "k2_kernel", 550, 600, 0, 9),
        Event("device", "other", 130, 200, 0, 10),
    ]


def test_op_device_time_follows_launches_under_the_op():
    ev = _slice()
    assert op_device_ns(ev, K1_OP) == (50, 1)
    assert op_device_ns(ev, K2_OP) == (50, 1)
    assert op_device_ns(ev, "absent") == (0, 0)


def test_summary_idle_share_and_gap_labels():
    s = summarize(_slice())
    assert s["window_ns"] == 1000
    # device intervals 100-200 (overlapping) and 550-600
    assert s["busy_ns"] == 150
    assert s["launches"] == 4
    assert s["spans"]["mm_track"] == (400, 1)
    assert s["spans"]["local_track"] == (600, 1)
    idle = dict(s["idle_gaps"])
    # a gap goes whole to the span under its midpoint: 0-100 and 200-550
    # (midpoint 375) to mm_track, 600-1000 to local_track
    assert idle["mm_track"] == pytest.approx(450e-9)
    assert idle["local_track"] == pytest.approx(400e-9)
    assert s["device_ops"][0] == ["other", pytest.approx(70e-9)]


def test_innermost_span_labels():
    cuts, labels = innermost_spans([(0, 100, "outer"), (10, 20, "inner")])
    assert cuts == [0, 10, 20, 100]
    assert labels == ["outer", "inner", "outer", HOST]


def _ctx(**kw):
    trace = dict(spans={"mm_track": (3e6, 2), "local_map": (1e6, 2),
                        "local_track": (2e6, 2), "frame_build": (1.2e6, 2),
                        "mapping_stage": (5e6, 2)},
                 k1_device_ns=2000, k2_device_ns=0, busy_ns=250,
                 window_ns=1000, launches=600)
    ctx = dict(trace=trace, slice_frames=12, frames_per_step=1,
               k1_work=[(1, 2048, 4096, 10**6)],
               k2_work=[], step_ms=[1.0, 3.0, 2.0],
               latency_ms=list(range(101)))
    ctx.update(kw)
    return ctx


def test_readers():
    ctx = _ctx()
    read = {m: spec.load_reader(m) for m in (
        "step_ms.p50", "frame_ms.p90", "track_host_ms_per_frame",
        "frame_build_host_ms_per_frame", "mapping_host_ms_per_keyframe", "k1_roofline", "k2_roofline",
        "device_idle_pct", "launches_per_frame")}
    assert read["step_ms.p50"](ctx) == 2.0
    assert read["frame_ms.p90"](ctx) == pytest.approx(90.0)
    assert read["track_host_ms_per_frame"](ctx) == pytest.approx(0.5)
    assert read["frame_build_host_ms_per_frame"](ctx) == pytest.approx(0.1)
    assert read["mapping_host_ms_per_keyframe"](ctx) == pytest.approx(2.5)
    k1 = peaks.k1_bound_s(1, 2048, 4096, 10**6)
    assert read["k1_roofline"](ctx) == pytest.approx(100 * k1 / 2e-6)
    assert read["k2_roofline"](ctx) is None      # nothing to read
    assert read["device_idle_pct"](ctx) == pytest.approx(
        100 * (1 - (250e-6 / 12) / 2.0))
    assert read["launches_per_frame"](ctx) == pytest.approx(50.0)
    assert read["step_ms.p50"](_ctx(step_ms=[])) is None
    # the idle share takes the busy time per frame of the slice against
    # the time per frame outside it: 250 ns busy over 12 frames against
    # steps of 1-3 ms of 4 frames each
    four = _ctx(frames_per_step=4)
    assert read["device_idle_pct"](four) == pytest.approx(
        100 * (1 - (250e-6 / 12) / (2.0 / 4)))

def test_bounds_match_the_programs_kernel_bench():
    kb = pytest.importorskip("slam_dynamic_tpu_torch.kernel_bench")
    ms, _ = kb.k2_bound(2048, 2048)
    assert peaks.k2_bound_s(1, 2048, 2048) * 1e3 == pytest.approx(ms)
    ms4, _ = kb.k2_bound(1000, 1000, lanes=4)
    assert peaks.k2_bound_s(4, 1000, 1000) * 1e3 == pytest.approx(ms4)
    # K1 at 2048 x 2048 with 1.5M gated-in pairs: bound by operations
    t = peaks.k1_bound_s(1, 2048, 2048, 1_500_000)
    assert t == pytest.approx(6 * 1_500_000 / peaks.INT32_OPS_PER_S)
    # the bytes bound when no pair is gated in
    t0 = peaks.k1_bound_s(2, 100, 50, 0)
    assert t0 == pytest.approx(
        2 * (100 * 45 + 50 * 49 + 1200) / peaks.HBM_BYTES_PER_S)


def test_profile_slice_of_whole_steps():
    import torch

    from portbench.trace import Profile
    p = Profile({"skip_steps": 1, "min_frames": 2, "min_keyframes": 1,
                 "max_frames": 3})
    assert not p.should_start(0) and p.should_start(1)
    p.start()
    assert not p.should_start(1)
    for kf in (0, 0):
        torch.ones(4).add_(1)
        p.count(1, kf)
    assert not p.enough()            # no keyframe yet
    p.count(1, 0)
    assert p.enough()                # max_frames
    p.stop()
    assert p.done and not p.should_start(5) and p.events()
    p.finish()
    assert p.done and not p.active
