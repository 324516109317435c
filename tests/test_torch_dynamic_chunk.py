"""The dynamic-object module on the chunked path: the port's
System.track_chunk(..., detections=) against the JAX System's, on the
320x240 moving-object world of ``tests/test_e2e_dynamic.py`` (31 frames,
C = 6, one chunk in flight as ``bench.py --dynamic`` runs it, the H/F
classification on every 2nd chunk frame).

The two packages draw their RANSAC samples differently (JAX's threefry
against the port's hash, seeded from the pose on the device), so the
comparison is by outcome. Tolerances: every frame OK on both; the same
keyframe decisions up to the first frame at which the two packages' box
statuses differ; the same final statuses, with a box confirmed dynamic
(status 2), the confirmation no more than one chunk apart; ATE within
max(1 mm, 20%) of JAX's; one packet readback per chunk. Without the
boxes (``detector="off"``) the port's ATE is more than 3 times its ATE
with them, as the JAX package's own test holds (unaligned ATE)."""
import numpy as np
import pytest

from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.frontend import tracking as ttracking
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import decisions, dynamic_configs, dynamic_world, \
    first_status, first_status_difference, run_dynamic, with_tracking

C = 6
N_FRAMES = 31
B = 16


@pytest.fixture(scope="module")
def world():
    return dynamic_world("moving", N_FRAMES)


@pytest.fixture(scope="module")
def runs(world):
    jcfg, tcfg = (with_tracking(c, pipeline_depth=1)
                  for c in dynamic_configs(world[0]))
    js = JSystem(jcfg)
    shapes = []
    orig = ttracking.fused_track_chunk_dyn

    def spy(*args, **kw):
        outs, packed = orig(*args, **kw)
        shapes.append(tuple(packed.shape))
        return outs, packed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttracking, "fused_track_chunk_dyn", spy)
        port = run_dynamic(System(tcfg, device="cpu"), world, N_FRAMES, C)
    port["packet_shapes"] = shapes
    return {"jax": run_dynamic(js, world, N_FRAMES, C), "port": port}


def test_dynamic_chunk_states_and_keyframes_match_jax(runs):
    dj, dt = decisions(runs["jax"]), decisions(runs["port"])
    assert [d[0] for d in dt] == [d[0] for d in dj] == list(range(N_FRAMES))
    assert all(d[1] == "OK" for d in dj + dt)
    upto = first_status_difference(runs["jax"], runs["port"])
    assert dt[:upto] == dj[:upto]
    assert sum(d[2] for d in dt) >= 3


def test_dynamic_chunk_box_status_matches_jax(runs):
    sj = runs["jax"]["system"].boxes.status
    st = runs["port"]["system"].boxes.status
    np.testing.assert_array_equal(st, sj)
    assert (st == 2).any()
    assert abs(first_status(runs["port"], 2)
               - first_status(runs["jax"], 2)) <= 1


def test_dynamic_chunk_ate_tracks_jax(runs, world):
    gt = world[1].t_wc[:N_FRAMES]
    ate_j = jate(runs["jax"]["est"], gt)
    ate_t = ate_rmse(runs["port"]["est"], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_rmse(runs["port"]["est"], gt, align=False) < 0.12


def test_dynamic_chunk_packets(runs):
    """One readback per chunk, each [C, 28 + 17 B]; every chunk frame
    returns its verdicts and per-box 3D state, and only even chunk frames
    (classify_every_chunked = 2) carry a verdict."""
    system = runs["port"]["system"]
    tracker = system.tracker
    assert tracker.packet_reads == tracker.dispatches == (N_FRAMES - 1) // C
    assert runs["port"]["packet_shapes"] == \
        [(C, 28 + 17 * B)] * tracker.dispatches
    chunked = [s for s in runs["port"]["stats"] if s.frame_id >= 1]
    assert all(s.verdicts is not None and s.verdicts.shape == (B,)
               and s.box3d.shape == (B, 16) for s in chunked)
    assert not any(s.verdicts.any() for s in chunked
                   if (s.frame_id - 1) % C % 2)
    assert any(s.verdicts.any() for s in chunked)
    assert system.object_states     # the confirmed box's 3D state


def test_boxes_off_hurt_the_port(runs, world):
    """The port without boxes (detector off) tracks the moving object and
    drifts: its unaligned ATE is more than 3 times its ATE with boxes."""
    _, tcfg = (with_tracking(c, pipeline_depth=1)
               for c in dynamic_configs(world[0], detector="off"))
    off = run_dynamic(System(tcfg, device="cpu"), world, N_FRAMES, C,
                      use_boxes=False)
    gt = world[1].t_wc[:N_FRAMES]
    ate_off = ate_rmse(off["est"], gt, align=False)
    ate_on = ate_rmse(runs["port"]["est"], gt, align=False)
    assert ate_off > 3 * ate_on, (ate_off, ate_on)
