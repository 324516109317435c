"""The dynamic-object module on the per-frame path: the port's
System.track_rgbd(..., detections=) against the JAX System's, on the
320x240 falsely boxed world of ``tests/test_e2e_dynamic.py`` (a static
object in a detector box, 31 frames), classifying every 2nd frame
(``classify_every = 2``), so both forms of the dynamic step run. Also:
the library's default config constructs, the parts not ported yet raise
with their ROADMAP item, and the ``mask=`` path runs.

The RANSAC samples differ between the packages, so the comparison is by
outcome. Tolerances: every frame OK on both; the same keyframe decisions
up to the first frame at which the two packages' box statuses differ;
every box static (status 1) at the end on both, the first flip to 1 no
more than two frames apart; ATE within max(1 mm, 20%) of JAX's, and
unaligned under 80 mm (the JAX package's own bound)."""
import numpy as np
import pytest

from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch import config as TC
from slam_dynamic_tpu_torch.frontend import tracking as ttracking
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from torch_port_util import decisions, dynamic_configs, dynamic_world, \
    first_status, first_status_difference, run_dynamic

N_FRAMES = 31


@pytest.fixture(scope="module")
def world():
    return dynamic_world("static_box", N_FRAMES)


@pytest.fixture(scope="module")
def runs(world):
    jcfg, tcfg = dynamic_configs(world[0], classify_every=2)
    js = JSystem(jcfg)
    forms = []
    orig = ttracking.fused_track_step_dyn

    def spy(*args, **kw):
        forms.append(kw["classify"])
        return orig(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttracking, "fused_track_step_dyn", spy)
        port = run_dynamic(System(tcfg, device="cpu"), world, N_FRAMES, 1)
    port["forms"] = forms
    return {"jax": run_dynamic(js, world, N_FRAMES, 1), "port": port}


def test_dynamic_frame_states_and_keyframes_match_jax(runs):
    dj, dt = decisions(runs["jax"]), decisions(runs["port"])
    assert [d[0] for d in dt] == [d[0] for d in dj] == list(range(N_FRAMES))
    assert all(d[1] == "OK" for d in dj + dt)
    upto = first_status_difference(runs["jax"], runs["port"])
    assert dt[:upto] == dj[:upto]


def test_false_box_reclassified_static_like_jax(runs):
    for name in ("jax", "port"):
        status = runs[name]["system"].boxes.status
        assert len(status) >= 1 and (status == 1).all(), (name, status)
    assert abs(first_status(runs["port"], 1)
               - first_status(runs["jax"], 1)) <= 2


def test_dynamic_frame_ate_tracks_jax(runs, world):
    gt = world[1].t_wc[:N_FRAMES]
    ate_j = jate(runs["jax"]["est"], gt)
    ate_t = ate_rmse(runs["port"]["est"], gt)
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_rmse(runs["port"]["est"], gt, align=False) < 0.08


def test_both_classify_forms_dispatched(runs):
    """Every tracked frame after the first runs the dynamic step, the
    classifying form on even frames, the light one on odd frames; verdicts
    come back only from the classifying form."""
    forms = runs["port"]["forms"]
    assert forms == [f % 2 == 0 for f in range(1, N_FRAMES)]
    tracker = runs["port"]["system"].tracker
    assert tracker.packet_reads == tracker.dispatches == N_FRAMES - 1
    for s in runs["port"]["stats"][1:]:
        assert s.verdicts is not None and s.box3d.shape == (16, 16)
        if s.frame_id % 2:
            assert not s.verdicts.any()


def test_default_config_constructs_and_unported_parts_raise(world):
    system = System(TC.SystemConfig(), device="cpu")
    assert system.dynamics is not None
    assert system.cfg.detector.mode == "precomputed"
    # the online detector is ported (item 18): its System builds the
    # CenterNet with the shipped weights
    online = System(TC.SystemConfig(detector=TC.DetectorConfig(
        mode="online")), device="cpu")
    assert online.detector is not None and online.detector.n_classes == 8
    # stereo and mono are ported (item 17): their default configs build
    for sensor in ("stereo", "mono"):
        s = System(TC.SystemConfig(sensor=sensor), device="cpu")
        assert s.tracker.stereo_obs == (sensor == "stereo")
    # the post-loop global BA (item 20a), strided depth (item 20b) and the
    # adaptive pipeline depth (item 22) are ported: their Systems build
    assert System(TC.SystemConfig(loop=TC.LoopConfig(run_global_ba=True)),
                  device="cpu")._gba is None
    assert System(TC.SystemConfig(tracking=TC.TrackingConfig(
        depth_stride=2)), device="cpu").tracker.state == "NOT_INITIALIZED"
    assert System(TC.SystemConfig(tracking=TC.TrackingConfig(
        adaptive_pipeline=True)), device="cpu").tracker._adaptive_depth()
    # the mask= path is ported: a frame builds on the host and initializes
    scfg, seq, gray8, depth16 = world
    tcfg = dynamic_configs(scfg)[1]
    st = System(tcfg, device="cpu").track_rgbd(
        gray8[0], depth16[0], 0.0, mask=np.zeros(gray8[0].shape, bool))
    assert st.state == "OK" and st.is_keyframe
