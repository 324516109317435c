"""Localization-only mode (``System.activate_localization_mode``, the
reference's ActivateLocalizationMode) and its VO mode (the reference's
mbVO dual hypothesis) against the JAX System, on the 320x240 RGB-D world
of ``tests/test_e2e_slam.py:164-252``.

One run per package, 24 frames: 6 mapping, 6 in localization-only mode,
6 more there with the VO threshold out of reach (every other frame is
then relocalized against the frozen map and its pose preferred), 6
mapping again, a keyframe at least every 3 frames. Then a young map (at
most 5 keyframes) fed frames of another world: in localization-only mode
it stays LOST and is never reset, and a relocalization corrects no
drift; out of it, it is reset.

Tolerances: the same states, keyframe decisions, keyframe counts and VO
flags frame by frame, the same relocalization count; the map frozen
(keyframe poses and landmarks unchanged) while localizing; ATE within
max(1 mm, 20%) of JAX's, unaligned under 0.06 m (the JAX VO test's
bound).
"""
import dataclasses

import numpy as np
import pytest

from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.system import System
from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
from torch_port_util import SMALL, configs, small_world, to_t, \
    with_tracking

N = 24
LOCALIZE, VO, MAP_AGAIN = 6, 12, 18


def _np(x):
    return to_t(x).numpy() if not hasattr(x, "cpu") else x.cpu().numpy()


def _count_calls(tracker, hook):
    calls = []
    orig = getattr(tracker, hook)

    def counting(*args):
        calls.append(args)
        return orig(*args)
    setattr(tracker, hook, counting)
    return calls


def _run(system, world):
    _, seq, gray8, depth16 = world
    relocs = _count_calls(system.tracker, "relocalizer")
    rows, frozen = [], {}
    for i in range(N):
        if i == LOCALIZE:
            system.activate_localization_mode()
            m = system.tracker.map
            frozen["before"] = [_np(a) for a in (m.kf_R, m.kf_t, m.lm_pos,
                                                 m.n_lm)]
        if i == VO:
            system.cfg = system.cfg.replace(tracking=dataclasses.replace(
                system.cfg.tracking, vo_mode_inliers=10_000))
            system.tracker.cfg = system.cfg
        if i == MAP_AGAIN:
            m = system.tracker.map
            frozen["after"] = [_np(a) for a in (m.kf_R, m.kf_t, m.lm_pos,
                                                m.n_lm)]
            system.deactivate_localization_mode()
        st = system.track_rgbd(gray8[i], depth16[i], float(seq.timestamps[i]))
        rows.append((i, st.state, st.is_keyframe, system.tracker.n_kf_host,
                     len(relocs), system.tracker.vo_mode))
    est = np.stack([-R.T @ t for _, R, t in system.trajectory])
    return dict(rows=rows, est=est, frozen=frozen)


@pytest.fixture(scope="module")
def world():
    return small_world(N)


@pytest.fixture(scope="module")
def runs(world):
    jcfg, tcfg = (with_tracking(c, max_frames_between_kf=3)
                  for c in configs(world[0]))
    return {"jax": _run(JSystem(jcfg), world),
            "port": _run(System(tcfg, device="cpu"), world)}


def test_localization_only_mode_matches_jax(runs):
    rj, rt = runs["jax"]["rows"], runs["port"]["rows"]
    assert rt == rj
    n_kf = rt[LOCALIZE - 1][3]
    for i, state, is_kf, kfs, _, _ in rt[LOCALIZE:MAP_AGAIN]:
        assert state == "OK" and not is_kf and kfs == n_kf, i
    assert rt[-1][3] > n_kf                     # mapping resumed


def test_localization_only_mode_freezes_the_map(runs):
    before, after = (runs["port"]["frozen"][k] for k in ("before", "after"))
    for a, b in zip(before, after):
        np.testing.assert_array_equal(b, a)


def test_vo_mode_dual_hypothesis_matches_jax(runs):
    """In VO mode every other frame is relocalized and the relocalized pose
    preferred (a success clears VO mode; the unreachable threshold sets it
    again); before it, no frame was relocalized."""
    rt = runs["port"]["rows"]
    assert rt[VO - 1][4] == 0
    assert rt[MAP_AGAIN - 1][4] - rt[VO - 1][4] >= 3
    assert [r[5] for r in rt] == [r[5] for r in runs["jax"]["rows"]]


def test_localization_ate_tracks_jax(runs, world):
    seq = world[1]
    ej, et = runs["jax"]["est"], runs["port"]["est"]
    ate_j = jate(ej, seq.t_wc[:len(ej)])
    ate_t = ate_rmse(et, seq.t_wc[:len(et)])
    assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (ate_t, ate_j)
    assert ate_rmse(et, seq.t_wc[:len(et)], align=False) < 0.06


def _young_map_run(make, cfg, world, alien):
    """5 frames mapped, then in localization-only mode two frames of
    another world (LOST, no reset) and the world's next frame
    (relocalized, no drift correction); out of it, two alien frames
    (reset)."""
    _, seq, gray8, depth16 = world
    system = make(cfg)
    corrections = _count_calls(system.tracker, "on_reloc")
    ts = [float(t) for t in seq.timestamps]
    states = [system.track_rgbd(gray8[i], depth16[i], ts[i]).state
              for i in range(5)]
    n_kf = system.tracker.n_kf_host
    system.activate_localization_mode()
    for j, i in ((0, 5), (1, 6)):
        states.append(system.track_rgbd(alien[0][j], alien[1][j],
                                        ts[i]).state)
    states.append(system.track_rgbd(gray8[7], depth16[7], ts[7]).state)
    kept = (system.tracker.n_kf_host, len(corrections))
    system.deactivate_localization_mode()
    for j, i in ((2, 8), (3, 9)):
        states.append(system.track_rgbd(alien[0][j], alien[1][j],
                                        ts[i]).state)
    return states, n_kf, kept


def test_localization_mode_never_resets_a_young_map(runs, world):
    alien_seq = generate(SynthConfig(**{**SMALL, "n_frames": 4}, seed=11,
                                     trajectory="orbit"))
    alien = (np.clip(alien_seq.gray[::-1], 0, 255).astype(np.uint8),
             np.clip(alien_seq.depth[::-1] * 1000.0, 0, 65535)
             .astype(np.uint16))
    jcfg, tcfg = configs(world[0])
    sj = _young_map_run(JSystem, jcfg, world, alien)
    st = _young_map_run(lambda c: System(c, device="cpu"), tcfg, world,
                            alien)
    assert st == sj
    states, n_kf, (kfs, n_corrections) = st
    assert n_kf <= 5 and kfs == n_kf and n_corrections == 0
    assert states[5:7] == ["LOST", "LOST"], states
    assert states[7] == "OK", states
    assert "NOT_INITIALIZED" in states[8:], states
