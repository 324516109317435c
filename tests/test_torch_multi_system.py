"""Batched serving in the port (``parallel/multi_system.py``, the batched
fused steps and the lane axis of kernels K1 and K2) against the JAX
package, JAX on the CPU and the port with CPU tensors, on the scenarios of
``tests/test_multi_system.py`` (two lanes of its 256x192 world, 500 ORB
features, its capacities).

Tolerances, each with its reason:
- the scatter helpers and the batched K1 and K2 (plain, and the custom ops
  under ``torch.func.vmap``): bit-equal, with the old in-place forms, the
  per-lane loop and JAX's ``vmap`` of the Pallas kernels in interpret
  mode (integer results; K1's index where a pair passed, as
  ``tests/test_torch_kernels.py`` holds it);
- the batched steps from a JAX MultiSystem's stacked map carried across
  by ``convert.py``: against the port's one-lane step on each lane's
  inputs, equal counts and poses within 1e-4 (batched float32 sums in
  another order: 1e-5 after a chunk's three chained frames); against
  JAX's, n_map equal on the frames whose
  descriptors are equal in both packages (the extractions differ in
  about one descriptor in 1000, ROADMAP Queue 3) and n_mm within 1% there
  (JAX's CPU motion-model pass gates the radius in the expanded form
  |a|^2 + |b|^2 - 2 a.b, K1 and its plain version in the direct one, so a
  keypoint on the radius edge can flip: 1 or 2 of 300 here, in the
  one-lane step too), poses within 1e-4;
- the MultiSystem against two independent port Systems on the same
  frames: the same states and keyframe frames, camera centres within
  1 mm (the batched ops reduce in another order than one lane's, and the
  difference grows over the frames: 0.1 mm after 10 frames here);
- against JAX's MultiSystem on ``test_multi_system_chunked``'s scenario:
  ATE within max(1 mm, 20%) of JAX's and the same keyframe count per
  lane;
- the pipelined, stereo and chunked cold-start scenarios under the JAX
  tests' own bounds;
- ``mesh=`` (2 lanes over a 2-entry "dp" mesh, one lane per group): the
  unsharded MultiSystem's decisions and camera centres within 1 mm, per
  frame and chunked; a group equals a MultiSystem of its lanes bit for
  bit.
"""
import argparse
import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_dynamic_tpu import config as JC
from slam_dynamic_tpu.frontend import fused as jfused
from slam_dynamic_tpu.io.evo import ate_rmse as jate
from slam_dynamic_tpu.ops.pallas_hamming import hamming_matrix_pallas
from slam_dynamic_tpu.ops.pallas_match import gated_match_pallas
from slam_dynamic_tpu.parallel.multi_system import MultiSystem as JMulti
from slam_dynamic_tpu_torch import bench
from slam_dynamic_tpu_torch import config as TC
from slam_dynamic_tpu_torch.convert import (lane_maps_from_numpy,
                                            map_state_from_numpy)
from slam_dynamic_tpu_torch.frontend import fused as tfused
from slam_dynamic_tpu_torch.io.evo import ate_rmse
from slam_dynamic_tpu_torch.io.synthetic import SynthConfig, generate
from slam_dynamic_tpu_torch.kernel_bench import k1_problem
from slam_dynamic_tpu_torch.ops import gated_match as gm
from slam_dynamic_tpu_torch.ops import hamming as hm
from slam_dynamic_tpu_torch.parallel.mesh import make_mesh
from slam_dynamic_tpu_torch.parallel.multi_system import MultiSystem
from slam_dynamic_tpu_torch.system import System
from slam_dynamic_tpu_torch.utils import scatter
from torch_port_util import map_arrays, to_t

BASE = dict(n_frames=18, width=256, height=192, fx=210.0, fy=210.0,
            cx=127.5, cy=95.5)
T = BASE["n_frames"]
C = 3
INVALID = 1 << 15


def _cfg(Cm, scfg, sensor="rgbd"):
    """``test_multi_system.py``'s config in either package (``Cm``)."""
    return Cm.SystemConfig(
        camera=Cm.CameraConfig(fx=scfg.fx, fy=scfg.fy, cx=scfg.cx,
                               cy=scfg.cy, bf=scfg.fx * scfg.baseline,
                               width=scfg.width, height=scfg.height,
                               th_depth=120.0, fps=scfg.fps),
        orb=Cm.ORBConfig(n_features=500),
        detector=Cm.DetectorConfig(mode="off"),
        capacity=Cm.CapacityConfig(
            max_keyframes=16, max_landmarks=4096, max_keypoints=512,
            local_ba_keyframes=8, local_ba_landmarks=1024),
        sensor=sensor)


def _est(traj):
    return np.stack([-R.T @ t for _, R, t in traj])


def _lanes(stereo=False):
    return [generate(SynthConfig(**BASE, seed=s, stereo=stereo))
            for s in (0, 3)]


def _frame(seqs, i, stereo=False):
    return ([q.gray[i] for q in seqs],
            [(q.right if stereo else q.depth)[i] for q in seqs],
            [float(q.timestamps[i]) for q in seqs])


def _chunk(seqs, i):
    return ([[q.gray[i + j] for j in range(C)] for q in seqs],
            [[q.depth[i + j] for j in range(C)] for q in seqs],
            [[float(q.timestamps[i + j]) for j in range(C)] for q in seqs])


@pytest.fixture(scope="module")
def seqs():
    return _lanes()


def _chunked_scenario(ms, seqs):
    """``test_multi_system_chunked``: per-frame batches until every lane is
    OK (at most 4 frames), then chunks of C, then the flush. Returns
    (stats, frames fed)."""
    i, sts = 0, []
    while any(s.tracker.state != "OK" for s in ms.systems) and i < 4:
        sts += [s for s in ms.track_rgbd_batch(*_frame(seqs, i)) if s]
        i += 1
    while i + C <= T:
        sts += ms.track_rgbd_chunk_batch(*_chunk(seqs, i))
        i += C
    sts += ms.flush() or []
    return sts, i


@pytest.fixture(scope="module")
def jax_chunked(seqs):
    """The JAX MultiSystem on the chunked scenario, with the inputs and
    outputs of its first batched chunk kept, and JAX's batched per-frame
    step on that chunk's first frame."""
    cap = {}
    orig = jfused.fused_track_chunk_batch

    def spy(m, cam, bounds, g, d, bx, ba, *chain, **kw):
        outs, packed = orig(m, cam, bounds, g, d, bx, ba, *chain, **kw)
        if not cap:
            cap.update(args=(m, cam, bounds, g, d, bx, ba, chain, kw),
                       maps=map_arrays(m), g=np.array(g),
                       d=np.array(d),
                       chain=[np.asarray(x) for x in chain],
                       desc=[np.asarray(o.fd.desc) for o in outs],
                       packed=np.asarray(packed))
        return outs, packed

    ms = JMulti(_cfg(JC, SynthConfig(**BASE)), n=2, pipeline=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused, "fused_track_chunk_batch", spy)
        stats, i = _chunked_scenario(ms, seqs)
    m, cam, bounds, g, d, bx, ba, chain, kw = cap["args"]
    kw = {k: v for k, v in kw.items() if k != "chunk"}
    one = jfused.fused_track_step_batch(m, cam, bounds, g[:, 0], d[:, 0],
                                        bx[:, 0], ba[:, 0], *chain, **kw)
    cap["step"] = dict(desc=np.asarray(one.fd.desc),
                       packed=np.asarray(one.packed))
    return dict(ms=ms, stats=stats, fed=i, cap=cap,
                traj=[ms.systems[b].trajectory for b in range(2)],
                kf=[ms.systems[b].tracker.kf_seq for b in range(2)])


@pytest.fixture(scope="module")
def port_chunked(seqs):
    ms = MultiSystem(_cfg(TC, SynthConfig(**BASE)), 2, pipeline=True,
                     device="cpu")
    stats, i = _chunked_scenario(ms, seqs)
    return dict(ms=ms, stats=stats, fed=i,
                traj=[ms.systems[b].trajectory for b in range(2)],
                kf=[ms.systems[b].tracker.kf_seq for b in range(2)])


@pytest.fixture(scope="module")
def independent(seqs):
    """``test_multi_system_matches_independent``: the batched lanes and two
    independent port Systems on the same frames."""
    cfg = _cfg(TC, SynthConfig(**BASE))
    solo = []
    for q in seqs:
        s = System(cfg, device="cpu")
        st = [s.track_rgbd(q.gray[i], q.depth[i], float(q.timestamps[i]))
              for i in range(T)]
        solo.append((st, _est(s.trajectory)))
    ms = MultiSystem(cfg, 2, device="cpu")
    rows = [ms.track_rgbd_batch(*_frame(seqs, i)) for i in range(T)]
    return dict(ms=ms, solo=solo, rows=rows,
                steps=(ms.dispatches, ms.packet_reads),
                est=[_est(ms.systems[b].trajectory) for b in range(2)])


# --- the scatter helpers -----------------------------------------------

def _old_set_last(base, idx, vals):
    idx = idx.long()
    pos = torch.arange(idx.shape[0])
    winner = torch.full((base.shape[0],), -1, dtype=torch.long)
    winner = winner.scatter_reduce(0, idx, pos, "amax")
    out = base.clone()
    out[idx] = vals[winner[idx]]
    return out


def _old_count_at(n, idx, weights):
    return torch.zeros(n, dtype=torch.int32).index_add_(
        0, idx.long(), weights.to(torch.int32))


def _old_mark(n, idx):
    out = torch.zeros(n, dtype=torch.bool)
    out[idx.long()] = True
    return out


def _old_nonzero_fixed(mask, size, fill):
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64)
    out[dst] = torch.arange(mask.shape[0])
    return out[:size]


def _scatter_inputs(rng, lanes=3, n=64, k=200):
    """Per lane: a base [n, 3], k indices into n (many duplicates), their
    values and weights, and a mask [k]."""
    return (torch.from_numpy(rng.normal(size=(lanes, n, 3)).astype(
                np.float32)),
            torch.from_numpy(rng.integers(0, n, (lanes, k))),
            torch.from_numpy(rng.normal(size=(lanes, k, 3)).astype(
                np.float32)),
            torch.from_numpy(rng.integers(-2, 5, (lanes, k)).astype(
                np.int32)),
            torch.from_numpy(rng.uniform(size=(lanes, k)) < 0.3))


def _helpers(n=64, size=40):
    return {
        "set_last": (scatter.set_last, _old_set_last,
                     lambda a: (a[0], a[1], a[2])),
        "count_at": (functools.partial(scatter.count_at, n),
                     functools.partial(_old_count_at, n),
                     lambda a: (a[1], a[3])),
        "mark": (functools.partial(scatter.mark, n),
                 functools.partial(_old_mark, n), lambda a: (a[1],)),
        "nonzero_fixed": (
            lambda m: scatter.nonzero_fixed(m, size, n),
            lambda m: _old_nonzero_fixed(m, size, n), lambda a: (a[4],)),
    }


@pytest.mark.parametrize("name", ["set_last", "count_at", "mark",
                                  "nonzero_fixed"])
def test_scatter_helpers_equal_old_forms_and_vmap(name):
    """Out of place, every helper equals its old in-place form lane by
    lane (set-last-wins on duplicates), and under vmap the per-lane
    loop."""
    new, old, pick = _helpers()[name]
    args = pick(_scatter_inputs(np.random.default_rng(5)))
    loop = [new(*(a[b] for a in args)) for b in range(args[0].shape[0])]
    for b, got in enumerate(loop):
        assert torch.equal(got, old(*(a[b] for a in args)))
    assert torch.equal(torch.func.vmap(new)(*args), torch.stack(loop))


# --- the batched K1 and K2 ---------------------------------------------

def _jax_vmap_k1(per, lvl_min=-1, lvl_max=1):
    f = jax.vmap(functools.partial(gated_match_pallas, lvl_min=lvl_min,
                                   lvl_max=lvl_max, interpret=True))
    return f(*[jnp.asarray(np.stack(x)) for x in zip(*per)])


def _check_k1(ref, got):
    (ij, bj, sj), (it, bt, st) = ref, got
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    has = np.asarray(bj) < INVALID
    np.testing.assert_array_equal(it.numpy()[has], np.asarray(ij)[has])


@pytest.mark.parametrize("lanes,n,m,dup,window", [
    (3, 300, 700, 0.1, (-1, 1)), (2, 256, 512, 0.3, (-7, 7)),
    (4, 64, 64, 0.0, (0, 0))])
def test_batched_k1_equals_jax_vmapped_pallas(lanes, n, m, dup, window):
    rng = np.random.default_rng(n + m + lanes)
    per = [k1_problem(rng, n, m, dup) for _ in range(lanes)]
    ref = _jax_vmap_k1(per, *window)
    args = [torch.from_numpy(np.stack(x)) for x in zip(*per)]
    lo, hi = window
    _check_k1(ref, gm.gated_match_batched(*args, lvl_min=lo, lvl_max=hi))
    vm = torch.func.vmap(functools.partial(gm.gated_match, lvl_min=lo,
                                           lvl_max=hi))(*args)
    _check_k1(ref, vm)


def test_batched_k1_shared_landmarks_under_vmap():
    """An argument the vmap does not batch (one landmark set for every
    lane) is shared by the lanes."""
    rng = np.random.default_rng(11)
    per = [k1_problem(rng, 200, 300, 0.2) for _ in range(3)]
    for p in per[1:]:
        p[4:] = per[0][4:]
    args = [torch.from_numpy(np.stack(x)) for x in zip(*per)]
    shared = [a[0] for a in args[4:]]
    vm = torch.func.vmap(gm.gated_match, in_dims=(0,) * 4 + (None,) * 5)(
        *args[:4], *shared)
    _check_k1(_jax_vmap_k1(per), vm)


@pytest.mark.parametrize("lanes,n,m", [(2, 1000, 1000), (3, 300, 170),
                                       (2, 1, 1)])
def test_batched_k2_equals_jax_vmapped_pallas(lanes, n, m):
    rng = np.random.default_rng(n * m + lanes)
    a = rng.integers(0, 2**32, (lanes, n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (lanes, m, 8), dtype=np.uint32)
    b[:, :min(n, m) // 2] = a[:, :min(n, m) // 2]       # zero distances
    ref = np.asarray(jax.vmap(functools.partial(
        hamming_matrix_pallas, interpret=True))(jnp.asarray(a),
                                                jnp.asarray(b)))
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    np.testing.assert_array_equal(hm.hamming_matrix_batched(ta, tb).numpy(),
                                  ref)
    np.testing.assert_array_equal(
        torch.func.vmap(hm.hamming_matrix)(ta, tb).numpy(), ref)


# --- the batched fused steps -------------------------------------------

def _port_inputs(cap):
    """The captured JAX chunk's inputs as the port's: the stacked map
    through convert.py, the chain and the images."""
    tracker = System(_cfg(TC, SynthConfig(**BASE)), device="cpu").tracker
    maps = map_state_from_numpy(cap["maps"], "cpu")
    chain = [to_t(x) for x in cap["chain"]]
    chain[-1] = chain[-1].long()
    dc = tracker._scalar_consts()
    return tracker, maps, chain, dc


def _check_packets(packed_t, packed_j, desc_t, desc_j):
    """Where the frame's descriptors are equal: n_map equal, n_mm within
    1%; poses within 1e-4. Returns how many frames had equal
    descriptors."""
    n_equal = 0
    for b in range(packed_j.shape[0]):
        same = np.array_equal(desc_t[b], desc_j[b].view(np.int32))
        n_equal += same
        if same:
            assert packed_t[b, 1] == packed_j[b, 1], (b, packed_t[b, :2],
                                                      packed_j[b, :2])
            assert abs(packed_t[b, 0] - packed_j[b, 0]) \
                <= 0.01 * packed_j[b, 0], (b, packed_t[b, :2],
                                           packed_j[b, :2])
        np.testing.assert_allclose(packed_t[b, 4:16], packed_j[b, 4:16],
                                   atol=1e-4)
    return n_equal


def _lane(tree, b):
    return type(tree)(*[x[b] for x in tree])


def _check_one_lane(packed_batch, packed_one):
    """A lane of the batched step against the one-lane step: the same
    counts, poses within 1e-4."""
    np.testing.assert_array_equal(packed_batch[..., :4], packed_one[..., :4])
    np.testing.assert_allclose(packed_batch, packed_one, atol=1e-4)


def test_fused_track_chunk_batch_matches_jax(jax_chunked):
    cap = jax_chunked["cap"]
    tracker, maps, chain, dc = _port_inputs(cap)
    bx = dc["bx_empty"].expand(2, C, -1, -1)
    ba = dc["ba_empty"].expand(2, C, -1)
    outs, packed = tfused.fused_track_chunk_batch(
        maps, tracker.cam, tracker.bounds, torch.from_numpy(cap["g"]),
        torch.from_numpy(cap["d"]), bx, ba, *chain,
        **tracker._track_kwargs())
    assert tuple(packed.shape) == (2, C, 28)
    n_equal = sum(_check_packets(packed[:, j].numpy(),
                                 cap["packed"][:, j],
                                 outs[j].fd.desc.numpy(), cap["desc"][j])
                  for j in range(C))
    assert n_equal >= C, n_equal
    for b in range(2):
        _, one = tfused.fused_track_chunk(
            _lane(maps, b), tracker.cam, tracker.bounds,
            torch.from_numpy(cap["g"][b]), torch.from_numpy(cap["d"][b]),
            bx[b], ba[b], *(c[b] for c in chain), **tracker._track_kwargs())
        _check_one_lane(packed[b].numpy(), one.numpy())


def test_fused_track_step_batch_matches_jax(jax_chunked):
    cap = jax_chunked["cap"]
    tracker, maps, chain, dc = _port_inputs(cap)
    out = tfused.fused_track_step_batch(
        maps, tracker.cam, tracker.bounds, torch.from_numpy(cap["g"][:, 0]),
        torch.from_numpy(cap["d"][:, 0]), dc["bx_empty"].expand(2, -1, -1),
        dc["ba_empty"].expand(2, -1), *chain, **tracker._track_kwargs())
    assert tuple(out.packed.shape) == (2, 28)
    assert _check_packets(out.packed.numpy(), cap["step"]["packed"],
                          out.fd.desc.numpy(), cap["step"]["desc"]) >= 1
    for b in range(2):
        one = tfused.fused_track_step(
            _lane(maps, b), tracker.cam, tracker.bounds,
            torch.from_numpy(cap["g"][b, 0]), torch.from_numpy(cap["d"][b, 0]),
            dc["bx_empty"], dc["ba_empty"], *(c[b] for c in chain),
            **tracker._track_kwargs())
        _check_one_lane(out.packed[b].numpy(), one.packed.numpy())


# --- MultiSystem ---------------------------------------------------------

def test_multi_system_matches_independent_port_systems(independent, seqs):
    for b, q in enumerate(seqs):
        solo_stats, solo_est = independent["solo"][b]
        lane = [row[b] for row in independent["rows"]]
        assert [s.state for s in lane] == [s.state for s in solo_stats]
        assert [s.is_keyframe for s in lane] == \
            [s.is_keyframe for s in solo_stats]
        est = independent["est"][b]
        assert est.shape == (T, 3)
        np.testing.assert_allclose(est, solo_est, atol=1e-3)
        ate_batch = ate_rmse(est, q.t_wc[:T], align=False)
        ate_ref = ate_rmse(solo_est, q.t_wc[:T], align=False)
        assert ate_batch < max(0.06, 2.0 * ate_ref), (ate_batch, ate_ref)
        tr = independent["ms"].systems[b].tracker
        assert tr.state == "OK" and tr.n_kf_host >= 2
    assert independent["steps"] == (T - 1, T - 1)


def test_multi_system_chunked_matches_jax(jax_chunked, port_chunked, seqs):
    """``test_multi_system_chunked``'s scenario in both packages."""
    assert port_chunked["fed"] == jax_chunked["fed"]
    assert port_chunked["kf"] == jax_chunked["kf"]
    for b, q in enumerate(seqs):
        est_t, est_j = _est(port_chunked["traj"][b]), \
            _est(jax_chunked["traj"][b])
        assert est_t.shape == est_j.shape
        ate_t = ate_rmse(est_t, q.t_wc[:len(est_t)], align=False)
        ate_j = jate(est_j, q.t_wc[:len(est_j)], align=False)
        assert abs(ate_t - ate_j) <= max(1e-3, 0.2 * ate_j), (b, ate_t,
                                                              ate_j)
        # the JAX test's own bounds
        assert ate_t < 0.06
        tr = port_chunked["ms"].systems[b].tracker
        assert tr.state == "OK" and tr.n_kf_host >= 2
        ts = [t for t, _, _ in port_chunked["traj"][b]]
        assert ts == sorted(ts) and len(ts) == len(set(ts))
        assert len(ts) >= port_chunked["fed"] - C
    ms = port_chunked["ms"]
    assert ms.dispatches == ms.packet_reads


def test_multi_system_pipelined(seqs):
    """``test_multi_system_pipelined``: one step in flight."""
    ms = MultiSystem(_cfg(TC, SynthConfig(**BASE)), 2, pipeline=True,
                     device="cpu")
    for i in range(T):
        ms.track_rgbd_batch(*_frame(seqs, i))
    ms.flush()
    for b, q in enumerate(seqs):
        est = _est(ms.systems[b].trajectory)
        assert len(est) == T
        assert ate_rmse(est, q.t_wc[:T], align=False) < 0.08
        assert ms.systems[b].tracker.state == "OK"


def test_multi_system_stereo_batch():
    """``test_multi_system_stereo_batch``: stereo pairs per lane; the
    stereo matcher's Hamming matrices go through K2's vmap rule, one
    batched call per step."""
    seqs = _lanes(stereo=True)
    cfg = _cfg(TC, SynthConfig(**BASE, stereo=True), sensor="stereo")
    ms = MultiSystem(cfg, 2, device="cpu")
    calls = []
    orig = hm.hamming_matrix_batched

    def spy(a, b):
        calls.append(tuple(a.shape))
        return orig(a, b)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hm, "hamming_matrix_batched", spy)
        for i in range(T):
            ms.track_stereo_batch(*_frame(seqs, i, stereo=True))
    assert ms.dispatches == T - 1 and len(calls) == T - 1
    assert calls[0][0] == 2
    for b, q in enumerate(seqs):
        est = _est(ms.systems[b].trajectory)
        assert len(est) == T
        assert ate_rmse(est, q.t_wc[:T], align=False) < 0.2
        assert ms.systems[b].tracker.state == "OK"


def test_multi_system_chunked_cold_start(seqs):
    """``test_multi_system_chunked_cold_start``: chunks from frame 0 with
    no per-frame bootstrap; the first chunk falls back to per-frame
    batches, whose step in flight the first real chunk finalizes."""
    ms = MultiSystem(_cfg(TC, SynthConfig(**BASE)), 2, pipeline=True,
                     device="cpu")
    i, n_stats = 0, 0
    while i + C <= T:
        sts = ms.track_rgbd_chunk_batch(*_chunk(seqs, i))
        assert all(hasattr(st, "state") for st in sts), sts
        n_stats += len(sts)
        i += C
    ms.flush()
    assert n_stats > 0
    for b, q in enumerate(seqs):
        assert ms.systems[b].tracker.state == "OK"
        est = _est(ms.systems[b].trajectory)
        assert ate_rmse(est, q.t_wc[:len(est)], align=False) < 0.06


def _decisions(sts):
    return [(s.state, s.n_inliers_mm, s.n_inliers_map, s.is_keyframe)
            for s in sts]


def test_mesh_raises_for_item_20c(seqs, independent):
    """Item 20c is ported, and ``mesh=`` no longer raises: 2 lanes over a
    2-entry "dp" mesh build one lane group per entry, each with its own
    stacked map, and track per frame with the unsharded MultiSystem's
    states, inlier counts and keyframe decisions, camera centres within
    1 mm (a group of one lane reduces in another order than a batch of
    two, as a solo System does). A group is a MultiSystem of its own
    lanes: over its first 8 frames lane 0 equals a one-lane MultiSystem
    bit for bit, decisions and packet poses."""
    cfg = _cfg(TC, SynthConfig(**BASE))
    ms = MultiSystem(cfg, 2, mesh=make_mesh(2, "dp",
                                            devices=["cpu", "cpu"]))
    assert [g.lanes for g in ms.groups] == [range(0, 1), range(1, 2)]
    assert all(g.maps.kf_R.shape[0] == 1 for g in ms.groups)
    rows = [ms.track_rgbd_batch(*_frame(seqs, i)) for i in range(T)]
    one = MultiSystem(cfg, 1, device="cpu")
    rows1 = [one.track_rgbd_batch(*[x[:1] for x in _frame(seqs, i)])[0]
             for i in range(8)]
    for b in range(2):
        assert _decisions([r[b] for r in rows]) == \
            _decisions([r[b] for r in independent["rows"]])
        np.testing.assert_allclose(_est(ms.systems[b].trajectory),
                                   independent["est"][b], atol=1e-3)
    lane0 = [r[0] for r in rows[:8]]
    assert _decisions(lane0) == _decisions(rows1)
    for a, b in zip(lane0[1:], rows1[1:]):
        np.testing.assert_array_equal(a.np_R, b.np_R)
        np.testing.assert_array_equal(a.np_t, b.np_t)
    # each call queues every group's step, then reads every packet
    assert ms.dispatches == ms.packet_reads == 2 * (T - 1)


def test_mesh_multi_system_chunked(seqs, port_chunked):
    """The chunked scenario (``test_multi_system_chunked``) on the 2-entry
    mesh, one chunk in flight: the unsharded run's stats, keyframe
    counts and frames fed, camera centres within 1 mm."""
    ms = MultiSystem(_cfg(TC, SynthConfig(**BASE)), 2, pipeline=True,
                     mesh=make_mesh(2, "dp", devices=["cpu", "cpu"]))
    stats, fed = _chunked_scenario(ms, seqs)
    assert fed == port_chunked["fed"]
    assert _decisions(stats) == _decisions(port_chunked["stats"])
    assert [s.tracker.kf_seq for s in ms.systems] == port_chunked["kf"]
    for b in range(2):
        np.testing.assert_allclose(_est(ms.systems[b].trajectory),
                                   _est(port_chunked["traj"][b]), atol=1e-3)
    assert ms.dispatches == ms.packet_reads


def test_lane_maps_carried_from_jax(jax_chunked):
    """convert.py carries a JAX MultiSystem's stacked map lane by lane:
    each lane's map equals the stack's row."""
    arrays = map_arrays(jax_chunked["ms"].maps)
    stack = map_state_from_numpy(arrays, "cpu")
    lanes = lane_maps_from_numpy(arrays, "cpu")
    assert len(lanes) == 2
    for b, m in enumerate(lanes):
        for name, full, one in zip(m._fields, stack, m):
            assert torch.equal(full[b], one), name
    assert int(lanes[0].n_kf) == jax_chunked["kf"][0]


def _vo_lane(ms):
    """Lane 0 in localization-only VO mode (its relocalizer counted),
    tracked one more step; returns the relocalizer's results."""
    sys0 = ms.systems[0]
    sys0.activate_localization_mode()
    sys0.tracker.vo_mode = True
    results = []
    orig = sys0.tracker.relocalizer

    def counted(frame):
        results.append(orig(frame))
        return results[-1]
    sys0.tracker.relocalizer = counted
    return results


def test_localization_only_lane_relocalizes(independent, seqs):
    """A localization-only lane in VO mode relocalizes each tracked frame
    and prefers the relocalized pose. Its relocalizer returns five values
    and the lane takes the first four, as the Tracker does: the JAX
    MultiSystem unpacks four of them and raises (a difference by design,
    ROADMAP Queue 3)."""
    ms = independent["ms"]
    results = _vo_lane(ms)
    n_kf = ms.systems[0].tracker.kf_seq
    st = ms.track_rgbd_batch(*_frame(seqs, T - 1))
    assert len(results) == 1 and len(results[0]) == 5
    assert results[0][0], "the lane did not relocalize"
    assert st[0].state == "OK" and not st[0].is_keyframe
    assert ms.systems[0].tracker.kf_seq == n_kf
    np.testing.assert_allclose(st[0].np_R, results[0][1].numpy())
    assert not ms.systems[0].tracker.vo_mode


def test_jax_localization_only_lane_raises(jax_chunked, seqs):
    """The JAX MultiSystem on the same event: a relocalizer of five values
    (the System's) makes its lane raise."""
    ms = jax_chunked["ms"]
    sys0 = ms.systems[0]
    sys0.tracker.localization_only = True
    sys0.tracker.vo_mode = True
    sys0.tracker.relocalizer = lambda frame: (False, None, None, None, -1)
    i = jax_chunked["fed"] - C
    ms.track_rgbd_chunk_batch(*_chunk(seqs, i))
    with pytest.raises(ValueError, match="too many values"):
        ms.flush()


# --- bench --multi and the bench flags -----------------------------------

def test_bench_multi_cpu_prints_json_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(["--multi", "2", "--frames", "2", "--cpu"]) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["unit"] == "fps" and line["value"] > 0
    assert "2 lanes" in line["metric"] and "CPU" in line["metric"]
    assert line["per_lane_fps"] == pytest.approx(line["value"] / 2,
                                                 abs=0.01)
    assert np.isfinite(line["ate_m"])


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv,want", [
    (["--depth-stride", "2"], dict(depth_stride=2, pipeline_depth=1)),
    (["--pipeline-depth", "2"], dict(pipeline_depth=2)),
    (["--no-pipeline"], dict(pipeline_depth=0)),
    (["--eager-finalize"], dict(chunk_eager_finalize=True)),
    (["--multi", "3", "--depth-stride", "4"], dict(depth_stride=4)),
])
def test_bench_flags_reach_the_config(monkeypatch, argv, want):
    """Each bench flag reaches the tracking config of the System (or
    MultiSystem) the run builds."""
    seen = []

    def capture(cfg, *a, **kw):
        seen.append(cfg)
        raise _Stop
    monkeypatch.setattr(bench, "System", capture)
    monkeypatch.setattr(bench, "MultiSystem", capture)
    with pytest.raises(_Stop):
        bench.main(argv + ["--frames", "2", "--cpu"])
    got = dataclasses.asdict(seen[0].tracking)
    assert {k: got[k] for k in want} == want


def test_bench_ate_flag_reports_the_ate():
    line = bench.result_line(argparse.Namespace(ate=True, multi=0),
                             dict(ate_m=0.004, fps=3.0))
    assert line["unit"] == "m" and line["value"] == 0.004
    assert line["vs_baseline"] == 5.0


def test_bench_budget_watchdog_prints_the_partial_line(capsys):
    """``bench --budget``: at the budget the watchdog prints the partial
    line (the timed frames' fps) and exits with 0; a run that ended
    prints nothing more."""
    import time
    args = argparse.Namespace(
        budget=5.0, multi=2, chunk=1, cpu=True, ate=False, stereo=False,
        dynamic=False)
    progress = bench.Progress()
    progress.start(time.perf_counter() - 2.0)
    progress.add(12)
    codes = []
    bench._watchdog(args, progress, exit=codes.append)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert codes == [0] and line["partial_frames"] == 12
    assert 0 < line["value"] <= 6.0 and "budget of 5.0 s hit" in \
        line["metric"] and "2 lanes" in line["metric"]
    assert line["per_lane_fps"] == pytest.approx(line["value"] / 2,
                                                 abs=0.01)
    progress.done = True
    bench._watchdog(args, progress, exit=codes.append)
    assert codes == [0] and not capsys.readouterr().out


def test_bench_budget_cuts_a_run():
    """A budget shorter than the run's set-up: the error line, exit 0."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "slam_dynamic_tpu_torch.bench", "--cpu",
         "--budget", "1", "--frames", "200"], cwd=root, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "fewer than 5 timed frames" in \
        line["error"]
