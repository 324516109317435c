"""The online detector inside the chunked System: ``track_chunk`` at
C = 6 with ``DetectorConfig(mode="online")``, the detector run on each
frame of a chunk before it is dispatched, against the JAX System on the
320x240 moving-object world (13 frames: the first, then two chunks; the
object is confirmed dynamic when the second chunk is finalized, in
both). The per-frame form and the tolerances:
``tests/test_torch_online_system.py``.
"""
import pytest

from torch_port_util import check_online_ate, check_online_boxes, \
    check_online_decisions, dynamic_world, run_online

N_FRAMES = 13


@pytest.fixture(scope="module")
def world():
    return dynamic_world("moving", N_FRAMES)


@pytest.fixture(scope="module")
def runs(world):
    return run_online(world, N_FRAMES, chunk=6)


def test_online_chunk_boxes_match_jax(runs):
    check_online_boxes(runs)


def test_online_chunk_states_and_keyframes_match_jax(runs):
    check_online_decisions(runs)


def test_online_chunk_ate_tracks_jax(runs, world):
    check_online_ate(runs, world)
