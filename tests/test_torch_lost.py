"""The LOST path of the port's System against the JAX System (both with
their keyframe hook, so loop detection runs on every keyframe), with the
relocalizer off in both and on in both: the same state on every frame."""
import numpy as np

from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.system import System
from torch_port_util import configs, small_world


def _states(relocalizer: bool):
    """Both Systems on frames 0, 1, a blank frame, 3, 4, 5: their states
    and trajectory lengths."""
    scfg, seq, gray8, depth16 = small_world(n_frames=6)
    jcfg, tcfg = configs(scfg)
    blank = np.full_like(gray8[0], 128)
    frames = [gray8[0], gray8[1], blank, gray8[3], gray8[4], gray8[5]]
    systems = (JSystem(jcfg), System(tcfg, device="cpu"))
    out = []
    for s in systems:
        if not relocalizer:
            s.tracker.relocalizer = None
        out.append(([s.track_rgbd(g, depth16[i], float(seq.timestamps[i]))
                     .state for i, g in enumerate(frames)],
                    len(s.trajectory)))
    return out


def test_lost_and_reset_path_matches_jax():
    """Without a relocalizer: a blank frame after tracking starts, the BoW
    fallback finds nothing, the frame is LOST, and the next textured frame
    resets the young map and re-initializes; both packages take the same
    states."""
    (sj, nj), (st, nt) = _states(relocalizer=False)
    assert sj == st
    assert st[2] == "LOST" and "NOT_INITIALIZED" in st
    assert st[-1] == "OK"
    assert nt == nj


def test_lost_then_relocalized_matches_jax():
    """With both relocalizers on (the Systems' own wiring): the textured
    frame after the LOST one is relocalized against the young map instead
    of resetting it; both packages take the same states."""
    (sj, nj), (st, nt) = _states(relocalizer=True)
    assert sj == st
    assert st[2] == "LOST" and st[-1] == "OK"
    assert nt == nj
