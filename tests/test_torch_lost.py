"""The LOST path of the port's System against the JAX System (both with
their keyframe hook, so loop detection runs on every keyframe, and with
no relocalizer): the same state on every frame."""
import numpy as np

from slam_dynamic_tpu.system import System as JSystem
from slam_dynamic_tpu_torch.system import System
from torch_port_util import configs, small_world


def test_lost_and_reset_path_matches_jax():
    """A blank frame after tracking starts: the BoW fallback finds nothing,
    the frame is LOST, and the next textured frame resets the young map
    and re-initializes; both packages take the same states."""
    scfg, seq, gray8, depth16 = small_world(n_frames=6)
    jcfg, tcfg = configs(scfg)
    blank = np.full_like(gray8[0], 128)
    frames = [gray8[0], gray8[1], blank, gray8[3], gray8[4], gray8[5]]
    js = JSystem(jcfg)
    js.tracker.relocalizer = None
    ts = System(tcfg, device="cpu")
    states = []
    for s in (js, ts):
        states.append([s.track_rgbd(g, depth16[i], float(seq.timestamps[i]))
                       .state for i, g in enumerate(frames)])
    assert states[0] == states[1]
    assert states[1][2] == "LOST" and "NOT_INITIALIZED" in states[1]
    assert states[1][-1] == "OK"
    assert len(ts.trajectory) == len(js.trajectory)
