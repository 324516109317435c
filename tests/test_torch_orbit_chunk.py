"""Loop closing on the chunked path: the port's System.track_chunk
against the JAX System's on the 320x240 orbit world (C = 6, each chunk
finalized before the next is dispatched), up to the first loop closure:
the same keyframe and candidate, every frame OK, the unaligned ATE
within max(1 mm, 20%) of JAX's, and the frames of the chunk still in
flight when the loop is corrected exported with their reference
keyframes' corrected poses, in both packages
(torch_port_util.check_orbit_closure)."""
from torch_port_util import check_orbit_closure


def test_chunked_orbit_closes_first_loop_like_jax():
    check_orbit_closure(chunk=6)
