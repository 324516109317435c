"""The device ray-caster against the port's ``io/synthetic.py`` renderer,
and the periodic world it renders."""
import numpy as np
import torch

from portbench.world import Renderer, _mask_boxes
from slam_dynamic_tpu_torch.io import synthetic as syn


class _NoNoise:
    def normal(self, mean, sigma, shape):
        return np.zeros(shape)


def test_cast_matches_synthetic_renderer():
    cfg = syn.SynthConfig(n_frames=5, width=160, height=120, fx=131.25,
                          fy=131.25, cx=79.5, cy=59.5, seed=3,
                          dynamic_object=True, obj_size=1.0)
    R_all, t_all = syn._trajectory(cfg)
    cam = dict(width=160, height=120, fx=131.25, fy=131.25, cx=79.5,
               cy=59.5, fps=30.0)
    world = dict(period_frames=5, random_start=False, camera={},
                 room=dict(x=[-4, 4], y=[-2, 2], z=[-3, 9]),
                 objects=[dict(size=[1.0, 1.0], center=[0, 0, 0])])
    r = Renderer(cam, world, seed=0, device="cpu", texture_seed=3)
    for i in range(5):
        obj = np.array([cfg.obj_x0 + cfg.obj_speed * i,
                        cfg.obj_bob * np.sin(2 * np.pi * i / 50.0),
                        cfg.obj_depth + 0.3 * np.sin(2 * np.pi * i / 80.0)],
                       np.float32)
        gray, depth, mask, box = syn._render_view(cfg, R_all[i], t_all[i],
                                                  obj, _NoNoise())
        color, d, ident = r.cast(torch.from_numpy(R_all[i][None]),
                                 torch.from_numpy(t_all[i][None]),
                                 torch.from_numpy(obj[None, None]))
        assert np.abs(color[0].numpy() - gray).max() < 1e-3
        np.testing.assert_allclose(d[0].numpy(), depth, rtol=1e-5)
        assert np.array_equal(ident[0].numpy() >= 0, mask)
        got = _mask_boxes(ident == 0)[0].numpy()
        np.testing.assert_array_equal(got, box)


def _small_world(objects=()):
    cam = dict(width=96, height=72, fx=80.0, fy=80.0, cx=47.5, cy=35.5,
               fps=30.0)
    world = dict(period_frames=24,
                 room=dict(x=[-3, 3], y=[-1.6, 1.0], z=[-3, 2.6]),
                 camera=dict(center=[0, 0, 0],
                             path=[dict(amp=[0.4], cycles=[1]),
                                   dict(amp=[0.1], cycles=[2]),
                                   dict(amp=[0.3], cycles=[1])],
                             yaw=dict(amp=[0.1], cycles=[1])),
                 objects=list(objects))
    return cam, world


def test_world_is_periodic_and_seeded():
    walker = dict(size=[0.6, 1.6], center=[0, 0.2, 1.5],
                  walk=dict(axis=0, amp=1.0, cycles=1))
    cam, spec = _small_world([walker])
    r = Renderer(cam, spec, seed=2**31 + 7, device="cpu")
    frames = torch.arange(0, 48)
    R, t = r.poses(frames)
    assert torch.allclose(R[:24], R[24:], atol=1e-5)
    assert torch.allclose(t[:24], t[24:], atol=1e-5)
    c = r.object_centers(frames)
    assert torch.allclose(c[:24], c[24:], atol=1e-5)
    w1 = r.render(5000.0)
    w2 = Renderer(cam, spec, seed=2**31 + 7, device="cpu").render(5000.0)
    w3 = Renderer(cam, spec, seed=5, device="cpu").render(5000.0)
    assert np.array_equal(w1.gray, w2.gray)
    assert np.array_equal(w1.aux, w2.aux)
    assert not np.array_equal(w1.gray, w3.gray)
    assert w1.gray.dtype == np.uint8 and w1.aux.dtype == np.uint16
    # uint16 depth at the rig's factor, truncated, as a depth camera's
    d = w1.depth_m.numpy()
    assert np.abs(w1.aux / 5000.0 - d).max() <= 1.0 / 5000.0 + 1e-6
    assert w1.moving.tolist() == [True]
    assert w1.index(0) == w1.start and w1.index(24) == w1.start


def test_stereo_pair_and_boxes():
    cam, spec = _small_world([dict(size=[0.6, 0.6], center=[0.3, -0.2, 1.5])])
    w = Renderer(cam, spec, seed=1, device="cpu").render(None, baseline=0.1)
    assert w.aux.dtype == np.uint8 and w.aux.shape == w.gray.shape
    assert not np.array_equal(w.aux, w.gray)
    assert w.box_valid.all()
    assert w.detections(0, np.array([True])).shape == (1, 4)
    assert w.detections(0, np.array([False])) is None
