"""The benchmark's world: a textured box room ray-cast on the device.

A PyTorch copy of the port's ``io/synthetic.py`` renderer (the same
texture hash, the same planes and the same quad objects), made periodic:
the camera path and every object's motion repeat after ``period`` frames,
so frame ``i`` of a run is frame ``i mod period`` of the world and a
faster program never runs out of it. The whole period is rendered once,
on the device, in a few large batches, and handed to the program as the
host arrays a camera driver gives: uint8 gray, uint16 depth at the rig's
``DepthMapFactor``, or uint8 right images.

The seed sets the texture hash, the sensor noise, the objects' start
positions and, unless the world sets ``random_start`` false, where on
its periodic path the camera starts (a cell whose window covers a small
part of the period starts every seed at frame 0, so that every seed has
the same path and the same work). The world also keeps its exact truth:
camera poses, the rendered depth in metres, and per frame each object's
box and whether it moves.

Camera convention as ``io/synthetic.py``: x right, y down, z forward;
x_world = R_wc @ x_cam + t_wc.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# frames rendered per batch on the device
BATCH = 16
# numbers drawn from the seed, one stream per use
_STREAM_TEXTURE, _STREAM_NOISE, _STREAM_PLACE = 1, 2, 3


def texture(u: torch.Tensor, v: torch.Tensor, seed, cells: float):
    """``io/synthetic.py``'s ``_texture``: a random-intensity checker plus
    a rotated harmonic layer, float32 in [40, 240). ``seed`` is an int or
    an int64 tensor broadcast against ``u``."""
    u = u.to(torch.float64)
    v = v.to(torch.float64)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=u.device)
    iu = torch.floor(u * cells).to(torch.int64)
    iv = torch.floor(v * cells).to(torch.int64)
    h1 = (iu * 73856093) ^ (iv * 19349663) ^ (seed * 83492791)
    base = torch.remainder(h1, 1000).to(torch.float64) / 1000.0
    iu2 = torch.floor((u + 0.31 * v) * cells * 2.7).to(torch.int64)
    iv2 = torch.floor((v - 0.17 * u) * cells * 2.7).to(torch.int64)
    h2 = (iu2 * 2654435761) ^ (iv2 * 40503) ^ ((seed + 1) * 65599)
    fine = torch.remainder(h2, 1000).to(torch.float64) / 1000.0
    return (40.0 + 150.0 * base + 50.0 * fine).to(torch.float32)


def room_planes(room: dict):
    """The six walls as ``io/synthetic.py``'s ``_ROOM`` lists them: (axis,
    offset), back, front, left, right, floor, ceiling."""
    (x0, x1), (y0, y1), (z0, z1) = room["x"], room["y"], room["z"]
    return [(2, z1), (2, z0), (0, x0), (0, x1), (1, y1), (1, y0)]


def seed_stream(seed: int, stream: int) -> int:
    """A 63-bit seed of one stream of numbers drawn from the run's seed."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), stream])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def _rot(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """R = Ry(yaw) @ Rx(pitch), [F, 3, 3] float32 (``io/synthetic.py``'s
    sweep)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)
    Ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cp, -sp], -1),
                      torch.stack([zero, sp, cp], -1)], -2)
    return (Ry @ Rx).to(torch.float32)


def _sines(t: torch.Tensor, period: int, spec: Optional[dict]):
    """sum of amp * sin(2 pi cycles t / period + phase) over a spec's
    terms: {"amp": [..], "cycles": [..], "phase": [..]} (phase optional)."""
    out = torch.zeros_like(t)
    if not spec:
        return out
    phases = spec.get("phase", [0.0] * len(spec["amp"]))
    for a, k, ph in zip(spec["amp"], spec["cycles"], phases):
        out = out + a * torch.sin(2 * math.pi * k * t / period + ph)
    return out


def _triangle(t: torch.Tensor, period: int, cycles: int) -> torch.Tensor:
    """A triangle wave in [-1, 1] with ``cycles`` periods in ``period``
    frames, rising through 0 at t = 0."""
    x = torch.remainder(t * cycles / period + 0.25, 1.0)
    return 4.0 * torch.abs(x - 0.5) - 1.0


@dataclass
class World:
    """One rendered period and its truth (host numpy unless noted)."""

    period: int
    fps: float
    gray: np.ndarray            # [P, H, W] uint8
    aux: np.ndarray             # [P, H, W] uint16 depth or uint8 right
    depth_m: torch.Tensor       # [P, H, W] float32 metres
    R_wc: np.ndarray            # [P, 3, 3] float64
    t_wc: np.ndarray            # [P, 3] float64
    boxes: np.ndarray           # [P, K, 4] float32 (x0, y0, x1, y1), -1
    box_valid: np.ndarray       # [P, K] bool
    moving: np.ndarray          # [K] bool
    start: int                  # the seed's frame offset on the path

    def index(self, i: int) -> int:
        """The world frame of run frame ``i``."""
        return (self.start + i) % self.period

    def detections(self, i: int, boxed: np.ndarray):
        """Run frame i's boxes [D, 4] of the boxed objects in view, as a
        detector gives them, or None with none in view."""
        w = self.index(i)
        keep = self.box_valid[w] & boxed
        return self.boxes[w][keep] if keep.any() else None


class Renderer:
    """Ray-caster of one world description on one device."""

    def __init__(self, cam: dict, world: dict, seed: int, device,
                 texture_seed: Optional[int] = None):
        self.cam = cam
        self.spec = world
        self.device = torch.device(device)
        self.period = int(world["period_frames"])
        # the hash takes a small seed (its products stay inside int64)
        self.tseed = (seed_stream(seed, _STREAM_TEXTURE) % (1 << 20)
                      if texture_seed is None else int(texture_seed))
        self.noise_sigma = float(world.get("gray_noise", 1.0))
        self.cells = float(world.get("texture_cells", 2.8))
        self.planes = room_planes(world["room"])
        place = np.random.default_rng(seed_stream(seed, _STREAM_PLACE))
        self.start = int(place.integers(0, self.period)) \
            if world.get("random_start", True) else 0
        self.objects = []
        for ob in world.get("objects", []):
            jit = np.asarray(ob.get("jitter", [0.0, 0.0, 0.0]), np.float64)
            center = np.asarray(ob["center"], np.float64) + \
                jit * place.uniform(-1.0, 1.0, 3)
            phase = float(place.uniform(0.0, 1.0)) \
                if ob.get("walk") else 0.0
            self.objects.append(dict(ob, center=center, phase=phase))
        H, W = int(cam["height"]), int(cam["width"])
        dev = self.device
        xs = (torch.arange(W, dtype=torch.float32, device=dev)
              - cam["cx"]) / cam["fx"]
        ys = (torch.arange(H, dtype=torch.float32, device=dev)
              - cam["cy"]) / cam["fy"]
        dy, dx = torch.meshgrid(ys, xs, indexing="ij")
        self.dirs_c = torch.stack([dx, dy, torch.ones_like(dx)], -1)

    # -- the truth --------------------------------------------------------
    def poses(self, frames: torch.Tensor):
        """(R_wc [F, 3, 3], t_wc [F, 3]) float32 of world frames."""
        cs = self.spec["camera"]
        t = frames.to(torch.float64)
        P = self.period
        pos = torch.stack([cs["center"][a] + _sines(t, P, cs["path"][a])
                           for a in range(3)], -1)
        yaw = cs.get("yaw0", 0.0) + _sines(t, P, cs.get("yaw"))
        pitch = _sines(t, P, cs.get("pitch"))
        return _rot(yaw, pitch), pos.to(torch.float32)

    def object_centers(self, frames: torch.Tensor):
        """[F, K, 3] float32 centres of the objects at world frames."""
        t = frames.to(torch.float64)
        out = []
        for ob in self.objects:
            c = torch.tensor(ob["center"], dtype=torch.float64,
                             device=t.device).expand(len(t), 3).clone()
            walk = ob.get("walk")
            if walk:
                tt = t + ob["phase"] * self.period / walk["cycles"]
                c[:, walk["axis"]] += walk["amp"] * _triangle(
                    tt, self.period, walk["cycles"])
            bob = ob.get("bob")
            if bob:
                c[:, 1] += _sines(t, self.period, bob)
            out.append(c)
        if not out:
            return torch.zeros(len(t), 0, 3, device=t.device)
        return torch.stack(out, 1).to(torch.float32)

    # -- ray casting ------------------------------------------------------
    def cast(self, R: torch.Tensor, origin: torch.Tensor,
             centers: torch.Tensor):
        """Ray-cast F cameras (R [F, 3, 3], origin [F, 3], object centres
        [F, K, 3]): (color float32 [F, H, W] before noise, depth float32
        metres [F, H, W], object id int8 [F, H, W], -1 for a wall)."""
        dirs = torch.einsum("hwc,fdc->fhwd", self.dirs_c, R)
        F, H, W = dirs.shape[:3]
        best = torch.full((F, H, W), float("inf"), device=self.device)
        color = torch.zeros((F, H, W), device=self.device)
        uv_axes = {0: (2, 1), 1: (0, 2), 2: (0, 1)}
        for pi, (axis, off) in enumerate(self.planes):
            d = dirs[..., axis]
            denom = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
            th = (off - origin[:, axis, None, None]) / denom
            hit = (th > 0.05) & (th < best)
            au, av = uv_axes[axis]
            pu = origin[:, au, None, None] + th * dirs[..., au]
            pv = origin[:, av, None, None] + th * dirs[..., av]
            tex = texture(pu[hit], pv[hit], self.tseed * 31 + pi, self.cells)
            color[hit] = tex
            best = torch.where(hit, th, best)
        ident = torch.full((F, H, W), -1, dtype=torch.int8,
                           device=self.device)
        for k, ob in enumerate(self.objects):
            half_w, half_h = ob["size"][0] / 2, ob["size"][1] / 2
            c = centers[:, k]
            d = dirs[..., 2]
            denom = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
            th = (c[:, 2, None, None] - origin[:, 2, None, None]) / denom
            px = origin[:, 0, None, None] + th * dirs[..., 0] \
                - c[:, 0, None, None]
            py = origin[:, 1, None, None] + th * dirs[..., 1] \
                - c[:, 1, None, None]
            hit = (th > 0.05) & (px.abs() < half_w) & (py.abs() < half_h) \
                & (th < best)
            color[hit] = texture(px[hit], py[hit], self.tseed * 77 + 5 + k,
                                 self.cells * 3.0)
            best = torch.where(hit, th, best)
            ident[hit] = k
        # the hit point's z in the camera frame is the ray length along a
        # direction whose camera z is 1
        depth = torch.where(torch.isfinite(best), best,
                            torch.zeros_like(best))
        return color, depth, ident

    def render(self, depth_factor: Optional[float], baseline: float = 0.0):
        """The whole period as a ``World``: with ``depth_factor`` the aux
        images are uint16 depth, else (stereo) uint8 right images from a
        camera ``baseline`` metres to the right."""
        P = self.period
        H, W = self.dirs_c.shape[:2]
        K = len(self.objects)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed_stream(self.tseed, _STREAM_NOISE))
        gray = torch.empty((P, H, W), dtype=torch.uint8, device=self.device)
        aux = torch.empty((P, H, W), dtype=torch.uint16 if depth_factor
                          else torch.uint8, device=self.device)
        depth_m = torch.empty((P, H, W), device=self.device)
        boxes = torch.full((P, K, 4), -1.0, device=self.device)
        Rs, ts = [], []
        for lo in range(0, P, BATCH):
            frames = torch.arange(lo, min(lo + BATCH, P), device=self.device)
            R, t = self.poses(frames)
            centers = self.object_centers(frames)
            color, depth, ident = self.cast(R, t, centers)
            gray[lo:lo + len(frames)] = self._sensor(color, gen)
            depth_m[lo:lo + len(frames)] = depth
            if depth_factor:
                aux[lo:lo + len(frames)] = (depth * depth_factor).clamp(
                    0, 65535).to(torch.int32).to(torch.uint16)
            else:
                t_right = t + R[:, :, 0] * baseline
                color_r, _, _ = self.cast(R, t_right, centers)
                aux[lo:lo + len(frames)] = self._sensor(color_r, gen)
            for k in range(K):
                boxes[lo:lo + len(frames), k] = _mask_boxes(ident == k)
            Rs.append(R)
            ts.append(t)
        box_valid = boxes[..., 0] >= 0
        moving = np.array([bool(ob.get("walk")) for ob in self.objects],
                          bool)
        return World(P, float(self.cam["fps"]), gray.cpu().numpy(),
                     aux.cpu().numpy(), depth_m,
                     torch.cat(Rs).double().cpu().numpy(),
                     torch.cat(ts).double().cpu().numpy(),
                     boxes.cpu().numpy(), box_valid.cpu().numpy(), moving,
                     self.start)

    def _sensor(self, color: torch.Tensor, gen) -> torch.Tensor:
        """uint8 image from the ray-cast intensity and the seed's noise
        (clipped, then truncated as ``astype(np.uint8)``)."""
        noise = torch.randn(color.shape, generator=gen, device=self.device)
        return (color + self.noise_sigma * noise).clamp(0, 255).to(
            torch.uint8)


def _mask_boxes(mask: torch.Tensor) -> torch.Tensor:
    """[F, 4] boxes (x0, y0, x1, y1) of [F, H, W] masks; -1 where a mask
    is empty."""
    F, H, W = mask.shape
    cols = mask.any(1)
    rows = mask.any(2)
    xi = torch.arange(W, device=mask.device, dtype=torch.float32)
    yi = torch.arange(H, device=mask.device, dtype=torch.float32)
    big = float(max(H, W) + 1)
    x0 = torch.where(cols, xi, big).min(1)[0]
    x1 = torch.where(cols, xi, -1.0).max(1)[0]
    y0 = torch.where(rows, yi, big).min(1)[0]
    y1 = torch.where(rows, yi, -1.0).max(1)[0]
    out = torch.stack([x0, y0, x1, y1], -1)
    return torch.where(cols.any(1)[:, None], out, torch.full_like(out, -1.0))
