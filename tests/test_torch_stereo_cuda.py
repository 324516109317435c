"""The stereo and mono paths' device work on the card against the same
code on the CPU: K2 at the stereo matcher's shapes, ``match_stereo``,
the mono bootstrap ``try_initialize`` and the batched-levels extractor.
Every test is marked ``cuda`` and skips without a card; this file
imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_stereo_cuda.py -m cuda \\
        --noconftest -q

Tolerances: K2 and ``match_stereo`` (on the same keypoints and uint8
images) bit-equal; ``try_initialize`` on the same frames with the same
hashed RANSAC draws: the same ``ok`` and match count, the good masks
differing on at most 1% of the good points (the refits round
differently on the card and move points at the reprojection gate),
(R2, t2) within 1e-4 (cuSOLVER and LAPACK may order the SVD candidates
differently; cheirality picks the same motion); the batched
extractor's keypoint positions equal on at least 99% of the slots (the
card's pyramid sums round in another order).
"""
import numpy as np
import pytest
import torch

from slam_dynamic_tpu_torch.config import ORBConfig
from slam_dynamic_tpu_torch.frontend.extractor import Keypoints, extract
from slam_dynamic_tpu_torch.frontend.frame import build_frame
from slam_dynamic_tpu_torch.frontend.initializer import try_initialize
from slam_dynamic_tpu_torch.io.bench_world import bench_world
from slam_dynamic_tpu_torch.ops import hamming as hm
from slam_dynamic_tpu_torch.ops.stereo import match_stereo
from slam_dynamic_tpu_torch.system import intrinsics_from_config

SF = np.float32(1.2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _to(tree, device):
    return type(tree)(*(t.to(device) for t in tree))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1000, 1000), (1000, 997), (999, 1000)])
def test_k2_at_stereo_shapes_on_card(cuda_device, n, m):
    rng = np.random.default_rng(n * m)
    a, b = (torch.from_numpy(rng.integers(0, 2**32, (k, 8), dtype=np.uint32)
                             .view(np.int32)).to(cuda_device)
            for k in (n, m))
    before = hm.launches
    got = hm.hamming_matrix(a, b)
    assert hm.launches == before + 1
    assert torch.equal(got, hm.hamming_matrix_plain(a, b))


@pytest.mark.cuda
def test_match_stereo_on_card_equals_cpu(cuda_device):
    seq, gray8, right8, cfg = bench_world(1, sensor="stereo")
    left = torch.from_numpy(gray8[0].astype(np.float32))
    right = torch.from_numpy(right8[0].astype(np.float32))
    kl, kr = extract(left, cfg.orb), extract(right, cfg.orb)
    sl, sr = (torch.tensor(SF) ** k.level.to(torch.float32)
              for k in (kl, kr))
    bf = cfg.camera.bf
    cpu = match_stereo(left, right, kl, kr, bf, 0.1, sl, sr)
    before = hm.launches
    card = match_stereo(left.to(cuda_device), right.to(cuda_device),
                        _to(kl, cuda_device), _to(kr, cuda_device), bf, 0.1,
                        sl.to(cuda_device), sr.to(cuda_device))
    assert hm.launches == before + 1
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)
    assert int(cpu.valid.sum()) > 300


@pytest.mark.cuda
def test_try_initialize_on_card_matches_cpu(cuda_device):
    seq, gray8, _, cfg = bench_world(4, sensor="mono")
    cam = intrinsics_from_config(cfg, "cpu")
    ref = build_frame(cfg, cam, gray8[0], 0, 0.0).data
    cur = build_frame(cfg, cam, gray8[3], 3, 0.1).data
    cpu = try_initialize(cam, ref, cur, seed=3, min_matches=100)
    card = try_initialize(intrinsics_from_config(cfg, cuda_device),
                          _to(ref, cuda_device), _to(cur, cuda_device),
                          seed=3, min_matches=100)
    assert bool(card.ok) == bool(cpu.ok) and bool(cpu.ok)
    assert int(card.n_matches) == int(cpu.n_matches)
    # the RANSAC refits round differently on the card, which moves points
    # at the 2 px reprojection gate across it
    good_c, good = card.good.cpu(), cpu.good
    assert int((good_c ^ good).sum()) <= max(2, int(good.sum()) // 100)
    assert int(good.sum()) > 100
    torch.testing.assert_close(card.R2.cpu(), cpu.R2, atol=1e-4, rtol=0)
    torch.testing.assert_close(card.t2.cpu(), cpu.t2, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_batched_extractor_on_card_matches_cpu(cuda_device):
    _, gray8, _, _ = bench_world(1)
    img = torch.from_numpy(gray8[0].astype(np.float32))
    orb = ORBConfig(n_features=1000, batched_levels=True)
    cpu = extract(img, orb)
    card = Keypoints(*(t.cpu() for t in extract(img.to(cuda_device), orb)))
    same = (card.xy == cpu.xy).all(1) & (card.level == cpu.level) \
        & (card.valid == cpu.valid)
    assert same.float().mean() >= 0.99
    assert int(card.valid.sum()) > 900
