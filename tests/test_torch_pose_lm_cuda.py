"""Kernel K3 (the tracker's pose LM, one launch per ``optimize_pose``
call) on the card against its plain version, the PyTorch loop run on the
card. Every test is marked ``cuda`` and skips without a card; this file
imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_pose_lm_cuda.py -m cuda --noconftest -q

Tolerances (``kernel_bench.hold_k3``): R and t within 1e-4 (the two sum
in another order, and an LM step near convergence can be accepted by one
and rejected by the other); inlier labels equal except for observations whose chi2 lies within 1% of
the gate; n_inliers within 1%. K3 twice, and a lane of a batched launch
against its single launch: bit for bit (fixed-order sums, no atomics).
Problems whose answer float32 cannot pin down get consistent
observations: a single observation (rank 2 or 3 of 6: a manifold of
answers) is noise-free and starts at the truth, and three valid ones are
stereo and noise-free (as three mono observations, the minimal P3P
problem, rounding moves the answer by up to 1e-3 between two sound
solvers; seen with K3's arithmetic emulated on the CPU).
"""
import numpy as np
import pytest
import torch

from slam_dynamic_tpu_torch.kernel_bench import hold_k3, k3_problem
from slam_dynamic_tpu_torch.optim import pose_opt
from slam_dynamic_tpu_torch.utils import profiling

CHI2 = {2: 5.991, 3: 7.815}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _check(args, rounds, iters):
    """K3 against the plain loop on the same card tensors."""
    chi2 = CHI2[args[4].shape[-1]]
    before = pose_opt.launches
    got = pose_opt.pose_lm(*args, rounds, iters, chi2)
    assert pose_opt.launches == before + 1
    ref = pose_opt.pose_lm_plain(*args, rounds, iters, chi2)
    hold_k3(got, ref, chi2)
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("outliers", [0.0, 0.3])
@pytest.mark.parametrize("n", [1, 37, 2048, 5000])
@pytest.mark.parametrize("rounds,iters", [(2, 6), (4, 10)])
@pytest.mark.parametrize("d", [3, 2])
def test_k3_equals_plain_on_card(cuda_device, d, rounds, iters, n,
                                 outliers):
    kw = dict(noise=0.0, start=0.0) if n == 1 else {}
    args = k3_problem(np.random.default_rng(n + d), n, d, outliers,
                      cuda_device, **kw)
    _check(args, rounds, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("case,d", [("none_valid", 3), ("none_valid", 2),
                                    ("behind", 3), ("behind", 2),
                                    ("three_valid", 3)])
def test_k3_degenerate_problems_on_card(cuda_device, case, d):
    kw = dict(noise=0.0, outliers=0.0) if case == "three_valid" else {}
    args = k3_problem(np.random.default_rng(7), 300, d, dev=cuda_device,
                      case=case, **kw)
    got, _ = _check(args, 4, 10)
    assert int(got[3]) == (3 if case == "three_valid" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 2])
def test_k3_above_staged_shared_memory_on_card(cuda_device, d):
    """9,000 observations do not fit the kernel's shared memory: the
    passes read them from global memory."""
    args = k3_problem(np.random.default_rng(9), 9000, d, 0.3, cuda_device)
    _check(args, 4, 10)


@pytest.mark.cuda
def test_k3_is_bit_identical_run_to_run(cuda_device):
    args = k3_problem(np.random.default_rng(3), 2048, 3, 0.3, cuda_device)
    first = pose_opt.pose_lm(*args, 4, 10, CHI2[3])
    second = pose_opt.pose_lm(*args, 4, 10, CHI2[3])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k3_vmap_of_16_lanes_is_one_launch_equal_to_single_calls(
        cuda_device):
    lanes = [k3_problem(np.random.default_rng(100 + b), 2048, 3, 0.3,
                        cuda_device) for b in range(16)]
    cam = lanes[0][0]                    # shared, as the batched step's
    batched = [torch.stack([p[i] for p in lanes]) for i in range(1, 8)]
    before = (pose_opt.launches, pose_opt.batched_launches)
    got = torch.func.vmap(
        lambda *a: pose_opt.pose_lm(cam, *a, 2, 6, CHI2[3]))(*batched)
    torch.cuda.synchronize()
    assert (pose_opt.launches, pose_opt.batched_launches) == (
        before[0] + 1, before[1] + 1)
    for b, p in enumerate(lanes):
        single = pose_opt.pose_lm(cam, *p[1:], 2, 6, CHI2[3])
        for g, s in zip(got, single):
            assert torch.equal(g[b], s)


@pytest.mark.cuda
def test_solo_stereo_frame_counts_three_pose_lm_launches(cuda_device):
    """A tracked stereo frame runs the pose LM three times (the motion
    model's narrow and wide passes, the local map): three launches of
    K3."""
    from slam_dynamic_tpu_torch.io.bench_world import bench_world
    from slam_dynamic_tpu_torch.system import System

    seq, left, right, cfg = bench_world(6, sensor="stereo")
    system = System(cfg)
    system.track_stereo(left[0], right[0], float(seq.timestamps[0]))
    counts = []
    for i in range(1, 6):
        profiling.records()
        profiling.enable()
        try:
            system.track_stereo(left[i], right[i], float(seq.timestamps[i]))
        finally:
            profiling.disable()
        counts.append(profiling.records().totals.get("pose_lm_launches", 0))
    system.shutdown()
    assert counts == [3] * 5, counts


@pytest.mark.cuda
def test_k3_wrapper_rejects_bad_input(cuda_device):
    args = k3_problem(np.random.default_rng(5), 64, 3, 0.3, cuda_device)

    def call(i, value):
        bad = list(args)
        bad[i] = value
        pose_opt.pose_lm(*bad, 2, 6, CHI2[3])

    with pytest.raises(TypeError):
        call(3, args[3].double())                       # xw float64
    with pytest.raises(TypeError):
        call(6, args[6].to(torch.uint8))                # valid not bool
    with pytest.raises(ValueError):
        call(5, args[5][:-1].contiguous())              # inv_sigma2 [N-1]
    with pytest.raises(ValueError):
        call(4, torch.zeros(64, 4, device=cuda_device))  # obs [N, 4]
    with pytest.raises(ValueError):
        call(7, args[7].cpu())                          # another device
    with pytest.raises(ValueError):
        call(3, args[3].t().contiguous().t())           # not contiguous
