"""The H100's published peaks and the least time of the program's two
kernels, frozen here so that no later change to the program moves the
yardstick (copied from ``slam_dynamic_tpu_torch/kernel_bench.py``).

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
HBM3 at 3.35 TB/s, int8 tensor cores at 1,979 TOP/s. The kernels take
their distances from the binary tensor cores, whose rate is not
published; the int8 rate of the bipolar formulation stands in for it.
CUDA cores at the 1.98 GHz boost clock on 132 SMs: fp32 add, multiply and
compare at 128 per clock per SM, 32-bit integer add, multiply-add,
compare, min and max at 64 (CUDA C++ Programming Guide, arithmetic
instruction throughput, compute capability 9.0). Each input byte is
counted read once and each output byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# K1's CUDA-core operations per pair with both ok flags set, the fewest
# the function needs: fp32, the radius test's 2 subtract, 2 multiply, 1
# add and its compare; integer, the level window 2, the candidate key 1,
# the top-2 update 3. A pair with a flag clear needs none.
K1_FP32_OPS_PER_PAIR = 6
K1_INT32_OPS_PER_PAIR = 6


def bound_s(bytes_moved: float, tc_ops: float = 0.0, fp32_ops: float = 0.0,
            int32_ops: float = 0.0) -> float:
    """The least time (s): the larger of the bytes over the memory rate
    and the operations over the rate of their unit (the tensor cores and
    the CUDA cores' fp32 and integer pipes run side by side, so the
    slowest of them)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(tc_ops / INT8_TC_OPS_PER_S, fp32_ops / FP32_OPS_PER_S,
                int32_ops / INT32_OPS_PER_S)
    return max(t_bytes, t_ops)


def k1_bound_s(lanes: int, n: int, m: int, pairs: int) -> float:
    """K1 on ``lanes`` x [n] keypoints against [m] landmarks, ``pairs``
    of them with both ok flags set (over all lanes): the descriptors,
    coordinates, levels, radii and flags read once, three int32 outputs
    written once; a distance and the gates for the gated-in pairs."""
    bytes_moved = lanes * (n * (32 + 8 + 4 + 1) + m * (32 + 8 + 4 + 4 + 1)
                           + 3 * n * 4)
    return bound_s(bytes_moved, tc_ops=2 * 256 * pairs,
                   fp32_ops=K1_FP32_OPS_PER_PAIR * pairs,
                   int32_ops=K1_INT32_OPS_PER_PAIR * pairs)


def k2_bound_s(lanes: int, n: int, m: int) -> float:
    """K2 at [n, 8] x [m, 8] in each of ``lanes`` lanes: every pair's
    distance, the int32 matrix written once."""
    return bound_s(lanes * (n * 32 + m * 32 + n * m * 4),
                   tc_ops=lanes * 2 * 256 * n * m)
