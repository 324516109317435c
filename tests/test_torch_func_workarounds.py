"""The two torch.func faults the port's loop-closing Jacobians work round,
pinned so that the workarounds go when torch fixes them.

- ``utils/sim3.py``, ``optim/sim3_opt.py`` and ``optim/pose_graph.py``
  take their ``jacfwd`` Jacobians in float64 (``sim3.float64``): under
  ``torch.func.jacfwd`` the tangent of a float32 0-d result of an
  operation with a Python scalar comes out float64, and the next float32
  matrix product rejects it.
- ``sim3.sim3_log`` inverts W in closed form (``ops.nullspace.inv3``):
  ``torch.linalg.solve``'s forward-mode derivative is wrong under
  ``torch.func.vmap`` (one call per sample, and a batched call without
  ``vmap``, are right).

Each test asserts that the fault is still there. When one fails, torch
has fixed that fault: remove its workaround (the float64 casts, or the
closed-form inverse) and this test with it.
"""
import torch
from torch.func import jacfwd, vmap


def test_jacfwd_float32_scalar_tangent_is_still_float64():
    def f(x):
        return 1.0 + x[0] / 2.0

    J = jacfwd(f)(torch.zeros(1, dtype=torch.float32))
    assert J.dtype == torch.float64, (
        "torch.func.jacfwd keeps float32 tangents now: the float64 "
        "detour (slam_dynamic_tpu_torch/utils/sim3.py:float64) can go")


def test_linalg_solve_forward_derivative_is_still_wrong_under_vmap():
    g = torch.Generator().manual_seed(0)
    eye = torch.eye(3, dtype=torch.float64)
    A = torch.randn(4, 3, 3, dtype=torch.float64, generator=g) + 3 * eye
    b = torch.randn(4, 3, dtype=torch.float64, generator=g)

    def f(x, A, b):
        return torch.linalg.solve(A + x * eye, b)

    x0 = torch.zeros((), dtype=torch.float64)
    # d/dx (A + x I)^-1 b at 0 = -A^-1 (A^-1 b)
    exact = -torch.linalg.solve(A, torch.linalg.solve(A, b))
    per_sample = torch.stack([jacfwd(f)(x0, A[i], b[i]) for i in range(4)])
    torch.testing.assert_close(per_sample, exact, rtol=1e-9, atol=1e-9)
    under_vmap = vmap(jacfwd(f), in_dims=(None, 0, 0))(x0, A, b)
    assert (under_vmap - exact).abs().max() > 1e-3, (
        "torch.linalg.solve's forward derivative is right under vmap now: "
        "sim3_log (slam_dynamic_tpu_torch/utils/sim3.py) can solve with it "
        "instead of the closed-form inverse")
