"""The essential graph solved with its edges sharded: Gauss-Newton summed
across shards.

Port of ``slam_dynamic_tpu/parallel/sharded_pose_graph.py``
(``make_sharded_pose_graph`` :28). The edges of the essential graph (a
few per keyframe) are cut into contiguous blocks over the mesh's axis.
Each shard builds the residuals and 7x7 Jacobian blocks of its edges
(``optim/pose_graph.py``'s ``normal_equations``, float64 Jacobians) into
a partial dense [7K, 7K] Hessian and right-hand side; ``reduce`` sums
(H, b, err) over the shards (:78, one all-reduce on a mesh over
processes), and the damped solve with its accept/reject step, the same
loop as the single-device ``optimize_pose_graph``, is replicated. The
error after the step is summed the same way (:105): two reductions per
iteration, (7K)^2 + 7K + 1 floats and then one, whatever the edge count.
"""
from __future__ import annotations

from ..optim.pose_graph import (PoseGraphProblem, damped_gn, edge_error,
                                normal_equations)
from .sharded_ba import layout, reduce


def make_sharded_pose_graph(mesh, K: int, E: int, iters: int = 20,
                            fix_scale: bool = True, axis: str = "lm"):
    """The edge-sharded essential-graph solve over ``mesh`` (a shard
    count, or a ``Mesh`` whose ``axis`` it uses; on a mesh over processes
    each rank builds its own edges). E must be a multiple of the shard
    count: pad with ``e_valid`` False edges. Returns fn(problem:
    PoseGraphProblem) -> (s, R, t), the same on every rank."""
    n_shards, shards, group = layout(mesh, axis)
    assert E % n_shards == 0, (E, n_shards)
    Eb = E // n_shards

    def run(problem: PoseGraphProblem):
        assert problem.s.shape[0] == K and problem.e_i.shape[0] == E
        parts = [problem._replace(**{
            f: getattr(problem, f)[s * Eb:(s + 1) * Eb]
            for f in ("e_i", "e_j", "e_s", "e_R", "e_t", "e_valid",
                      "e_weight")}) for s in shards]

        def system(s, R, t):
            return reduce([normal_equations(p, s, R, t) for p in parts],
                          group)

        def error(s, R, t):
            return reduce([(edge_error(p, s, R, t),) for p in parts],
                          group)[0]

        return damped_gn(problem, iters, fix_scale, system, error)

    return run
