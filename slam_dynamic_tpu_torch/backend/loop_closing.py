"""Loop detection on keyframes: the detection half of loop closing.

Port of ``slam_dynamic_tpu/backend/loop_closing.py``: ``_detect_device``
:37, ``LoopResult`` :207, ``LoopCloser.__init__`` :217, ``on_keyframe``
:230 and ``_detect`` :337 with its streak bookkeeping keyed on the
monotonic keyframe count ``seq``. Every keyframe's BoW vector goes into
the keyframe database; from the 10th keyframe on, each one is scored
against the database and a candidate must be seen in consecutive
keyframes (``covisibility_consistency_th``) to be returned.

Not ported yet: the Sim3 verification and map correction a candidate
leads to (``_compute_sim3`` :430, ``_correct`` :476, ``_search_and_fuse``
:623, ``on_relocalization`` :260). Until they are, ``on_keyframe``
raises ``NotImplementedError`` on a candidate rather than skip the loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SystemConfig
from ..models import vocabulary as voc_mod
from ..utils.camera import Intrinsics
from ..worldmap import kfdb as kfdb_mod
from ..worldmap.state import MapState


def _detect_device(db: kfdb_mod.KFDatabase, hist, covis, kf_valid, k: int):
    """The loop-detection scoring as one device packet: [best candidate,
    its score, covisibility row of the best (K 0/1 floats)]. The query's
    covisible keyframes and culled keyframes are excluded, and the least
    score among its strong covisibles (>= 15 shared landmarks) is the
    candidates' minimum score."""
    covis_row = covis[k]
    exclude = (covis_row > 0) | ~kf_valid
    exclude[k] = True
    strong = (covis_row >= 15) & db.valid & kf_valid
    sims, _ = kfdb_mod.scores(db, hist)
    min_score = torch.where(strong, sims, float("inf")).min()
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    cand = kfdb_mod.query(db, hist, covis, exclude, min_score=min_score)
    # the first index at the maximum, as jnp.argmax
    best = torch.where(cand.score == cand.score.max(),
                       torch.arange(cand.score.shape[0], device=covis.device),
                       cand.score.shape[0]).min()
    return torch.cat([torch.stack([best.to(torch.float32), cand.score[best]]),
                      (covis[best] > 0).to(torch.float32)])


@dataclasses.dataclass
class LoopResult:
    closed: bool = False
    matched_kf: int = -1
    n_inliers: int = 0
    n_total: int = 0


class LoopCloser:
    """Host orchestration of loop detection; the numerics are torch ops
    on the map's device."""

    def __init__(self, cfg: SystemConfig, cam: Intrinsics,
                 voc: voc_mod.Vocabulary):
        self.cfg = cfg
        self.cam = cam
        self.voc = voc
        self.db = kfdb_mod.KFDatabase.empty(
            cfg.capacity.max_keyframes, min(kfdb_mod.TOP_WORDS, voc.n_words),
            device=voc.weights.device)
        self.streaks = {}                  # candidate kf -> consecutive count
        self.last_loop_kf = -1000
        self._last_detect_kf = -1000       # streaks hold only consecutively
        self.n_detect = 0                  # _detect calls and candidates
        self.n_candidates = 0

    def on_keyframe(self, m: MapState, k: int, stereo: bool,
                    seq: int = None) -> tuple[MapState, LoopResult]:
        """Keyframe slot k was inserted: add its BoW vector to the
        database and, from the 10th keyframe on, look for a loop. ``seq``
        is the monotonic insertion count (slot ids stop being temporal
        order once slots recycle at capacity); it defaults to k."""
        if seq is None:
            seq = k
        bv = voc_mod.transform(self.voc, m.kf_kp_desc[k], m.kf_kp_valid[k])
        hist = voc_mod.sparse_bow(bv, top_w=self.db.word.shape[1])
        cfg = self.cfg.loop
        if cfg.enabled and seq - self.last_loop_kf > cfg.kf_gap \
                and seq >= 10:
            cand_k = self._detect(m, k, hist, seq)
            self.n_detect += 1
            if cand_k >= 0:
                self.n_candidates += 1
                raise NotImplementedError(
                    f"loop candidate keyframe {cand_k} for keyframe {k}: "
                    "Sim3 verification and loop correction are not ported "
                    "yet (ROADMAP Queue 1, item 15)")
        self.db = kfdb_mod.add(self.db, k, hist)
        return m, LoopResult()

    def _detect(self, m: MapState, k: int, hist, seq: int = None) -> int:
        """The best BoW candidate that is not covisible with k, once it (or
        its covisible group) was seen in ``covisibility_consistency_th``
        consecutive keyframes; else -1. One device packet, one readback."""
        if seq is None:
            seq = k
        # a streak means consecutive keyframes: a skipped one resets them
        if seq != self._last_detect_kf + 1:
            self.streaks = {}
        self._last_detect_kf = seq
        packet = _detect_device(self.db, hist, m.covis, m.kf_valid,
                                k).cpu().numpy()
        best = int(packet[0])
        if float(packet[1]) <= 0:
            self.streaks = {}
            return -1
        group = set(np.nonzero(packet[2:] > 0)[0].tolist())
        group.add(best)
        hit = max(self.streaks.get(g, 0) for g in group)
        self.streaks = {g: hit + 1 for g in group}
        if hit + 1 >= self.cfg.loop.covisibility_consistency_th:
            return best
        return -1
