"""Keyframe database for loop detection.

Port of ``slam_dynamic_tpu/worldmap/kfdb.py``: ``KFDatabase`` (``empty``
:42), ``add`` :49, ``erase`` :59, ``scores`` :64 and ``query`` :85. Each
keyframe keeps its top-W (word, weight) pairs sorted by word, so the
database is [K, W] whatever the vocabulary's size. For L1-normalized
vectors, 1 - 0.5 |q - w|_1 = sum_i min(q_i, w_i), which needs only the
words both vectors hold; a binary search of each stored word in the
sorted query finds them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..models.vocabulary import PAD_WORD, SparseBow

# default per-keyframe sparse capacity: >= distinct words of a
# 1000-feature frame
TOP_WORDS = 1024


class KFDatabase(NamedTuple):
    word: torch.Tensor     # [K, W] int32 word ids ascending (-1 = empty)
    weight: torch.Tensor   # [K, W] float32 L1-normalized tf-idf weights
    valid: torch.Tensor    # [K] bool

    @staticmethod
    def empty(K: int, top_w: int = TOP_WORDS, device=None) -> "KFDatabase":
        dev = resolve_device(device)
        return KFDatabase(
            torch.full((K, top_w), -1, dtype=torch.int32, device=dev),
            torch.zeros((K, top_w), dtype=torch.float32, device=dev),
            torch.zeros(K, dtype=torch.bool, device=dev))


def add(db: KFDatabase, k: int, sb: SparseBow) -> KFDatabase:
    """Keyframe k's sparse vector as row k (PAD_WORD pads become -1)."""
    word, weight, valid = db.word.clone(), db.weight.clone(), db.valid.clone()
    word[k] = torch.where(sb.word < PAD_WORD, sb.word, -1)
    weight[k] = sb.weight
    valid[k] = True
    return KFDatabase(word, weight, valid)


def erase(db: KFDatabase, k: int) -> KFDatabase:
    valid = db.valid.clone()
    valid[k] = False
    return db._replace(valid=valid)


def scores(db: KFDatabase, sb: SparseBow):
    """([K] L1 similarity, [K] int32 shared-word count) of the query
    against every stored row."""
    wq = sb.word.shape[0]
    pos = torch.searchsorted(sb.word, db.word).clamp(0, wq - 1)
    hit = (sb.word[pos] == db.word) & (db.word >= 0)
    qv = torch.where(hit, sb.weight[pos], 0.0)
    s = torch.where(hit, torch.minimum(qv, db.weight), 0.0).sum(1)
    return s, hit.sum(1).to(torch.int32)


class Candidates(NamedTuple):
    score: torch.Tensor        # [K] L1 similarity (0 where filtered out)
    shared: torch.Tensor       # [K] shared-word counts
    accumulated: torch.Tensor  # [K] covisibility-group score


def query(db: KFDatabase, sb: SparseBow, covis, exclude_mask,
          min_score=0.0) -> Candidates:
    """Score a query against every keyframe: the shared-word gate
    (>= 0.8 of the most shared), the score gate (>= min_score), each
    candidate's score accumulated over its 10 most covisible candidates
    (a stable descending sort, ties to the lower index, as
    ``jax.lax.top_k``), and the cut at 0.75 of the best group."""
    score, shared = scores(db, sb)
    shared = torch.where(db.valid & ~exclude_mask, shared, 0)
    max_shared = shared.max()
    ok = shared >= torch.clamp((0.8 * max_shared).to(torch.int32), min=1)
    score = torch.where(ok & (score >= min_score), score, 0.0)
    w = covis * (score > 0).to(covis.dtype)[None, :]
    topw, topi = torch.sort(w, dim=1, descending=True, stable=True)
    n_top = min(10, w.shape[1])
    topw, topi = topw[:, :n_top], topi[:, :n_top]
    group = score + torch.where(topw > 0, score[topi], 0.0).sum(1)
    group = torch.where(score > 0, group, 0.0)
    final = torch.where(group >= 0.75 * group.max(), score, 0.0)
    return Candidates(final, shared, group)
