"""Visual vocabulary: a bag of binary words as a dense k-ary tree.

Port of ``slam_dynamic_tpu/models/vocabulary.py``: ``Vocabulary`` :32,
the host-numpy training ``train`` :112 (with ``_hamming_np`` :58,
``_bit_vote_mean`` :73 and ``_kmedians`` :83, copied as numpy code),
``default_vocab_path`` :163, the DBoW2 text format (``load_orbvoc_text``
:179, ``save_orbvoc_text`` :276, host numpy code), ``save`` :299 and
``load`` :305 (.npz), ``BowVector`` and ``transform``
(``_transform_impl`` :326-357), ``bow_histogram`` :359, ``PAD_WORD``,
``SparseBow`` and ``sparse_bow`` (``_sparse_bow_impl`` :391-426),
``l1_score`` :429 and the DBoW2 scoring family on sparse vectors
(``score_l1``, ``score_l2``, ``score_chi_square``,
``score_bhattacharyya``, ``score_dot``, ``score_kl``, :436-502). Descent,
BoW building and scoring are plain PyTorch ops (the reference runs them
as XLA ops, not as a Pallas kernel).

Level l of the tree holds k^(l+1) centroids; the children of node n at
level l are rows [n*k, (n+1)*k) of level l+1. Centroids are [rows, 8]
int32, the bit view of the reference's uint32 lanes.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.hamming import popcount32

# sorts after every real word id (vocabularies are < 2^30 words); the pad
# value of SparseBow.word, so a binary search never matches a pad
PAD_WORD = 1 << 30


class Vocabulary(NamedTuple):
    centroids: tuple          # per level [k^(l+1), 8] int32
    weights: torch.Tensor     # [k^L] float32 idf weight per leaf word
    k: int
    levels: int

    @property
    def n_words(self):
        return self.k ** self.levels


def _to_device(cents, weights, k, levels, device) -> Vocabulary:
    dev = resolve_device(device)
    return Vocabulary(
        tuple(torch.from_numpy(np.ascontiguousarray(c, np.uint32)
                               .view(np.int32)).to(dev) for c in cents),
        torch.from_numpy(np.asarray(weights, np.float32)).to(dev),
        int(k), int(levels))


# ----------------------------------------------------------------------------
# training (host numpy, a copy of the reference's)
# ----------------------------------------------------------------------------

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _hamming_np(a, b, block=1 << 16):
    """[N,8] x [M,8] uint32 -> [N,M] popcount distances, blocked over N."""
    if len(a) <= block:
        x = np.bitwise_xor(a[:, None, :], b[None, :, :]).view(np.uint8)
        return _POPCNT8[x].sum(-1, dtype=np.int32)
    out = np.empty((len(a), len(b)), np.int32)
    for i in range(0, len(a), block):
        out[i:i + block] = _hamming_np(a[i:i + block], b, block)
    return out


def _bit_vote_mean(desc):
    """Majority-vote mean of binary descriptors (FORB::meanValue)."""
    if len(desc) == 0:
        return np.zeros(8, np.uint32)
    bits = np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little")
    mean = (bits.sum(0) * 2 >= len(desc)).astype(np.uint8)
    return np.packbits(mean, bitorder="little").view(np.uint32)


def _kmedians(desc, k, rs, iters=8):
    """Binary k-medians with k-means++-style seeding; [k, 8] uint32."""
    n = len(desc)
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = desc
        if n > 0:
            out[n:] = desc[rs.randint(0, n, k - n)]
        return out
    centers = [desc[rs.randint(n)]]
    for _ in range(k - 1):
        d = _hamming_np(desc, np.stack(centers)).min(1).astype(np.float64)
        s = d.sum()
        if s <= 0:        # every member equals a center: seed uniformly
            centers.append(desc[rs.randint(n)])
            continue
        centers.append(desc[rs.choice(n, p=d / s)])
    C = np.stack(centers)
    for _ in range(iters):
        assign = _hamming_np(desc, C).argmin(1)
        newC = np.stack([
            _bit_vote_mean(desc[assign == j]) if (assign == j).any()
            else desc[rs.randint(n)] for j in range(k)])
        if (newC == C).all():
            break
        C = newC
    return C


def train(descriptors: np.ndarray, k: int = 10, levels: int = 4,
          seed: int = 0, max_train: int = 200_000,
          device=None) -> Vocabulary:
    """Build a k^levels vocabulary from a [N, 8] uint32 descriptor corpus
    (int32 bit views are taken as they are)."""
    rs = np.random.RandomState(seed)
    desc = np.ascontiguousarray(descriptors).view(np.uint32)
    if len(desc) > max_train:
        desc = desc[rs.choice(len(desc), max_train, replace=False)]

    cents = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(levels)]
    groups = {0: desc}           # node index at the current level -> members
    for l in range(levels):
        next_groups = {}
        for node in range(k ** l):
            members = groups.get(node, np.zeros((0, 8), np.uint32))
            C = _kmedians(members, k, rs)
            cents[l][node * k:(node + 1) * k] = C
            if len(members):
                assign = _hamming_np(members, C).argmin(1)
                for j in range(k):
                    sel = members[assign == j]
                    if len(sel):
                        next_groups[node * k + j] = sel
        groups = next_groups

    # idf weights from the corpus' occupancy of the leaves, assigned by
    # tree descent exactly as ``transform`` assigns words
    def descend(block):
        node = np.zeros(len(block), np.int64)
        for l in range(levels):
            idx = node[:, None] * k + np.arange(k)[None, :]
            x = np.bitwise_xor(cents[l][idx], block[:, None, :])
            d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            node = idx[np.arange(len(block)), d.argmin(1)]
        return node

    assign = np.concatenate([
        descend(desc[i:i + 32768]) for i in range(0, len(desc), 32768)]) \
        if len(desc) else np.zeros(0, np.int64)
    counts = np.bincount(assign, minlength=k ** levels)
    n_docs = max(len(desc) / 500.0, 1.0)   # pseudo-documents of 500 feats
    idf = np.log(n_docs / np.maximum(counts / 500.0, 1e-3))
    idf = np.clip(idf, 0.1, None).astype(np.float32)
    return _to_device(cents, idf, k, levels, device)


def default_vocab_path():
    """The JAX package's shipped vocabulary, found by file path and read
    with numpy (not copied): the 10^5-word tree, else the 10^4-word one,
    else None."""
    base = Path(__file__).resolve().parents[2] / "slam_dynamic_tpu" / "assets"
    for name in ("vocab_synth_100k.npz", "vocab_synth.npz"):
        p = base / name
        if p.exists():
            return str(p)
    return None


def load_orbvoc_text(path: str, device=None) -> Vocabulary:
    """Import a DBoW2 text vocabulary (the reference's ORBvoc.txt, written
    by TemplatedVocabulary::saveToTextFile).

    Format: a header ``k L scoring weighting``, then one node per line
    ``parent_id is_leaf b0..b31 weight``; node ids are implicit (1-based,
    file order; parents precede children) and a leaf may sit at any depth
    (a cluster of fewer than k members ends early).

    The pointer tree maps onto the complete k-ary heap layout of this
    module: a node's children are the heap rows [r*k, (r+1)*k) of the
    next level. Holes are filled so that descent is unchanged: a missing
    sibling copies its group's first real child (Hamming ties go to the
    lower index, so the real child wins), and a leaf above the bottom
    copies its descriptor down its whole subtree, whose leftmost bottom
    word carries the leaf's idf weight. Each fill pass is one array
    operation per level.
    """
    with open(path) as f:
        hdr = f.readline().split()
        k, L = int(hdr[0]), int(hdr[1])
        if not (0 < k <= 20 and 1 <= L <= 10):
            raise ValueError(f"not a DBoW2 text vocabulary header: {hdr}")
        rows = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if rows.shape[1] != 2 + 32 + 1:
        raise ValueError(f"expected 35 columns/node, got {rows.shape[1]}")
    n = rows.shape[0]
    parent = rows[:, 0].astype(np.int64)           # node id (0 = root)
    is_leaf = rows[:, 1] > 0
    desc = np.ascontiguousarray(
        rows[:, 2:34].astype(np.uint8)).view(np.uint32)   # [n, 8]
    w_leaf = rows[:, 34].astype(np.float32)

    # each node's rank among its parent's children (file order)
    order = np.argsort(parent, kind="stable")
    sp = parent[order]
    group_start = np.r_[0, np.flatnonzero(sp[1:] != sp[:-1]) + 1]
    counts = np.diff(np.r_[group_start, n])
    rank_sorted = np.arange(n) - np.repeat(group_start, counts)
    child_rank = np.empty(n, np.int64)
    child_rank[order] = rank_sorted
    if (child_rank >= k).any():
        raise ValueError("node with more than k children")

    # level and heap row of each node (parents precede children and the
    # tree is at most L deep, so L + 1 passes suffice)
    lev = np.full(n + 1, -2, np.int64)     # by node id; the root is -1
    heap = np.zeros(n + 1, np.int64)
    lev[0] = -1
    ids = np.arange(1, n + 1)
    for _ in range(L + 1):
        known = lev[parent] != -2
        upd = (lev[ids] == -2) & known
        lev[ids[upd]] = lev[parent[upd]] + 1
        heap[ids[upd]] = heap[parent[upd]] * k + child_rank[upd]
        if not upd.any():
            break
    if (lev[1:] < 0).any() or (lev[1:] >= L).any():
        raise ValueError("malformed tree: node level out of [0, L)")

    cents = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(L)]
    filled = [np.zeros(k ** (l + 1), bool) for l in range(L)]
    wts = np.zeros(k ** L, np.float32)
    for l in range(L):
        sel = lev[1:] == l
        cents[l][heap[1:][sel]] = desc[sel]
        filled[l][heap[1:][sel]] = True
    # the holes, from the top level down
    for l in range(L):
        g_desc = cents[l].reshape(-1, k, 8)
        g_fill = filled[l].reshape(-1, k)
        any_fill = g_fill.any(1)
        first = g_fill.argmax(1)                  # rank of the first real
        sib = g_desc[np.arange(g_fill.shape[0]), first]          # [G, 8]
        # a group with no real child lies under a leaf: copy the parent's
        # descriptor down
        fill_src = sib if l == 0 else np.where(any_fill[:, None], sib,
                                               cents[l - 1])
        g_desc[:] = np.where(g_fill[:, :, None], g_desc,
                             fill_src[:, None, :])
    # a leaf at level l owns the leftmost bottom word of its subtree
    word = heap[1:][is_leaf] * (k ** (L - 1 - lev[1:][is_leaf]))
    wts[word] = w_leaf[is_leaf]
    return _to_device(cents, wts, k, L, device)


def _centroids_u32(voc: Vocabulary, l: int) -> np.ndarray:
    return voc.centroids[l].cpu().numpy().view(np.uint32)


def save_orbvoc_text(path: str, voc: Vocabulary):
    """Export to the DBoW2 text format (saveToTextFile), the round-trip
    partner of ``load_orbvoc_text``: the complete heap tree, level by
    level so that parents precede children, with L1 scoring and TF-IDF
    weighting (0 0) in the header."""
    k, L = voc.k, voc.levels
    wts = voc.weights.cpu().numpy()
    # the node id of heap row r at level l is offs[l] + r + 1
    offs = np.cumsum([0] + [k ** (l + 1) for l in range(L)])
    with open(path, "w") as f:
        f.write(f"{k} {L}  0 0\n")
        for l in range(L):
            C = _centroids_u32(voc, l).view(np.uint8).reshape(-1, 32)
            par = (np.zeros(len(C), np.int64) if l == 0
                   else offs[l - 1] + np.arange(len(C)) // k + 1)
            leaf = 1 if l == L - 1 else 0
            for r in range(len(C)):
                d = " ".join(str(int(b)) for b in C[r])
                w = float(wts[r]) if leaf else 0.0
                f.write(f"{par[r]} {leaf} {d} {w}\n")


def save(path: str, voc: Vocabulary):
    """Save as .npz (k, levels, weights, c0..c{L-1} as uint32), the JAX
    package's layout: either package loads the other's file."""
    np.savez_compressed(
        path, k=voc.k, levels=voc.levels, weights=voc.weights.cpu().numpy(),
        **{f"c{l}": _centroids_u32(voc, l) for l in range(voc.levels)})


def load(path: str, device=None) -> Vocabulary:
    """A vocabulary saved as .npz (k, levels, weights, c0..c{L-1}). Any
    other file raises what ``np.load`` raises on it, as the JAX package's
    ``load`` does: a DBoW2 text file goes through ``load_orbvoc_text``."""
    with np.load(path) as z:
        k, levels = int(z["k"]), int(z["levels"])
        return _to_device([z[f"c{l}"] for l in range(levels)], z["weights"],
                          k, levels, device)


# ----------------------------------------------------------------------------
# transform and sparse BoW vectors
# ----------------------------------------------------------------------------

class BowVector(NamedTuple):
    """Per keypoint slot: its leaf word, its node at the direct-index
    level, and the word's idf weight (-1, -1, 0 for an invalid slot)."""

    word: torch.Tensor     # [N] int32
    node: torch.Tensor     # [N] int32
    weight: torch.Tensor   # [N] float32


def _first_argmin(d: torch.Tensor) -> torch.Tensor:
    """Per row, the first column holding the minimum (argmin's choice
    among ties is not specified on CUDA)."""
    cols = torch.arange(d.shape[1], device=d.device)
    return torch.where(d == d.min(1, keepdim=True)[0], cols,
                       d.shape[1]).min(1)[0]


def transform(voc: Vocabulary, desc, valid, di_level: int = 2) -> BowVector:
    """All descriptors of a frame -> words and direct-index nodes: per
    level, a gather of each descriptor's k child centroids and the first
    Hamming argmin among them."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    di_node = node
    ks = torch.arange(voc.k, device=desc.device)
    for l in range(voc.levels):
        child = node[:, None] * voc.k + ks[None, :]             # [N, k]
        d = popcount32(torch.bitwise_xor(voc.centroids[l][child],
                                         desc[:, None, :])).sum(-1)
        node = child.gather(1, _first_argmin(d)[:, None])[:, 0]
        if l == di_level:
            di_node = node
    w = voc.weights[node.clamp(0, voc.weights.shape[0] - 1)]
    return BowVector(torch.where(valid, node, -1).to(torch.int32),
                     torch.where(valid, di_node, -1).to(torch.int32),
                     torch.where(valid, w, 0.0))


def bow_histogram(bv: BowVector, n_words: int) -> torch.Tensor:
    """The dense L1-normalized tf-idf histogram [n_words]. O(n_words)
    memory, for small vocabularies and tests: the scoring path of the
    System is ``sparse_bow`` and the keyframe database."""
    ok = bv.word >= 0
    hist = torch.zeros(n_words + 1, dtype=bv.weight.dtype,
                       device=bv.weight.device).index_add_(
        0, torch.where(ok, bv.word, n_words).long(),
        torch.where(ok, bv.weight, 0.0))[:n_words]
    return hist / torch.clamp(hist.abs().sum(), min=1e-9)


class SparseBow(NamedTuple):
    """A frame's L1-normalized tf-idf vector as its top-W (word, weight)
    pairs sorted by word id, padded with PAD_WORD and weight 0."""

    word: torch.Tensor     # [W] int32
    weight: torch.Tensor   # [W] float32


def sparse_bow(bv: BowVector, top_w: int = 1024) -> SparseBow:
    """BowVector -> SparseBow: duplicate words summed, the top_w heaviest
    kept (a stable descending sort, ties to the lower slot, as
    ``jax.lax.top_k``), re-sorted by word and divided by the L1 norm of
    the whole vector."""
    word = bv.word.to(torch.int64)
    n = word.shape[0]
    dev = word.device
    wid = torch.where(word >= 0, word, PAD_WORD)
    order = torch.argsort(wid, stable=True)
    sw = wid[order]
    wt = torch.where(word >= 0, bv.weight, 0.0)[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sw[1:] != sw[:-1]
    first &= sw < PAD_WORD
    # each run of a word sums into its first slot: a float64 prefix sum
    # differenced at the run's ends (deterministic on CUDA, unlike an
    # atomic index_add_; float64 keeps the float32 sum of a short run
    # within its last bits)
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = sw[1:] != sw[:-1]
    csum = torch.cumsum(wt.to(torch.float64), 0)
    run_end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, torch.arange(n, device=dev), n), [0]), 0)[0], [0])
    before = torch.cat([csum.new_zeros(1), csum[:-1]])
    sums = (csum[run_end.clamp(max=n - 1)] - before).to(torch.float32)
    u_weight = torch.where(first, sums, 0.0)
    u_word = torch.where(first, sw, PAD_WORD)
    kk = min(top_w, n)
    vals, idx = torch.sort(u_weight, descending=True, stable=True)
    vals, idx = vals[:kk], idx[:kk]
    sel_word = torch.where(vals > 0, u_word[idx], PAD_WORD)
    o2 = torch.argsort(sel_word, stable=True)
    sel_word = sel_word[o2]
    sel_weight = torch.where(sel_word < PAD_WORD, vals[o2], 0.0)
    if kk < top_w:
        sel_word = torch.cat([sel_word, sel_word.new_full((top_w - kk,),
                                                          PAD_WORD)])
        sel_weight = torch.cat([sel_weight, sel_weight.new_zeros(top_w - kk)])
    denom = torch.clamp(wt.sum(), min=1e-9)    # L1 norm of the whole vector
    return SparseBow(sel_word.to(torch.int32), sel_weight / denom)


def l1_score(hist_a, hist_b):
    """DBoW2's L1 similarity of two normalized dense histograms, in
    [0, 1]: 1 - 0.5 |a - b|_1 (ScoringObject L1Scoring)."""
    return 1.0 - 0.5 * (hist_a - hist_b).abs().sum(-1)


# ----------------------------------------------------------------------------
# the DBoW2 scoring family on sparse vectors (ScoringObject.cpp; ORB-SLAM2
# scores with L1, the others complete the library's surface)
# ----------------------------------------------------------------------------

def _sparse_gather(q: SparseBow, w: SparseBow):
    """(q_i, w_i, hit) on w's support, q found by binary search."""
    pos = torch.searchsorted(q.word, w.word).clamp(max=q.word.shape[0] - 1)
    hit = (q.word[pos] == w.word) & (w.word < PAD_WORD)
    return torch.where(hit, q.weight[pos], 0.0), w.weight, hit


def score_l1(q: SparseBow, w: SparseBow):
    """1 - 0.5 |q - w|_1, which is sum_i min(q_i, w_i) for L1-normalized
    vectors."""
    qv, wv, hit = _sparse_gather(q, w)
    return torch.where(hit, torch.minimum(qv, wv), 0.0).sum()


def score_l2(q: SparseBow, w: SparseBow):
    """1 - sqrt(1 - q.w / (|q|_2 |w|_2)), which needs only the dot product
    over the common words (L2Scoring)."""
    nq = torch.sqrt(torch.clamp((q.weight ** 2).sum(), min=1e-18))
    nw = torch.sqrt(torch.clamp((w.weight ** 2).sum(), min=1e-18))
    qv, wv, hit = _sparse_gather(q, w)
    dot = torch.where(hit, qv * wv, 0.0).sum() / (nq * nw)
    return 1.0 - torch.sqrt(torch.clamp(1.0 - dot, min=0.0))


def score_chi_square(q: SparseBow, w: SparseBow):
    """sum_i 2 q_i w_i / (q_i + w_i) over the common words."""
    qv, wv, hit = _sparse_gather(q, w)
    return torch.where(hit, 2.0 * qv * wv / torch.clamp(qv + wv, min=1e-18),
                       0.0).sum()


def score_bhattacharyya(q: SparseBow, w: SparseBow):
    """sum_i sqrt(q_i w_i)."""
    qv, wv, hit = _sparse_gather(q, w)
    return torch.where(hit, torch.sqrt(qv * wv), 0.0).sum()


def score_dot(q: SparseBow, w: SparseBow):
    """sum_i q_i w_i."""
    qv, wv, hit = _sparse_gather(q, w)
    return torch.where(hit, qv * wv, 0.0).sum()


def score_kl(q: SparseBow, w: SparseBow):
    """KL(q || w), a word of q missing from w costing DBoW2's LOG_EPS
    floor (KLScoring; lower is more similar)."""
    log_eps = torch.log(torch.tensor(2.2204460492503131e-16,
                                     dtype=torch.float32,
                                     device=q.weight.device))
    pos = torch.searchsorted(w.word, q.word).clamp(max=w.word.shape[0] - 1)
    hit = (w.word[pos] == q.word) & (q.word < PAD_WORD)
    real = q.word < PAD_WORD
    wv = torch.where(hit, w.weight[pos], 0.0)
    lq = torch.log(torch.clamp(q.weight, min=1e-18))
    term = torch.where(hit, lq - torch.log(torch.clamp(wv, min=1e-18)),
                       lq - log_eps)
    return torch.where(real & (q.weight > 0), q.weight * term, 0.0).sum()
