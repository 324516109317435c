"""Visual vocabulary: a bag of binary words as a dense k-ary tree.

Port of ``slam_dynamic_tpu/models/vocabulary.py``: ``Vocabulary`` :32,
the host-numpy training ``train`` :112 (with ``_hamming_np`` :58,
``_bit_vote_mean`` :73 and ``_kmedians`` :83, copied as numpy code),
``default_vocab_path`` :163, ``load`` :305, ``BowVector`` and
``transform`` (``_transform_impl`` :326-357), ``PAD_WORD``, ``SparseBow``
and ``sparse_bow`` (``_sparse_bow_impl`` :391-426). Descent and BoW
building are plain PyTorch ops (the reference runs them as XLA ops, not
as a Pallas kernel).

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


def load(path: str, device=None) -> Vocabulary:
    """A vocabulary saved as .npz (k, levels, weights, c0..c{L-1})."""
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
