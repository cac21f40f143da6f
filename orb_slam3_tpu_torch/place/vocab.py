"""Bag-of-binary-words vocabulary as dense tensors (port of
orb_slam3_tpu/place/vocab.py).

The role of DBoW2's `TemplatedVocabulary<FORB>` (ORBVocabulary): a
hierarchical k-majority tree over binary descriptors; `transform_words`
descends it per descriptor by Hamming distance (one batched gather of each
feature's k children per level), and scoring is DBoW2's L1 score on
L1-normalized tf-idf vectors (`ScoringObject.cc`). A keyframe's BoW vector
is stored sparse, as (word id, weight) pairs (`SparseBow`), so the
database scales with features, not with the vocabulary.

`train` is numpy, a copy of the JAX package's, so the same descriptors give
the same tree on either side; `load_orb_text` reads the reference's
ORBvoc.txt format. No vocabulary file ships with the repo: vocabularies
are trained in the run from held-out views.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..frontend import matching


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    """centers: [n_total, 32] uint8, the node centers level by level (level
    l holds k^(l+1) nodes); weights: [n_words] f32 idf weights."""

    centers: torch.Tensor
    weights: torch.Tensor
    branching: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth

    @property
    def device(self) -> torch.device:
        return self.centers.device


def _hamming_np(a, b):
    return np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=2).sum(axis=2)


def _kmajority(desc, k, rng, iters=8):
    """Binary k-means: centers are per-bit majorities of their cluster."""
    n = desc.shape[0]
    if n <= k:
        centers = np.zeros((k, 32), np.uint8)
        centers[:n] = desc
        if n > 0:
            centers[n:] = desc[rng.integers(0, n, k - n)]
        return centers
    centers = desc[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d = _hamming_np(desc, centers)
        assign = d.argmin(axis=1)
        new = []
        for c in range(k):
            sel = desc[assign == c]
            if len(sel) == 0:
                new.append(desc[rng.integers(0, n)])
                continue
            bits = np.unpackbits(sel, axis=1)
            maj = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
            new.append(np.packbits(maj))
        centers = np.stack(new)
    return centers


def _transform_np(centers, k: int, L: int, desc):
    """transform_words in numpy (first argmin on ties, as jnp.argmin)."""
    off = 0
    node = np.zeros(desc.shape[0], np.int64)
    for lvl in range(L):
        cand = node[:, None] * k + np.arange(k)[None, :]
        x = desc[:, None, :] ^ centers[off + cand]
        dc = np.unpackbits(x, axis=2).sum(axis=2)
        node = node * k + dc.argmin(axis=1)
        off += k ** (lvl + 1)
    return node


def train(descriptors: np.ndarray, branching: int = 8, depth: int = 3, seed: int = 0,
          device=None) -> Vocabulary:
    """Hierarchical k-majority training (TemplatedVocabulary::create) on
    [N, 32] uint8 descriptors, with idf weights from the same sample
    (setNodeWeights). Numpy, the JAX package's draws and order; the tables
    go to `device` (default CUDA)."""
    dev = device_mod.resolve(device)
    descriptors = np.asarray(descriptors, np.uint8)
    rng = np.random.default_rng(seed)
    k, L = branching, depth
    levels = []
    groups = [descriptors]
    for lvl in range(L):
        centers_lvl = []
        next_groups = []
        for g in groups:
            c = _kmajority(g, k, rng)
            centers_lvl.append(c)
            if lvl + 1 < L:
                if len(g) == 0:
                    next_groups.extend([g] * k)
                else:
                    a = _hamming_np(g, c).argmin(axis=1)
                    next_groups.extend([g[a == i] for i in range(k)])
        levels.append(np.concatenate(centers_lvl, axis=0))
        groups = next_groups
    centers = np.concatenate(levels, axis=0)
    words = _transform_np(centers, k, L, descriptors)
    counts = np.bincount(words, minlength=k ** L).astype(np.float64)
    idf = np.log(max(len(descriptors), 1) / np.maximum(counts, 1.0))
    return Vocabulary(centers=torch.from_numpy(centers).to(dev),
                      weights=torch.from_numpy(idf.astype(np.float32)).to(dev),
                      branching=k, depth=L)


def transform_words(voc: Vocabulary, desc, valid):
    """[F, 32] descriptors -> [F] int32 leaf word ids (0 where not valid):
    per level only each feature's k child centers are gathered and compared,
    so the work is O(F k L) whatever the level width."""
    k, L = voc.branching, voc.depth
    dev = desc.device
    ar = torch.arange(k, device=dev)
    off = 0
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=dev)
    for lvl in range(L):
        cand = node[:, None] * k + ar[None, :]
        dc = matching.popcount_bytes(desc[:, None, :] ^ voc.centers[off + cand])
        node = node * k + torch.argmin(dc, dim=1)
        off += k ** (lvl + 1)
    return torch.where(valid, node, 0).to(torch.int32)


def bow_vector(voc: Vocabulary, desc, valid):
    """Dense L1-normalized tf-idf BoW vector [n_words]."""
    words = transform_words(voc, desc, valid).long()
    tf = torch.zeros((voc.n_words,), dtype=torch.float32, device=desc.device)
    tf = tf.index_put((words,), valid.to(torch.float32), accumulate=True)
    v = tf * voc.weights
    n = torch.sum(torch.abs(v))
    return v / torch.where(n < 1e-12, 1.0, n)


def l1_score(a, b):
    """DBoW2 L1 score in [0, 1] of normalized vectors: 1 - 0.5 |a - b|_1."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


def load_orb_text(path: str, depth_limit: int | None = None, device=None) -> Vocabulary:
    """Read a DBoW2 text vocabulary, the reference's `Vocabulary/ORBvoc.txt`
    format (TemplatedVocabulary::loadFromTextFile): a header `k L scoring
    weighting`, then one node per line `parent_id is_leaf d0..d31 weight`,
    ids from 1 (root 0). Missing children are padded with a copy of the
    node's first real child (descent ties go to the first, real, one, and
    padded leaves weigh 0); early leaves repeat their own center downward.
    depth_limit truncates the tree (internal centers become the leaves, with
    uniform weights)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        children: list[list[int]] = [[]]
        descs = [np.zeros(32, np.uint8)]
        weights_n = [0.0]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            pid = int(parts[0])
            nid = len(children)
            children.append([])
            children[pid].append(nid)
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights_n.append(float(parts[34]))
    if depth_limit is not None:
        L = min(L, int(depth_limit))
    levels: list[np.ndarray] = []
    leaf_weights = []
    frontier = [(0, False)]
    for lvl in range(L):
        slots = []
        for nid, pad in frontier:
            real = children[nid][:k]
            if real:
                filled = [(c, pad) for c in real] + [(real[0], True)] * (k - len(real))
            else:
                filled = [(nid, pad)] + [(nid, True)] * (k - 1)
            slots.extend(filled)
        levels.append(np.stack([descs[nid] for nid, _ in slots]))
        if lvl == L - 1:
            leaf_weights = [0.0 if pad else weights_n[nid] for nid, pad in slots]
        frontier = slots
    w = np.array(leaf_weights, np.float32)
    if w.max() <= 0.0:
        w = np.ones_like(w)
    dev = device_mod.resolve(device)
    return Vocabulary(centers=torch.from_numpy(np.concatenate(levels, axis=0)).to(dev),
                      weights=torch.from_numpy(w).to(dev), branching=k, depth=L)


# ---------------------------------------------------------------------------
# Sparse BoW: (word id, weight) pairs
# ---------------------------------------------------------------------------

class SparseBow(NamedTuple):
    """L1-normalized tf-idf BoW as one slot per feature: ids [S] int32 with
    the sentinel n_words on empty slots, vals [S] f32 (0 there)."""

    ids: torch.Tensor
    vals: torch.Tensor


def sparse_bow(voc: Vocabulary, desc, valid) -> SparseBow:
    """transform, merge equal words (a stable sort, then segment sums) and
    L1-normalize. Reads nothing back to the host."""
    F = desc.shape[0]
    W = voc.n_words
    dev = desc.device
    words = transform_words(voc, desc, valid)
    words = torch.where(valid, words, W)
    tfw = torch.where(valid, voc.weights[torch.clamp(words, 0, W - 1).long()], 0.0)
    order = torch.argsort(words, stable=True)
    sw, sv = words[order], tfw[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), sw[1:] != sw[:-1]])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    ids = torch.full((F,), W, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg, sw, "amin")
    vals = torch.zeros((F,), dtype=torch.float32, device=dev).index_put(
        (seg,), sv, accumulate=True)
    vals = torch.where(ids < W, vals, 0.0)
    n = torch.sum(vals)
    return SparseBow(ids=ids, vals=vals / torch.where(n < 1e-12, 1.0, n))


def sparse_l1_score(a: SparseBow, b: SparseBow, n_words: int):
    """L1 score by the common-word identity: for L1-normalized vectors
    1 - 0.5 |a - b|_1 = sum over common words of min(a_i, b_i)."""
    dense = torch.zeros((n_words + 1,), dtype=torch.float32, device=a.ids.device)
    dense = dense.index_put((a.ids.long(),), a.vals, accumulate=True)
    got = dense[torch.clamp(b.ids, 0, n_words).long()]
    return torch.sum(torch.minimum(got, b.vals) * (b.ids < n_words))
