"""The vocabulary's training: hierarchical k-majority over binary descriptors.

Frozen copy of `orb_slam3_tpu_torch/place/vocab.py` at commit 356070c
(`_hamming_np`, `_kmajority`, `_transform_np`, `train`), numpy only. It
returns the tree's centres and idf weights; the harness wraps them in the
program's `Vocabulary` type, the stand-in for the ORBvoc file every
ORB-SLAM3 user loads.
"""

from __future__ import annotations

import numpy as np


def _hamming(a, b):
    return np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=2).sum(axis=2)


def _kmajority(desc, k, rng, iters=8):
    """Binary k-means: centres are per-bit majorities of their cluster."""
    n = desc.shape[0]
    if n <= k:
        centers = np.zeros((k, 32), np.uint8)
        centers[:n] = desc
        if n > 0:
            centers[n:] = desc[rng.integers(0, n, k - n)]
        return centers
    centers = desc[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        assign = _hamming(desc, centers).argmin(axis=1)
        new = []
        for c in range(k):
            sel = desc[assign == c]
            if len(sel) == 0:
                new.append(desc[rng.integers(0, n)])
                continue
            maj = (np.unpackbits(sel, axis=1).mean(axis=0) >= 0.5).astype(np.uint8)
            new.append(np.packbits(maj))
        centers = np.stack(new)
    return centers


def _words(centers, k: int, L: int, desc):
    """The leaf word of each descriptor (first argmin on ties)."""
    off = 0
    node = np.zeros(desc.shape[0], np.int64)
    for lvl in range(L):
        cand = node[:, None] * k + np.arange(k)[None, :]
        dc = np.unpackbits(desc[:, None, :] ^ centers[off + cand], axis=2).sum(axis=2)
        node = node * k + dc.argmin(axis=1)
        off += k ** (lvl + 1)
    return node


def train(descriptors: np.ndarray, branching: int = 8, depth: int = 3, seed: int = 0):
    """(centres [n_nodes, 32] uint8, idf [k^depth] float32) of the tree."""
    descriptors = np.asarray(descriptors, np.uint8)
    rng = np.random.default_rng(seed)
    k, L = branching, depth
    levels, groups = [], [descriptors]
    for lvl in range(L):
        centers_lvl, next_groups = [], []
        for g in groups:
            c = _kmajority(g, k, rng)
            centers_lvl.append(c)
            if lvl + 1 < L:
                if len(g) == 0:
                    next_groups.extend([g] * k)
                else:
                    a = _hamming(g, c).argmin(axis=1)
                    next_groups.extend([g[a == i] for i in range(k)])
        levels.append(np.concatenate(centers_lvl, axis=0))
        groups = next_groups
    centers = np.concatenate(levels, axis=0)
    counts = np.bincount(_words(centers, k, L, descriptors), minlength=k ** L).astype(np.float64)
    idf = np.log(max(len(descriptors), 1) / np.maximum(counts, 1.0))
    return centers, idf.astype(np.float32)
