"""Map-structure invariant checks (the port's own copy of
orb_slam3_tpu/atlas/invariants.py).

The role of the reference's debug validators (`Map::CheckEssentialGraph`,
`Map.h:128`) as pure functions over a MapState, usable as test predicates.
Each check reads the map to the host once and returns a list of violation
strings (empty = healthy).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def check_spanning_tree(s) -> list[str]:
    """Every valid keyframe is a root (parent < 0) or points to a valid
    parent in the same map, and parent chains are acyclic
    (`KeyFrame.h:220-247`)."""
    bad = []
    n = int(s.n_kf)
    valid = _np(s.kf_valid)[:n]
    parent = _np(s.kf_parent)[:n]
    map_id = _np(s.kf_map_id)[:n]
    for r in range(n):
        if not valid[r]:
            continue
        p = parent[r]
        if p < 0:
            continue
        if p >= n or not valid[p]:
            bad.append(f"KF {r}: parent {p} invalid")
            continue
        if map_id[p] != map_id[r]:
            bad.append(f"KF {r}: parent {p} in different map")
        seen = set()
        cur = r
        while cur >= 0 and parent[cur] >= 0:
            if cur in seen:
                bad.append(f"KF {r}: parent cycle through {cur}")
                break
            seen.add(cur)
            cur = parent[cur]
    return bad


def check_prev_chain(s) -> list[str]:
    """A valid keyframe's temporal link, if set, points to a valid earlier
    keyframe of the same map with an earlier timestamp
    (`LocalMapping.cc:1020-1041`)."""
    bad = []
    n = int(s.n_kf)
    valid = _np(s.kf_valid)[:n]
    prev = _np(s.kf_prev)[:n]
    map_id = _np(s.kf_map_id)[:n]
    ts = _np(s.kf_timestamp)[:n]
    for r in range(n):
        if not valid[r] or prev[r] < 0:
            continue
        p = prev[r]
        if p >= r:
            bad.append(f"KF {r}: prev {p} not earlier")
        elif not valid[p]:
            bad.append(f"KF {r}: prev {p} culled but still linked")
        elif map_id[p] != map_id[r]:
            bad.append(f"KF {r}: prev {p} in different map")
        elif ts[p] >= ts[r]:
            bad.append(f"KF {r}: prev timestamp not increasing")
    return bad


def check_observations(s) -> list[str]:
    """Feature bindings point at valid landmarks, and every valid landmark
    is observed by at least one valid keyframe (`MapPoint.h`)."""
    bad = []
    n = int(s.n_kf)
    L = s.lm_pos.shape[0]
    valid = _np(s.kf_valid)[:n]
    lm_valid = _np(s.lm_valid)
    feat_lm = _np(s.kf_feat_lm)[:n]
    feat_valid = _np(s.kf_feat_valid)[:n]
    obs_count = np.zeros(L, np.int64)
    for r in range(n):
        if not valid[r]:
            continue
        bound = (feat_lm[r] >= 0) & feat_valid[r]
        rows = feat_lm[r][bound]
        dead = ~lm_valid[np.clip(rows, 0, L - 1)]
        if dead.any():
            bad.append(f"KF {r}: {int(dead.sum())} observations of dead landmarks")
        np.add.at(obs_count, np.clip(rows, 0, L - 1), 1)
    orphan = lm_valid & (obs_count == 0)
    if orphan.any():
        bad.append(f"{int(orphan.sum())} valid landmarks with no observation")
    return bad


def check_all(s) -> list[str]:
    return check_spanning_tree(s) + check_prev_chain(s) + check_observations(s)
