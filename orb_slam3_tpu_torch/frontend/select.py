"""Spatially spread keypoint selection to a fixed budget (port of
orb_slam3_tpu/frontend/select.py).

Same output contract as `ORBextractor::DistributeOctTree` with fixed shapes:
top-k per spatial cell, then a global top-N that takes every cell's best
corner before any cell's second (round robin by per-cell rank, by response
within a rank).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def select_keypoints(resp, n_max: int, cell: int = 32, per_cell: int = 4):
    """resp [H, W] (0 = invalid) -> (xy [n, 2] f32 (x, y), score [n], valid [n]),
    n = min(n_max, cells * per_cell).

    Ties break as in the JAX package: the per-cell top-k keeps the lower
    index first (stable descending sort), and the global order is a stable
    argsort of the same f32 key 4e9*invalid + 1e9*rank - response, whose
    1e9 offsets make responses inside a rank collapse to index-ordered ties.
    """
    h, w = resp.shape
    ph, pw = (-h) % cell, (-w) % cell
    rp = F.pad(resp, (0, pw, 0, ph))
    hp, wp = rp.shape
    ncy, ncx = hp // cell, wp // cell
    cells = rp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell
    )

    k = min(per_cell, cell * cell)
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :k], idx[:, :k]

    cell_ids = torch.arange(ncy * ncx, device=resp.device)
    cy = (cell_ids // ncx) * cell
    cx = (cell_ids % ncx) * cell
    yy = cy[:, None] + top_idx // cell
    xx = cx[:, None] + top_idx % cell

    valid = top_vals > 0.0
    rank = torch.arange(k, device=resp.device)[None, :].expand(top_vals.shape)

    flat_vals = top_vals.reshape(-1)
    flat_rank = rank.reshape(-1)
    flat_valid = valid.reshape(-1)
    flat_y = yy.reshape(-1).to(torch.float32)
    flat_x = xx.reshape(-1).to(torch.float32)

    big = 1e9
    f32 = dict(dtype=torch.float32, device=resp.device)
    key = (
        torch.where(flat_valid, torch.tensor(0.0, **f32), torch.tensor(4.0 * big, **f32))
        + flat_rank.to(torch.float32) * big
        - flat_vals
    )
    order = torch.argsort(key, stable=True)[:n_max]

    xy = torch.stack([flat_x[order], flat_y[order]], dim=-1)
    return xy, flat_vals[order], flat_valid[order]
