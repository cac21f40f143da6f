"""Atlas multi-map state as fixed-capacity struct-of-arrays tensors (port of
orb_slam3_tpu/atlas/state.py).

The reference's KeyFrame/MapPoint objects (`Map.cc`, `Atlas.cc`,
`KeyFrame.cc`, `MapPoint.cc`) become rows of padded tensors: keyframe
poses and per-feature arrays, landmark positions and statistics, and one
feature-major observation table `kf_feat_lm[k, f]` = landmark row or -1.
The covisibility graph is an incidence-matrix product; the Atlas's maps are
a `map_id` column plus an `active_map` counter. Counters are 0-dim int32
tensors on the map's device.

Every function here returns new tensors and never writes into its input:
callers keep snapshots.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import device as device_mod
from ..frontend import matching
from ..ops.scatter import add_at

NO_LM = -1


@dataclasses.dataclass
class MapState:
    """One arena holding every map of the Atlas (rows tagged by map_id)."""

    # keyframes
    kf_R: torch.Tensor          # [K, 3, 3] Tcw rotation
    kf_t: torch.Tensor          # [K, 3]    Tcw translation
    kf_vel: torch.Tensor        # [K, 3]    world velocity (inertial)
    kf_bg: torch.Tensor         # [K, 3]    gyro bias
    kf_ba: torch.Tensor         # [K, 3]    acc bias
    kf_timestamp: torch.Tensor  # [K]
    kf_map_id: torch.Tensor     # [K] int32
    kf_valid: torch.Tensor      # [K] bool
    kf_parent: torch.Tensor     # [K] int32 spanning-tree parent (-1 root)
    kf_prev: torch.Tensor       # [K] int32 temporal chain (mPrevKF)
    # per-keyframe features
    kf_feat_xy: torch.Tensor      # [K, F, 2]
    kf_feat_octave: torch.Tensor  # [K, F] int32
    kf_feat_angle: torch.Tensor   # [K, F]
    kf_feat_desc: torch.Tensor    # [K, F, 32] uint8
    kf_feat_ur: torch.Tensor      # [K, F] right-camera u (< 0: mono)
    kf_feat_depth: torch.Tensor   # [K, F] (<= 0: none)
    kf_feat_valid: torch.Tensor   # [K, F] bool
    kf_feat_lm: torch.Tensor      # [K, F] int32 landmark row or NO_LM
    # landmarks
    lm_pos: torch.Tensor        # [L, 3]
    lm_normal: torch.Tensor     # [L, 3] mean viewing direction
    lm_min_dist: torch.Tensor   # [L] scale-invariance range
    lm_max_dist: torch.Tensor   # [L]
    lm_desc: torch.Tensor       # [L, 32] uint8
    lm_map_id: torch.Tensor     # [L] int32
    lm_valid: torch.Tensor      # [L] bool
    lm_visible: torch.Tensor    # [L] int32 (mnVisible)
    lm_found: torch.Tensor      # [L] int32 (mnFound)
    lm_first_kf: torch.Tensor   # [L] int32
    # counters / atlas (0-dim int32)
    n_kf: torch.Tensor
    n_lm: torch.Tensor
    active_map: torch.Tensor
    n_maps: torch.Tensor

    @property
    def kmax(self) -> int:
        return self.kf_R.shape[0]

    @property
    def lmax(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def fmax(self) -> int:
        return self.kf_feat_xy.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kf_R.device


def empty(kmax: int = 256, fmax: int = 1024, lmax: int = 16384, device=None) -> MapState:
    """An empty arena on `device` (default CUDA)."""
    dev = device_mod.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return MapState(
        kf_R=torch.eye(3, **f32).repeat(kmax, 1, 1),
        kf_t=torch.zeros((kmax, 3), **f32),
        kf_vel=torch.zeros((kmax, 3), **f32),
        kf_bg=torch.zeros((kmax, 3), **f32),
        kf_ba=torch.zeros((kmax, 3), **f32),
        kf_timestamp=torch.zeros((kmax,), **f32),
        kf_map_id=torch.full((kmax,), -1, **i32),
        kf_valid=torch.zeros((kmax,), **b),
        kf_parent=torch.full((kmax,), -1, **i32),
        kf_prev=torch.full((kmax,), -1, **i32),
        kf_feat_xy=torch.zeros((kmax, fmax, 2), **f32),
        kf_feat_octave=torch.zeros((kmax, fmax), **i32),
        kf_feat_angle=torch.zeros((kmax, fmax), **f32),
        kf_feat_desc=torch.zeros((kmax, fmax, 32), dtype=torch.uint8, device=dev),
        kf_feat_ur=torch.full((kmax, fmax), -1.0, **f32),
        kf_feat_depth=torch.zeros((kmax, fmax), **f32),
        kf_feat_valid=torch.zeros((kmax, fmax), **b),
        kf_feat_lm=torch.full((kmax, fmax), NO_LM, **i32),
        lm_pos=torch.zeros((lmax, 3), **f32),
        lm_normal=torch.zeros((lmax, 3), **f32),
        lm_min_dist=torch.zeros((lmax,), **f32),
        lm_max_dist=torch.zeros((lmax,), **f32),
        lm_desc=torch.zeros((lmax, 32), dtype=torch.uint8, device=dev),
        lm_map_id=torch.full((lmax,), -1, **i32),
        lm_valid=torch.zeros((lmax,), **b),
        lm_visible=torch.zeros((lmax,), **i32),
        lm_found=torch.zeros((lmax,), **i32),
        lm_first_kf=torch.full((lmax,), -1, **i32),
        n_kf=torch.zeros((), **i32),
        n_lm=torch.zeros((), **i32),
        active_map=torch.zeros((), **i32),
        n_maps=torch.ones((), **i32),
    )


def to_device(s: MapState, dev) -> MapState:
    """The map with every field on `dev`."""
    return dataclasses.replace(s, **{f.name: getattr(s, f.name).to(dev)
                                     for f in dataclasses.fields(s)})


# ---------------------------------------------------------------------------
# Covisibility graph (KeyFrame::UpdateConnections as an incidence product)
# ---------------------------------------------------------------------------

def _bound(s: MapState):
    """[K, F] bool: feature bound to a landmark of a valid keyframe, and the
    landmark rows clipped into range."""
    ok = (s.kf_feat_lm >= 0) & s.kf_feat_valid & s.kf_valid[:, None]
    return ok, torch.clamp(s.kf_feat_lm, 0, s.lmax - 1).long()


def observation_matrix(s: MapState) -> torch.Tensor:
    """[K, L] bool: keyframe k observes landmark l."""
    K, L = s.kmax, s.lmax
    ok, lm = _bound(s)
    rows = torch.arange(K, device=s.device)[:, None].expand_as(lm)
    M = torch.zeros(K * L, dtype=torch.int32, device=s.device)
    M = M.scatter_reduce(0, (rows * L + lm).reshape(-1), ok.reshape(-1).to(torch.int32),
                         "amax")
    return M.reshape(K, L) > 0


def covisibility_weights(s: MapState) -> torch.Tensor:
    """[K, K] int32 shared-landmark counts, diagonal zeroed (the
    reference's per-keyframe hash maps, `KeyFrame.cc:379-470`). One f32
    matmul: the counts are exact with TF32 off (device.init_cuda)."""
    M = observation_matrix(s).to(torch.float32)
    W = (M @ M.T).to(torch.int32)
    return W - torch.diag(torch.diagonal(W))


def essential_edges(s: MapState, W: torch.Tensor, min_weight: int = 100):
    """Essential-graph adjacency: spanning-tree edges plus covisibility edges
    with weight >= min_weight (`Optimizer.cc:1530`). [K, K] bool, symmetric."""
    K = s.kmax
    parent_ok = ((s.kf_parent >= 0) & s.kf_valid).to(torch.int32)
    rows = torch.arange(K, device=s.device)
    par = torch.clamp(s.kf_parent, 0, K - 1).long()
    A = (W >= min_weight).to(torch.int32).reshape(-1)
    A = A.scatter_reduce(0, rows * K + par, parent_ok, "amax")
    A = A.scatter_reduce(0, par * K + rows, parent_ok, "amax")
    A = A.reshape(K, K) > 0
    return A & s.kf_valid[:, None] & s.kf_valid[None, :]


# ---------------------------------------------------------------------------
# Landmark statistics
# ---------------------------------------------------------------------------

def update_landmark_stats(s: MapState, scale_factor: float = 1.2,
                          n_levels: int = 8) -> MapState:
    """Normals and scale-invariance distances from the current observations
    (MapPoint::UpdateNormalAndDepth, `MapPoint.cc:426-480`): the mean
    viewing direction, and the mean observing distance times
    scale_factor ** (mean octave)."""
    L = s.lmax
    ok, lm = _bound(s)
    Ow = -torch.einsum("kij,ki->kj", s.kf_R, s.kf_t)  # camera centres
    dirs = s.lm_pos[lm] - Ow[:, None, :]
    norms = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    unit = dirs / torch.clamp(norms, min=1e-9)
    okf = ok.to(torch.float32)
    z = torch.zeros((L,), dtype=torch.float32, device=s.device)
    lm, ok = lm.reshape(-1), ok.reshape(-1)
    normal_sum = add_at(torch.zeros((L, 3), dtype=torch.float32, device=s.device), lm,
                        unit.reshape(-1, 3), ok)
    n_obs = add_at(z, lm, okf.reshape(-1), ok)
    dist_sum = add_at(z, lm, norms.reshape(-1), ok)
    oct_sum = add_at(z, lm, s.kf_feat_octave.reshape(-1).to(torch.float32), ok)
    denom = torch.clamp(n_obs, min=1.0)
    normal = normal_sum / denom[:, None]
    mean_dist = dist_sum / denom
    mean_oct = oct_sum / denom
    max_dist = mean_dist * torch.pow(torch.tensor(scale_factor, dtype=torch.float32,
                                                  device=s.device), mean_oct)
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    has = n_obs > 0
    return dataclasses.replace(
        s,
        lm_normal=torch.where(has[:, None], normal, s.lm_normal),
        lm_max_dist=torch.where(has, max_dist, s.lm_max_dist),
        lm_min_dist=torch.where(has, min_dist, s.lm_min_dist),
    )


def predict_octave(s: MapState, dist, n_levels: int = 8, scale: float = 1.2):
    """MapPoint::PredictScale (`MapPoint.h:150-152`): ceil(log(max_dist /
    dist) / log(scale)), clipped to the levels."""
    ratio = torch.clamp(s.lm_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    log_s = torch.log(torch.tensor(scale, dtype=torch.float32, device=ratio.device))
    lvl = torch.ceil(torch.log(ratio) / log_s)
    return torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)


def compute_distinctive_descriptors(s: MapState, lm_rows) -> MapState:
    """Distinctive descriptor per landmark (MapPoint::ComputeDistinctive-
    Descriptors, `MapPoint.cc:329-424`) for the [R] rows `lm_rows`, over up
    to the first 16 observations in (keyframe, feature) order: the
    observation with the least mean Hamming distance to the others."""
    K, F, L = s.kmax, s.fmax, s.lmax
    cap = 16
    ok, lm = _bound(s)
    flat_lm = torch.where(ok, lm, L).reshape(-1)  # unbound -> L, sorted last
    order = torch.argsort(flat_lm, stable=True)
    sorted_lm = flat_lm[order]
    rows = lm_rows.long()
    start = torch.searchsorted(sorted_lm, rows)
    pos = torch.clamp(start[:, None] + torch.arange(cap, device=s.device), 0, K * F - 1)
    idx = order[pos]                                   # [R, cap]
    valid = sorted_lm[pos] == rows[:, None]
    descs = s.kf_feat_desc.reshape(-1, 32)[idx]        # [R, cap, 32]
    d = matching.popcount_bytes(descs[:, :, None, :] ^ descs[:, None, :, :])
    d = torch.where(valid[:, :, None] & valid[:, None, :], d, 0)
    cnt = torch.clamp(valid.sum(dim=1), min=1)
    mean = d.sum(dim=2).to(torch.float32) / cnt[:, None].to(torch.float32)
    mean = torch.where(valid, mean, float("inf"))
    best = torch.argmin(mean, dim=1)
    new = descs[torch.arange(rows.shape[0], device=s.device), best]
    has = valid.any(dim=1)
    lm_desc = s.lm_desc.clone()
    lm_desc[rows] = torch.where(has[:, None], new, s.lm_desc[rows])
    return dataclasses.replace(s, lm_desc=lm_desc)
