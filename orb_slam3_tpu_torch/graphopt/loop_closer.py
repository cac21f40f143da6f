"""Loop closing and map merging (port of
orb_slam3_tpu/graphopt/loop_closer.py).

Role of the LoopClosing thread (`LoopClosing.cc`), run after each keyframe:
a place-recognition query (`NewDetectCommonRegions:324`), then the
verification cascade of `DetectCommonRegionsFromBoW` (`:578-885`):

  1. BoW matches against the candidate's and its best covisibles' pooled
     map points (>= 20),
  2. Sim3 RANSAC (>= 15 inliers, `:699`),
  3. guided projection through the coarse Sim3 (>= 50, `:758`),
  4. OptimizeSim3 (>= 20, `:769`),
  5. re-projection at the refined Sim3 with a tighter window (>= 80,
     `:779`),
  6. three covisible keyframes of the current one re-finding the region
     (`:819-843`); short of three the detection is pending and must be
     re-confirmed on the next keyframes (`DetectAndReffineSim3FromLastKF`,
     `:396, 880`; two misses reset it, `:409-416`).

A confirmed detection in the same map is a loop correction (`CorrectLoop`,
`:969`: the corrected Sim3 through the covisible window, landmark
transport, essential-graph optimization, SearchAndFuse welding); in another
map it is a merge (`MergeLocal`, `:1215`). The welding runs
`fuse.merge_duplicates_at_keyframe`, kernel K1 on the card.

The host reads what the JAX package reads: each gate is one host read of
its count. Ties keep the JAX package's order: `np.argsort(-W)` on the host
(numpy's quicksort, as there) for the covisible keyframes, lax.top_k's for
the candidates; the Sim3 RANSAC of keyframe row k draws its sets from a CPU
generator seeded with k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..atlas import ops as atlas_ops
from ..atlas import state as atlas_state
from ..frontend import camera as cam_mod
from ..frontend import matching
from ..mapping import fuse as fuse_mod
from ..mapping import local_mapper
from ..ops import lie
from ..ops.scatter import mark
from ..place import recognition, vocab as vocab_mod
from ..utils.timing import GLOBAL_TIMER
from . import essential, sim3_solver


@dataclasses.dataclass
class LoopCloserConfig:
    # verification-cascade gates (LoopClosing.cc:581-585)
    n_bow_matches: int = 20
    n_bow_inliers: int = 15
    n_sim3_inliers: int = 20
    n_proj_matches: int = 50
    n_proj_opt_matches: int = 80
    # temporal / covisible consistency (LoopClosing.cc:396, 541-543, 822-843)
    n_consistency: int = 3
    n_refine_matches: int = 30
    n_refine_opt_matches: int = 50
    max_not_found: int = 2
    n_covisibles_pool: int = 10
    # projection windows (SearchByProjection th, LoopClosing.cc:756, 777)
    proj_radius_coarse: float = 12.0
    proj_radius_fine: float = 6.0
    min_kfs_in_map: int = 12
    min_temporal_gap: int = 10
    covis_threshold: int = 15
    run_pgo: bool = True


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _pool_rows(W_row, self_row: int, n: int, valid):
    """self and the best n covisible keyframe rows (GetBestCovisibility-
    KeyFrames), ties in numpy's argsort order."""
    W_row = _np(W_row).copy()
    W_row[self_row] = 0
    order = np.argsort(-W_row)
    return [self_row] + [int(r) for r in order[:n] if W_row[r] > 0 and valid[r]]


def _landmark_pool(s: atlas_state.MapState, rows):
    """[lmax] bool: the valid landmarks observed by keyframes `rows`."""
    rows_t = torch.as_tensor(rows, dtype=torch.long, device=s.device)
    lm = s.kf_feat_lm[rows_t]
    ok = (lm >= 0) & s.kf_feat_valid[rows_t]
    return mark(s.lmax, lm.long().reshape(-1), ok.reshape(-1), s.device) & s.lm_valid


def project_match_sim3(kind, K8, Rs, ts, ss, lm_pos, lm_desc, pool, feat_xy, feat_desc,
                       feat_valid, radius_px, max_dist=matching.TH_LOW,
                       lm_normal=None, lm_min_dist=None, lm_max_dist=None):
    """SearchByProjection through a Sim3 world -> camera transform
    (`ORBmatcher::SearchByProjection(KeyFrame*, Scw, ...)`,
    `ORBmatcher.cc:43-150`): the pooled landmarks projected, window-gated
    against the keyframe's features, best descriptor match per landmark.
    With the landmark normals and scale range, the viewing-direction and
    distance gates (`:92-105`), which reject a mirrored alias seen from
    behind. Returns (feat_idx [L], dist [L], ok [L])."""
    ss = torch.as_tensor(ss, dtype=torch.float32, device=lm_pos.device)
    Xc = ss * torch.einsum("ij,lj->li", Rs, lm_pos) + ts
    uvp = cam_mod.project(kind, K8, Xc)
    front = (Xc[:, 2] > 0.05) & pool
    if lm_normal is not None:
        O = -torch.einsum("ji,j->i", Rs, ts) / torch.clamp(ss, min=1e-9)
        PO = lm_pos - O[None, :]
        d3 = torch.linalg.norm(PO, dim=-1)
        view_ok = torch.sum(PO * lm_normal, dim=-1) >= 0.5 * d3
        dist_ok = (d3 >= 0.8 * lm_min_dist) & (d3 <= 1.2 * lm_max_dist)
        front = front & view_ok & dist_ok
    win = matching.window_mask(uvp, feat_xy, radius_px, front, feat_valid)
    dist = matching.hamming_matrix(lm_desc, feat_desc)
    return matching.masked_best_match(dist, win, max_dist=max_dist)


@dataclasses.dataclass
class PendingLoop:
    """A detection that passed the cascade but not yet the consistency gate
    (mnLoopNumCoincidences / mg2oLoopSlw)."""

    cand: int
    last_kf: int
    Rsw: torch.Tensor
    tsw: torch.Tensor
    ssw: float
    pool: torch.Tensor
    n_coincidences: int
    n_not_found: int = 0


class LoopCloser:
    """Keyframe database, loop / merge detection and correction for one
    tracker; `on_keyframe` after each keyframe insertion."""

    def __init__(self, voc: vocab_mod.Vocabulary, kmax: int,
                 cfg: LoopCloserConfig | None = None, scale_factors=None):
        self.voc = voc
        self.cfg = cfg if cfg is not None else LoopCloserConfig()
        self.db = recognition.KeyframeDB.empty(kmax, voc.n_words, device=voc.device)
        self.scale_factors = scale_factors
        self.n_loops = 0
        self.n_merges = 0
        self.pending: PendingLoop | None = None
        # inertial context set by the tracker before on_keyframe: None for
        # the visual sensors, else (imu_initialized, viba_stage)
        # (LoopClosing.cc:341-346, 240-252, 144-163, 1176-1184)
        self.inertial: tuple | None = None

    def rebuild_db(self, s: atlas_state.MapState):
        """Repopulate the keyframe database from a MapState: every valid
        keyframe's BoW vector re-added (`Atlas::PostLoad`, `Atlas.cc:335`)."""
        self.db = recognition.KeyframeDB.empty(s.kmax, self.voc.n_words, device=self.voc.device)
        valid = _np(s.kf_valid)
        for k in range(int(s.n_kf)):
            if valid[k]:
                self.db = self.db.add(k, vocab_mod.sparse_bow(
                    self.voc, s.kf_feat_desc[k], s.kf_feat_valid[k]))

    def on_keyframe(self, s: atlas_state.MapState, kf_row: int, kind: int, K8):
        """NewDetectCommonRegions and the correction it confirms. Returns
        (state, closed)."""
        cfg = self.cfg
        with GLOBAL_TIMER.stage("loop.query"):
            bow = vocab_mod.sparse_bow(self.voc, s.kf_feat_desc[kf_row], s.kf_feat_valid[kf_row])
        # inertial maps: no detection before inertial BA2 (LoopClosing.cc:341-346)
        if self.inertial is not None:
            initialized, viba_stage = self.inertial
            if not initialized or viba_stage < 2:
                self.db = self.db.add(kf_row, bow)
                return s, False
        W = atlas_state.covisibility_weights(s)
        # candidate exclusion uses any shared observation (KeyFrame.cc:461:
        # weight >= 1), the covisible score floor the strong edges
        connected = W[kf_row] >= 1
        covis = W[kf_row] >= cfg.covis_threshold
        confirmed = None
        if self.pending is not None:
            with GLOBAL_TIMER.stage("loop.cascade"):
                confirmed = self._refine_pending(s, kf_row, kind, K8)
        n_kf = int(s.n_kf)
        if self.pending is None and confirmed is None and n_kf >= cfg.min_kfs_in_map:
            with GLOBAL_TIMER.stage("loop.query"):
                covis_scores = recognition.query(self.db, bow)
                cs = _np(torch.where(covis & self.db.valid, covis_scores, float("nan")))
                min_score = float(np.nanmin(cs)) if np.any(~np.isnan(cs)) else 0.0
                # row order stands for recency only within a map
                recent = ((torch.arange(s.kmax, device=s.device) > (kf_row - cfg.min_temporal_gap))
                          & (s.kf_map_id == s.kf_map_id[kf_row]))
                idx, _, ok = recognition.loop_candidates(self.db, bow, kf_row, connected | recent,
                                                         min_score, covis_W=W)
                idx, ok = _np(idx), _np(ok)
            with GLOBAL_TIMER.stage("loop.cascade"):
                for cand, okc in zip(idx, ok):
                    if not okc:
                        continue
                    confirmed = self._cascade(s, kf_row, int(cand), kind, K8, W)
                    if confirmed is not None or self.pending is not None:
                        break

        closed = False
        if confirmed is not None:
            cand, Rsw, tsw, ssw, pool = confirmed
            kf_map = _np(s.kf_map_id)
            if int(kf_map[kf_row]) == int(kf_map[cand]):
                ok_inertial, Rsw, tsw, ssw = self._inertial_loop_gate(s, kf_row, Rsw, tsw, ssw)
                if not ok_inertial:
                    self.pending = None
                    self.db = self.db.add(kf_row, bow)
                    return s, False
                s = self._correct_loop(s, kf_row, cand, Rsw, tsw, ssw, pool, kind, K8)
                self.n_loops += 1
            else:
                if not self._inertial_merge_gate(ssw):
                    self.pending = None
                    self.db = self.db.add(kf_row, bow)
                    return s, False
                s = self._merge_maps_scw(s, kf_row, cand, Rsw, tsw, ssw, kind, K8)
                self.n_merges += 1
            self.pending = None
            closed = True
        self.db = self.db.add(kf_row, bow)
        return s, closed

    # ------------------------------------------------------------------
    def _one(self, s):
        return torch.ones((), dtype=torch.float32, device=s.device)

    def _inertial_loop_gate(self, s, kf_row, Rsw, tsw, ssw):
        """Inertial loop sanity and yaw-only forcing (LoopClosing.cc:
        228-258): the world-to-world correction Sww = Twc Scw must be nearly
        pure yaw (|pitch|, |roll| < 0.008 rad, |yaw| < 0.349); after inertial
        BA2 pitch and roll are zeroed and the scale set to 1. Returns (ok,
        Rsw, tsw, ssw)."""
        if self.inertial is None:
            return True, Rsw, tsw, ssw
        _, viba_stage = self.inertial
        one = self._one(s)
        Rwc, twc = lie.se3_inv(s.kf_R[kf_row], s.kf_t[kf_row])
        Rww, tww, _ = lie.sim3_mul(Rwc, twc, one, Rsw, tsw, one * ssw)
        phi = _np(lie.so3_log(Rww)).copy()
        if not (abs(phi[0]) < 0.008 and abs(phi[1]) < 0.008 and abs(phi[2]) < 0.349):
            return False, Rsw, tsw, ssw
        if viba_stage >= 2:
            phi[0] = phi[1] = 0.0
            Rww_f = lie.so3_exp(torch.as_tensor(phi, device=s.device))
            Rcw, tcw = lie.se3_inv(Rwc, twc)
            Rsw, tsw, ssw_t = lie.sim3_mul(Rcw, tcw, one, Rww_f, tww, one)
            ssw = float(ssw_t)
        return True, Rsw, tsw, ssw

    def _inertial_merge_gate(self, ssw):
        """Merge scale sanity for inertial maps (LoopClosing.cc:140-155):
        both maps are metric, so the scale must lie in (0.9, 1.1)."""
        if self.inertial is None:
            return True
        return 0.9 < float(ssw) < 1.1

    # ------------------------------------------------------------------
    def _match_pairs(self, s, kf_row, feat_idx, pool_dist, ok_lm):
        """Sim3-optimization pairs from a landmark -> feature match, over the
        current keyframe's features: (matched_lm [F], fwd [F], own_lm [F],
        inv [F]). A feature matched by several pool landmarks takes the
        closest (then the lowest row); inv also needs the feature's own
        valid map point."""
        F, L = s.kf_feat_xy.shape[1], s.lmax
        dev = s.device
        big = 2 ** 30
        key = pool_dist.to(torch.int64) * L + torch.arange(L, device=dev)
        best = torch.full((F + 1,), big, dtype=torch.int64, device=dev).scatter_reduce(
            0, torch.where(ok_lm, feat_idx.long(), F), torch.where(ok_lm, key, big), "amin")[:F]
        fwd = best < big
        matched_lm = torch.where(fwd, best % L, 0)
        own = s.kf_feat_lm[kf_row]
        own_c = torch.clamp(own, 0, L - 1).long()
        return matched_lm, fwd, own_c, fwd & (own >= 0) & s.lm_valid[own_c]

    def _optimize_scm(self, s, kf_row, cand, Rsw, tsw, ssw, pool, kind, K8, radius, fix_scale):
        """Guided projection and OptimizeSim3 against the pool: (n_proj,
        n_opt, refined (Rsw, tsw, ssw)), stages 3 and 4; one host read of
        both counts."""
        feat_idx, pdist, ok_lm = project_match_sim3(
            kind, K8, Rsw, tsw, ssw, s.lm_pos, s.lm_desc, pool,
            s.kf_feat_xy[kf_row], s.kf_feat_desc[kf_row], s.kf_feat_valid[kf_row], radius,
            lm_normal=s.lm_normal, lm_min_dist=s.lm_min_dist, lm_max_dist=s.lm_max_dist)
        matched_lm, fwd, own_lm, inv = self._match_pairs(s, kf_row, feat_idx, pdist, ok_lm)
        one = self._one(s)
        Rm, tm = s.kf_R[cand], s.kf_t[cand]
        Rwm, twm = lie.se3_inv(Rm, tm)
        Rcm, tcm, scm = lie.sim3_mul(Rsw, tsw, one * ssw, Rwm, twm, one)
        P2 = lie.se3_apply(Rm, tm, s.lm_pos[matched_lm])
        P1 = lie.se3_apply(s.kf_R[kf_row], s.kf_t[kf_row], s.lm_pos[own_lm])
        uv2 = cam_mod.project(kind, K8, P2)
        Ro, to, so, _, n_opt = sim3_solver.optimize_sim3(
            kind, K8, P1, P2, s.kf_feat_xy[kf_row], uv2, fwd, Rcm, tcm, scm,
            valid_inv=inv, fix_scale=fix_scale)
        Rsw2, tsw2, ssw2 = lie.sim3_mul(Ro, to, so, Rm, tm, one)
        n_proj, n_opt, ssw2 = torch.stack([ok_lm.sum().to(torch.float32),
                                           n_opt.to(torch.float32), ssw2]).tolist()
        return int(n_proj), int(n_opt), (Rsw2, tsw2, ssw2)

    def _count_proj(self, s, row, Rsw, tsw, ssw, pool, kind, K8, radius):
        _, _, ok_lm = project_match_sim3(
            kind, K8, Rsw, tsw, self._one(s) * ssw, s.lm_pos, s.lm_desc, pool,
            s.kf_feat_xy[row], s.kf_feat_desc[row], s.kf_feat_valid[row], radius,
            lm_normal=s.lm_normal, lm_min_dist=s.lm_min_dist, lm_max_dist=s.lm_max_dist)
        return int(ok_lm.sum())

    def _fix_scale(self, s, kf_row):
        """Metric maps (stereo, RGB-D, inertial) fix the Sim3 scale
        (mbFixScale, LoopClosing.cc:701-704)."""
        return bool(torch.any(s.kf_feat_ur[kf_row] >= 0)
                    | (torch.linalg.norm(s.kf_vel[kf_row]) > 0))

    # ------------------------------------------------------------------
    def _cascade(self, s, kf_row, cand, kind, K8, W):
        """Stages 1-6 for one BoW candidate: the confirmed tuple (cand, Rsw,
        tsw, ssw, pool), or None, with self.pending set when stages 1-5 pass
        but the consistency is short (LoopClosing.cc:846-876)."""
        cfg = self.cfg
        L = s.lmax
        kf_valid = _np(s.kf_valid)
        W_np = _np(W)

        # stage 1: BoW matches against the candidate-side landmark pool
        pool = _landmark_pool(s, _pool_rows(W_np[cand], cand, cfg.n_covisibles_pool, kf_valid))
        own = s.kf_feat_lm[kf_row]
        has_own = (own >= 0) & s.kf_feat_valid[kf_row]
        dist = matching.hamming_matrix(s.kf_feat_desc[kf_row], s.lm_desc)
        idx_lm, _, ok_f = matching.masked_best_match(
            dist, has_own[:, None] & pool[None, :], max_dist=matching.TH_LOW, ratio=0.9)
        n_bow = int(ok_f.sum())
        if n_bow < cfg.n_bow_matches:
            return None

        # stage 2: Sim3 RANSAC on the 3D-3D pairs
        own_c = torch.clamp(own, 0, L - 1).long()
        lmc = torch.clamp(idx_lm, 0, L - 1).long()
        X1, X2 = s.lm_pos[own_c], s.lm_pos[lmc]
        valid = ok_f & s.lm_valid[own_c] & s.lm_valid[lmc]
        uv2 = cam_mod.project(kind, K8, lie.se3_apply(s.kf_R[cand], s.kf_t[cand], X2))
        fix_scale = self._fix_scale(s, kf_row)
        R_s, t_s, s_s, _, n_inl = sim3_solver.sim3_ransac(
            kind, K8, X1, X2, valid, s.kf_R[kf_row], s.kf_t[kf_row], s.kf_R[cand],
            s.kf_t[cand], s.kf_feat_xy[kf_row], uv2,
            generator=torch.Generator().manual_seed(int(kf_row)), fix_scale=fix_scale)
        n_inl = int(n_inl)
        if n_inl < cfg.n_bow_inliers:
            return None

        # coarse Scw = S12 T_2w (LoopClosing.cc:748-750)
        Rsw, tsw, ssw = lie.sim3_mul(R_s, t_s, s_s, s.kf_R[cand], s.kf_t[cand], self._one(s))

        # stages 3 and 4: guided projection and OptimizeSim3
        n_proj, n_opt, (Rsw, tsw, ssw) = self._optimize_scm(
            s, kf_row, cand, Rsw, tsw, float(ssw), pool, kind, K8,
            cfg.proj_radius_coarse, fix_scale)
        if n_proj < cfg.n_proj_matches or n_opt < cfg.n_sim3_inliers:
            return None

        # stage 5: re-projection at the refined Sim3, tighter window
        n_fine = self._count_proj(s, kf_row, Rsw, tsw, ssw, pool, kind, K8,
                                  cfg.proj_radius_fine)
        if n_fine < cfg.n_proj_opt_matches:
            return None

        # stage 6: covisible-keyframe verification (LoopClosing.cc:819-843)
        n_kfs = 0
        Rci, tci = lie.se3_inv(s.kf_R[kf_row], s.kf_t[kf_row])
        for j in _pool_rows(W_np[kf_row], kf_row, cfg.n_covisibles_pool, kf_valid)[1:]:
            if n_kfs >= cfg.n_consistency:
                break
            Rjc, tjc = lie.se3_mul(s.kf_R[j], s.kf_t[j], Rci, tci)
            Rjw, tjw, sjw = lie.sim3_mul(Rjc, tjc, self._one(s), Rsw, tsw, self._one(s) * ssw)
            if self._count_proj(s, j, Rjw, tjw, sjw, pool, kind, K8,
                                cfg.proj_radius_coarse) >= cfg.n_refine_matches:
                n_kfs += 1
        if n_kfs >= cfg.n_consistency:
            return (cand, Rsw, tsw, ssw, pool)
        self.pending = PendingLoop(cand=cand, last_kf=kf_row, Rsw=Rsw, tsw=tsw, ssw=ssw,
                                   pool=pool, n_coincidences=n_kfs)
        return None

    def _refine_pending(self, s, kf_row, kind, K8):
        """DetectAndReffineSim3FromLastKF (LoopClosing.cc:535-576): predict
        Scw for the new keyframe through its pose relative to the last one
        that re-found the region, re-find it by projection, refine, count a
        coincidence."""
        cfg = self.cfg
        p = self.pending
        one = self._one(s)
        Rli, tli = lie.se3_inv(s.kf_R[p.last_kf], s.kf_t[p.last_kf])
        Rcl, tcl = lie.se3_mul(s.kf_R[kf_row], s.kf_t[kf_row], Rli, tli)
        Rsw, tsw, ssw = lie.sim3_mul(Rcl, tcl, one, p.Rsw, p.tsw, one * p.ssw)
        ssw = float(ssw)
        n_proj = self._count_proj(s, kf_row, Rsw, tsw, ssw, p.pool, kind, K8,
                                  cfg.proj_radius_coarse)
        if n_proj >= cfg.n_refine_matches:
            _, n_opt, (Rsw, tsw, ssw2) = self._optimize_scm(
                s, kf_row, p.cand, Rsw, tsw, ssw, p.pool, kind, K8,
                cfg.proj_radius_coarse, self._fix_scale(s, kf_row))
            if n_opt > cfg.n_refine_opt_matches:
                p.n_coincidences += 1
                p.last_kf = kf_row
                p.Rsw, p.tsw, p.ssw = Rsw, tsw, ssw2
                p.n_not_found = 0
                if p.n_coincidences >= cfg.n_consistency:
                    return (p.cand, Rsw, tsw, ssw2, p.pool)
                return None
        p.n_not_found += 1
        if p.n_not_found >= cfg.max_not_found:
            self.pending = None
        return None

    # ------------------------------------------------------------------
    def _correct_loop(self, s, kf_row, cand, Rsw, tsw, ssw, pool, kind, K8):
        """CorrectLoop (LoopClosing.cc:969-1160): the corrected Sim3 through
        the current keyframe's covisible window with its landmarks
        transported, then the essential graph with the loop edge (4-DoF on
        an initialized inertial map), then SearchAndFuse welding."""
        if not self.cfg.run_pgo:
            return s
        K = s.kmax
        dev = s.device
        one = self._one(s)
        with GLOBAL_TIMER.stage_sync("loop.correct.transport", dev):
            W = atlas_state.covisibility_weights(s)
            window = _pool_rows(W[kf_row], kf_row, self.cfg.n_covisibles_pool, _np(s.kf_valid))
            win_t = torch.as_tensor(window, dtype=torch.long, device=dev)
            # S_iw' = T_ic S_cw for the window (LoopClosing.cc:1045-1076)
            Rci, tci = lie.se3_inv(s.kf_R[kf_row], s.kf_t[kf_row])
            Ric, tic = lie.se3_mul(s.kf_R[win_t], s.kf_t[win_t], Rci, tci)
            n_w = len(window)
            Riw, tiw, siw = lie.sim3_mul(Ric, tic, one.expand(n_w), Rsw.expand(n_w, 3, 3),
                                         tsw.expand(n_w, 3), (one * ssw).expand(n_w))
            kf_R, kf_t = s.kf_R.clone(), s.kf_t.clone()
            kf_s = torch.ones((K,), dtype=torch.float32, device=dev)
            kf_R[win_t], kf_t[win_t], kf_s[win_t] = Riw, tiw, siw
            # the window's landmarks move with their host keyframe:
            # X' = S_iw'^-1 (T_iw X) (LoopClosing.cc:1092-1107)
            host = s.lm_first_kf
            in_win_kf = torch.zeros((K,), dtype=torch.bool, device=dev)
            in_win_kf[win_t] = True
            hostc = torch.clamp(host, 0, K - 1).long()
            in_window = in_win_kf[hostc] & (host >= 0) & s.lm_valid
            Xc = torch.einsum("lij,lj->li", s.kf_R[hostc], s.lm_pos) + s.kf_t[hostc]
            Xw = torch.einsum("lji,lj->li", kf_R[hostc], Xc - kf_t[hostc]) \
                / torch.clamp(kf_s[hostc], min=1e-9)[:, None]
            se3_t = kf_t / torch.clamp(kf_s, min=1e-9)[:, None]
            s = dataclasses.replace(
                s, lm_pos=torch.where(in_window[:, None], Xw, s.lm_pos), kf_R=kf_R,
                kf_t=torch.where(in_win_kf[:, None], se3_t, s.kf_t))

        with GLOBAL_TIMER.stage_sync("loop.correct.essential_graph", dev):
            # loop edge S_cand,cur = T_cand,w S_cw^-1
            Rsi, tsi, ssi = lie.sim3_inv(Rsw, tsw, one * ssw)
            Rrel, trel, srel = lie.sim3_mul(s.kf_R[cand], s.kf_t[cand], one, Rsi, tsi, ssi)
            loop_edge = (torch.tensor([kf_row], device=dev), torch.tensor([cand], device=dev),
                         Rrel[None], trel[None], srel[None])
            src, dst, R_rel, t_rel, s_rel, ev = essential.build_essential_edges(
                s, W, min_weight=100, extra_edges=loop_edge)
            fixed = torch.zeros((K,), dtype=torch.bool, device=dev)
            fixed[cand] = True
            fixed[0] = True
            if self.inertial is not None and self.inertial[0]:
                Ro, to, _ = essential.optimize_essential_graph_4dof(
                    kf_R, se3_t, fixed, src, dst, R_rel, t_rel, ev)
                so = torch.ones((K,), dtype=torch.float32, device=dev)
            else:
                Ro, to, so, _ = essential.optimize_essential_graph(
                    kf_R, kf_t, kf_s, fixed, src, dst, R_rel, t_rel, s_rel, ev)
            s = essential.correct_map_after_pgo(s, s.kf_R, s.kf_t, Ro, to, so)

        with GLOBAL_TIMER.stage_sync("loop.correct.fuse_window", dev):
            s = self._fuse_window(s, window, kind, K8)
        return s

    def _fuse_window(self, s, window, kind, K8):
        """SearchAndFuse (LoopClosing.cc:1118-1140): duplicates merged and
        the matched-side landmarks fused into each window keyframe."""
        if self.scale_factors is None:
            return s
        for row in window:
            s, _ = fuse_mod.merge_duplicates_at_keyframe(kind, K8, s, row, self.scale_factors)
            s = fuse_mod.fuse_into_keyframe(kind, K8, s, row, self.scale_factors)
        return atlas_state.update_landmark_stats(s)

    # ------------------------------------------------------------------
    def _merge_maps_scw(self, s, kf_row, cand, Rsw, tsw, ssw, kind, K8):
        """MergeLocal's core from the refined Scw: the active map moved into
        the candidate's map frame (X_new = S_cw^-1 T_kw X_old), relabelled,
        welded, and its remainder pose-graph optimized."""
        one = self._one(s)
        Ri, ti, si = lie.sim3_inv(Rsw, tsw, one * ssw)
        Rm, tm, sm = lie.sim3_mul(Ri, ti, si, s.kf_R[kf_row], s.kf_t[kf_row], one)
        # inertial merge after VIBA1: yaw-only map rotation (LoopClosing.cc:156-163)
        if self.inertial is not None and self.inertial[1] >= 1:
            phi = _np(lie.so3_log(Rm)).copy()
            phi[0] = phi[1] = 0.0
            Rm = lie.so3_exp(torch.as_tensor(phi, device=s.device))
        active, target = (int(v) for v in torch.stack([s.active_map, s.kf_map_id[cand]]).tolist())
        kf_in = s.kf_valid & (s.kf_map_id == active)
        lm_in = s.lm_valid & (s.lm_map_id == active)
        new_lm = torch.where(lm_in[:, None], sm * torch.einsum("ij,lj->li", Rm, s.lm_pos) + tm,
                             s.lm_pos)
        # cameras: T_jw S_m^-1 as SE3 [R, t / s] (Optimizer.cc:1745-1752)
        Rmi, tmi, smi = lie.sim3_inv(Rm, tm, sm)
        newR = torch.einsum("kij,jl->kil", s.kf_R, Rmi)
        newt = (torch.einsum("kij,j->ki", s.kf_R, tmi) + s.kf_t) / torch.clamp(smi, min=1e-9)
        s2 = dataclasses.replace(s, kf_R=torch.where(kf_in[:, None, None], newR, s.kf_R),
                                 kf_t=torch.where(kf_in[:, None], newt, s.kf_t), lm_pos=new_lm)
        s2 = atlas_ops.change_map_id(s2, active, target)
        s2 = dataclasses.replace(s2, active_map=torch.tensor(target, dtype=torch.int32,
                                                             device=s.device))
        if self.scale_factors is None:
            return s2
        s2, cur_side, _ = self._weld(s2, kf_row, cand, kind, K8)
        return self._merge_remainder_pgo(s2, kf_in, cur_side)

    def _merge_remainder_pgo(self, s2, was_active_kf, cur_side):
        """Essential graph of the merge remainder (LoopClosing.cc:1717): the
        welding window and the whole candidate-side map held fixed, the
        transformed but unwelded keyframes free."""
        K = s2.kmax
        free = _np(was_active_kf) & _np(s2.kf_valid)
        free[list(cur_side)] = False
        if not free.any():
            return s2
        W = atlas_state.covisibility_weights(s2)
        src, dst, R_rel, t_rel, s_rel, ev = essential.build_essential_edges(s2, W, min_weight=100)
        ones = torch.ones((K,), dtype=torch.float32, device=s2.device)
        Ro, to, so, _ = essential.optimize_essential_graph(
            s2.kf_R, s2.kf_t, ones, torch.as_tensor(~free, device=s2.device),
            src, dst, R_rel, t_rel, s_rel, ev)
        return essential.correct_map_after_pgo(s2, s2.kf_R, s2.kf_t, Ro, to, so)

    def _weld(self, s2, kf_row, cand, kind, K8):
        """The welding window after a merge (MergeLocal's SearchAndFuse and
        welding local BA, LoopClosing.cc:1307-1331, Optimizer.cc:3498):
        duplicates fused through both sides, then a local BA with the
        candidate side held fixed. Returns (state, current side, candidate
        side)."""
        Wn = _np(atlas_state.covisibility_weights(s2))

        def top_covis(row, n):
            order = np.argsort(-Wn[row])
            return [row] + [int(r) for r in order[:n] if Wn[row, r] > 0]

        cur_side = top_covis(kf_row, 5)
        cand_side = [r for r in top_covis(cand, 5) if r not in cur_side] or [cand]
        for row in cur_side + cand_side:
            s2, _ = fuse_mod.merge_duplicates_at_keyframe(kind, K8, s2, row, self.scale_factors)
            s2 = fuse_mod.fuse_into_keyframe(kind, K8, s2, row, self.scale_factors)
        rows = cand_side + cur_side
        s2, _ = local_mapper.local_ba(
            kind, K8, s2, torch.as_tensor(rows, dtype=torch.int32, device=s2.device),
            n_fixed=len(cand_side), window=len(rows), iters=8,
            scale_factors=self.scale_factors)
        return atlas_state.update_landmark_stats(s2), cur_side, cand_side
