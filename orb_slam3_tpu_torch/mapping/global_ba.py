"""Global bundle adjustment, in the background with abort and catch-up
(port of orb_slam3_tpu/mapping/global_ba.py with the one-device body of
orb_slam3_tpu/parallel/map_ba.py and parallel/dist_ba.py).

The reference runs global BA in a side thread after a loop closure
(`LoopClosing::CorrectLoop` -> `RunGlobalBundleAdjustment`,
`LoopClosing.cc:1199-1207, 2268`), abortable through `mbStopGBA`
(`:979-993`); on completion it reconciles the map the tracker has moved
on with: keyframes made during GBA inherit their spanning-tree parent's
correction (`:2334-2449`) and map points made during GBA move with their
reference keyframe (`:2453-2486`).

Here the campaign runs on one card over an immutable MapState snapshot:
the active map's observation graph is flattened on the host
(`extract_global_problem`) and solved by the Schur-complement LM of
`lm/schur` with the JAX package's distributed loop (halve lambda on an
accepted step, quadruple it on a rejected one), in abortable chunks of
iterations. `parallel/map_ba.distributed_global_ba` shards the landmark
axis over a process group with the same problem (`map_problem`), loop and
write-back.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..atlas.state import MapState
from ..lm import edges as lm_edges, schur
from ..lm.problem import VertexBlock


def extract_global_problem(s: MapState, scale_factors=None):
    """The active map's observation graph as numpy arrays: (kf_rows,
    cam_idx, lm_idx, uv, info), the camera indices positions in kf_rows,
    the information 1 / scale_factor(octave)^2."""
    kv = (s.kf_valid & (s.kf_map_id == s.active_map)).cpu().numpy()
    kf_rows = np.nonzero(kv)[0]
    row_to_pos = -np.ones(s.kmax, np.int32)
    row_to_pos[kf_rows] = np.arange(len(kf_rows))
    lm = s.kf_feat_lm.cpu().numpy()
    fv = s.kf_feat_valid.cpu().numpy()
    lv = s.lm_valid.cpu().numpy()
    if scale_factors is None:
        scale_factors = 1.2 ** np.arange(8)
    oct_ = s.kf_feat_octave.cpu().numpy()
    xy = s.kf_feat_xy.cpu().numpy()
    cams, lms, uvs, infos = [], [], [], []
    for k in kf_rows:
        sel = fv[k] & (lm[k] >= 0) & lv[np.clip(lm[k], 0, s.lmax - 1)]
        idx = np.nonzero(sel)[0]
        cams.append(np.full(len(idx), row_to_pos[k], np.int32))
        lms.append(lm[k][idx])
        uvs.append(xy[k][idx])
        infos.append(1.0 / scale_factors[np.clip(oct_[k][idx], 0, len(scale_factors) - 1)] ** 2)
    cam_idx = np.concatenate(cams) if cams else np.zeros(0, np.int32)
    lm_idx = np.concatenate(lms) if lms else np.zeros(0, np.int32)
    uv = np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32)
    info = np.concatenate(infos) if infos else np.zeros(0, np.float32)
    return kf_rows, cam_idx, lm_idx, uv.astype(np.float32), info.astype(np.float32)


def map_problem(s: MapState, K8, kind: int, cam_rows, cam_fixed, points, point_fixed,
                cam_idx, lm_idx, uv, info, mask, huber_delta) -> schur.BAProblem:
    """The global BA problem over keyframe rows `cam_rows` (tensors or
    numpy; `cam_fixed` per row) and the landmarks `points` / `point_fixed`
    with their mono reprojection edges (camera positions in cam_rows,
    landmark rows in points), on the map's device."""
    dev = s.device
    rows = torch.as_tensor(cam_rows, dtype=torch.long, device=dev)
    E = len(cam_idx)
    return schur.BAProblem(
        cams=VertexBlock(state={"R": s.kf_R[rows], "t": s.kf_t[rows]},
                         fixed=torch.as_tensor(cam_fixed, dtype=torch.bool, device=dev),
                         tangent_dim=6, retract=lm_edges.se3_retract),
        points=torch.as_tensor(points, dtype=torch.float32, device=dev),
        point_fixed=torch.as_tensor(point_fixed, dtype=torch.bool, device=dev),
        cam_idx=torch.as_tensor(cam_idx, dtype=torch.int32, device=dev),
        lm_idx=torch.as_tensor(lm_idx, dtype=torch.int32, device=dev),
        obs_data={"uv": torch.as_tensor(uv, dtype=torch.float32, device=dev),
                  "K": torch.as_tensor(K8, dtype=torch.float32, device=dev).expand(E, 8)},
        obs_info=torch.as_tensor(info, dtype=torch.float32, device=dev),
        obs_mask=torch.as_tensor(mask, dtype=torch.bool, device=dev),
        cam_edges=(), residual_dim=2, residual=_ba_residual(kind), huber_delta=huber_delta,
    )


def write_back(s: MapState, kf_rows, cams: dict, points) -> MapState:
    """The solved poses of `kf_rows` (the first len(kf_rows) cameras) and
    the landmarks [L, 3] (valid rows) into the map."""
    rows = torch.as_tensor(kf_rows, dtype=torch.long, device=s.device)
    n = len(kf_rows)
    kf_R, kf_t = s.kf_R.clone(), s.kf_t.clone()
    kf_R[rows], kf_t[rows] = cams["R"][:n], cams["t"][:n]
    return dataclasses.replace(
        s, kf_R=kf_R, kf_t=kf_t, lm_pos=torch.where(s.lm_valid[:, None], points, s.lm_pos))


def global_ba(s: MapState, K8, kind: int = 0, n_fixed: int = 2, num_iters: int = 10,
              huber_delta: float | None = 5.991 ** 0.5, lam0: float = 1e-5) -> MapState:
    """Global BA of the active map (Optimizer::GlobalBundleAdjustemnt,
    `Optimizer.cc:52`): its keyframes (the first n_fixed held) and every
    valid landmark, mono reprojection edges with Huber, solved by
    `schur.solve_halving` (one linearization and one Schur solve per
    iteration; the loop `parallel/dist_ba.dist_ba_solve` runs over a
    group). Returns the MapState with the new poses and landmarks
    (unchanged with fewer than 3 keyframes or no observation)."""
    kf_rows, cam_idx, lm_idx, uv, info = extract_global_problem(s)
    if len(kf_rows) < 3 or len(cam_idx) == 0:
        return s
    p = map_problem(s, K8, kind, kf_rows, np.arange(len(kf_rows)) < n_fixed, s.lm_pos,
                    ~s.lm_valid, cam_idx, lm_idx, uv, info, np.ones(len(cam_idx), bool),
                    huber_delta)
    p, _ = schur.solve_halving(p, num_iters, lam0)
    return write_back(s, kf_rows, p.cams.state, p.points)


def _ba_residual(kind: int):
    res = lm_edges.make_mono_residual(kind)

    def residual(cam_state, x, data):
        return res(cam_state, {"x": x}, data)

    return residual


class GlobalBARunner:
    """One GBA campaign: `launch` on a snapshot, poll `finished`, then
    `reconcile` into the live map; `run` is the synchronous form."""

    def __init__(self, K8, kind: int, num_iters: int = 10, chunk: int = 5):
        self.K8 = K8
        self.kind = kind
        self.num_iters = num_iters
        self.chunk = chunk
        self._thread: threading.Thread | None = None
        self._abort = threading.Event()
        self.snapshot: MapState | None = None
        self.result: MapState | None = None
        self.failed = False
        self.error: BaseException | None = None

    def run(self, s: MapState) -> MapState:
        """Synchronous global BA of the active map (10 iterations,
        `Optimizer.cc:52`), abortable between chunks."""
        done = 0
        while done < self.num_iters and not self._abort.is_set():
            it = min(self.chunk, self.num_iters - done)
            s = global_ba(s, self.K8, kind=self.kind, num_iters=it)
            done += it
        return s

    def launch(self, s: MapState):
        """Start the side-thread GBA on a snapshot of s (`new thread(&
        LoopClosing::RunGlobalBundleAdjustment, ...)`). A failure marks the
        campaign failed and keeps the exception in `error`; tracking goes
        on, as in the reference. On CUDA the campaign runs on a stream of
        its own, after the launching stream's work on the snapshot (an
        event), and its stream is drained before the thread ends, so the
        result is complete once `finished`."""
        if self.running:
            return
        self.snapshot = s
        self.result = None
        self.failed = False
        self.error = None
        self._abort.clear()
        dev = s.device
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))

        def _target():
            try:
                stream = None if ready is None else torch.cuda.Stream(dev)
                with torch.cuda.stream(stream):
                    if stream is not None:
                        stream.wait_event(ready)
                    result = self.run(self.snapshot)
                    if stream is not None:
                        stream.synchronize()
                self.result = result
            except Exception as e:  # noqa: BLE001 -- kept for the caller to read
                self.failed = True
                self.error = e

        self._thread = threading.Thread(target=_target, daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def finished(self) -> bool:
        return (self._thread is not None and not self._thread.is_alive()
                and self.result is not None and not self.failed)

    def request_abort(self):
        """mbStopGBA: a new loop or merge invalidates the running campaign."""
        self._abort.set()

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def reconcile(self, cur: MapState) -> MapState:
        """Merge the finished result into the live state `cur`: keyframes
        and landmarks of the snapshot take their GBA values; keyframes made
        since follow their spanning-tree parent, T_new = (T_cur T_parent_cur^-1)
        T_parent_new, walked in row order; landmarks made since move with
        their reference keyframe, X_new = T_ref_new^-1 T_ref_cur X_cur.
        Host numpy in float32, as the JAX package does it."""
        snap, res = self.snapshot, self.result
        if res is None:
            return cur
        in_kf = snap.kf_valid.cpu().numpy()
        in_lm = snap.lm_valid.cpu().numpy()
        n_kf = int(cur.n_kf)
        kf_R_cur = cur.kf_R.cpu().numpy()
        kf_t_cur = cur.kf_t.cpu().numpy()
        kf_R, kf_t = kf_R_cur.copy(), kf_t_cur.copy()
        parent = cur.kf_parent.cpu().numpy()
        valid = cur.kf_valid.cpu().numpy()
        kf_R[in_kf] = res.kf_R.cpu().numpy()[in_kf]
        kf_t[in_kf] = res.kf_t.cpu().numpy()[in_kf]
        for k in range(n_kf):
            if in_kf[k] or not valid[k]:
                continue
            p = parent[k]
            if p < 0 or p >= n_kf:
                continue
            R_rel = kf_R_cur[k] @ kf_R_cur[p].T
            t_rel = kf_t_cur[k] - R_rel @ kf_t_cur[p]
            kf_R[k] = R_rel @ kf_R[p]
            kf_t[k] = R_rel @ kf_t[p] + t_rel
        lm_pos = cur.lm_pos.cpu().numpy().copy()
        lm_pos[in_lm] = res.lm_pos.cpu().numpy()[in_lm]
        new_lm = cur.lm_valid.cpu().numpy() & ~in_lm
        if new_lm.any():
            ref = np.clip(cur.lm_first_kf.cpu().numpy(), 0, cur.kmax - 1)
            rows = np.nonzero(new_lm)[0]
            k = ref[rows]
            Xc = np.einsum("nij,nj->ni", kf_R_cur[k], lm_pos[rows]) + kf_t_cur[k]
            lm_pos[rows] = np.einsum("nji,nj->ni", kf_R[k], Xc - kf_t[k])
        dev = cur.device
        out = dataclasses.replace(cur, kf_R=torch.from_numpy(kf_R).to(dev),
                                  kf_t=torch.from_numpy(kf_t).to(dev),
                                  lm_pos=torch.from_numpy(lm_pos).to(dev))
        self._thread = None
        self.result = None
        self.snapshot = None
        return out
