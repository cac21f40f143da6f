"""Offline map and trajectory exports, the viewer's stand-in (port of
orb_slam3_tpu/api/viz.py).

The Pangolin viewer stack (`Viewer.cc`, `MapDrawer.cc`, `FrameDrawer.cc`)
for a host with no display:
- `save_map_ply`: landmarks coloured by map id, and keyframe centres, as an
  ASCII PLY point cloud (MapDrawer::DrawMapPoints / DrawKeyFrames);
- `save_topdown_png`: an orthographic top-down view of landmarks,
  keyframes and the frame trajectory;
- `save_tracking_overlay`: the frame's keypoints, matched ones in green
  (FrameDrawer::DrawFrame);
- `map_3d_payload` / `render_map_html` / `save_map_html`: the interactive
  3D map as one self-contained HTML page.
The PLY text and the JSON payload equal the JAX package's for the same
map. The images are drawn here into numpy arrays (a disc stamp for dots,
Bresenham for segments) and written with the port's PNG codec, in RGB.

Every function takes a MapState of tensors (copied to the host here, on
the caller's stream) or a `HostMap` of numpy arrays (the live viewer's
snapshot).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..utils import png

_MAP_COLORS = np.array(
    [[66, 135, 245], [240, 101, 67], [60, 180, 75], [255, 195, 0],
     [145, 30, 180], [70, 240, 240]], np.uint8
)
_TRAJ_RGB = (80, 220, 80)
_KF_RGB = (255, 0, 0)
HOST_FIELDS = ("lm_valid", "lm_pos", "lm_map_id", "kf_valid", "kf_R", "kf_t", "kf_parent",
               "n_kf", "n_lm", "n_maps", "active_map")


class HostMap:
    """The MapState fields the exports read, as numpy arrays."""

    def __init__(self, arrays: dict):
        self.__dict__.update(arrays)


def host_map(s) -> HostMap:
    """A MapState's exported fields on the host (a HostMap passes through)."""
    if isinstance(s, HostMap):
        return s
    return HostMap({k: getattr(s, k).detach().cpu().numpy() if torch.is_tensor(getattr(s, k))
                    else np.asarray(getattr(s, k)) for k in HOST_FIELDS})


def _centers(R, t):
    return -np.einsum("nij,ni->nj", R, t)


def save_map_ply(path: str, s) -> None:
    h = host_map(s)
    lm = h.lm_valid
    X = h.lm_pos[lm]
    mid = h.lm_map_id[lm] % len(_MAP_COLORS)
    kv = h.kf_valid
    centers = _centers(h.kf_R[kv], h.kf_t[kv])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(X) + len(centers)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        for x, m in zip(X, mid):
            c = _MAP_COLORS[m]
            f.write(f"{x[0]:.4f} {x[1]:.4f} {x[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        for c_ in centers:
            f.write(f"{c_[0]:.4f} {c_[1]:.4f} {c_[2]:.4f} 255 0 0\n")


def draw_disc(img: np.ndarray, centers: np.ndarray, radius: int, color) -> None:
    """Filled discs of `radius` px at integer `centers` [N, 2] (x, y),
    clipped to the image (cv2.circle with thickness -1)."""
    if len(centers) == 0:
        return
    r = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    keep = dx * dx + dy * dy <= radius * radius + radius  # cv2's rounded disc
    dx, dy = dx[keep], dy[keep]
    xs = (centers[:, 0:1] + dx[None]).ravel()
    ys = (centers[:, 1:2] + dy[None]).ravel()
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """An 8-connected segment from p0 to p1 (x, y), clipped to the image
    (cv2.line's LINE_8)."""
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    n = max(abs(x1 - x0), abs(y1 - y0))
    s = np.arange(n + 1)
    if n == 0:
        xs, ys = np.array([x0]), np.array([y0])
    else:
        xs = x0 + np.floor((x1 - x0) * s / n + 0.5).astype(int)
        ys = y0 + np.floor((y1 - y0) * s / n + 0.5).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def render_topdown(s, trajectory=None, size: int = 900, axes=(0, 2)) -> np.ndarray:
    """Orthographic projection onto the `axes` plane (default x-z, the top
    view of a forward-z camera world) -> [size, size, 3] uint8 RGB."""
    h = host_map(s)
    axes = list(axes)
    img = np.full((size, size, 3), 20, np.uint8)
    lm = h.lm_valid
    X = h.lm_pos[lm][:, axes]
    kv = h.kf_valid
    centers = _centers(h.kf_R[kv], h.kf_t[kv])[:, axes]
    pts = [X] if len(X) else []
    if len(centers):
        pts.append(centers)
    traj = None if trajectory is None or not len(trajectory) else np.asarray(trajectory)[:, axes]
    if traj is not None:
        pts.append(traj)
    if not pts:
        return img
    allp = np.concatenate(pts)
    lo = allp.min(axis=0) - 0.2
    hi = allp.max(axis=0) + 0.2
    scale = (size - 40) / max(float((hi - lo).max()), 1e-6)

    def to_px(p):
        return np.clip(((p - lo) * scale + 20).astype(int), 0, size - 1)

    mid = h.lm_map_id[lm] % len(_MAP_COLORS)
    q = to_px(X)
    img[q[:, 1], q[:, 0]] = _MAP_COLORS[mid]
    if traj is not None and len(traj) > 1:
        tp = to_px(traj)
        for a, b in zip(tp[:-1], tp[1:]):
            draw_line(img, a, b, _TRAJ_RGB)
    draw_disc(img, to_px(centers), 3, _KF_RGB)
    return img


def save_topdown_png(path: str, s, trajectory=None, size: int = 900, axes=(0, 2)) -> None:
    png.write(path, render_topdown(s, trajectory, size, axes))


def render_tracking_overlay(img_gray, xy, valid, matched=None,
                            matched_rgb=(0, 255, 0), other_rgb=(120, 120, 120)) -> np.ndarray:
    """The frame in grey with each valid keypoint as a 2 px dot, matched
    ones in `matched_rgb` -> [H, W, 3] uint8 RGB."""
    g = np.clip(np.asarray(img_gray), 0, 255).astype(np.uint8)
    out = np.repeat(g[:, :, None], 3, axis=2)
    xy = np.asarray(xy).astype(int)
    valid = np.asarray(valid, bool)
    matched = np.zeros(len(xy), bool) if matched is None else np.asarray(matched, bool)
    draw_disc(out, xy[valid & ~matched], 2, other_rgb)
    draw_disc(out, xy[valid & matched], 2, matched_rgb)
    return out


def save_tracking_overlay(path: str, img_gray, feats, matched_mask=None) -> None:
    """Keypoints drawn on the frame (green = matched to a landmark)."""
    xy = feats.xy.detach().cpu().numpy() if torch.is_tensor(feats.xy) else feats.xy
    valid = feats.valid.detach().cpu().numpy() if torch.is_tensor(feats.valid) else feats.valid
    if torch.is_tensor(matched_mask):
        matched_mask = matched_mask.detach().cpu().numpy()
    if torch.is_tensor(img_gray):
        img_gray = img_gray.detach().cpu().numpy()
    png.write(path, render_tracking_overlay(img_gray, xy, valid, matched_mask))


def map_3d_payload(s, trajectory=None, max_points: int = 40000) -> dict:
    """The interactive viewer's scene as JSON-ready lists: landmarks (a
    palette index per map id), keyframe centres and camera-to-world
    rotations (frusta), spanning-tree edges, the frame trajectory
    (MapDrawer's data contract, `MapDrawer.cc:135-447`)."""
    h = host_map(s)
    lm = h.lm_valid
    X = h.lm_pos[lm]
    mid = (h.lm_map_id[lm] % len(_MAP_COLORS)).astype(int)
    if len(X) > max_points:
        sel = np.random.default_rng(0).choice(len(X), max_points, replace=False)
        X, mid = X[sel], mid[sel]
    rows = np.flatnonzero(h.kf_valid)
    kR = h.kf_R[rows]
    centers = _centers(kR, h.kf_t[rows])
    Rwc = np.transpose(kR, (0, 2, 1))
    parent = h.kf_parent[rows]
    row_pos = {int(r): i for i, r in enumerate(rows)}
    edges = [[row_pos[int(r)], row_pos[int(p)]] for r, p in zip(rows, parent)
             if int(p) in row_pos and int(p) != int(r)]
    traj = (np.asarray(trajectory, np.float32).tolist()
            if trajectory is not None and len(trajectory) else [])
    return dict(
        points=np.round(X.astype(float), 4).tolist(),
        colors=mid.tolist(),
        palette=_MAP_COLORS.tolist(),
        kf_centers=np.round(centers.astype(float), 4).tolist(),
        kf_rot=np.round(Rwc.astype(float), 4).tolist(),
        edges=edges,
        trajectory=traj,
    )


_VIEWER3D_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>orb_slam3 map</title>
<style>
 body{margin:0;background:#101014;color:#ccc;font:12px monospace;overflow:hidden}
 #hud{position:fixed;left:8px;top:8px;user-select:none}
 canvas{display:block}
</style></head><body>
<div id="hud">drag: orbit &middot; shift-drag/right-drag: pan &middot;
 wheel: zoom &middot; t: trajectory &middot; f: frusta &middot; e: edges</div>
<canvas id="c"></canvas>
<script id="scene" type="application/json">__SCENE_JSON__</script>
<script>
"use strict";
const S = JSON.parse(document.getElementById("scene").textContent);
const cv = document.getElementById("c"), cx = cv.getContext("2d");
let W, H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener("resize", rs);
const pts = S.points, n = pts.length;
let c0=[0,0,0];
for (const p of pts){c0[0]+=p[0];c0[1]+=p[1];c0[2]+=p[2];}
if(n){c0=c0.map(v=>v/n);}
let rad=1e-6;
for (const p of pts){const d=Math.hypot(p[0]-c0[0],p[1]-c0[1],p[2]-c0[2]); if(d>rad)rad=d;}
let yaw=0.6, pitch=0.4, dist=rad*2.5, panX=0, panY=0;
let showT=true, showF=true, showE=true;
function cam(){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  return [[cy,0,-sy],[sy*sp,cp,cy*sp],[sy*cp,-sp,cy*cp]];
}
function proj(p, R){
  const x=p[0]-c0[0], y=p[1]-c0[1], z=p[2]-c0[2];
  const X=R[0][0]*x+R[0][1]*y+R[0][2]*z + panX;
  const Y=R[1][0]*x+R[1][1]*y+R[1][2]*z + panY;
  const Z=R[2][0]*x+R[2][1]*y+R[2][2]*z + dist;
  if (Z<=rad*0.01) return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*X/Z, H/2+f*Y/Z, Z];
}
function draw(){
  cx.fillStyle="#101014"; cx.fillRect(0,0,W,H);
  const R=cam();
  const pal=S.palette;
  for(let i=0;i<n;i++){
    const q=proj(pts[i],R); if(!q) continue;
    const c=pal[S.colors[i]];
    cx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;
    const s=Math.max(1, 2.2*rad/q[2]);
    cx.fillRect(q[0],q[1],s,s);
  }
  if(showT && S.trajectory.length>1){
    cx.strokeStyle="#50dc78"; cx.beginPath(); let started=false;
    for(const p of S.trajectory){const q=proj(p,R); if(!q){started=false;continue;}
      if(!started){cx.moveTo(q[0],q[1]);started=true;} else cx.lineTo(q[0],q[1]);}
    cx.stroke();
  }
  const C=S.kf_centers, Rw=S.kf_rot;
  if(showE){
    cx.strokeStyle="#3c64c8"; cx.beginPath();
    for(const e of S.edges){const a=proj(C[e[0]],R), b=proj(C[e[1]],R);
      if(a&&b){cx.moveTo(a[0],a[1]);cx.lineTo(b[0],b[1]);}}
    cx.stroke();
  }
  if(showF){
    const s=rad*0.03;
    cx.strokeStyle="#ff5050";
    for(let k=0;k<C.length;k++){
      const o=C[k], Q=Rw[k];
      const loc=[[0,0,0],[-s,-s*0.7,s*1.6],[s,-s*0.7,s*1.6],[s,s*0.7,s*1.6],[-s,s*0.7,s*1.6]];
      const w=loc.map(v=>[o[0]+Q[0][0]*v[0]+Q[0][1]*v[1]+Q[0][2]*v[2],
                          o[1]+Q[1][0]*v[0]+Q[1][1]*v[1]+Q[1][2]*v[2],
                          o[2]+Q[2][0]*v[0]+Q[2][1]*v[1]+Q[2][2]*v[2]]);
      const q=w.map(p=>proj(p,R));
      if(q.some(x=>!x)) continue;
      cx.beginPath();
      for(const [a,b] of [[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]]){
        cx.moveTo(q[a][0],q[a][1]); cx.lineTo(q[b][0],q[b][1]);}
      cx.stroke();
    }
  }
}
let drag=null;
cv.addEventListener("mousedown",e=>{drag=[e.clientX,e.clientY,e.shiftKey||e.button===2];});
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){panX+=dx*dist/(0.9*Math.min(W,H));panY+=dy*dist/(0.9*Math.min(W,H));}
  else {yaw+=dx*0.008; pitch+=dy*0.008;}
  drag=[e.clientX,e.clientY,drag[2]]; draw();
});
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();});
cv.addEventListener("contextmenu",e=>e.preventDefault());
addEventListener("keydown",e=>{
  if(e.key==="t")showT=!showT; if(e.key==="f")showF=!showF;
  if(e.key==="e")showE=!showE; draw();});
rs();
</script></body></html>
"""


def render_map_html(s, trajectory=None) -> str:
    """The interactive 3D map as one self-contained HTML page (a canvas
    renderer in plain JavaScript, no external assets): landmarks, keyframe
    frusta, spanning-tree edges and the trajectory, with orbit, pan and
    zoom (`MapDrawer.cc:135-447`, `Viewer.cc:180-370`)."""
    return _VIEWER3D_HTML.replace("__SCENE_JSON__", json.dumps(map_3d_payload(s, trajectory)))


def save_map_html(path: str, s, trajectory=None) -> None:
    with open(path, "w") as f:
        f.write(render_map_html(s, trajectory))
