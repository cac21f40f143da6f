"""The live viewer: a session watched over HTTP (port of
orb_slam3_tpu/api/viewer.py).

The Pangolin viewer thread (`Viewer.cc:162`, `MapDrawer.cc:135-447`,
`FrameDrawer.cc:370`) for a host with no display: a stdlib HTTP server on
127.0.0.1 serves an auto-refreshing page with the top-down map, the current
frame with its tracked keypoints and the run's counters, plus

    /stats.json   the counters
    /map.png      the top-down map (landmarks, keyframes)
    /frame.png    the last frame, tracked keypoints green, others red
    /map3d        the interactive 3D map (api/viz.render_map_html)
    /cmd?localization=1|0, /cmd?reset=1
                  the viewer's menu (`Viewer.cc:253-262`)

Reading across streams: the handler threads never touch a tensor the
tracker's or the mapper's stream may still be writing. A request takes the
tracker's current map (the last one it adopted: a mapper commit reaches
`tracker.map` only after the tracker's stream waited for the commit's
event), records an event on the tracker's stream, makes its own stream
wait for it, marks the tensors for its stream and copies them to the host.
The tracker's stream is the one current on the thread that started the
viewer. Commands run under the System's frame lock, between frames.

Usage:
    viewer = system.start_viewer(port=0)   # http://127.0.0.1:<viewer.port>
    ... track frames ...
    system.shutdown()                      # stops the viewer
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..utils import png
from . import viz

_PAGE = """<!doctype html>
<html><head><title>orb_slam3 live viewer</title>
<meta http-equiv="refresh" content="{refresh}">
<style>
 body {{ background:#111; color:#ddd; font-family:monospace; }}
 img {{ border:1px solid #444; margin:4px; }}
 a {{ color:#7ab4ff; }}
</style></head>
<body>
<h3>orb_slam3 (PyTorch) &mdash; live session</h3>
<div id="stats">{stats}</div>
<img src="/map.png" width="540"> <img src="/frame.png" width="540">
<p><a href="/map3d" target="_blank">interactive 3D map</a></p>
<p><a href="/cmd?localization=1">localization mode ON</a> |
   <a href="/cmd?localization=0">OFF</a> |
   <a href="/cmd?reset=1">reset session</a></p>
</body></html>"""

_STATES = ["NOT_INITIALIZED", "OK", "RECENTLY_LOST", "LOST"]


@dataclasses.dataclass
class Snapshot:
    """What one request reads, on the host."""

    map: viz.HostMap
    img: np.ndarray | None
    xy: np.ndarray | None
    valid: np.ndarray | None
    tracked: np.ndarray | None


class LiveViewer:
    def __init__(self, system, port: int = 8090, refresh_s: float = 1.0):
        self.system = system
        self.port = port
        self.refresh_s = refresh_s
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._stream = None

    # ------------------------------------------------------------------
    def snapshot(self) -> Snapshot:
        """The tracker's latest map, last frame and its features on the
        host, read after the tracker's stream has reached them."""
        sys_ = self.system
        t = sys_.tracker
        s, last, feat_lm, img = t.map, t.last, t._feat_lm, sys_._last_img
        tensors = [getattr(s, k) for k in viz.HOST_FIELDS]
        feats = last["feats"] if last is not None else None
        extra = [] if feats is None else [feats.xy, feats.valid]
        if feat_lm is not None and feats is not None:
            extra.append(feat_lm)
        if torch.is_tensor(img):
            extra.append(img)
        dev = s.device
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(self._stream)
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            for a in tensors + extra:
                if a.device.type == "cuda":
                    a.record_stream(cur)
        host = [a.detach().cpu().numpy() for a in tensors]
        hmap = viz.HostMap(dict(zip(viz.HOST_FIELDS, host)))
        xy = valid = tracked = None
        if feats is not None:
            xy = feats.xy.detach().cpu().numpy()
            valid = feats.valid.detach().cpu().numpy()
            if feat_lm is not None:
                tracked = feat_lm.detach().cpu().numpy() >= 0
        if torch.is_tensor(img):
            img = img.detach().cpu().numpy()
        return Snapshot(hmap, None if img is None else np.asarray(img), xy, valid, tracked)

    def stats(self, snap: Snapshot | None = None) -> dict:
        snap = snap or self.snapshot()
        t = self.system.tracker
        lc = t.loop_closer
        m = snap.map
        return {
            "state": _STATES[min(int(t.state), 3)],
            "n_keyframes": int(m.n_kf),
            "n_landmarks": int(m.n_lm),
            "n_maps": int(m.n_maps),
            "active_map": int(m.active_map),
            "inliers": int(t.last_inliers),
            "frames": len(t.trajectory),
            "loops": lc.n_loops if lc else 0,
            "merges": lc.n_merges if lc else 0,
            "localization_mode": bool(t.mapping_paused),
        }

    def map_png(self) -> bytes:
        return png.encode(viz.render_topdown(self.snapshot().map))

    def frame_png(self) -> bytes:
        snap = self.snapshot()
        img = snap.img if snap.img is not None else np.zeros((240, 320), np.float32)
        if snap.xy is None:
            rgb = viz.render_tracking_overlay(img, np.zeros((0, 2)), np.zeros(0, bool))
        else:
            rgb = viz.render_tracking_overlay(img, snap.xy, snap.valid, snap.tracked,
                                              matched_rgb=(80, 220, 80),
                                              other_rgb=(200, 60, 60))
        return png.encode(rgb)

    def command(self, query: dict) -> None:
        """The viewer's menu, run between frames (under the frame lock)."""
        sys_ = self.system
        with sys_._frame_lock:
            if query.get("localization", ["0"])[0] == "1":
                sys_.activate_localization_mode()
            elif "localization" in query:
                sys_.deactivate_localization_mode()
            if query.get("reset", ["0"])[0] == "1":
                sys_.reset()

    # ------------------------------------------------------------------
    def start(self):
        """Serve on 127.0.0.1:port (0: a free port, then read `port`) from a
        daemon thread; call from the thread (and stream) that tracks."""
        viewer = self
        dev = self.system.tracker.device
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    u = urlparse(self.path)
                    if u.path == "/":
                        rows = " ".join(f"{k}=<b>{v}</b>" for k, v in viewer.stats().items())
                        page = _PAGE.format(refresh=viewer.refresh_s, stats=rows)
                        self._send(200, "text/html", page.encode())
                    elif u.path == "/stats.json":
                        self._send(200, "application/json", json.dumps(viewer.stats()).encode())
                    elif u.path == "/map.png":
                        self._send(200, "image/png", viewer.map_png())
                    elif u.path == "/frame.png":
                        self._send(200, "image/png", viewer.frame_png())
                    elif u.path == "/map3d":
                        html = viz.render_map_html(viewer.snapshot().map)
                        self._send(200, "text/html", html.encode())
                    elif u.path == "/cmd":
                        viewer.command(parse_qs(u.query))
                        self._send(200, "text/plain", b"ok")
                    else:
                        self._send(404, "text/plain", b"not found")
                except Exception as e:  # noqa: BLE001 -- the viewer never stops the session
                    try:
                        self._send(500, "text/plain", repr(e).encode())
                    except OSError:
                        pass

        self._server = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_port
        self._thread = threading.Thread(target=self._server.serve_forever, name="viewer",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
