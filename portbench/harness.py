"""One run of one cell: set-up, the measured window, the check, the readings.

A cell is found by its name in BENCHMARK.json. Its configuration is the
settings file the entry names (with `<stem>.json` beside it: the sensor,
the source, what was assumed), its traffic `traffic/<name>.json`, its
limits `limits/<cell>.json`, and each per-layer metric a reader
`metrics/<metric>.py` with `read(run) -> float | None`. Nothing here names
a cell, a configuration or a metric.

A run drives one whole SLAM session through the program's public entry,
`System(settings_path, sensor, vocabulary=...)`, with the program's
defaults (the background mapper, the software pipeline), one frame after
another in a closed loop: each frame is handed in as soon as the previous
call returns. Frames are host arrays (8-bit grey; 16-bit depth in the
file's DepthMapFactor units). Laps are replayed one after another,
timestamps running on.

The sensors a configuration file may name are those `Feed` drives
(`SENSORS`); `Cell` refuses any other, and `traffic.Camera` any camera but
a rad-tan pinhole, rather than run a session the harness cannot feed.
"""

from __future__ import annotations

import importlib.util
import json
import re
import time
from pathlib import Path

import numpy as np

from . import check, scene, trace, traffic, vocab
from .roofline import PEAKS, bound_s, k1_bound, k2_bound

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BUILD = CHECKOUT / "build" / "portbench"
T0 = 1.0  # the first frame's timestamp (seconds)
PROFILE_TRIES = 3
SENSORS = ("rgbd", "mono")  # the sensors Feed drives


class Cell:
    """What BENCHMARK.json and the cell's files say about one cell."""

    def __init__(self, name: str, bench: dict | None = None, root: Path = CHECKOUT):
        bench = bench or json.loads((root / "BENCHMARK.json").read_text())
        w = next((w for w in bench["workloads"] if w["name"] == name), None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        self.name, self.chips = name, int(w["chips"])
        self.settings = root / conf["file"]
        self.sidecar = json.loads(self.settings.with_suffix(".json").read_text())
        self.sensor = self.sidecar["sensor"]
        if self.sensor not in SENSORS:
            raise ValueError(f"{conf['file']}: sensor {self.sensor!r}; the harness feeds only "
                             f"{', '.join(SENSORS)}")
        files = root / HERE.name
        self.traffic = traffic.load(files / "traffic" / f"{w['traffic']}.json")
        self.limits = json.loads((files / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    @property
    def depth(self) -> bool:
        return self.sensor == "rgbd"


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Feed:
    """Hands frame i of the replayed laps to a session."""

    def __init__(self, cell: Cell, lap: traffic.Lap, imgs, depths):
        self.cell, self.lap = cell, lap
        self.imgs, self.depths = imgs, depths

    def frame(self, i: int, start: int = 0):
        """(lap frame j, timestamp) of the session's i-th frame."""
        return (start + i) % self.lap.n, T0 + i / self.lap.fps

    def call(self, system, i: int, start: int = 0):
        j, ts = self.frame(i, start)
        if self.cell.depth:
            return system.track_rgbd(self.imgs[j], self.depths[j], ts)
        return system.track_monocular(self.imgs[j], ts)


class Capture:
    """Records the arguments of the program's two kernel entry points while
    installed (the profiled frames of a traced run). Each tensor argument
    is copied at the call, on the calling thread's stream, so the bound
    worked out after the window reads the values the call was given, even
    where the program later rewrites the buffer in place. The copies are
    device to device and asynchronous: the window gets no sync."""

    def __init__(self):
        from orb_slam3_tpu_torch.frontend import match_kernel
        from orb_slam3_tpu_torch.tracking import pose_kernel

        self.sites = ((match_kernel, "search_by_projection_kernel", "k1"),
                      (pose_kernel, "pose_ba", "k2"))
        self.calls = {"k1": [], "k2": []}
        self._orig = [getattr(m, a) for m, a, _ in self.sites]

    def install(self):
        for (mod, attr, key), fn in zip(self.sites, self._orig):
            def wrapped(*args, _fn=fn, _key=key, **kwargs):
                self.calls[_key].append((_copy(args), _copy(kwargs)))
                return _fn(*args, **kwargs)
            setattr(mod, attr, wrapped)

    def remove(self):
        for (mod, attr, _), fn in zip(self.sites, self._orig):
            setattr(mod, attr, fn)


def _copy(x):
    """x with every tensor in it (in a tuple, list or dict) cloned."""
    import torch

    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v) for v in x)
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


class RunData:
    """What a traced run hands the per-layer readers."""

    def __init__(self, stages, frame_ms, analysis, bounds):
        self.stages, self.frame_ms = stages, frame_ms
        self.trace, self.bounds = analysis, bounds

    def stage_mean(self, name: str):
        v = self.stages.get(name)
        return float(np.mean(v)) if v else None

    def roofline_pct(self, key: str):
        """100 x (mean bound time per call) / (mean device time per call),
        or None where the window saw no call or no device event of it."""
        b = self.bounds.get(key)
        if self.trace is None or not b or not b[1] or not self.trace[f"{key}_events"]:
            return None
        dev = self.trace[f"{key}_device_s"] / self.trace[f"{key}_events"]
        return 100.0 * (b[0] / b[1]) / dev


def settings_without_distortion(path: Path) -> Path:
    """The control's settings file: the same with every distortion
    coefficient 0, so the session skips undistorting its keypoints."""
    text = re.sub(r"^(Camera1\.(k1|k2|k3|p1|p2)\s*:).*$", r"\1 0.0", path.read_text(),
                  flags=re.M)
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"{path.stem}.control.yaml"
    out.write_text(text)
    return out


def make_vocabulary(cell, room, settings: dict, device):
    """A vocabulary trained on held-out views of the room, the stand-in for
    ORBvoc: `n` views evenly round each circle of `radii` about the room's
    centre at height 0, looking out; a tree of `branching` and `depth`."""
    import torch
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.place.vocab import Vocabulary

    v = cell.traffic["vocabulary_views"]
    ocfg = orb.OrbConfig(int(settings["ORBextractor.nFeatures"]),
                         int(settings["ORBextractor.nLevels"]),
                         float(settings["ORBextractor.scaleFactor"]),
                         float(settings["ORBextractor.iniThFAST"]),
                         float(settings["ORBextractor.minThFAST"]))
    descs = []
    for r in v["radii"]:
        for k in range(int(v["n"])):
            a = v["start_angle"] + 2 * np.pi * k / v["n"]
            R_wc = traffic._rot(1, a)
            c = r * np.array([np.sin(a), 0.0, np.cos(a)])
            img, _ = room.cast(R_wc.T, -R_wc.T @ c)
            feats = orb.extract(torch.round(img), ocfg)
            descs.append(feats.descriptors[feats.valid].cpu().numpy())
    k, L = int(v["branching"]), int(v["depth"])
    centers, idf = vocab.train(np.concatenate(descs), branching=k, depth=L, seed=0)
    return Vocabulary(centers=torch.from_numpy(centers).to(device),
                      weights=torch.from_numpy(idf).to(device), branching=k, depth=L)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_process: float,
        control: bool = False) -> dict:
    """One run. Returns the result's fields: correct, attempted, failed,
    metrics, device, (breakdown), checks; plus `readings`. With `control`
    the session runs the settings file with its distortion coefficients 0
    (control.py)."""
    import torch
    from orb_slam3_tpu_torch.api.system import System
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    cuda = device.type == "cuda"
    if cuda:
        from orb_slam3_tpu_torch.kernels import build

        build.load("match_kernel")
        build.load("pose_kernel")
    raw = traffic.read_settings(cell.settings)
    cam = traffic.Camera(raw)
    settings_path = settings_without_distortion(cell.settings) if control else cell.settings
    t = cell.traffic
    if abs(float(t["fps"]) - cam.fps) > 1e-9:
        raise ValueError(f"traffic at {t['fps']} Hz for a {cam.fps} Hz camera")
    lap = traffic.Lap(t)
    sc = t["scene"]
    room = scene.Room(int(sc["seed"]), scene.radtan_rays(cam.K, cam.D, cam.wh), device,
                      half=sc["half"], wall_h=sc["wall_h"], n_panels=sc["n_panels"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    R_cw, t_cw = lap.frames()
    imgs, depths = room.render_lap(R_cw, t_cw, gen, sc.get("exposure_jitter", 0.0),
                                   sc.get("noise", 0.0),
                                   cam.depth_factor if cell.depth else None)
    voc = make_vocabulary(cell, room, raw, device)
    feed = Feed(cell, lap, imgs, depths)

    # a warm-up session on another stretch of the lap, shut down before
    # the timed one starts in a fresh System
    warm = System(str(settings_path), cell.sensor, vocabulary=voc, device=device)
    for i in range(int(t["warmup_frames"])):
        feed.call(warm, i, start=lap.n // 2)
    warm.shutdown()
    del warm
    system = System(str(settings_path), cell.sensor, vocabulary=voc, device=device)
    if cuda:
        torch.cuda.synchronize(device)

    prof = capture = None
    tries, prof_start, profiled = 0, None, None
    n_prof = int(t["profile_frames"])
    marks = []  # (start, end, profiled) host seconds of every frame
    GLOBAL_TIMER.reset()
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        if (traced and prof is None and tries < PROFILE_TRIES
                and t0 >= t_w0 + float(t["profile_at"]) * seconds):
            prof, capture = _start_profiler(torch)
            prof_start, tries = i, tries + 1
        if prof is not None:
            with torch.profiler.record_function(trace.FRAME_MARK):
                feed.call(system, i)
        else:
            feed.call(system, i)
        t1 = time.perf_counter()
        marks.append((t0, t1, prof is not None))
        i += 1
        if prof is not None and i - prof_start >= n_prof:
            prof.stop()
            capture.remove()
            events = prof.profiler.kineto_results.events()
            prof = None
            if trace.saw_kernels(events, (trace.K1_NAME, trace.K2_NAME)):
                profiled = (events, capture, i - prof_start)
                tries = PROFILE_TRIES
    if prof is not None:
        prof.stop()
        capture.remove()
    stages = {k: list(v) for k, v in GLOBAL_TIMER.samples.items()}
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    # after the window: the session's own record, then its shutdown
    tr = system.tracker
    ts, R, tt, ok = tr.poses()
    s = tr.map
    keep = (s.lm_valid & (s.lm_map_id == s.active_map)).cpu().numpy()
    landmarks = s.lm_pos.cpu().numpy()[keep].astype(np.float64)
    system.shutdown()
    del system, tr, s
    if cuda:
        torch.cuda.empty_cache()

    truth = {}
    for k in range(len(marks)):
        j, ts_k = feed.frame(k)
        truth[float(ts_k)] = lap.pose_wc(j / lap.n)[1]
    out = dict(ts=np.asarray(ts, np.float64), R_cw=R, t_cw=tt, ok=np.asarray(ok, bool),
               landmarks=landmarks)
    readings = check.judge(out, truth, room, monocular=not cell.depth)
    correct, checks = check.compare(readings, cell.limits)
    failed, _ = check.lost_after_first_pose(out["ok"])

    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    result = {
        "correct": bool(correct), "attempted": len(marks), "failed": failed,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
                   "memory_peak_bytes": peak},
    }
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not traced:
        values = {"fps": completed_rate(marks, deadline, seconds), "setup_s": t_w0 - t_process}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        analysis, bounds = None, {}
        if profiled is not None:
            events, cap, n_frames = profiled
            analysis = trace.analyse(events, n_frames)
            bounds = _bounds(cap, PEAKS.get(name))
        frame_ms = [1e3 * (b - a) for a, b, p in marks if b <= deadline and not p]
        data = RunData(stages, frame_ms, analysis, bounds)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        result["metrics"] = metrics
        if analysis is not None:
            result["device"]["busy_s"] = analysis["busy_s"]
            result["device"]["window_s"] = analysis["window_s"]
            result["breakdown"] = {"device_ops": analysis["device_ops"],
                                   "idle_gaps": analysis["idle_gaps"]}
    result["checks"] = checks
    result["readings"] = readings
    return result


def completed_rate(marks, deadline: float, seconds: float) -> float:
    """Frames whose call returned by the window's end, per second of the
    window; marks are (start, end, profiled) host seconds."""
    return sum(1 for _, t1, _ in marks if t1 <= deadline) / seconds


def _start_profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    capture = Capture()
    capture.install()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof, capture


def _bounds(capture: Capture, peak) -> dict:
    """{key: (sum of bound seconds, calls)} over the captured calls."""
    if peak is None:
        return {}
    out = {}
    for key, fn in (("k1", k1_bound), ("k2", k2_bound)):
        calls = capture.calls[key]
        out[key] = (sum(bound_s(*fn(a, kw), peak) for a, kw in calls), len(calls))
    return out
