"""CPU tests of the benchmark's own code: the benchmark file's names and
units, each cell's files found by name (and what the harness cannot feed
refused), the lap, the arithmetic of the metrics, the comparison that decides `correct` (with the
faults it has to catch, on a small session on the CPU), and that nothing
the harness loads is JAX or the JAX package. Two tests need a card and
skip without one: the control at the cell's own size (at the CPU's small
size the missing undistortion barely moves the trajectory), and one run
of a cell through its command.

    python -m pytest -q portbench/test_portbench.py
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, harness, roofline, scene, trace, traffic

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
TRAFFIC = sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json"))


def _line(text, n=200):
    return isinstance(text, str) and 1 <= len(text) <= n and "\n" not in text and "\t" not in text


def test_benchmark_names_and_units_are_legal():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert all((ROOT / p).is_dir() and re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
               for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in b["configs"]] + WORKLOADS
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.fullmatch(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert len(c["reduced"]) <= 16 and any(w["config"] == c["name"] for w in b["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(WORKLOADS) if "workloads" in m else True
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e - {"setup_s"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_files_are_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.sensor in harness.SENSORS
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    cam = traffic.Camera(traffic.read_settings(cell.settings))
    assert cam.fps == cell.traffic["fps"]
    assert set(cell.limits) <= {"ate_m", "ate_max_m", "rpe_m", "map_median_m", "map_p90_m",
                                "lost_share"}


@pytest.mark.parametrize("sensor", ["mono-imu", "rgbd-imu", "stereo", "stereo-imu"])
def test_a_sensor_the_harness_cannot_feed_is_refused(tmp_path, sensor):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "c.json").write_text(json.dumps({"sensor": sensor}))
    bench = {"configs": [{"name": "c", "file": "portbench/configs/c.yaml"}],
             "workloads": [{"name": "c.xyz", "config": "c", "traffic": "xyz", "chips": 1}]}
    with pytest.raises(ValueError, match="feeds only"):
        harness.Cell("c.xyz", bench=bench, root=tmp_path)


def test_a_camera_the_renderer_cannot_draw_is_refused():
    s = traffic.read_settings(ROOT / "portbench" / "configs" / "tum1-rgbd.yaml")
    assert traffic.Camera(s).K[0] == pytest.approx(517.306408)
    with pytest.raises(ValueError, match="PinHole"):
        traffic.Camera(dict(s, **{"Camera.type": "KannalaBrandt8"}))


def test_a_captured_call_keeps_the_values_it_was_given():
    buf = torch.arange(4.0)
    args, kwargs = harness._copy((buf, 3, [buf])), harness._copy({"ur": buf})
    buf.mul_(0.0)  # the program rewrites the buffer after the call
    assert args[0].tolist() == args[2][0].tolist() == kwargs["ur"].tolist() == [0, 1, 2, 3]
    assert args[1] == 3


@pytest.mark.parametrize("name", TRAFFIC)
def test_lap_closes_at_the_published_rates(name):
    t = traffic.load(ROOT / "portbench" / "traffic" / f"{name}.json")
    lap = traffic.Lap(t)
    R0, c0 = lap.pose_wc(0.0)
    R1, c1 = lap.pose_wc(1.0)
    assert np.abs(R0 - R1).max() < 1e-12 and np.abs(c0 - c1).max() < 1e-12
    speed, rate = lap.mean_rates(sub=4)
    assert speed == pytest.approx(t["target"]["mean_speed_mps"], rel=0.03)
    assert rate == pytest.approx(t["target"]["mean_rate_dps"], rel=0.03)


def test_fps_counts_the_calls_returned_in_the_window():
    marks = [(0.0, 0.3, False), (0.3, 0.7, False), (0.7, 1.2, True), (1.2, 2.5, False)]
    assert harness.completed_rate(marks, deadline=2.0, seconds=2.0) == 1.5


def test_p95_is_over_all_samples_and_stage_means():
    run = harness.RunData({"orb_extraction": [10.0, 20.0]}, list(np.arange(1.0, 101.0)), None,
                          {})
    assert harness.reader("frame_p95_ms")(run) == pytest.approx(95.05)
    assert harness.reader("extract_ms")(run) == 15.0
    assert harness.reader("local_ba_ms")(run) is None
    assert harness.reader("device_idle_pct")(run) is None
    assert harness.reader("k1_roofline")(run) is None


class _Ev:
    def __init__(self, name, start, dur, dev="CPU", tid=1):
        self._n, self._s, self._d, self._dev, self._tid = name, start, dur, dev, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def activity_type(self):
        return "kernel" if self._dev == "CUDA" else "cpu_op"

    def start_thread_id(self):
        return self._tid


def test_idle_share_and_gaps_from_a_synthetic_trace():
    ms = 1_000_000
    events = [
        _Ev(trace.FRAME_MARK, 0, 40 * ms), _Ev(trace.FRAME_MARK, 50 * ms, 50 * ms),
        _Ev("aten::sum", 0, 30 * ms), _Ev("inner", 5 * ms, 10 * ms, tid=2),
        # two streams overlapping: busy 10-20 and 15-25 -> 10-25
        _Ev("void match_kernel<1>", 10 * ms, 10 * ms, "CUDA"),
        _Ev("pose_kernel", 15 * ms, 10 * ms, "CUDA"),
        _Ev("Memcpy HtoD", 60 * ms, 20 * ms, "CUDA"),
        _Ev(trace.FRAME_MARK, 0, 0, "CUDA"),  # a host mark mirrored on the device
    ]
    a = trace.analyse(events, n_frames=2)
    assert a["window_s"] == pytest.approx(0.1)
    assert a["busy_s"] == pytest.approx(0.035)
    assert a["kernels"] == 2
    assert a["k1_device_s"] == pytest.approx(0.01) and a["k1_events"] == 1
    assert a["k2_device_s"] == pytest.approx(0.01) and a["k2_events"] == 1
    assert a["idle_gaps"][0] == ["no host op", pytest.approx(0.035)]
    assert a["idle_gaps"][1] == ["no host op", pytest.approx(0.02)]
    assert a["idle_gaps"][2] == ["inner (thread 2)", pytest.approx(0.01)]
    run = harness.RunData({}, [], a, {})
    assert harness.reader("device_idle_pct")(run) == pytest.approx(65.0)
    assert harness.reader("kernels_per_frame")(run) == 1.0
    assert trace.saw_kernels(events, (trace.K1_NAME, trace.K2_NAME))
    assert trace.analyse(events[:4], 2) is None


def test_roofline_from_counted_operations_and_bytes():
    f32, i32 = torch.float32, torch.int32
    uv = torch.tensor([[10.0, 10.0], [100.0, 100.0]], dtype=f32)
    kp = torch.tensor([[12.0, 9.0], [10.0, 30.0], [300.0, 5.0]], dtype=f32)
    args = (uv, torch.tensor([0, 1], dtype=i32), torch.zeros(2, 32, dtype=torch.uint8),
            torch.tensor([True, True]), kp, torch.tensor([0, 3, 0], dtype=i32),
            torch.zeros(3, 32, dtype=torch.uint8), torch.tensor([True, True, True]),
            torch.tensor([5.0, 5.0]))
    nbytes, ops = roofline.k1_bound(args, {"level_lo": -1, "level_hi": 1})
    # one landmark window holds one keypoint (of the right octave)
    assert nbytes == 2 * 49 + 3 * 45 + 2 * 9
    assert ops == 3 * 12 + 1 * 9 + 1 * 27
    valid = torch.tensor([[True, False, True]])
    ur = torch.tensor([[5.0, 5.0, -1.0]])
    z = torch.zeros
    nb, op = roofline.k2_bound((z(1, 4), z(1, 3, 3), z(1, 3), z(1, 3, 2), z(1, 3, 3), z(1, 3),
                                valid), {"ur": ur, "rounds": 3, "iters": 6})
    assert op == 21 * (2 * 200 + 1 * 85)
    assert nb == 3 + 2 * 28 + 68 + 52 + 3
    peak = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    assert roofline.bound_s(3.35e12, 0, peak) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, peak) == pytest.approx(1.0)
    run = harness.RunData({}, [], {"k1_events": 4, "k1_device_s": 4e-5}, {"k1": (2e-7, 2)})
    assert harness.reader("k1_roofline")(run) == pytest.approx(1.0)


def test_horn_alignment_recovers_a_similarity():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(3, 40))
    R = traffic._rot(0, 0.3) @ traffic._rot(1, -0.2) @ traffic._rot(2, 0.5)
    Y = 1.7 * R @ X + np.array([[1.0], [2.0], [3.0]])
    Ra, _, s, err = check.horn_align(X, Y, with_scale=True)
    assert s == pytest.approx(1.7) and np.abs(Ra - R).max() < 1e-9 and err.max() < 1e-9
    _, _, s, _ = check.horn_align(X, Y, with_scale=False)
    assert s == 1.0


def test_surface_distance_and_rays():
    K, D = (517.3, 516.5, 318.6, 255.3), (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    rays = scene.radtan_rays(K, D, (64, 48))
    us, vs = np.meshgrid(np.arange(64.0), np.arange(48.0))
    back = scene.distort(K, D, rays.reshape(-1, 3))
    assert np.abs(back - np.stack([us.ravel(), vs.ravel()], -1)).max() < 1e-6
    room = scene.Room(7, scene.radtan_rays(K, D, (8, 6)), torch.device("cpu"), half=2.5,
                      wall_h=1.4, n_panels=0)
    X = np.array([[0.0, 0.0, 2.4], [0.0, 0.0, 0.0]])
    assert room.surface_distance(X) == pytest.approx([0.1, 1.4])


def test_nothing_loaded_is_jax_or_the_jax_package():
    prog = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench import harness, run, control, check, scene, trace, traffic, vocab;"
        "from orb_slam3_tpu_torch.api.system import System;"
        "from orb_slam3_tpu_torch.frontend import orb, match_kernel;"
        "from orb_slam3_tpu_torch.tracking import pose_kernel;"
        "from orb_slam3_tpu_torch.place.vocab import Vocabulary;"
        "from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER;"
        "[harness.reader(m['name']) for m in harness.Cell(harness.json.loads("
        "(harness.CHECKOUT / 'BENCHMARK.json').read_text())['workloads'][0]['name']).per_layer];"
        "print(run.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", prog, str(ROOT)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    from portbench import run as run_mod

    assert "orb_slam3_tpu_torch" not in run_mod.FORBIDDEN
    assert {"jax", "jaxlib", "flax", "orb_slam3_tpu"} == run_mod.FORBIDDEN


# ---------------------------------------------------------------------------
# a small session on the CPU: correct, the control, and the faults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    """tum1-rgbd.xyz cut to a size the CPU runs: 256x192 with TUM1's
    distortion, 300 features on 4 levels, a small arena."""
    root = tmp_path_factory.mktemp("bench")
    files = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (files / d).mkdir(parents=True)
    text = (ROOT / "portbench" / "configs" / "tum1-rgbd.yaml").read_text()
    for k, v in (("Camera1.fx", 200.0), ("Camera1.fy", 200.0), ("Camera1.cx", 128.0),
                 ("Camera1.cy", 96.0), ("Camera.width", 256), ("Camera.height", 192),
                 ("ORBextractor.nFeatures", 300), ("ORBextractor.nLevels", 4)):
        text = re.sub(rf"^{re.escape(k)}:.*$", f"{k}: {v}", text, flags=re.M)
    (files / "configs" / "small.yaml").write_text(text)
    (files / "configs" / "small.json").write_text(json.dumps({"sensor": "rgbd"}))
    t = traffic.load(ROOT / "portbench" / "traffic" / "xyz.json")
    t.update(warmup_frames=2, profile_frames=2)
    t["vocabulary_views"].update(n=4, radii=[0.3], branching=8, depth=3)
    (files / "traffic" / "small.json").write_text(json.dumps(t))
    (files / "limits" / "small.xyz.json").write_text(json.dumps(
        {"ate_m": 0.01, "map_median_m": 0.15}))
    bench = {"configs": [{"name": "small", "file": "portbench/configs/small.yaml"}],
             "workloads": [{"name": "small.xyz", "config": "small", "traffic": "small",
                            "chips": 1}],
             "end_to_end": [{"name": "fps", "unit": "frames/s"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "extract_ms", "unit": "ms", "moves": "fps"}]}
    return harness.Cell("small.xyz", bench=bench, root=root)


@pytest.fixture
def small_arena(monkeypatch):
    from orb_slam3_tpu_torch.api import settings

    monkeypatch.setattr(settings, "to_tracker_config", functools.partial(
        settings.to_tracker_config, kmax=16, lmax=1024, local_window=4))


def _run(cell, **kw):
    # 15 s holds some 20-40 frames on a loaded CPU: the map has had its new
    # landmarks culled and refined by then (after only 7-8 frames its median
    # distance to the room still read 6-22 cm)
    return harness.run(cell, 2**31 + 11, 15.0, False, torch.device("cpu"), 0.0, **kw)


def test_small_session_is_correct(small_cell, small_arena):
    sound = _run(small_cell)
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] >= 5 and sound["failed"] == 0


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(small_cell, small_arena,
                                                               monkeypatch):
    from orb_slam3_tpu_torch.api.system import System

    monkeypatch.setattr(System, "track_rgbd", lambda self, img, depth, ts, imu=None: None)
    r = _run(small_cell)
    assert not r["correct"] and r["checks"]["ate_m"]["value"] is None


def test_a_pose_altered_where_it_is_made_is_not_correct(small_cell, small_arena, monkeypatch):
    from orb_slam3_tpu_torch.tracking import tracker

    record = tracker.Tracker._record_frame

    def shifted(self, timestamp, ok, rel=None):
        record(self, timestamp, ok, rel)
        f = self.trajectory[-1]
        if len(self.trajectory) % 2:  # every other frame 3 cm off
            f.t_rel = f.t_rel + torch.tensor([0.03, 0.0, 0.0])

    monkeypatch.setattr(tracker.Tracker, "_record_frame", shifted)
    r = _run(small_cell)
    assert not r["correct"] and r["checks"]["ate_m"]["value"] > small_cell.limits["ate_m"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


def test_the_control_is_not_correct_on_the_card(card):
    """The control at the cell's own size and window: the session with the
    distortion coefficients 0 fails the comparison (one seed; PERF.md gives
    the readings of three)."""
    cell = harness.Cell(WORKLOADS[0])
    r = harness.run(cell, 2**31 + 7, float(BENCH["run_seconds"]), False,
                    torch.device("cuda", 0), 0.0, control=True)
    assert not r["correct"], r["checks"]


def test_one_run_of_a_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
                          "--seed", str(2**31 + 5), "--seconds", str(BENCH["run_seconds"]),
                          "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(r)[-1] == "checks" and r["correct"]
    assert set(r["metrics"]) == {"fps", "setup_s"} and r["metrics"]["fps"]["value"] > 0
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
