"""Ground rules of the PyTorch port, checked on any host.

- Neither the package nor chip_smoke.py imports jax or orb_slam3_tpu.
- The package imports without triton or nvcc (kernels build at first use).
- Entry points (entry(), bootstrap(), slam(), the tracker's map and config,
  Tracker, System, System(settings_path), to_tracker_config, the
  rectifier, make_kb8, the vocabulary's train / load_orb_text and
  train_vocabulary's camera, the room scene's ray caster) default to CUDA
  and raise where there is none.
- The place-recognition and loop-closing subpackages (place/, graphopt/),
  the global BA, the inertial modules (imu/, tracking/vi_pose_opt.py,
  tracking/vi_tracker.py) and the background mapper (runtime/) import
  neither jax nor the JAX package.
- TrackerConfig, Tracker and System default to the JAX package's schedule:
  the background mapper on a free-running thread, pipeline depth 6; the
  mapper takes the tracker's device, CUDA by default.
- Tracker and System accept the three inertial sensors and default to
  CUDA with them too.
- Settings files are read without PyYAML or OpenCV.
- The port's copy of the ORB pattern equals the JAX package's asset, and
  atlas/invariants.py is the port's own module.
- No module of the port, and not chip_smoke.py, imports cv2 (a CUDA host
  need not have OpenCV); the parallel layers, the checkpoint, viz, viewer
  and dataset modules, the codec, the frame loader and the drivers import
  neither jax nor the JAX package.
- Loading an Atlas, the fleet step, the distributed global BA,
  init_distributed and the dataset drivers default to CUDA and raise
  where there is none.
- Every file that conftest.py orders exists, and its scheduling hook
  keeps each file's tests together, the longest sessions first.
- conftest.py's one time limit names a test that exists, fails it at the
  limit and disarms after it.
"""

import ast
import importlib
import importlib.util
import pkgutil
import signal
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import orb_slam3_tpu_torch
from orb_slam3_tpu_torch import entry as tentry
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.atlas import state as tstate
from orb_slam3_tpu_torch.frontend import camera as tcam
from orb_slam3_tpu_torch.tracking import tracker as ttracker

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "orb_slam3_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "orb_slam3_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_package_imports_without_triton_or_nvcc():
    names = [m.name for m in pkgutil.walk_packages(
        orb_slam3_tpu_torch.__path__, "orb_slam3_tpu_torch.")]
    assert "orb_slam3_tpu_torch.kernels.build" in names
    for name in names:
        importlib.import_module(name)
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == [
        "match_kernel.cu", "pose_kernel.cu"]


def test_entry_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcam.make_pinhole(450.0, 450.0, 376.0, 240.0)
    K = tcam.make_pinhole(450.0, 450.0, 376.0, 240.0, device="cpu")
    assert K.device.type == "cpu" and K.dtype == torch.float32


def test_bootstrap_and_tracker_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = np.zeros((48, 64), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.bootstrap([frame, frame])
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.tracker_config()
    cfg = tentry.tracker_config("cpu", img_wh=(64, 48), kmax=4, lmax=32)
    assert cfg.K.device.type == "cpu" and (cfg.kmax, cfg.lmax, cfg.local_window) == (4, 32, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttracker.empty_map(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.empty(kmax=2, fmax=4, lmax=8)
    assert ttracker.empty_map(cfg, device="cpu").lm_pos.device.type == "cpu"


def test_slam_tracker_and_system_default_to_cuda_and_raise_without_it(monkeypatch):
    from orb_slam3_tpu_torch.api import system as tsystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = np.zeros((48, 64), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.slam([frame])
    K = np.asarray([40.0, 40.0, 32.0, 24.0, 0, 0, 0, 0], np.float32)
    cfg = ttracker.TrackerConfig(K=K, img_wh=(64, 48), kmax=4, lmax=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttracker.Tracker(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.System(config=cfg)
    t = ttracker.Tracker(cfg, device="cpu")
    assert t.device.type == "cpu" and t.map.lm_pos.device.type == "cpu"
    assert cfg.K is K  # the tracker keeps its own copy of the config
    cpu_cfg = tentry.tracker_config("cpu", img_wh=(64, 48), kmax=4, lmax=32)
    s = tsystem.System(config=cpu_cfg)
    assert s.tracker.device.type == "cpu"  # the camera tensor's device
    assert s.track_monocular(frame, 0.0) is None and s.tracking_state() == ttracker.NOT_INITIALIZED


def test_settings_rectifier_and_kb8_default_to_cuda_and_raise_without_it(monkeypatch,
                                                                          tmp_path):
    from orb_slam3_tpu_torch.api import settings as tsettings
    from orb_slam3_tpu_torch.api import system as tsystem
    from orb_slam3_tpu_torch.frontend import rectify as trect

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "legacy.yaml"
    path.write_text(tentry.euroc_legacy_settings())
    s = tsettings.load_settings(str(path), "stereo")  # numpy only: no device
    with pytest.raises(RuntimeError, match="CUDA"):
        tsettings.to_tracker_config(s)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.System(str(path), sensor="stereo")
    with pytest.raises(RuntimeError, match="CUDA"):
        trect.StereoRectifier(s.rect_left, s.rect_right, s.width, s.height)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcam.make_kb8(260.0, 260.0, 256.0, 192.0, 0.01, -0.005, 0.002, -0.001)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.slam([], settings_path=str(path), sensor="stereo")
    sys_ = tsystem.System(str(path), sensor="stereo", device="cpu")
    assert sys_.tracker.device.type == "cpu" and sys_.rectifier.map_l.device.type == "cpu"


def test_place_and_loop_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                                          tmp_path):
    from orb_slam3_tpu_torch.graphopt import loop_closer
    from orb_slam3_tpu_torch.place import vocab

    assert {p.name for p in (PKG / "place").glob("*.py")} >= {"vocab.py", "recognition.py"}
    assert {p.name for p in (PKG / "graphopt").glob("*.py")} >= {
        "sim3_solver.py", "essential.py", "loop_closer.py"}
    desc = np.random.default_rng(0).integers(0, 256, (64, 32), dtype=np.uint8)
    path = tmp_path / "voc.txt"
    path.write_text("2 1 0 0\n" + "".join(f"0 1 {' '.join(['7'] * 32)} 1.0\n" for _ in range(2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vocab.train(desc, branching=2, depth=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        vocab.load_orb_text(str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.room_scene(np.array([200.0, 200.0, 32.0, 24.0]), img_wh=(64, 48), n_panels=1)
    voc = vocab.train(desc, branching=2, depth=2, device="cpu")
    assert voc.centers.device.type == "cpu" and voc.n_words == 4
    lc = loop_closer.LoopCloser(voc, kmax=4)
    assert lc.db.ids.device.type == "cpu" and lc.db.ids.shape == (4, 1024)


def test_yaml_reading_needs_no_pyyaml():
    src = (PKG / "api" / "settings.py").read_text()
    assert "yaml" not in set(_imported_roots(PKG / "api" / "settings.py"))
    assert "cv2" not in src


def test_entry_points_import_no_jax():
    for rel in ("entry.py", "tracking/tracker.py", "atlas/invariants.py", "api/system.py",
                "api/evaluate.py", "api/trajectory.py", "mapping/pipeline.py",
                "mapping/fuse.py", "mapping/local_mapper.py", "utils/timing.py",
                "utils/verbose.py", "api/settings.py", "frontend/rectify.py",
                "frontend/camera.py", "frontend/stereo.py", "place/vocab.py",
                "place/recognition.py", "graphopt/sim3_solver.py", "graphopt/essential.py",
                "graphopt/loop_closer.py", "mapping/global_ba.py", "imu/preintegration.py",
                "imu/factors.py", "imu/initialization.py", "imu/vi_ba.py",
                "tracking/vi_pose_opt.py", "tracking/vi_tracker.py", "convert.py",
                "runtime/__init__.py", "runtime/mapper.py"):
        roots = set(_imported_roots(PKG / rel))
        assert not roots & set(FORBIDDEN), (rel, roots & set(FORBIDDEN))


def test_invariants_is_the_ports_own_copy():
    assert Path(tinv.__file__).resolve() == (PKG / "atlas" / "invariants.py").resolve()
    assert tinv.check_all.__module__ == "orb_slam3_tpu_torch.atlas.invariants"
    src = (PKG / "atlas" / "invariants.py").read_text()
    assert "orb_slam3_tpu." not in src and "import orb_slam3_tpu" not in src
    for name in ("check_spanning_tree", "check_prev_chain", "check_observations", "check_all"):
        assert callable(getattr(tinv, name))


def test_orb_pattern_copy_equals_jax_asset():
    ours = np.load(PKG / "frontend" / "assets" / "orb_pattern.npy")
    ref = np.load(ROOT / "orb_slam3_tpu" / "frontend" / "assets" / "orb_pattern.npy")
    assert ours.dtype == ref.dtype and ours.shape == ref.shape == (256, 4)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("sensor", ["mono-imu", "stereo-imu", "rgbd-imu"])
def test_inertial_sensors_are_accepted_and_default_to_cuda(monkeypatch, sensor):
    from orb_slam3_tpu_torch.api import system as tsystem

    assert {p.name for p in (PKG / "imu").glob("*.py")} >= {
        "preintegration.py", "factors.py", "initialization.py", "vi_ba.py"}
    K = np.asarray([40.0, 40.0, 32.0, 24.0, 0, 0, 0, 0], np.float32)
    Tbc = np.eye(4, dtype=np.float32)
    Tbc[:3, 3] = (0.1, 0.0, 0.02)
    cfg = ttracker.TrackerConfig(K=K, img_wh=(64, 48), sensor=sensor, bf=4.0, kmax=4, lmax=32,
                                 Tbc=Tbc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttracker.Tracker(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.System(config=cfg, sensor=sensor)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.tracker_config(sensor=sensor, bf=4.0)
    t = ttracker.Tracker(cfg, device="cpu")
    assert t.base_sensor == sensor.split("-")[0] and t.imu is not None
    assert t.imu.Rbc.device.type == "cpu" and float(t.imu.tbc[0]) == pytest.approx(0.1)
    cpu_cfg = tentry.tracker_config("cpu", img_wh=(64, 48), sensor=sensor, bf=4.0, kmax=4,
                                    lmax=32)
    s = tsystem.System(config=cpu_cfg, sensor=sensor)
    frame = np.zeros((48, 64), np.float32)
    packet = np.zeros((4, 7))
    packet[:, 0] = np.arange(1, 5) * 0.005
    track = {"mono": lambda: s.track_monocular(frame, 0.02, imu=packet),
             "stereo": lambda: s.track_stereo(frame, frame, 0.02, imu=packet),
             "rgbd": lambda: s.track_rgbd(frame, frame, 0.02, imu=packet)}[t.base_sensor]
    assert track() is None and s.tracking_state() == ttracker.NOT_INITIALIZED
    assert s.tracker.imu._frame_meas is not None


def test_imu_measurements_on_a_visual_session_raise():
    from orb_slam3_tpu_torch.api import system as tsystem

    s = tsystem.System(config=tentry.tracker_config("cpu", img_wh=(64, 48), kmax=4, lmax=32))
    with pytest.raises(ValueError, match="IMU"):
        s.track_monocular(np.zeros((48, 64), np.float32), 0.0, imu=np.zeros((2, 7)))


def test_runtime_imports_no_jax_and_the_defaults_map_in_the_background(monkeypatch):
    from orb_slam3_tpu_torch.api import system as tsystem
    from orb_slam3_tpu_torch.runtime import mapper as tmapper

    files = sorted((PKG / "runtime").glob("*.py"))
    assert {f.name for f in files} == {"__init__.py", "mapper.py"}
    for f in files:
        assert not set(_imported_roots(f)) & set(FORBIDDEN), f
    cfg = ttracker.TrackerConfig()
    assert (cfg.async_mapping, cfg.deterministic_mapping, cfg.pipeline_depth) == (True, False, 6)
    K = np.asarray([40.0, 40.0, 32.0, 24.0, 0, 0, 0, 0], np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.System(config=ttracker.TrackerConfig(K=K, img_wh=(64, 48), kmax=4, lmax=32))
    s = tsystem.System(config=tentry.tracker_config("cpu", img_wh=(64, 48), kmax=4, lmax=32))
    tr = s.tracker
    assert tr.cfg.async_mapping and not tr.cfg.deterministic_mapping
    assert tr.cfg.pipeline_depth == 6 and tr._depth() == 6
    tr._ensure_mapper()
    m = tr.async_mapper
    assert isinstance(m, tmapper.AsyncMapper) and not m.inline and m.device.type == "cpu"
    assert m._thread.is_alive() and m._thread.daemon and m._stream is None
    s.shutdown()
    assert tr.async_mapper is None and not m._thread.is_alive()


def test_no_module_of_the_port_imports_cv2():
    """A CUDA host need not have OpenCV: the package and chip_smoke.py decode
    and encode images with utils/png.py."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f.relative_to(ROOT).as_posix() for f in files if "cv2" in set(_imported_roots(f))]
    assert not bad, bad


def test_parallel_and_the_new_api_modules_import_no_jax():
    files = sorted((PKG / "parallel").glob("*.py")) + [
        PKG / rel for rel in ("api/checkpoint.py", "api/viz.py", "api/viewer.py",
                              "api/datasets.py", "utils/png.py", "utils/frameloader.py",
                              "drivers.py")]
    assert {f.name for f in (PKG / "parallel").glob("*.py")} == {
        "__init__.py", "dist_ba.py", "map_ba.py", "multihost.py", "fleet.py"}
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & (set(FORBIDDEN) | {"cv2"}), (f.name, roots)


def test_resume_fleet_gba_and_drivers_default_to_cuda_and_raise_without_it(monkeypatch,
                                                                          tmp_path):
    from orb_slam3_tpu_torch import drivers
    from orb_slam3_tpu_torch.api import checkpoint as tck
    from orb_slam3_tpu_torch.api import system as tsystem
    from orb_slam3_tpu_torch.frontend import orb as torb
    from orb_slam3_tpu_torch.parallel import fleet, map_ba, multihost

    K = np.asarray([40.0, 40.0, 32.0, 24.0, 0, 0, 0, 0], np.float32)
    cpu_cfg = tentry.tracker_config("cpu", img_wh=(64, 48), kmax=4, lmax=32)
    s = ttracker.empty_map(cpu_cfg, device="cpu")
    path = str(tmp_path / "atlas.npz")
    tck.save_atlas(path, s)
    root = str(tmp_path / "seq")
    tentry.write_euroc_folder(root, [np.zeros((48, 64), np.float32)] * 2)
    yaml = tmp_path / "cam.yaml"
    yaml.write_text(tentry.pinhole_settings(K, (64, 48), n_features=100, n_levels=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: tck.load_atlas(path),
            lambda: tsystem.System(config=ttracker.TrackerConfig(K=K, img_wh=(64, 48), kmax=4,
                                                                 lmax=32), atlas_path=path),
            lambda: fleet.make_fleet_step(torb.OrbConfig(100, 2), K),
            lambda: map_ba.distributed_global_ba(s, K),
            lambda: multihost.init_distributed("127.0.0.1:1", 1, 0),
            lambda: drivers.run_euroc(root, str(yaml), log=lambda *a: None),
            lambda: drivers.main(["euroc", root, str(yaml), "--out", str(tmp_path / "t.txt")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # with the CPU named, the resumed System loads onto it
    r = tsystem.System(config=cpu_cfg, atlas_path=path)
    assert r.tracker.map.kf_R.device.type == "cpu" and int(r.tracker.map.active_map) == 1
    r.shutdown()


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_file_the_conftest_orders_exists():
    conftest = _root_conftest()
    listed = conftest.FIRST + conftest.LAST
    assert len(conftest.FIRST) >= 1 and len(set(listed)) == len(listed)
    missing = [f for f in listed if not (ROOT / "tests" / f).is_file()]
    assert not missing, f"conftest.py orders files that are gone: {missing}"


@pytest.mark.parametrize("reverse", [False, True])
def test_the_conftest_starts_the_longest_sessions_first_and_keeps_files_whole(reverse):
    conftest = _root_conftest()
    first, last = list(conftest.FIRST), list(conftest.LAST)
    cheap = [f"test_cheap_{i}.py" for i in range(8)]
    listed = (first + last)[::-1] if reverse else first + last
    collected = [f for pair in zip(listed, cheap) for f in pair] + listed[len(cheap):]
    items = [SimpleNamespace(path=Path("tests") / f, case=(f, k))
             for f in collected for k in range(3)]
    conftest.pytest_collection_modifyitems(None, items)

    order = list(dict.fromkeys(item.path.name for item in items))
    assert [item.case for item in items] == [(f, k) for f in order for k in range(3)]
    # the longest sessions, then the files not listed in collection order, then LAST
    assert order == first + cheap + last


def test_the_time_limit_fails_a_sleeping_test_and_disarms(monkeypatch):
    conftest = _root_conftest()
    monkeypatch.setattr(conftest, "TIME_LIMITS", {"test_stand_in.py::test_sleeps": (1, "it sleeps")})
    before = signal.getsignal(signal.SIGALRM)
    hook = conftest.pytest_runtest_call(SimpleNamespace(path=Path("tests/test_stand_in.py"),
                                                        name="test_sleeps"))
    next(hook)                                # armed, as pytest does before the call
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception) as failed:
        time.sleep(30)                        # the stand-in test
    assert 0.9 < time.monotonic() - t0 < 5
    with pytest.raises(pytest.fail.Exception, match="time limit of 1 s: it sleeps"):
        hook.throw(failed.value)              # pytest hands the test's error to the wrapper
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert signal.getsignal(signal.SIGALRM) is before

    other = conftest.pytest_runtest_call(SimpleNamespace(path=Path("tests/test_stand_in.py"),
                                                         name="test_other"))
    next(other)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    with pytest.raises(StopIteration):
        other.send(None)


def test_the_one_time_limit_names_a_test_that_exists():
    conftest = _root_conftest()
    assert len(conftest.TIME_LIMITS) == 1
    for name, (seconds, why) in conftest.TIME_LIMITS.items():
        file, test = name.split("::")
        tree = ast.parse((ROOT / "tests" / file).read_text())
        assert test in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert 0 < seconds < 300 and why
