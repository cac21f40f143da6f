"""Atlas checkpoints and the resumed session on the port.

- An atlas the JAX package wrote loads in the port equal, field by field
  and exactly, to `convert.map_state` of the JAX state; one the port wrote
  loads in the JAX package equal to the port's arrays.
- `vocab_checksum` is the JAX package's for one vocabulary trained here (a
  non-contiguous copy of its centres too); the guard refuses another.
- The twin of tests/test_api.py::test_checkpoint_roundtrip.
- System(atlas_path=...) on a saved arena at the small CPU config, with no
  frame tracked: the loaded maps, a fresh active map, the keyframe
  database rebuilt from every loaded keyframe; Tracker.adopt_map of a
  grown arena.
- Behind `slow`: a session that maps, saves, resumes and tracks on, with
  adopt_map between its frames; the twin of
  tests/test_loop_reloc.py::test_atlas_resume_relocalizes_into_loaded_map
  at its size (the resumed session merges into the loaded map).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.api import checkpoint as jck
from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.atlas import state as jstate
from orb_slam3_tpu.place import vocab as jvocab
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.api import checkpoint as tck
from orb_slam3_tpu_torch.api.system import System
from orb_slam3_tpu_torch.atlas import ops as tops
from orb_slam3_tpu_torch.atlas import state as tstate
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.place import vocab as tvocab
from orb_slam3_tpu_torch.tracking import tracker as ttrk

torch.set_num_threads(2)
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
WH = (256, 192)


@pytest.fixture(scope="module")
def vocabs():
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, (500, 32), dtype=np.uint8)
    vj = jvocab.train(desc, 4, 2)
    vj2 = jvocab.train(rng.integers(0, 256, (500, 32), dtype=np.uint8), 4, 2, seed=9)
    return vj, convert.vocabulary(vj, "cpu"), convert.vocabulary(vj2, "cpu")


def jax_map():
    """A JAX MapState with two keyframes and bound landmarks."""
    rng = np.random.default_rng(1)
    s = jstate.empty(kmax=8, fmax=32, lmax=64)
    for k in range(2):
        s, _ = jops.add_keyframe(
            s, jnp.eye(3), jnp.asarray([0.1 * k, 0.0, 0.0]), 1.5 + k,
            jnp.asarray(rng.random((32, 2)) * 100, jnp.float32),
            jnp.asarray(rng.integers(0, 4, 32), jnp.int32),
            jnp.asarray(rng.random(32), jnp.float32),
            jnp.asarray(rng.integers(0, 256, (32, 32)), jnp.uint8), jnp.ones(32, bool),
            feat_lm=jnp.asarray(np.where(np.arange(32) < 20, np.arange(32), -1), jnp.int32))
    return dataclasses.replace(
        s, lm_pos=jnp.asarray(rng.normal(size=(64, 3)), jnp.float32),
        lm_valid=jnp.asarray(np.arange(64) < 20), n_lm=jnp.asarray(20, jnp.int32),
        lm_desc=jnp.asarray(rng.integers(0, 256, (64, 32)), jnp.uint8))


def test_vocab_checksum_is_the_jax_packages(vocabs):
    vj, vt, vt2 = vocabs
    assert tck.vocab_checksum(vt) == jck.vocab_checksum(vj)
    assert tck.vocab_checksum(None) == jck.vocab_checksum(None) == "none"
    # a non-contiguous copy of the same centres hashes the same bytes
    odd = dataclasses.replace(vt, centers=vt.centers.T.contiguous().T)
    assert not odd.centers.is_contiguous()
    assert tck.vocab_checksum(odd) == jck.vocab_checksum(vj)
    assert tck.vocab_checksum(vt2) != tck.vocab_checksum(vt)


def test_a_jax_atlas_loads_in_the_port(tmp_path, vocabs):
    vj, vt, vt2 = vocabs
    js = jax_map()
    path = str(tmp_path / "jax.npz")
    jck.save_atlas(path, js, vj, extra={"frames": np.arange(3)})
    got, extra = tck.load_atlas(path, vt, device="cpu")
    want = convert.map_state(js, "cpu")
    for f in dataclasses.fields(tstate.MapState):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    np.testing.assert_array_equal(extra["frames"], np.arange(3))
    with pytest.raises(ValueError, match="checksum"):
        tck.load_atlas(path, vt2, device="cpu")


def test_a_port_atlas_loads_in_the_jax_package(tmp_path, vocabs):
    vj, vt, _ = vocabs
    ts = convert.map_state(jax_map(), "cpu")
    ts = dataclasses.replace(ts, kf_vel=torch.randn(ts.kmax, 3),
                             active_map=torch.tensor(1, dtype=torch.int32),
                             n_maps=torch.tensor(2, dtype=torch.int32))
    path = str(tmp_path / "port.npz")
    tck.save_atlas(path, ts, vt)
    js, _ = jck.load_atlas(path, vj)
    want = convert.map_state_arrays(ts)
    for f in dataclasses.fields(jstate.MapState):
        a = np.asarray(getattr(js, f.name))
        assert a.dtype == want[f.name].dtype and a.shape == want[f.name].shape, f.name
        np.testing.assert_array_equal(a, want[f.name], err_msg=f.name)
    # and back in the port: every field, its shape (0-dim counters) included
    back, _ = tck.load_atlas(path, vt, device="cpu")
    for f in dataclasses.fields(tstate.MapState):
        a, b = getattr(back, f.name), getattr(ts, f.name)
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), f.name


def test_checkpoint_roundtrip(tmp_path, vocabs):
    """tests/test_api.py::test_checkpoint_roundtrip on the port."""
    _, vt, vt2 = vocabs
    rng = np.random.default_rng(0)
    s = tstate.empty(kmax=8, fmax=32, lmax=64, device="cpu")
    s, _ = tops.add_keyframe(
        s, torch.eye(3), torch.ones(3), 1.5, torch.tensor(rng.random((32, 2)) * 100,
                                                          dtype=torch.float32),
        torch.zeros(32, dtype=torch.int32), torch.zeros(32),
        torch.tensor(rng.integers(0, 256, (32, 32)), dtype=torch.uint8),
        torch.ones(32, dtype=torch.bool))
    path = str(tmp_path / "atlas.npz")
    tck.save_atlas(path, s, vt)
    s2, _ = tck.load_atlas(path, vt, device="cpu")
    assert int(s2.n_kf) == 1
    np.testing.assert_array_equal(s2.kf_t[0].numpy(), np.ones(3))
    assert torch.equal(s2.kf_feat_desc, s.kf_feat_desc)
    with pytest.raises(ValueError):
        tck.load_atlas(path, vt2, device="cpu")


# ---------------------------------------------------------------------------
# the resumed session
# ---------------------------------------------------------------------------

def small_config():
    return ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                              orb=torb.OrbConfig(300, 4), kmax=16, lmax=1024, local_window=4,
                              sensor="rgbd", bf=20.0, th_depth=20.0, kf_max_frames=2,
                              async_mapping=False, pipeline_depth=1)


def random_words(seed):
    """A vocabulary of random words: the database and its guard do not need
    the scene's (the slow twin below trains on held-out views)."""
    return tvocab.train(np.random.default_rng(seed).integers(0, 256, (400, 32), dtype=np.uint8),
                        branching=8, depth=3, device="cpu")


def test_system_loads_an_atlas_and_rebuilds_the_database(tmp_path):
    """System(atlas_path=...) on a saved arena of 4 keyframes, no frame
    tracked: load -> create_map -> rebuild_db. The loaded maps sit beside
    a fresh active map, the database holds every loaded keyframe, another
    vocabulary is refused; Tracker.adopt_map takes a grown arena, rebuilds
    the database at its size and refuses to shrink."""
    cfg = small_config()
    rng = np.random.default_rng(4)
    fmax = cfg.orb.n_features
    s = tstate.empty(kmax=cfg.kmax, fmax=fmax, lmax=cfg.lmax, device="cpu")
    for k in range(4):
        s, _ = tops.add_keyframe(
            s, torch.eye(3), torch.tensor([0.1 * k, 0.0, 0.0]), 0.05 * k,
            torch.tensor(rng.random((fmax, 2)) * 100, dtype=torch.float32),
            torch.zeros(fmax, dtype=torch.int32), torch.zeros(fmax),
            torch.tensor(rng.integers(0, 256, (fmax, 32)), dtype=torch.uint8),
            torch.ones(fmax, dtype=torch.bool))
    voc = random_words(1)
    path = str(tmp_path / "atlas.npz")
    tck.save_atlas(path, s, voc)
    s2 = System(config=small_config(), vocabulary=voc, atlas_path=path)
    t2 = s2.tracker
    m = t2.map
    assert int(m.n_maps) == int(s.n_maps) + 1 and int(m.active_map) == int(s.n_maps)
    for f in dataclasses.fields(m):
        if f.name not in ("active_map", "n_maps"):
            a, b = getattr(m, f.name), getattr(s, f.name)
            assert a.shape == b.shape and torch.equal(a, b), f.name
    db = t2.loop_closer.db
    assert int(db.valid.sum()) == 4 and bool((db.valid == s.kf_valid).all())
    with pytest.raises(ValueError, match="checksum"):
        System(config=small_config(), vocabulary=random_words(3), atlas_path=path)
    grown = tops.grow(m, kmax=2 * m.kmax, lmax=2 * m.lmax)
    v0 = t2._map_version
    t2.adopt_map(grown)
    assert (t2.cfg.kmax, t2.cfg.lmax) == (grown.kmax, grown.lmax)
    assert t2._map_version == v0 + 1 and t2.loop_closer.db.valid.shape[0] == grown.kmax
    assert int(t2.loop_closer.db.valid.sum()) == 4
    with pytest.raises(ValueError, match="shrink"):
        t2.adopt_map(s)
    s2.shutdown()


@pytest.mark.slow
def test_system_resumes_from_a_saved_atlas(tmp_path):
    """Session 1 maps 6 frames and saves; System(atlas_path=...) holds the
    loaded maps with a fresh active map and a keyframe database of every
    loaded keyframe, then tracks the same region in its fresh map, adopts
    a grown arena between two frames and tracks on."""
    planes = entry.plane_scene(7)
    R, t = entry.orbit_trajectory(20, advance=0.05)
    frames = [entry.render_with_depth(planes, tuple(K_NP[:4]), WH, R[i], t[i])
              for i in range(6)]
    cfg = small_config()
    voc = random_words(1)
    s1 = System(config=cfg, vocabulary=voc)
    for i, (img, depth) in enumerate(frames):
        s1.track_rgbd(img, depth, 0.05 * i)
    assert s1.tracking_state() == ttrk.OK
    path = str(tmp_path / "session1.npz")
    s1.save_atlas(path)
    saved = s1.tracker.map
    s1.shutdown()
    n_kf = int(saved.kf_valid.sum())
    assert n_kf >= 3

    s2 = System(config=small_config(), vocabulary=voc, atlas_path=path)
    t2 = s2.tracker
    m = t2.map
    assert int(m.n_maps) == int(saved.n_maps) + 1 and int(m.active_map) == int(saved.n_maps)
    for f in dataclasses.fields(m):
        if f.name not in ("active_map", "n_maps"):
            a, b = getattr(m, f.name), getattr(saved, f.name)
            assert a.shape == b.shape and torch.equal(a, b), f.name
    db = t2.loop_closer.db
    assert int(db.valid.sum()) == n_kf
    assert bool((db.valid == saved.kf_valid).all())
    # the refusal of another vocabulary
    with pytest.raises(ValueError, match="checksum"):
        System(config=small_config(), vocabulary=random_words(3), atlas_path=path)
    img, depth = frames[2]
    s2.track_rgbd(img, depth, 100.0)
    assert s2.tracking_state() == ttrk.OK
    # Tracker.adopt_map: the live session takes a larger arena holding its
    # own rows (what HostedAtlas.ship_map hands it); its per-landmark
    # buffers grow, the database is rebuilt, and tracking goes on
    grown = tops.grow(t2.map, kmax=2 * t2.map.kmax, lmax=2 * t2.map.lmax)
    v0 = t2._map_version
    t2.adopt_map(grown)
    assert t2.map is not None and (t2.cfg.kmax, t2.cfg.lmax) == (grown.kmax, grown.lmax)
    assert t2._map_version == v0 + 1 and t2.loop_closer.db.valid.shape[0] == grown.kmax
    assert int(t2.loop_closer.db.valid.sum()) == int(grown.kf_valid.sum())
    assert t2._tracked_lms is None or t2._tracked_lms.shape[0] == grown.lmax
    with pytest.raises(ValueError, match="shrink"):
        t2.adopt_map(saved)
    img, depth = frames[3]
    s2.track_rgbd(img, depth, 100.2)
    assert s2.tracking_state() == ttrk.OK
    s2.shutdown()


@pytest.mark.slow
def test_atlas_resume_relocalizes_into_loaded_map(tmp_path):
    """tests/test_loop_reloc.py::test_atlas_resume_relocalizes_into_loaded_map
    on the port at its size (512x384, OrbConfig(600, 4), kmax 64, lmax
    8192, the JAX deterministic schedule): the rebuilt database holds >= 8
    keyframes, the resumed session merges its fresh map into the loaded
    one, one map id is left."""
    K = (350.0, 350.0, 256.0, 192.0)
    wh = (512, 384)
    planes = entry.plane_scene(7)
    R_gt, t_gt = entry.orbit_trajectory(40, advance=0.05)
    cfg = entry.tracker_config("cpu", img_wh=wh, K=K, sensor="rgbd", bf=35.0, th_depth=20.0,
                               orb=torb.OrbConfig(600, 4), kmax=64, lmax=8192, local_window=6,
                               kf_max_frames=2, deterministic_mapping=True)
    frame = lambda i: entry.render_with_depth(planes, K, wh, R_gt[i], t_gt[i])  # noqa: E731
    voc = entry.train_vocabulary([frame(i)[0] for i in range(3)], cfg)
    t = ttrk.Tracker(cfg, device="cpu")
    t.attach_loop_closer(voc)
    for i in range(20):
        img, depth = frame(i)
        t.process(img, i * 0.05, depth_map=depth)
    t.sync_mapping()
    assert t.state == ttrk.OK and int(t.map.n_kf) >= 8
    path = str(tmp_path / "session1.npz")
    tck.save_atlas(path, t.map, voc)
    t.shutdown()
    sys2 = System(config=cfg, vocabulary=voc, atlas_path=path)
    t2 = sys2.tracker
    assert int(t2.loop_closer.db.valid.sum()) >= 8, "KF database was not rebuilt on load"
    merged = False
    for k, i in enumerate(range(2, 40, 2)):
        img, depth = frame(i)
        t2.process(img, 100.0 + k * 0.05, depth_map=depth)
        t2.sync_mapping()
        if t2.loop_closer.n_merges > 0:
            merged = True
            break
    sys2.shutdown()
    assert merged, "resumed session never merged into the loaded map"
    assert len(np.unique(t2.map.kf_map_id.numpy()[t2.map.kf_valid.numpy()])) == 1
