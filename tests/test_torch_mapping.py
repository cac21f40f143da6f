"""The port's local-mapping stages against the JAX package, stage by stage.

The map comes from a short monocular session at the size of
test_torch_bootstrap.py (PlaneScene at 256x192, OrbConfig(300, 4), kmax 8,
lmax 1024, local window 4) run by the port's Tracker on the JAX package's
features (its jitted extraction, converted), with the JAX tracker's two-view
minimal sets. The state it holds just before its fourth keyframe is turned
into a JAX MapState, and that one JAX map state, carried across by
convert.map_state, is the input of both sides:

- triangulate_pair: accept masks equal on >= 99% of features, the matched
  feature equal where both accept, Xw within 1e-4 relative;
- fuse_into_keyframe: the keyframe row's bindings equal on >= 99% of
  features, and a planted conflict (two landmarks on one feature) resolves
  to the JAX package's value on the CPU, the higher landmark row;
- cull_landmarks, cull_keyframes (a culled chain three parents deep) and
  map_stage_post: every integer and flag field equal, float fields within
  1e-5;
- map_stage_pre: keyframe row, BA window and n_fixed equal, landmark count
  within 1%, bindings equal on >= 99% of features.

The JAX side runs with the repair the port makes to add_observations
(writes only its ok entries; see test_torch_bootstrap.py): triangulation
binds kf2 through the unchecked best match of every kf1 feature, which
repeats features. JAX's compiled programs are cleared around the module, so
no program traced with that repair outlives it.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu.atlas import ops as jops
from orb_slam3_tpu.atlas import state as jstate
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.frontend import two_view as jtv
from orb_slam3_tpu.mapping import fuse as jfuse
from orb_slam3_tpu.mapping import local_mapper as jlm
from orb_slam3_tpu.mapping import pipeline as jpipe
from orb_slam3_tpu.tracking import tracker as jtrk
from orb_slam3_tpu_torch import convert
from orb_slam3_tpu_torch.atlas import ops as tops
from orb_slam3_tpu_torch.frontend import matching as tm
from orb_slam3_tpu_torch.mapping import fuse as tfuse
from orb_slam3_tpu_torch.mapping import local_mapper as tlm
from orb_slam3_tpu_torch.mapping import pipeline as tpipe
from orb_slam3_tpu_torch.tracking import tracker as ttrk
from synthetic_scene import PlaneScene, orbit_trajectory

torch.set_num_threads(1)
WH = (256, 192)
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
OCFG = jorb.OrbConfig(n_features=300, n_levels=4)
SF = np.asarray([1.2 ** i for i in range(4)], np.float32)


def jax_add_observations_ok_only(s, kf_row, feat_idx, lm_rows, ok):
    """JAX atlas_ops.add_observations writing only the ok entries."""
    F = s.kf_feat_lm.shape[1]
    new = s.kf_feat_lm.at[kf_row, jnp.where(ok, feat_idx, F)].set(lm_rows, mode="drop")
    return dataclasses.replace(s, kf_feat_lm=new)


def jax_features(n_frames):
    """The PlaneScene orbit's first n_frames frames, extracted by the JAX
    tracker's jitted extraction: (images, JAX features, port features)."""
    scene = PlaneScene(K_NP, img_wh=WH, two_planes=True, seed=0)
    R_gt, t_gt = orbit_trajectory(n_frames)
    imgs = [scene.render(R_gt[i], t_gt[i]) for i in range(n_frames)]
    zero = jnp.zeros((5,), jnp.float32)
    jf = [jtrk._extract_features(jnp.asarray(im, jnp.float32), jnp.asarray(K_NP), zero, OCFG,
                                 False) for im in imgs]
    tf = [convert.features(f.xy, f.response, f.angle, f.octave, f.descriptors, f.valid,
                           device="cpu") for f in jf]
    return imgs, jf, tf, (R_gt, t_gt)


def port_tracker(tf, kmax=8, lmax=1024, async_mapping=False, pipeline_depth=1, **fields):
    """A CPU port Tracker whose extraction hands out `tf` in order (the JAX
    features of each frame); the synchronous schedule unless told
    otherwise."""
    cfg = ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                             orb=convert.orb_config(OCFG), kmax=kmax, lmax=lmax,
                             local_window=4, async_mapping=async_mapping,
                             pipeline_depth=pipeline_depth, **fields)
    t = ttrk.Tracker(cfg)
    it = iter(tf)
    t._extract = lambda img: next(it)
    return t


def use_jax_minimal_sets(monkeypatch):
    """Make the port's initialization use the minimal sets the JAX tracker
    draws for the same frame count (its key: PRNGKey(frame count))."""
    orig = ttrk.initialize_monocular

    def init(cfg, s, init_ref, feats, timestamp, seed=0, sets=None, timer=ttrk.no_timer):
        if init_ref is not None:
            r = init_ref[0]
            _, ok = tm.search_for_initialization(r.xy, r.descriptors, r.valid, feats.xy,
                                                 feats.descriptors, feats.valid,
                                                 window=100.0, ratio=0.9)
            key = jax.random.split(jax.random.PRNGKey(seed))[0]
            sets = torch.from_numpy(np.array(jtv._sample_minimal_sets(key, jnp.asarray(ok.numpy()))))
        return orig(cfg, s, init_ref, feats, timestamp, seed=seed, sets=sets, timer=timer)

    monkeypatch.setattr(ttrk, "initialize_monocular", init)


def jax_map(s_port):
    """The port's MapState as a JAX MapState."""
    return jstate.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_arrays(s_port).items()})


def jax_package(pkg):
    """The port's KFPackage as a JAX KFPackage."""
    a = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa: E731
    return jpipe.KFPackage(
        R=a(pkg.R), t=a(pkg.t), timestamp=pkg.timestamp, feat_xy=a(pkg.feat_xy),
        feat_octave=a(pkg.feat_octave), feat_angle=a(pkg.feat_angle),
        feat_desc=a(pkg.feat_desc), feat_valid=a(pkg.feat_valid), feat_lm=a(pkg.feat_lm),
        feat_ur=a(pkg.feat_ur), feat_depth=a(pkg.feat_depth), n_inliers=pkg.n_inliers)


def jax_config(tcfg):
    return jtrk.TrackerConfig(K=jnp.asarray(K_NP), img_wh=WH, orb=OCFG, kmax=tcfg.kmax,
                              lmax=tcfg.lmax, local_window=tcfg.local_window,
                              async_mapping=False, pipeline_depth=1)


def assert_states_equal(t, j, float_rtol=1e-5):
    """Every integer and flag field equal; float fields within float_rtol."""
    ja = {f.name: np.asarray(getattr(j, f.name)) for f in dataclasses.fields(j)}
    for name, a in convert.map_state_arrays(t).items():
        b = ja[name]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=float_rtol, atol=float_rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def capture_before_kf():
    """The map just before the session inserts its fourth keyframe, with
    that keyframe's package, as JAX objects."""
    imgs, jf, tf, _ = jax_features(11)
    rec = {}
    with pytest.MonkeyPatch.context() as mp:
        use_jax_minimal_sets(mp)
        orig = tpipe.run_pre_stage

        def record(s, pkg, cfg, base_sensor, parent_row, scale_factors):
            rec.setdefault("calls", []).append((s, pkg, parent_row))
            return orig(s, pkg, cfg, base_sensor, parent_row, scale_factors)

        mp.setattr(tpipe, "run_pre_stage", record)
        t = port_tracker(tf)
        for i, img in enumerate(imgs):
            t.process(img, 0.05 * i)
    s, pkg, parent = rec["calls"][-1]
    assert int(s.n_kf) == 3 and parent == 2 and len(rec["calls"]) == 2
    return dict(js=jax_map(s), jpkg=jax_package(pkg), parent=parent, tcfg=t.cfg,
                jsf=jnp.asarray(SF), tsf=torch.from_numpy(SF))


@pytest.fixture(scope="module")
def before_kf():
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "add_observations", jax_add_observations_ok_only)
        yield capture_before_kf()
    jax.clear_caches()


def _with_keyframe(b):
    """The JAX state with the package's keyframe appended (row 3), as
    map_stage_pre inserts it."""
    p = b["jpkg"]
    js, kf = jops.add_keyframe(b["js"], p.R, p.t, p.timestamp, p.feat_xy, p.feat_octave,
                               p.feat_angle, p.feat_desc, p.feat_valid, feat_lm=p.feat_lm,
                               parent=jnp.int32(b["parent"]), prev=jnp.int32(b["parent"]))
    return js, int(kf)


@pytest.mark.parametrize("nbr", [1, 0])
def test_triangulate_pair_matches_jax(before_kf, nbr):
    js, kf = _with_keyframe(before_kf)
    K = jnp.asarray(K_NP)
    Xj, f1j, f2j, aj = (np.asarray(a) for a in jlm.triangulate_pair(
        0, K, js, jnp.int32(kf), jnp.int32(nbr), before_kf["jsf"]))
    Xt, f1t, f2t, at = (a.numpy() for a in tlm.triangulate_pair(
        0, convert.camera(K_NP, "cpu"), convert.map_state(js, "cpu"), kf, nbr,
        before_kf["tsf"]))
    np.testing.assert_array_equal(f1t, f1j)
    assert aj.sum() >= 10, aj.sum()
    assert (at == aj).mean() >= 0.99, ((at != aj).sum(), aj.sum())
    both = at & aj
    np.testing.assert_array_equal(f2t[both], f2j[both])
    err = np.linalg.norm(Xt[both] - Xj[both], axis=1) / np.linalg.norm(Xj[both], axis=1)
    assert err.max() <= 1e-4, err.max()
    # a mono map has no measured depth: use_depth changes nothing
    Xd, f1d, f2d, ad = (a.numpy() for a in tlm.triangulate_pair(
        0, convert.camera(K_NP, "cpu"), convert.map_state(js, "cpu"), kf, nbr,
        before_kf["tsf"], use_depth=True))
    np.testing.assert_array_equal(ad, at)
    np.testing.assert_array_equal(Xd[ad], Xt[at])


def _triangulated(b):
    """The JAX state after the new keyframe, its triangulation against row 1
    (the parent, row 2, is too close for any point to pass) and a refresh of
    the landmark statistics, so that the new landmarks can be fused (before
    the refresh their distance range is empty)."""
    js, kf = _with_keyframe(b)
    out = jlm.triangulate_pair(0, jnp.asarray(K_NP), js, jnp.int32(kf), jnp.int32(1), b["jsf"])
    js = jlm.insert_triangulated(js, kf, jnp.int32(1), *out)
    return jstate.update_landmark_stats(js), kf


def test_insert_triangulated_matches_jax(before_kf):
    js, kf = _with_keyframe(before_kf)
    out = jlm.triangulate_pair(0, jnp.asarray(K_NP), js, jnp.int32(kf), jnp.int32(1),
                               before_kf["jsf"])
    j = jlm.insert_triangulated(js, kf, jnp.int32(1), *out)
    t = tlm.insert_triangulated(convert.map_state(js, "cpu"), kf, 1,
                                *(torch.from_numpy(np.array(a)) for a in out))
    assert int(t.n_lm) == int(j.n_lm) > int(js.n_lm)
    assert_states_equal(t, j)


@pytest.mark.parametrize("row", [2, 1])
def test_fuse_into_keyframe_matches_jax(before_kf, row):
    js, _ = _triangulated(before_kf)
    ts = convert.map_state(js, "cpu")
    j = jfuse.fuse_into_keyframe(0, jnp.asarray(K_NP), js, jnp.int32(row), before_kf["jsf"])
    t = tfuse.fuse_into_keyframe(0, convert.camera(K_NP, "cpu"), ts, row, before_kf["tsf"])
    fj, ft = np.asarray(j.kf_feat_lm[row]), t.kf_feat_lm[row].numpy()
    added = (fj != np.asarray(js.kf_feat_lm[row])).sum()
    assert added >= 5, added
    assert (ft == fj).mean() >= 0.99, (ft != fj).sum()
    # nothing but the row changes
    np.testing.assert_array_equal(np.delete(t.kf_feat_lm.numpy(), row, 0),
                                  np.delete(np.asarray(j.kf_feat_lm), row, 0))


def test_fuse_conflict_resolves_to_the_jax_cpu_value(before_kf):
    """Landmark r and its copy r2 (a higher row) both match one free feature
    of keyframe 2. JAX's scatter-set keeps the last write on the CPU, r2;
    the port keeps the highest row, r2, in any order."""
    js, _ = _triangulated(before_kf)
    kf = 2
    ts = convert.map_state(js, "cpu")
    t1 = tfuse.fuse_into_keyframe(0, convert.camera(K_NP, "cpu"), ts, kf, before_kf["tsf"])
    new = (t1.kf_feat_lm[kf] >= 0) & (ts.kf_feat_lm[kf] < 0)
    f = int(torch.nonzero(new)[0, 0])
    r = int(t1.kf_feat_lm[kf, f])
    r2 = int(js.n_lm)
    dup = {name: getattr(js, name).at[r2].set(getattr(js, name)[r])
           for name in ("lm_pos", "lm_desc", "lm_valid", "lm_map_id", "lm_normal",
                        "lm_min_dist", "lm_max_dist", "lm_first_kf")}
    jsd = dataclasses.replace(js, n_lm=js.n_lm + 1, **dup)
    j = jfuse.fuse_into_keyframe(0, jnp.asarray(K_NP), jsd, jnp.int32(kf), before_kf["jsf"])
    t = tfuse.fuse_into_keyframe(0, convert.camera(K_NP, "cpu"), convert.map_state(jsd, "cpu"),
                                 kf, before_kf["tsf"])
    assert int(j.kf_feat_lm[kf, f]) == r2 and r2 > r
    assert int(t.kf_feat_lm[kf, f]) == r2
    # the inversion alone: rows 0, 2 and 3 pick feature 1
    idx, ok = np.int32([1, 3, 1, 1]), np.array([True, True, True, True])
    ref = jnp.full((4,), -1, jnp.int32).at[jnp.where(ok, idx, 4)].set(
        jnp.where(ok, jnp.arange(4, dtype=jnp.int32), 0), mode="drop")
    got = tfuse.invert_matches(torch.from_numpy(idx), torch.from_numpy(ok), 4)
    assert got.tolist() == np.asarray(ref).tolist() == [-1, 3, -1, 1]


def cull_chain_state():
    """A JAX MapState of 10 keyframes where rows 3, 5 and 7 are redundant
    (all 12 bound landmarks seen by 5 keyframes) and form a parent chain
    8 -> 7 -> 5 -> 3 -> 2; the other rows bind 12 landmarks of their own.
    Landmarks have a mix of found / visible ratios and creation rows."""
    K, F, L = 12, 16, 128
    rng = np.random.default_rng(4)
    s = jstate.empty(kmax=K, fmax=F, lmax=L)
    lm = np.full((K, F), -1, np.int32)
    nxt = 12
    for r in range(10):
        if r in (3, 5, 7):
            lm[r, :12] = np.arange(12)
        elif r in (0, 1):
            lm[r, :12] = np.arange(12)
            lm[r, 12:] = np.arange(nxt, nxt + 4)
            nxt += 4
        else:
            lm[r, :4] = np.arange(4)
            lm[r, 4:] = np.arange(nxt, nxt + 12)
            nxt += 12
    first = np.zeros(L, np.int32)
    for r in range(10):
        first[lm[r][lm[r] >= 12]] = r
    n_lm = nxt + 2  # two valid landmarks nobody observes
    parent = np.int32([-1, 0, 1, 2, 3, 3, 5, 5, 7, 8] + [-1] * 2)
    prev = np.int32([-1, 0, 1, 2, 3, 4, 5, 6, 7, 8] + [-1] * 2)
    Rs = np.stack([np.eye(3, dtype=np.float32)] * K)
    ts = np.zeros((K, 3), np.float32)
    ts[:10, 0] = -0.05 * np.arange(10)
    pos = np.concatenate([rng.uniform(-2, 2, (L, 2)), rng.uniform(4, 6, (L, 1))], 1)
    xy = rng.uniform(0, 256, (K, F, 2))
    vis = rng.integers(0, 12, L)
    found = rng.integers(0, vis + 1)
    vis[:12] = found[:12] = 10  # the shared landmarks are found when visible
    return dataclasses.replace(
        s, n_kf=jnp.int32(10), n_lm=jnp.int32(n_lm),
        kf_valid=jnp.asarray(np.arange(K) < 10), kf_map_id=jnp.asarray(np.where(np.arange(K) < 10, 0, -1).astype(np.int32)),
        kf_parent=jnp.asarray(parent), kf_prev=jnp.asarray(prev), kf_R=jnp.asarray(Rs),
        kf_t=jnp.asarray(ts), kf_feat_lm=jnp.asarray(lm),
        kf_feat_valid=jnp.asarray(np.broadcast_to(np.arange(K)[:, None] < 10, (K, F))),
        kf_feat_xy=jnp.asarray(xy, jnp.float32),
        kf_feat_octave=jnp.asarray(rng.integers(0, 4, (K, F)).astype(np.int32)),
        lm_valid=jnp.asarray(np.arange(L) < n_lm), lm_map_id=jnp.zeros((L,), jnp.int32),
        lm_pos=jnp.asarray(pos, jnp.float32), lm_first_kf=jnp.asarray(first),
        lm_visible=jnp.asarray(vis.astype(np.int32)),
        lm_found=jnp.asarray(found.astype(np.int32)),
    )


def test_cull_landmarks_matches_jax():
    js = cull_chain_state()
    j = jlm.cull_landmarks(js)
    t = tlm.cull_landmarks(convert.map_state(js, "cpu"))
    killed = int(js.lm_valid.sum()) - int(j.lm_valid.sum())
    assert 10 <= killed < int(js.lm_valid.sum()) - 12, killed
    assert_states_equal(t, j, float_rtol=0.0)


def test_cull_keyframes_matches_jax_through_a_culled_chain():
    js = cull_chain_state()
    rows = jnp.arange(10, dtype=jnp.int32)
    j = jlm.cull_keyframes(js, rows)
    t = tlm.cull_keyframes(convert.map_state(js, "cpu"), torch.arange(10, dtype=torch.int32))
    assert np.nonzero(~np.asarray(j.kf_valid[:10]))[0].tolist() == [3, 5, 7]
    # 8's parent chain 7 -> 5 -> 3 is culled: it hangs on 2, as do 4 and 6
    assert np.asarray(j.kf_parent[:10]).tolist() == [-1, 0, 1, 2, 2, 2, 2, 2, 2, 8]
    assert_states_equal(t, j, float_rtol=0.0)


@pytest.mark.parametrize("min_kf_for_cull", [8, 10])
def test_map_stage_post_matches_jax(min_kf_for_cull):
    """min_kf_for_cull 8: keyframe culling runs (10 valid rows); 10: it does
    not."""
    js = cull_chain_state()
    rows = jnp.arange(10, dtype=jnp.int32)
    j = jpipe.map_stage_post(js, rows, jnp.asarray(min_kf_for_cull, jnp.int32))
    t = tpipe.map_stage_post(convert.map_state(js, "cpu"), torch.arange(10, dtype=torch.int32),
                             min_kf_for_cull)
    assert int(j.kf_valid.sum()) == (7 if min_kf_for_cull == 8 else 10)
    assert_states_equal(t, j)


def test_map_stage_pre_matches_jax(before_kf):
    b = before_kf
    jcfg = jax_config(b["tcfg"])
    js, kf_j, rows_j, nf_j = jpipe.run_pre_stage(b["js"], b["jpkg"], jcfg, "mono", b["parent"],
                                                 b["jsf"])
    ts, kf_t, rows_t, nf_t = tpipe.run_pre_stage(
        convert.map_state(b["js"], "cpu"), convert.kf_package(b["jpkg"], "cpu"), b["tcfg"],
        "mono", b["parent"], b["tsf"])
    assert kf_t == kf_j == 3
    assert rows_t.tolist() == np.asarray(rows_j).tolist() == [0, 1, 2, 3, 3, 3, 3, 3]
    assert int(nf_t) == int(nf_j) == 2
    n_j, n_t = int(js.lm_valid.sum()), int(ts.lm_valid.sum())
    assert n_j > int(b["js"].lm_valid.sum()) and abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
    fl_j, fl_t = np.asarray(js.kf_feat_lm[:4]), ts.kf_feat_lm[:4].numpy()
    for r in range(4):
        assert (fl_t[r] == fl_j[r]).mean() >= 0.99, (r, (fl_t[r] != fl_j[r]).sum())
    np.testing.assert_array_equal(ts.kf_parent.numpy(), np.asarray(js.kf_parent))
