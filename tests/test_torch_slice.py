"""The port's per-frame tracking step against the JAX step, end to end.

A self-consistent scene at small size (256x192 blob frame, 256 features
over 4 levels, L=512): landmarks lifted from the frame's own keypoints plus
random valid slots, tracked from a perturbed start pose. The JAX step is
the body of __graft_entry__.entry() at this size; the port's is
entry.make_track_step. Inputs cross through convert.py. Both must recover
the true pose, and agree on n, R and t.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_tpu.frontend import camera as jcam
from orb_slam3_tpu.frontend import orb as jorb
from orb_slam3_tpu.tracking import track as jtrack
from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.frontend import orb as torb

torch.set_num_threads(1)

H, W, L = 192, 256, 512
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)


def _jax_step(cfg, K, img_wh):
    scale_factors = jnp.asarray([cfg.scale_factor ** i for i in range(cfg.n_levels)])

    def track_step(img, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind,
                   lm_normal, R0, t0):
        feats = jorb.extract(img, cfg)
        idx, ok, _, _, _ = jtrack.match_local_map(
            jcam.PINHOLE, K, R0, t0, lm_pos, lm_desc, lm_valid,
            lm_maxd, lm_mind, lm_normal,
            feats.xy, feats.descriptors, feats.octave, feats.valid,
            15.0, scale_factors, img_wh=img_wh,
        )
        inv_sig2 = 1.0 / (
            scale_factors[jnp.clip(feats.octave[idx], 0, cfg.n_levels - 1)] ** 2
        )
        R, t, _, n = jtrack.pose_optimize(
            jcam.PINHOLE, K, R0, t0, feats.xy[idx], lm_pos, inv_sig2, ok
        )
        return R, t, n

    return jax.jit(track_step)


def test_track_step_matches_jax():
    jcfg = jorb.OrbConfig(n_features=256, n_levels=4)
    img = entry.blob_frame(H, W, seed=3)
    f = jax.jit(jorb.extract, static_argnums=1)(jnp.asarray(img), jcfg)
    scene = entry.make_scene(
        np.asarray(f.xy), np.asarray(f.octave), np.asarray(f.descriptors),
        np.asarray(f.valid), K_NP, jcfg.n_levels, L, seed=4,
    )
    assert scene["n_frame"] > 200
    lm_keys = ("lm_pos", "lm_desc", "lm_valid", "lm_max_dist", "lm_min_dist", "lm_normal")

    j_step = _jax_step(jcfg, jnp.asarray(K_NP), (float(W), float(H)))
    R_j, t_j, n_j = j_step(jnp.asarray(img), *(jnp.asarray(scene[k]) for k in lm_keys),
                           jnp.asarray(scene["R0"]), jnp.asarray(scene["t0"]))
    R_j, t_j, n_j = np.asarray(R_j), np.asarray(t_j), int(n_j)

    dev = "cpu"
    t_step = entry.make_track_step(convert.orb_config(jcfg), convert.camera(K_NP, dev),
                                   (W, H))
    lm = convert.local_map(*(scene[k] for k in lm_keys), device=dev)
    R0, t0 = convert.pose(scene["R0"], scene["t0"], device=dev)
    R_t, t_t, n_t = t_step(torch.from_numpy(img), *lm, R0, t0)
    R_t, t_t, n_t = R_t.numpy(), t_t.numpy(), int(n_t)

    assert abs(n_t - n_j) <= max(2, 0.01 * n_j), (n_t, n_j)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    np.testing.assert_allclose(t_t, t_j, atol=1e-3)
    # both recover the truth and match nearly every frame landmark
    for R, t, n in ((R_j, t_j, n_j), (R_t, t_t, n_t)):
        assert np.abs(R - scene["R_true"]).max() < 1e-3
        assert np.abs(t - scene["t_true"]).max() < 1e-3
        assert n >= 0.9 * scene["n_frame"], (n, scene["n_frame"])


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    n = 16
    fj = dict(xy=rng.uniform(0, 100, (n, 2)), response=rng.uniform(size=n),
              angle=rng.uniform(-3, 3, n), octave=rng.integers(0, 4, n),
              descriptors=rng.integers(0, 256, (n, 32)), valid=rng.uniform(size=n) > 0.5)
    ft = convert.features(**fj, device="cpu")
    assert isinstance(ft, torb.Features)
    assert (ft.xy.dtype, ft.octave.dtype, ft.descriptors.dtype, ft.valid.dtype) == (
        torch.float32, torch.int32, torch.uint8, torch.bool)
    np.testing.assert_array_equal(ft.descriptors.numpy(), fj["descriptors"])
    np.testing.assert_array_equal(ft.xy.numpy(), fj["xy"].astype(np.float32))
    cfg = convert.orb_config(jorb.OrbConfig(n_features=300, n_levels=5, cell=30))
    assert cfg == torb.OrbConfig(n_features=300, n_levels=5, cell=30)
    assert cfg.features_per_level() == jorb.OrbConfig(300, 5, cell=30).features_per_level()
    R, t = convert.pose(np.eye(3), np.arange(3.0), device="cpu")
    assert R.dtype == t.dtype == torch.float32 and t.tolist() == [0.0, 1.0, 2.0]
