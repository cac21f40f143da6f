"""Carry the JAX package's state across to the port.

Each function takes numpy arrays (or anything `np.asarray` reads, such as a
JAX array) as the JAX package holds them and returns tensors with the port's
dtypes on `device` (default CUDA). The JAX package runs with x64 off, so
every float becomes float32, every index int32, descriptors uint8 and flags
bool.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as device_mod
from .atlas import state as atlas_state
from .frontend import orb


def _f32(a, dev):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def _i32(a, dev):
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)


def _u8(a, dev):
    return torch.from_numpy(np.array(a, dtype=np.uint8)).to(dev)


def _bool(a, dev):
    return torch.from_numpy(np.array(a, dtype=bool)).to(dev)


def camera(K, device=None):
    """Camera vector K[8] -> float32 [8]."""
    K = np.asarray(K)
    if K.shape != (8,):
        raise ValueError(f"camera vector must have shape (8,), got {K.shape}")
    return _f32(K, device_mod.resolve(device))


def orb_config(cfg) -> orb.OrbConfig:
    """A JAX OrbConfig (any object with its fields) -> the port's OrbConfig."""
    return orb.OrbConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(orb.OrbConfig)})


def features(xy, response, angle, octave, descriptors, valid, device=None) -> orb.Features:
    """A Features set: xy [N,2], response [N], angle [N], octave [N],
    descriptors [N,32], valid [N]."""
    dev = device_mod.resolve(device)
    return orb.Features(
        xy=_f32(xy, dev), response=_f32(response, dev), angle=_f32(angle, dev),
        octave=_i32(octave, dev), descriptors=_u8(descriptors, dev),
        valid=_bool(valid, dev),
    )


def local_map(lm_pos, lm_desc, lm_valid, lm_max_dist, lm_min_dist, lm_normal,
              device=None):
    """A local-map snapshot -> (lm_pos f32 [L,3], lm_desc u8 [L,32],
    lm_valid bool [L], lm_max_dist f32 [L], lm_min_dist f32 [L],
    lm_normal f32 [L,3]), in the order track_step takes them."""
    dev = device_mod.resolve(device)
    return (
        _f32(lm_pos, dev), _u8(lm_desc, dev), _bool(lm_valid, dev),
        _f32(lm_max_dist, dev), _f32(lm_min_dist, dev), _f32(lm_normal, dev),
    )


def pose(R, t, device=None):
    """Pose R [3,3], t [3] -> float32 tensors."""
    dev = device_mod.resolve(device)
    return _f32(R, dev), _f32(t, dev)


def _port_array(a, dev):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return _bool(a, dev)
    if a.dtype == np.uint8:
        return _u8(a, dev)
    if np.issubdtype(a.dtype, np.integer):
        return _i32(a, dev)
    return _f32(a, dev)


def map_state(s, device=None) -> atlas_state.MapState:
    """A JAX MapState (any object with its fields, as arrays) -> the port's
    MapState: floats f32, indices and counters int32, descriptors uint8,
    flags bool."""
    dev = device_mod.resolve(device)
    return atlas_state.MapState(**{
        f.name: _port_array(getattr(s, f.name), dev)
        for f in dataclasses.fields(atlas_state.MapState)
    })


def tracker_config(cfg, device=None):
    """A JAX TrackerConfig -> the port's TrackerConfig: the fields the
    port reads; the cameras (K, and K_right of a fisheye rig), the rig's
    extrinsics R_rl / t_rl and the rad-tan dist_coeffs as float32 tensors
    on `device` (None stays None)."""
    from .tracking import tracker

    dev = device_mod.resolve(device)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tracker.TrackerConfig)}
    fields.update(K=camera(cfg.K, dev), orb=orb_config(cfg.orb), img_wh=tuple(cfg.img_wh))
    for name in ("R_rl", "t_rl", "dist_coeffs"):
        if fields[name] is not None:
            fields[name] = _f32(fields[name], dev)
    if cfg.K_right is not None:
        fields["K_right"] = camera(cfg.K_right, dev)
    return tracker.TrackerConfig(**fields)


def kf_package(pkg, device=None):
    """A JAX KFPackage -> the port's KFPackage (optional fields stay None;
    the inertial fields are not carried)."""
    from .mapping import pipeline

    dev = device_mod.resolve(device)
    opt = lambda a, conv: None if a is None else conv(a, dev)  # noqa: E731
    return pipeline.KFPackage(
        R=_f32(pkg.R, dev), t=_f32(pkg.t, dev), timestamp=float(pkg.timestamp),
        feat_xy=_f32(pkg.feat_xy, dev), feat_octave=_i32(pkg.feat_octave, dev),
        feat_angle=_f32(pkg.feat_angle, dev), feat_desc=_u8(pkg.feat_desc, dev),
        feat_valid=_bool(pkg.feat_valid, dev), feat_lm=opt(pkg.feat_lm, _i32),
        feat_ur=opt(pkg.feat_ur, _f32), feat_depth=opt(pkg.feat_depth, _f32),
        n_inliers=int(pkg.n_inliers), stat_vis=opt(pkg.stat_vis, _i32),
        stat_found=opt(pkg.stat_found, _i32),
    )


def map_state_arrays(s) -> dict:
    """The reverse: the port's MapState -> {field name: numpy array}, ready
    for the JAX MapState's constructor."""
    return {f.name: getattr(s, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(s)}


def vocabulary(voc, device=None):
    """A JAX Vocabulary (centers [n_total, 32], idf weights [n_words],
    branching, depth) -> the port's place.vocab.Vocabulary."""
    from .place import vocab

    dev = device_mod.resolve(device)
    return vocab.Vocabulary(centers=_u8(voc.centers, dev), weights=_f32(voc.weights, dev),
                            branching=int(voc.branching), depth=int(voc.depth))


def keyframe_db(db, device=None):
    """A JAX KeyframeDB (sparse BoW pairs per keyframe row) -> the port's
    place.recognition.KeyframeDB."""
    from .place import recognition

    dev = device_mod.resolve(device)
    return recognition.KeyframeDB(ids=_i32(db.ids, dev), vals=_f32(db.vals, dev),
                                  valid=_bool(db.valid, dev), n_words=int(db.n_words))


def preintegrated(p, device=None):
    """A JAX Preintegrated (one window or a stack) -> the port's, every
    field float32."""
    from .imu import preintegration

    dev = device_mod.resolve(device)
    return preintegration.Preintegrated(**{
        f.name: _f32(getattr(p, f.name), dev)
        for f in dataclasses.fields(preintegration.Preintegrated)})


def imu_state(imu, device=None):
    """A JAX tracker's ImuState -> the port's: the noise densities and
    extrinsics, biases and velocity (float32 tensors), the per-keyframe
    interval buffers, the open window and the last frame's measurements
    (numpy copies), and the stage flags and timestamps."""
    from .tracking import vi_tracker

    dev = device_mod.resolve(device)
    Tbc = np.eye(4, dtype=np.float32)
    Tbc[:3, :3], Tbc[:3, 3] = np.asarray(imu.Rbc), np.asarray(imu.tbc)
    out = vi_tracker.ImuState(imu.noise, Tbc, dev)
    out.bg, out.ba, out.vel = _f32(imu.bg, dev), _f32(imu.ba, dev), _f32(imu.vel, dev)
    out.kf_buffers = {int(r): tuple(np.array(x) for x in b) for r, b in imu.kf_buffers.items()}
    out._cur = tuple([np.array(x) for x in lst] for lst in imu._cur)
    out._frame_meas = (None if imu._frame_meas is None
                       else tuple(np.array(x) for x in imu._frame_meas))
    out._frame_window = None
    for name in ("initialized", "first_kf_ts", "init_ts", "viba_stage", "last_scale_refine_ts",
                 "tinit", "bad"):
        setattr(out, name, getattr(imu, name))
    return out
