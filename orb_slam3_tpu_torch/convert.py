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
