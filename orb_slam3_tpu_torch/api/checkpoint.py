"""Atlas checkpoint save / load (port of orb_slam3_tpu/api/checkpoint.py).

`System::SaveAtlas` / `LoadAtlas` (`System.cc:1403-1546`): the MapState is
already checkpoint-shaped, so a checkpoint is one compressed npz of every
MapState field plus `__voc_checksum` (a sha256 of the vocabulary, the
reference's MD5-of-the-vocabulary-file guard, `System.cc:1508-1546`) and
the caller's `__extra_*` arrays. The files are the JAX package's: the
field names and dtypes are the same, and the checksum hashes the same
bytes (the uint8 centres, then the float32 weights, then
"branching:depth"), read in C order from CPU copies.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .. import device as device_mod
from ..atlas.state import MapState


def _host(t) -> np.ndarray:
    """A host numpy array of the same shape (0-dim counters stay 0-dim)."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def vocab_checksum(voc) -> str:
    """sha256 of the vocabulary's centres, weights, branching and depth, or
    "none" without one."""
    if voc is None:
        return "none"
    h = hashlib.sha256()
    # tobytes() reads in C order, whatever the layout of the copy
    h.update(_host(voc.centers).astype(np.uint8, copy=False).tobytes())
    h.update(_host(voc.weights).astype(np.float32, copy=False).tobytes())
    h.update(f"{voc.branching}:{voc.depth}".encode())
    return h.hexdigest()


def save_atlas(path: str, s: MapState, voc=None, extra: dict | None = None) -> None:
    """Write every MapState field (as host numpy), the vocabulary checksum
    and `extra` (each under "__extra_<key>") to one compressed npz."""
    arrays = {f.name: _host(getattr(s, f.name)) for f in dataclasses.fields(s)}
    arrays["__voc_checksum"] = np.frombuffer(vocab_checksum(voc).encode(), dtype=np.uint8)
    for k, v in (extra or {}).items():
        arrays[f"__extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, voc=None, check_vocab: bool = True,
               device=None) -> tuple[MapState, dict]:
    """Read a checkpoint onto `device` (default CUDA): (MapState, extra).
    Raises ValueError when the file was built with another vocabulary."""
    dev = device_mod.resolve(device)
    with np.load(path) as data:
        stored = bytes(data["__voc_checksum"]).decode()
        if check_vocab and stored != vocab_checksum(voc):
            raise ValueError(
                f"vocabulary checksum mismatch: atlas was built with {stored[:12]}..., "
                f"current vocabulary is {vocab_checksum(voc)[:12]}...")
        state = MapState(**{f.name: torch.from_numpy(np.array(data[f.name])).to(dev)
                            for f in dataclasses.fields(MapState)})
        extra = {k[len("__extra_"):]: data[k] for k in data.files if k.startswith("__extra_")}
    return state, extra
