"""Ground rules of the PyTorch port, checked on any host.

- Neither the package nor chip_smoke.py imports jax or orb_slam3_tpu.
- The package imports without triton or nvcc (kernels build at first use).
- Entry points default to CUDA and raise where there is none.
- The port's copy of the ORB pattern equals the JAX package's asset.
"""

import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import orb_slam3_tpu_torch
from orb_slam3_tpu_torch import entry as tentry
from orb_slam3_tpu_torch.frontend import camera as tcam

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


def test_orb_pattern_copy_equals_jax_asset():
    ours = np.load(PKG / "frontend" / "assets" / "orb_pattern.npy")
    ref = np.load(ROOT / "orb_slam3_tpu" / "frontend" / "assets" / "orb_pattern.npy")
    assert ours.dtype == ref.dtype and ours.shape == ref.shape == (256, 4)
    np.testing.assert_array_equal(ours, ref)
