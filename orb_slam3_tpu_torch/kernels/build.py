"""Build, load and feed the port's CUDA kernels.

Each `orb_slam3_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` into its own
shared library with a plain C interface, `build/torch_kernels/<name>-<hash>.so`
at the root of the checkout, and loaded with ctypes. The hash covers every
source under csrc/ and the flags, so an edit rebuilds. Nothing is built when
the package is imported: the first launch builds what it needs, and
`build_all()` builds every kernel at once, one nvcc process per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, the toolkit's default prefix, or PATH."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from orb_slam3_tpu_torch/csrc "
        "on a host with the CUDA toolkit (set CUDA_HOME)"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.log"


def build_all(names=None) -> float:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc per source, all started together. Returns the wall seconds.
    Raises with the compiler's output if any build fails."""
    names = [p.stem for p in sources()] if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for n in todo:
        src = CSRC / f"{n}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        tmp = BUILD_DIR / f"{lib_path(n).stem}.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        log_path(n).write_text(out)
        if p.returncode != 0:
            failed.append(f"{n} (nvcc exit {p.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def check_tensor(name, t, dtype, shape, device):
    """Raise unless `t` is what a kernel takes: on `device`, of `dtype` and
    `shape`, contiguous. The wrappers call this before passing pointers."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _LIBS:
        from .. import device

        device.init_cuda()
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
