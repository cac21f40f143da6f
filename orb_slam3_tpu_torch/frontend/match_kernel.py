"""K1: projection-windowed descriptor search as one CUDA kernel.

Replaces the Pallas kernel `orb_slam3_tpu/frontend/match_kernel.py::_match_kernel`.
For each predicted landmark, over all frame keypoints: window gate
|dx|, |dy| <= r, octave gate, both valid flags, 256-bit Hamming distance,
best distance and its first argmin, second best without the argmin column,
and ok = best <= max_dist and best < ratio * second. No [N, M] array is
written to device memory (csrc/match_kernel.cu).

`search_by_projection_kernel` launches the kernel for CUDA tensors and runs
`search_by_projection_plain` for CPU tensors only. `launches` counts kernel
launches, under a lock (the tracker and the background mapper launch from
two threads); `launches_by_thread` splits the count by the launching
thread's name (the mapper's thread is "mapper").
"""

from __future__ import annotations

import ctypes
import threading

import torch

BIG = 100000
launches = 0
launches_by_thread: dict = {}
_count_lock = threading.Lock()


def search_by_projection_plain(uv_pred, pred_octave, pred_desc, pred_valid,
                               kp_xy, kp_octave, kp_desc, kp_valid, radius,
                               *, max_dist, ratio, level_lo, level_hi):
    """The kernel's function in plain torch ops: window and octave masks,
    the Hamming matrix and the masked best match.
    Returns (idx int32 [N], dist int32 [N], ok bool [N])."""
    from . import matching

    m = matching.window_mask(uv_pred, kp_xy, radius, pred_valid, kp_valid)
    m = m & matching.octave_mask(pred_octave, kp_octave, level_lo, level_hi)
    dist = matching.hamming_matrix(pred_desc, kp_desc)
    idx, best, ok = matching.masked_best_match(dist, m, max_dist=max_dist, ratio=ratio)
    return idx.to(torch.int32), best, ok


_FN = None


def _lib():
    global _FN
    if _FN is None:
        from ..kernels import build

        fn = build.load("match_kernel").match_kernel_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, F, F, I, I, I, P, P, P, P]
        fn.restype = I
        _FN = fn
    return _FN


def search_by_projection_kernel(uv_pred, pred_octave, pred_desc, pred_valid,
                                kp_xy, kp_octave, kp_desc, kp_valid, radius,
                                *, max_dist, ratio, level_lo, level_hi):
    """Fused search_by_projection core; radius [N] is already octave-scaled.

    Takes uv_pred f32 [N,2], pred_octave i32 [N], pred_desc u8 [N,32],
    pred_valid bool [N], kp_xy f32 [M,2], kp_octave i32 [M], kp_desc u8
    [M,32], kp_valid bool [M], radius f32 [N]. Returns (idx i32, dist i32,
    ok bool), each [N]; a row where nothing passes gives (0, BIG, False)."""
    args = (uv_pred, pred_octave, pred_desc, pred_valid,
            kp_xy, kp_octave, kp_desc, kp_valid, radius)
    dev = uv_pred.device
    if dev.type == "cpu":
        return search_by_projection_plain(
            *args, max_dist=max_dist, ratio=ratio,
            level_lo=level_lo, level_hi=level_hi,
        )
    if dev.type != "cuda":
        raise ValueError(f"search_by_projection_kernel: unsupported device {dev}")
    from ..kernels.build import check_aligned, check_args, raw_stream

    n, m = uv_pred.shape[0], kp_xy.shape[0]
    f32, i32, u8, b = torch.float32, torch.int32, torch.uint8, torch.bool
    check_args(dev, (
        ("uv_pred", uv_pred, f32, (n, 2)), ("pred_octave", pred_octave, i32, (n,)),
        ("pred_desc", pred_desc, u8, (n, 32)), ("pred_valid", pred_valid, b, (n,)),
        ("kp_xy", kp_xy, f32, (m, 2)), ("kp_octave", kp_octave, i32, (m,)),
        ("kp_desc", kp_desc, u8, (m, 32)), ("kp_valid", kp_valid, b, (m,)),
        ("radius", radius, f32, (n,)),
    ))
    check_aligned("pred_desc", pred_desc)
    check_aligned("kp_desc", kp_desc)

    idx = torch.empty(n, dtype=i32, device=dev)
    dist = torch.empty(n, dtype=i32, device=dev)
    ok = torch.empty(n, dtype=b, device=dev)
    rc = _lib()(
        uv_pred.data_ptr(), radius.data_ptr(), pred_octave.data_ptr(),
        pred_valid.data_ptr(), pred_desc.data_ptr(),
        kp_xy.data_ptr(), kp_octave.data_ptr(), kp_valid.data_ptr(),
        kp_desc.data_ptr(), n, m, max_dist,
        0.0 if ratio is None else ratio, ratio is not None, level_lo, level_hi,
        idx.data_ptr(), dist.data_ptr(), ok.data_ptr(), raw_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"match_kernel launch failed with CUDA error {rc}")
    global launches
    with _count_lock:
        launches += 1
        who = threading.current_thread().name
        launches_by_thread[who] = launches_by_thread.get(who, 0) + 1
    return idx, dist, ok
