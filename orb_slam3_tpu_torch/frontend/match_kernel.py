"""K1: projection-windowed descriptor search as one CUDA kernel.

Replaces the Pallas kernel `orb_slam3_tpu/frontend/match_kernel.py::_match_kernel`.
For each predicted landmark, over all frame keypoints: window gate
|dx|, |dy| <= r, octave gate, both valid flags, 256-bit Hamming distance,
best distance and its first argmin, second best without the argmin column,
and ok = best <= max_dist and best < ratio * second. No [N, M] array is
written to device memory (csrc/match_kernel.cu).

`search_by_projection_kernel` launches the kernel for CUDA tensors and runs
`search_by_projection_plain` for CPU tensors only. `launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

BIG = 100000
launches = 0


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


def _lib():
    from ..kernels import build

    lib = build.load("match_kernel")
    fn = lib.match_kernel_launch
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, F, F, I, I, I, P, P, P, P]
        fn.restype = I
    return fn


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
    if uv_pred.device.type == "cpu":
        return search_by_projection_plain(
            *args, max_dist=max_dist, ratio=ratio,
            level_lo=level_lo, level_hi=level_hi,
        )
    if uv_pred.device.type != "cuda":
        raise ValueError(f"search_by_projection_kernel: unsupported device {uv_pred.device}")
    from ..kernels.build import check_tensor

    dev = uv_pred.device
    n, m = uv_pred.shape[0], kp_xy.shape[0]
    f32, i32, u8, b = torch.float32, torch.int32, torch.uint8, torch.bool
    for name, t, dtype, shape in (
        ("uv_pred", uv_pred, f32, (n, 2)), ("pred_octave", pred_octave, i32, (n,)),
        ("pred_desc", pred_desc, u8, (n, 32)), ("pred_valid", pred_valid, b, (n,)),
        ("kp_xy", kp_xy, f32, (m, 2)), ("kp_octave", kp_octave, i32, (m,)),
        ("kp_desc", kp_desc, u8, (m, 32)), ("kp_valid", kp_valid, b, (m,)),
        ("radius", radius, f32, (n,)),
    ):
        check_tensor(name, t, dtype, shape, dev)
    for name, t in (("pred_desc", pred_desc), ("kp_desc", kp_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned (read as uint4)")

    idx = torch.empty(n, dtype=i32, device=dev)
    dist = torch.empty(n, dtype=i32, device=dev)
    ok = torch.empty(n, dtype=b, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(
        uv_pred.data_ptr(), radius.data_ptr(), pred_octave.data_ptr(),
        pred_valid.data_ptr(), pred_desc.data_ptr(),
        kp_xy.data_ptr(), kp_octave.data_ptr(), kp_valid.data_ptr(),
        kp_desc.data_ptr(), n, m, float(max_dist),
        0.0 if ratio is None else float(ratio), int(ratio is not None),
        int(level_lo), int(level_hi),
        idx.data_ptr(), dist.data_ptr(), ok.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"match_kernel launch failed with CUDA error {rc}")
    global launches
    launches += 1
    return idx, dist, ok
