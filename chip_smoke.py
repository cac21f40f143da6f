#!/usr/bin/env python3
"""Smoke test of the PyTorch port (orb_slam3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final `ok` line:
  1. the card's name and power limit (nvidia-smi); CUDA required; TF32 off;
  2. build both CUDA kernels from orb_slam3_tpu_torch/csrc (one nvcc each,
     started together) and print the build seconds and ptxas reports
     (registers, spills);
  3. K1 against its plain version at N=2048 landmarks x M=1000 keypoints,
     with planted matches, ties and empty windows (ok exact, idx/dist exact
     where ok), then the spatial binning's edge cases at the same shapes,
     exact everywhere: keypoints far outside the frame, windows on their
     edge, a radius larger than a grid cell, all keypoints in one cell, a
     tie whose lower index lies in a cell visited later, M=0, M=2100 (two
     tiles) and N=37;
  4. K2 against its plain version at N=2048 rows, mono and mixed stereo,
     B=1 and B=4, then N in {5, 256, 257, 2049, 9000} (cluster sizes 1, 2
     and 8, a ragged edge, rows past the shared-memory stage), B in {1, 4},
     mono and stereo: n and mask equal, R within 1e-5 and t within 1e-4;
     two calls on the same inputs give the same bits; prints the cluster
     size K2 launches with at N=2048;
  5. the tracking step at full width (752x480, 1000 features, 8 levels,
     L=2048) on a self-consistent scene: the launch counters are zeroed,
     the step runs once, both kernels must have launched, >= 90% of the
     frame landmarks are inliers and the true pose is recovered within
     1e-3; the same step on the CPU (plain versions) must recover it too;
     entry()'s own example arguments run and give finite results;
  6. timing of the full step, each kernel and each plain version at the
     main path's inputs (CUDA events, median of 50 runs after warm-up; the
     plain versions median of 5),
     each kernel's device time (torch.profiler, and CUDA events around 20
     calls queued behind a spin kernel, the fallback wherever the profiler
     sees no device time), its host enqueue time (host clock around the
     call, no sync, median) and the device time of an empty launch;
  7. the monocular bootstrap at full width (752x480, 1000 features, 8
     levels, kmax 128, lmax 8192, window 8) on the PlaneScene geometry
     rendered here: entry.bootstrap with the launch counters zeroed just
     before it, initialization within 10 frames with >= 100 landmarks, the
     initial BA lowering its cost, keyframe 1 within 0.5 deg / 3 deg of the
     truth, 8 tracked frames with >= 50 inliers and K1 and K2 launched on
     each, camera centres within 5% of the travelled path with one fitted
     scale (printed in the init's scale too); K1 == plain and
     K2 within R 1e-5 / t 1e-4 on a tracked frame's inputs (N = 8192) and K2
     at N = 1000; the card's features through the CPU plain path (same init
     frames, the first 2 tracked poses within 1e-3); whether the init
     repeats bit for bit; then
     the init's parts, track_frame, K1 / K2 at N = 8192, kernels per
     tracked frame and the device busy share.
  8. monocular SLAM with keyframes and local mapping at full width (the
     same config) on 40 PlaneScene frames along the orbit of
     tests/test_slam_mono.py: entry.slam (System.track_monocular) with the
     launch counters zeroed just before it, the gates of that test (state OK
     at the end, >= 70% of frames tracked, scale-fitted ATE < 0.35, n_kf >= 3,
     > 150 landmarks, >= 95% of bindings on valid landmarks, the Atlas
     invariants); K1 launched once per fuse target and equal to its plain
     version everywhere on the last fuse call's inputs, with no valid
     keypoint, and with 3% of all landmark rows added; the fuse inversion's
     conflicts equal on the card and the CPU; the last keyframe's mapping
     stack (map_stage_pre -> local BA -> map_stage_post) rerun on the card
     and on the CPU plain path from the same state (same keyframe row, BA
     window and n_fixed; landmarks within 1%, bindings >= 99% per row,
     keyframe poses within 1e-3); then per-frame track and extraction ms,
     the mapping parts per keyframe (the port's stage timer), K1 at the
     fuse shape and the device busy share over one keyframe; the fuse's new
     observations per keyframe.
  9. pinhole stereo, RGB-D and localization mode at full width (the same
     config with the depth fields; th_depth 20) through entry.slam
     (System.track_rgbd / track_stereo), each session with the launch
     counters zeroed just before it: RGB-D (PlaneScene seed 1, 25 frames,
     bf 450 x 0.1: >= 80% tracked, unscaled ATE < 0.10), stereo (seed 2, 20
     frames, baseline 0.12, bf 450 x 0.12: >= 80% tracked, ATE < 0.15) and
     localization (seed 6, RGB-D: 12 mapped frames, then 22 with mapping
     paused: state OK, n_kf unchanged, the last camera centre within 0.15),
     and the localization session again at th_depth 80 (12 + 10 frames, the
     same gates), where the VO points lie nearer than th_depth_m = 8 m and
     so are valid (>= 100 valid and >= 50 matched at every VO match);
     K2's stereo template launched on every tracked frame and equal to its
     plain version on a tracked stereo frame's inputs; in localization mode
     K1 at the VO points (N = 1000, exact) and K2 over map + VO rows
     (N = 9192) launched and equal to their plain versions on the th_depth
     80 session's last paused frame; one depth
     keyframe's mapping stack on the card equal to the CPU plain path (every
     binding, keyframe poses within 1e-4); then per session the frame and
     keyframe-frame ms split by stage (synchronised), launches per frame,
     the fuse's new observations per keyframe, match_stereo /
     depth_from_rgbd / extraction alone, and the device busy share over one
     depth keyframe.
 10. settings files at full width through entry.slam(settings_path=...)
     (System(settings_path, "stereo").track_stereo, TrackerConfig defaults),
     each session with the launch counters zeroed just before it: the KB8
     fisheye rig of tests/test_slam_fisheye.py (512x384, K8, 0.3 m
     baseline, 1000 features on 8 levels, PlaneScene seed 5, 10 frames
     rendered by the numpy KB8 renderer: >= 70% tracked, unscaled ATE <
     0.05) and the legacy EuRoC stereo file (LEFT./RIGHT. blocks, 752x480,
     raw images rendered through cam0's rad-tan distortion, 0.11 m
     baseline, seed 2, 20 frames: >= 80% tracked, ATE < 0.15); K1 at the
     right-camera call site launched on every tracked fisheye frame and
     equal to its plain version, K2 never launched for the KB8 camera;
     match_stereo_fisheye (good equal on >= 99% of rows, depth within 1e-4
     relative) and the KB8 pose_optimize_two_cam (R 1e-5 / t 1e-4) on the
     card against the CPU; one fisheye keyframe's mapping stack on the card
     against the CPU plain path; the StereoRectifier (1e-3) and the rad-tan
     keypoint path (>= 97% the same keypoints, 1e-3 px) on the card against
     the CPU; K1 and K2's stereo template on the rectified session's inputs
     against their plain versions; then per session the frame and
     keyframe-frame ms by stage, the plain KB8 pose BA's time and CUDA
     kernels per call, and K1's launches by call site.
 11. relocalization, loop closing and map merging at full width (752x480,
     1000 features, TrackerConfig defaults, RGB-D with th_depth 20 and bf
     450 x 0.1; each vocabulary trained in the run, branching 8, depth 3,
     on held-out views) through entry.slam(vocabulary=...)
     (System.track_rgbd), each session with the launch counters zeroed
     just before it; loop-full on the free-running schedule (the
     background mapper thread, pipeline depth 6), the other two on the
     synchronous one: reloc-full (tests/test_loop_reloc.py's blackout:
     PlaneScene seed 5, 14 frames, 3 blank, a resume at frame 6's view:
     lost after the blank frames, OK after the resume, camera centre within
     0.15, one map), loop-full (tests/test_loop_closing.py's closed loop:
     the numpy room scene, seed 3, 110 frames of 1.12 turns, kf_max_frames
     2: phase-1 keyframe ATE < 0.10, >= 1 loop, post-loop ATE < max(1.05 x
     pre, 0.05) and < 0.12, the last 10 frames tracked, the Atlas
     invariants; and tests/test_async_accuracy.py::test_async_loop_closing's
     >= 1 loop or merge and keyframe ATE < 0.20) and merge-full (tests/test_loop_reloc.py's multimap merge:
     seed 6, 24 frames, 7 blank, a resume over frames 40 -> 6: two maps
     after the blackout, >= 1 merge, one map id at the end); K1 launched at
     the merge site (merge_duplicates_at_keyframe) and equal to its plain
     version on the last merge call's inputs, that merge from the same
     state on the card and on the CPU plain path equal; K2 launched at the
     relocalization site and within R 1e-5 / t 1e-4 of its plain version
     on that call's inputs; then per session the frame and keyframe-frame
     ms, on_keyframe ms split into query and cascade, a correction's parts
     (landmark transport, essential graph, fuse window), each
     relocalization attempt's ms, and System.run_global_ba on the loop map.
 12. visual-inertial SLAM at 512x384 (K = (350, 350, 256, 192),
     OrbConfig(1000, 8), kmax 64, lmax 8192, window 6, kf_max_frames 3,
     frames at 10 fps with their 200 Hz IMU packets) through
     entry.slam(imu=...) (System.track_* with the packets), each session
     with the launch counters zeroed just before it: vi-mono-full
     (tests/test_slam_vi.py's session: PlaneScene seed 3, 160 frames;
     >= 60% tracked, the IMU initialized, VIBA1 reached, scale-fitted
     |s - 1| < 0.05, unscaled ATE < 0.5), vi-stereo-full and vi-rgbd-full
     (tests/test_slam_vi_depth.py's sessions: seeds 8 and 9, 36 frames,
     bf 350 x 0.12; no map before the excitation, >= 60% tracked, the IMU
     initialized and not bad, unscaled ATE < 0.25), the Atlas invariants;
     K1 and K2 launched on every tracked frame after the IMU init; K1 at
     the inertial tracking site (the window at the IMU's prediction) and
     at the last fuse_recent call equal to plain, K2 there (and its stereo
     template at the stereo-inertial site) within R 1e-5 / t 1e-4; the last
     keyframe's run_vi_local_ba and the last pose_inertial_optimize rerun
     on the card and the CPU from the same state (poses 1e-3 / 1e-4,
     velocities 1e-2 / 1e-3, biases 1e-3 / 1e-4); then per session the
     frame ms before and after the IMU init, the keyframe-frame ms,
     track.imu_predict / track.vi_refine / map.vi_local_ba ms, the IMU
     init and each refinement's ms, the pose-inertial call's CUDA kernels,
     one frame's preintegration alone, and one inertial keyframe's device
     busy share.
 13. the free-running default schedule at full width (TrackerConfig's
     defaults: the background mapper on its own thread and CUDA stream,
     pipeline depth 6) through entry.slam, each session with the launch
     counters zeroed just before it: async-mono-full (phase 8's 40 frames,
     run twice), async-rgbd-full (phase 9's RGB-D session), async-reloc-full
     (phase 11's blackout) and async-vi-full
     (tests/test_async_accuracy.py::test_async_vi_init_and_metric_scale's
     60-frame mono-inertial session at phase 12's config), with the gates
     of tests/test_async_accuracy.py (mono: OK, >= 70% tracked,
     scale-fitted ATE < 0.35, both runs; RGB-D: OK, >= 80% tracked,
     unscaled ATE < 0.10; blackout: not OK after the blank frames, OK after
     the resume; VI: IMU initialized, >= 60% tracked, |s - 1| < 0.2) and
     the Atlas invariants; every fuse call on the mapper thread's stream,
     K1 there equal to its plain version on the last fuse call's inputs,
     K2 within R 1e-5 / t 1e-4 of plain on a pipelined frame's inputs,
     every mapper thread stopped by System.shutdown; then per cell the
     frame ms with the mapper busy and idle, keyframe-request frames, the
     mapper's per-package stages, its packages, BAs, skipped BAs and
     longest queue, the frames in flight, and the device busy share over 5
     frames tracked while a package is mapped.
 14. persistence and I/O at full width, each path with the launch counters
     zeroed just before it: phase 8's 40 PlaneScene frames written as a
     EuRoC ASL folder with the port's PNG codec and run through the EuRoC
     driver (orb_slam3_tpu_torch.drivers.run_euroc: datasets ->
     FrameLoader -> System(settings_path) on the free-running schedule ->
     the trajectory and save_atlas) with tests/test_slam_mono.py's gates;
     the frames per second, the loader's decoder and save_atlas's bytes and
     ms; then tests/test_loop_reloc.py's resume at full width (RGB-D, th_depth
     20, bf 450 x 0.1, kf_max_frames 2, a vocabulary trained in the run):
     session 1 maps 20 frames (>= 8 keyframes) and saves its Atlas,
     System(atlas_path=...) loads it (equal to the saved map, a database of
     >= 8 keyframes) and tracks the same region until its map merges into
     the loaded one (one map id at the end), while the live viewer serves
     every endpoint to a client thread (PNG signatures, the stats, the
     localization command); save_map_3d and the PLY (one vertex per landmark
     and keyframe); K1 and K2's launches on both paths.
 15. the parallel layers and batched extraction: the landmark-sharded
     global BA over an NCCL world of one on the resumed map against
     GlobalBARunner (poses within 5e-3, points within 2e-2; buckets of 1
     against global_ba bit for bit, printed); the fleet step at B = 8 at
     full width (track-full's scene from 8 perturbed start poses, L = 2048
     each) with the launch counters zeroed just before it: K1 launched 8
     times and K2 once, each session's (R, t, n) equal to its own step (R
     1e-5, t 1e-4, n equal), K2 at B = 8 against its plain version; the
     fleet step's ms against 8 sequential steps, K2's ms, device ms, plain
     ms and bound at B = 8; extract_batched against extract at full width
     (every valid keypoint equal) with the ms and CUDA kernels of both.
 16. the reference's operating regime at full width (752x480, 1000
     features on 8 levels, RGB-D, th_depth 20), each session with the launch
     counters zeroed just before it: scale-full
     (tests/test_reference_scale.py's session: the room ray-cast on the
     card, seed 21, 420 frames of 2.3 turns at 0.1 s, frames 180-186 blank,
     bf 45, kmax 64, lmax 8192, window 6, kf_max_frames 2, the deterministic
     schedule, a vocabulary trained in the run on 4 held-out views: >= 2
     maps, >= 1 merge, one map id at the end, >= 100 keyframes, kmax > 64,
     unscaled keyframe ATE < 0.30, the median of the last 100 frame times <
     4 x the median of frames 40-140 + 0.05 s, the Atlas invariants) and
     churn-full (tests/test_compaction.py's churn: PlaneScene seed 11, 60
     frames, bf 35, kmax 16, lmax 2048, window 5, a keyframe every frame,
     synchronous: >= 80% tracked, unscaled ATE < 0.15, the invariants, n_kf
     < 60); the frames at which the arena compacted and grew, the Atlas
     gained a map, a loop closed and the maps merged; K1 at the largest N of
     its tracking, fuse and merge sites exactly equal to its plain version,
     K2's stereo template at the call with the most valid rows within R 1e-5
     / t 1e-4; System.run_global_ba on the unified map; the per-frame
     medians, the stages, each essential-graph solve and the kernels'
     times at those shapes.
Phases 6-16 print one JSON line with each kernel's bound and launches by
path and call site; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import faulthandler
import json
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet) used for the bounds: HBM3
# bandwidth, and the float32 rate outside the tensor cores, the only
# non-tensor rate in that table, applied to every scalar op (f32, integer
# and compare alike).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

FULL_W, FULL_H, FULL_L = 752, 480, 2048

# the synchronous schedule phases 7-12 measure (mapping on the frame that
# inserts the keyframe, each frame's outcome consumed on that frame); the
# port's default is the background mapper at pipeline depth 6 (phase 13)
SYNC = dict(async_mapping=False, pipeline_depth=1)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, runs=50, warmup=5):
    """Median milliseconds of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, runs=50, warmup=5):
    """Median host milliseconds to enqueue one call: host clock around the
    call, no synchronisation in between."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def events_device_ms(fn, runs=20):
    """Device milliseconds per call from CUDA events alone: a spin kernel
    holds the stream until all `runs` calls are enqueued behind it, so the
    calls run back to back on the device and the host's enqueue time drops
    out (the gaps between launches stay in)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's boost clock
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def device_kernel_ms(fn, name, runs=20):
    """(ms, how): the mean device time per call of the kernel whose name
    contains `name` (one launch per call), from torch.profiler
    ("profiler"); where three profiler windows hold fewer than `runs` of
    its device events, the device time of the whole call from CUDA events
    instead ("events", see events_device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):  # the profiler's trace now and then lacks device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if name in ev.key
               and (getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0))]
        us = sum((getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0))
                 for ev in evs)
        n = sum(ev.count for ev in evs)
        if n >= runs:
            return us / 1000.0 / n, "profiler"
        print(f"[timing] profiler window {attempt + 1} saw {n} of {runs} device events "
              f"of {name}")
    ms = events_device_ms(fn, runs)
    print(f"[timing] {name}: device time from CUDA events instead: {ms:.5f} ms per call")
    return ms, "events"


def device_busy(prof):
    """(busy ms, CUDA kernels, [(us, count, name)]) from a profiler window;
    busy ms is None where the window holds no device event."""
    from torch.autograd import DeviceType

    busy_us, n_kernels, by_name = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy_us += ev.self_device_time_total
            n_kernels += ev.count
            by_name.append((ev.self_device_time_total, ev.count, ev.key))
    if n_kernels == 0:
        print("[timing] the profiler saw no device event: device busy share not measured")
        return None, 0, []
    return busy_us / 1000.0, n_kernels, by_name


def pct(share):
    return "not measured" if share is None else f"{100 * share:.1f}%"


# ---------------------------------------------------------------- phase 3
def k1_case(dev, seed=0, N=2048, M=1000):
    """Landmarks vs keypoints with planted matches, ties and empty windows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    uv = rng.uniform(0, [FULL_W, FULL_H], (N, 2)).astype(np.float32)
    kp = rng.uniform(0, [FULL_W, FULL_H], (M, 2)).astype(np.float32)
    pd = rng.integers(0, 256, (N, 32)).astype(np.uint8)
    kd = rng.integers(0, 256, (M, 32)).astype(np.uint8)
    po = rng.integers(0, 8, N).astype(np.int32)
    ko = rng.integers(0, 8, M).astype(np.int32)
    # planted matches: keypoint j sits near landmark j with its descriptor
    # up to a few flipped bits
    P = 700
    kp[:P] = uv[:P] + rng.uniform(-4, 4, (P, 2)).astype(np.float32)
    kd[:P] = pd[:P] ^ (rng.uniform(size=(P, 32)) < 0.02).astype(np.uint8)
    ko[:P] = np.clip(po[:P] + rng.integers(-1, 2, P), 0, 7)
    # ties: keypoints P..P+49 duplicate keypoints 0..49
    kp[P:P + 50], kd[P:P + 50], ko[P:P + 50] = kp[:50], kd[:50], ko[:50]
    pv = rng.uniform(size=N) > 0.05
    kv = rng.uniform(size=M) > 0.05
    pv[:50] = kv[:50] = kv[P:P + 50] = True
    # empty windows: landmarks far outside the frame
    uv[1500:1600] += 10000.0
    radius = (15.0 * 1.2 ** np.clip(po, 0, 7)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(uv), t(po), t(pd), t(pv), t(kp), t(ko), t(kd), t(kv), t(radius))


def compare_k1(got, ref):
    idx_g, d_g, ok_g = (x.cpu() for x in got)
    idx_r, d_r, ok_r = (x.cpu() for x in ref)
    check(bool((ok_g == ok_r).all()), f"K1: ok differs in {(ok_g != ok_r).sum()} rows")
    check(bool((idx_g[ok_r] == idx_r[ok_r]).all()), "K1: idx differs where ok")
    check(bool((d_g[ok_r] == d_r[ok_r]).all()), "K1: dist differs where ok")
    err = max(
        (idx_g[ok_r] - idx_r[ok_r]).abs().max().item() if ok_r.any() else 0,
        (d_g[ok_r] - d_r[ok_r]).abs().max().item() if ok_r.any() else 0,
    )
    return float(err), int(ok_r.sum())


def phase_k1(dev):
    from orb_slam3_tpu_torch.frontend import match_kernel as mk

    args = k1_case(dev)
    kw = dict(max_dist=100, ratio=0.8, level_lo=-1, level_hi=1)
    got = mk.search_by_projection_kernel(*args, **kw)
    ref = mk.search_by_projection_plain(*args, **kw)
    import torch

    torch.cuda.synchronize()
    err, n_ok = compare_k1(got, ref)
    check(n_ok > 400, f"K1: only {n_ok} planted matches accepted")
    ok = got[2].cpu()
    check(not ok[:50].any(), "K1: tied rows must be rejected")
    check(bool((got[0][1500:1600] == 0).all()) and not ok[1500:1600].any(),
          "K1: empty rows must give idx 0, not ok")
    print(f"[k1] N=2048 M=1000: ok rows {n_ok}, kernel == plain")

    for name, a, kw_e in k1_edge_cases(dev):
        got = mk.search_by_projection_kernel(*a, **kw_e)
        torch.cuda.synchronize()
        got = [x.cpu() for x in got]
        if a[4].shape[0] == 0:  # M = 0: the plain version has no column to argmin
            check(bool((got[0] == 0).all() and (got[1] == mk.BIG).all()) and not got[2].any(),
                  "K1 M=0: every row must be empty")
            print(f"[k1] edge case {name} (N={a[0].shape[0]}, M=0): every row empty")
            continue
        ref = mk.search_by_projection_plain(*a, **kw_e)
        for g, r, what in zip(got, ref, ("idx", "dist", "ok")):
            check(torch.equal(g, r.cpu()), f"K1 {name}: {what} differs in "
                  f"{int((g != r.cpu()).sum())} rows")
        if name == "tie_in_later_cell":
            check((int(got[0][0]), int(got[1][0]), bool(got[2][0])) == (2, 0, True),
                  f"K1 tie: got idx {int(got[0][0])}, want the lower index 2")
        print(f"[k1] edge case {name} (N={a[0].shape[0]}, M={a[4].shape[0]}): "
              f"ok rows {int(got[2].sum())}, kernel == plain everywhere")
    return err


def k1_edge_cases(dev, N=2048, M=1000):
    """(name, args, kwargs) of the binning's edge cases at the main path's
    shapes, from k1_case's planted matches."""
    import numpy as np
    import torch

    kw = dict(max_dist=100, ratio=0.8, level_lo=-1, level_hi=1)
    t = lambda arrs: [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs]
    fresh = lambda seed=5, m=M: [x.cpu().numpy().copy() for x in k1_case("cpu", seed, N, m)]
    rng = np.random.default_rng(6)
    out = []

    uv, po, pd, pv, kp, ko, kd, kv, radius = a = fresh()
    kp[-40:] = rng.uniform(-1e5, 1e5, (40, 2))  # far outside the frame
    uv[1700], pd[1700], po[1700], pv[1700] = kp[M - 3], kd[M - 3], ko[M - 3], True
    kv[M - 3] = True
    out.append(("far_keypoints", t(a), kw))

    uv, po, pd, pv, kp, ko, kd, kv, radius = a = fresh()
    r = radius[:300, None]
    sign = np.where(rng.uniform(size=(300, 2)) < 0.5, -1.0, 1.0).astype(np.float32)
    edge = uv[:300] + sign * r  # on the window's edge, |d| == r where f32 allows
    kp[:300] = np.where(np.abs(edge - uv[:300]) <= r, edge, kp[:300])
    out.append(("border_windows", t(a), kw))

    a = fresh()
    a[8][:] = 400.0  # radius far larger than a grid cell
    out.append(("large_radius", t(a), kw))

    uv, po, pd, pv, kp, ko, kd, kv, radius = a = fresh()
    kp[:] = np.float32(376.0) + rng.uniform(0, 1e-3, (M, 2)).astype(np.float32)
    uv[:100] = 376.0
    out.append(("one_cell", t(a), kw))

    uv, po, pd, pv, kp, ko, kd, kv, radius = a = fresh()
    # keypoints 2 and 9 carry landmark 0's descriptor; 2, the lower index,
    # sits lower in the image, in a grid row visited after 9's
    uv[0], radius[0], pv[0] = (376.0, 240.0), 40.0, True
    kp[0] = (5.0, 5.0)
    kd[[2, 9]], ko[[2, 9]], kv[[2, 9]] = pd[0], po[0], True
    kp[2], kp[9] = (376.0, 270.0), (376.0, 210.0)
    out.append(("tie_in_later_cell", t(a), dict(kw, ratio=None)))

    a = fresh()
    for i in (4, 5, 6, 7):
        a[i] = a[i][:0]
    out.append(("no_keypoints", t(a), kw))

    out.append(("two_tiles", t(fresh(seed=7, m=2100)), kw))

    a = fresh()
    for i in (0, 1, 2, 3, 8):  # 37 landmarks with planted matches, past the tied rows
        a[i] = a[i][600:637]
    out.append(("37_landmarks", t(a), kw))
    return out


# ---------------------------------------------------------------- phase 4
def k2_case(dev, B, stereo, seed, N=2048):
    import numpy as np
    import torch

    from orb_slam3_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, bf = 450.0, 450.0, 376.0, 240.0, 45.0
    Xw = np.concatenate([rng.uniform(-3, 3, (B, N, 2)), rng.uniform(4, 9, (B, N, 1))], 2)
    xi = torch.from_numpy(rng.normal(size=(B, 6)) * 0.05)
    Rt, tt = lie.se3_exp(xi)
    Xc = (Rt[:, None] @ torch.from_numpy(Xw)[..., None])[..., 0] + tt[:, None]
    Xc = Xc.numpy()
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fy * Xc[..., 1] / Xc[..., 2] + cy], -1)
    uv += rng.normal(size=uv.shape) * 0.5
    n_out = N // 10
    uv[:, :n_out] += rng.uniform(20, 60, (B, n_out, 2))
    octv = rng.integers(0, 8, (B, N))
    isig = 1.0 / (1.2 ** octv) ** 2
    valid = rng.uniform(size=(B, N)) > 0.05
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    K = f(np.tile([fx, fy, cx, cy], (B, 1)))
    args = [K, f(np.tile(np.eye(3), (B, 1, 1))), f(np.zeros((B, 3))), f(uv), f(Xw),
            f(isig), torch.from_numpy(valid).to(dev)]
    kw = {}
    if stereo:
        ur = uv[..., 0] - bf / Xc[..., 2] + rng.normal(size=(B, N)) * 0.5
        ur = np.where(rng.uniform(size=(B, N)) < 0.5, ur, -1.0)
        kw = dict(ur=f(ur), bf=f(np.full(B, bf)))
    return args, kw


def compare_k2(got, ref, what):
    R_g, t_g, m_g, n_g = (x.cpu() for x in got)
    R_r, t_r, m_r, n_r = (x.cpu() for x in ref)
    check(bool((n_g == n_r).all()), f"K2 {what}: n {n_g.tolist()} vs {n_r.tolist()}")
    check(bool((m_g == m_r).all()), f"K2 {what}: masks differ in {(m_g != m_r).sum()} rows")
    eR = (R_g - R_r).abs().max().item()
    et = (t_g - t_r).abs().max().item()
    # block reductions sum the rows in another order than torch.sum: R to
    # 1e-5 and t to 1e-4 (a few f32 ulps of the 6x6 solve, amplified by
    # the GN iterations)
    check(eR <= 1e-5 and et <= 1e-4, f"K2 {what}: |dR| {eR:.3g} |dt| {et:.3g}")
    return max(eR, et)


def phase_k2(dev):
    import torch

    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    err = 0.0
    print(f"[k2] cluster size at N=2048: {pk.cluster_size(2048)} CTAs per problem")
    for N in (2048, 5, 256, 257, 2049, 9000):
        for B in (1, 4):
            for stereo in (False, True):
                args, kw = k2_case(dev, B, stereo, seed=10 * B + stereo + N, N=N)
                got = pk.pose_ba(*args, **kw)
                ref = pk.pose_ba_plain(*args, **kw)
                torch.cuda.synchronize()
                what = f"B={B} N={N} {'stereo' if stereo else 'mono'}"
                e = compare_k2(got, ref, what)
                err = max(err, e)
                again = pk.pose_ba(*args, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"K2 {what}: two calls differ")
                print(f"[k2] {what} (cluster {pk.cluster_size(N)}): n={got[3].tolist()} "
                      f"max |err| {e:.3g}, bitwise equal across two calls")
    return err


# ---------------------------------------------------------------- phase 5
def full_scene(dev):
    import numpy as np
    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import orb

    cfg = orb.OrbConfig(n_features=1000, n_levels=8)
    K = cam.make_pinhole(450.0, 450.0, 376.0, 240.0, device=dev)
    img_np = entry.blob_frame(FULL_H, FULL_W, seed=1)
    img = torch.from_numpy(img_np).to(dev)
    f = orb.extract(img, cfg)
    sc = entry.make_scene(f.xy.cpu().numpy(), f.octave.cpu().numpy(),
                          f.descriptors.cpu().numpy(), f.valid.cpu().numpy(),
                          K.cpu().numpy(), cfg.n_levels, FULL_L, seed=2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    keys = ("lm_pos", "lm_desc", "lm_valid", "lm_max_dist", "lm_min_dist",
            "lm_normal", "R0", "t0")
    args = (img,) + tuple(t(sc[k]) for k in keys)
    return cfg, K, args, sc


def phase_slice(dev):
    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    cfg, K, args, sc = full_scene(dev)
    step = entry.make_track_step(cfg, K, (FULL_W, FULL_H))
    step(*args)  # first call: builds nothing new, warms the allocator
    torch.cuda.synchronize()

    # record each kernel's main-path inputs for the comparisons and timings
    rec = {}
    k1_orig, k2_orig = mk.search_by_projection_kernel, pk.pose_ba

    def k1_rec(*a, **kw):
        rec["k1"] = (a, kw)
        return k1_orig(*a, **kw)

    def k2_rec(*a, **kw):
        rec["k2"] = (a, kw)
        return k2_orig(*a, **kw)

    mk.search_by_projection_kernel, pk.pose_ba = k1_rec, k2_rec
    try:
        mk.launches = 0
        pk.launches = 0
        R, t, n = step(*args)
        torch.cuda.synchronize()
        launches = {"K1": mk.launches, "K2": pk.launches}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba = k1_orig, k2_orig
    print(f"[slice] launches in one step: {launches}")
    check(launches["K1"] >= 1 and launches["K2"] >= 1,
          f"main path skipped a kernel: {launches}")

    n = int(n)
    eR = (R.cpu() - torch.from_numpy(sc["R_true"])).abs().max().item()
    et = (t.cpu() - torch.from_numpy(sc["t_true"])).abs().max().item()
    print(f"[slice] 752x480 L={FULL_L}: frame landmarks {sc['n_frame']}, "
          f"inliers {n}, |R-R*| {eR:.3g}, |t-t*| {et:.3g}")
    check(bool(torch.isfinite(R).all() and torch.isfinite(t).all()), "non-finite pose")
    check(n >= 0.9 * sc["n_frame"], f"only {n} of {sc['n_frame']} frame landmarks are inliers")
    check(eR < 1e-3 and et < 1e-3, "true pose not recovered")

    # the same step on the CPU through the plain versions: its extraction
    # rounds the pyramid and moments differently, so a few keypoints or
    # descriptor bits differ; both must still recover the truth
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import orb

    f_card = orb.extract(args[0], cfg)
    f_cpu = orb.extract(args[0].cpu(), cfg)
    same_kp = ((f_card.xy.cpu() == f_cpu.xy).all(1) & (f_card.octave.cpu() == f_cpu.octave)
               & f_cpu.valid)
    same_desc = same_kp & (f_card.descriptors.cpu() == f_cpu.descriptors).all(1)
    print(f"[slice] card vs CPU extraction: {int(same_kp.sum())} of {int(f_cpu.valid.sum())} "
          f"keypoints identical, {int(same_desc.sum())} with identical descriptors")
    K_cpu = cam.make_pinhole(450.0, 450.0, 376.0, 240.0, device="cpu")
    step_cpu = entry.make_track_step(cfg, K_cpu, (FULL_W, FULL_H))
    Rc, tc, nc = step_cpu(*(a.cpu() for a in args))
    nc = int(nc)
    eRc = (Rc - torch.from_numpy(sc["R_true"])).abs().max().item()
    etc = (tc - torch.from_numpy(sc["t_true"])).abs().max().item()
    print(f"[slice] CPU plain step: inliers {nc}, |R-R*| {eRc:.3g}, |t-t*| {etc:.3g}")
    check(nc >= 0.9 * sc["n_frame"] and eRc < 1e-3 and etc < 1e-3,
          "the CPU plain step does not recover the truth")

    # entry() with its own example arguments (random landmarks)
    e_step, e_args = entry.entry()
    Re, te, ne = e_step(*e_args)
    torch.cuda.synchronize()
    check(tuple(Re.shape) == (3, 3) and tuple(te.shape) == (3,), "entry(): bad shapes")
    check(bool(torch.isfinite(Re).all() and torch.isfinite(te).all()), "entry(): non-finite")
    print(f"[slice] entry() example args: n={int(ne)}")
    return step, args, rec, launches, (cfg, K)


def stage_breakdown(step, args, cfg, K):
    """Median ms of the step's three stages alone, and over whole steps the
    device busy share and CUDA kernels per step from torch.profiler."""
    import torch

    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.tracking import track

    img, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind, lm_normal, R0, t0 = args
    sf = cfg.scale_factors(K.device)
    f = orb.extract(img, cfg)

    def match():
        return track.match_local_map(
            cam.PINHOLE, K, R0, t0, lm_pos, lm_desc, lm_valid, lm_maxd, lm_mind,
            lm_normal, f.xy, f.descriptors, f.octave, f.valid, 15.0, sf,
            img_wh=(float(FULL_W), float(FULL_H)))

    idx, ok = match()[:2]
    idx = idx.long()
    inv = 1.0 / (sf[torch.clamp(f.octave[idx], 0, cfg.n_levels - 1).long()] ** 2)
    uv = f.xy[idx].contiguous()
    out = {
        "extract_ms": time_ms(lambda: orb.extract(img, cfg)),
        "match_ms": time_ms(match),
        "pose_ms": time_ms(lambda: track.pose_optimize(
            cam.PINHOLE, K, R0, t0, uv, lm_pos, inv, ok)),
    }
    from torch.profiler import ProfilerActivity, profile

    runs = 10
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(runs):
            step(*args)
        b.record()
        torch.cuda.synchronize()
    busy, n_kernels, _ = device_busy(prof)
    out["device_busy_share"] = None if busy is None else busy / a.elapsed_time(b)
    out["kernels_per_step"] = n_kernels / runs
    return out


# ---------------------------------------------------------------- phase 6
def k1_bound(a):
    from orb_slam3_tpu_torch.frontend import matching

    uv, po, pd, pv, kp, ko, kd, kv, radius = a
    N, M = uv.shape[0], kp.shape[0]
    nbytes = N * (8 + 4 + 32 + 1 + 4) + M * (8 + 4 + 32 + 1) + N * (4 + 4 + 1)
    window = matching.window_mask(uv, kp, radius, pv, kv)
    gated = window & matching.octave_mask(po, ko, -1, 1)
    # what these inputs need: binning the keypoints once (~12 ops each: two
    # cell coordinates, a count, a prefix sum and a scatter), then a gate
    # test only for the keypoints inside each window, as a perfect spatial
    # index gives them: 2 x (sub, abs, compare) + 2 octave compares + valid
    # = 9; per gated-in pair: 8 XOR + 8 popc + 8 adds + 3 for the
    # best/second update = 27
    ops = M * 12 + int(window.sum()) * 9 + int(gated.sum()) * 27
    return nbytes, ops


def k2_bound(a, kw, rounds=3, iters=6):
    K, R0, t0, uv, Xw, isig, valid = a
    B, N = uv.shape[0], uv.shape[1]
    ur = kw.get("ur")
    n_valid = int(valid.sum())
    # rows with a third (uR) residual: the valid rows with ur >= 0
    n_stereo = int((valid & (ur >= 0)).sum()) if ur is not None else 0
    # the valid mask is read for every row; a valid row's uv, Xw, isig (and
    # ur) once; R, t, n and the mask written once per problem / row
    nbytes = B * N + n_valid * (8 + 12 + 4 + (4 if ur is not None else 0))
    nbytes += B * (16 + 36 + 12 + (4 if ur is not None else 0))  # K's four, R0, t0, bf
    nbytes += B * (36 + 12 + 4) + B * N  # R, t, n, mask
    # what the function needs: one sweep over the valid rows per
    # Gauss-Newton iteration plus one per round, 21 at rounds=3, iters=6
    # (each trial pose's sweep gives both its cost and the next normal
    # equations; the reclassification is folded into the next round's
    # first sweep). A sweep is ~200 ops a mono row: chi2 31, weights 10,
    # Jacobians 23, 21 + 6 weighted products and sums ~135. The uR row adds
    # ~85: its residual and chi2 term ~10, its Jacobian row ~8 and its
    # 21 + 6 weighted products and sums ~67.
    sweeps = rounds * (1 + iters)
    return nbytes, sweeps * (n_valid * 200 + n_stereo * 85)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(step, args, rec, launches, errs, gpu, cfg_K):
    import torch

    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    a1, kw1 = rec["k1"]
    a2, kw2 = rec["k2"]
    # each kernel against its plain version on the main path's inputs
    errs["K1"] = max(errs["K1"], compare_k1(mk.search_by_projection_kernel(*a1, **kw1),
                                            mk.search_by_projection_plain(*a1, **kw1))[0])
    errs["K2"] = max(errs["K2"], compare_k2(pk.pose_ba(*a2, **kw2),
                                            pk.pose_ba_plain(*a2, **kw2), "main path"))

    step_ms = time_ms(lambda: step(*args))
    dev = a2[0].device
    floor_ms, floor_by = device_kernel_ms(lambda: pk.noop_launch(dev), "noop_kernel")
    floor_ev = events_device_ms(lambda: pk.noop_launch(dev))
    print(f"[timing] launch floor (device time of an empty kernel, {floor_by}): {floor_ms:.5f} ms"
          f"; by CUDA events behind a spin kernel (the profiler's fallback): {floor_ev:.5f} ms")
    rows = []
    specs = (
        ("K1", "orb_slam3_tpu_torch/csrc/match_kernel.cu",
         "orb_slam3_tpu/frontend/match_kernel.py:31",
         lambda: mk.search_by_projection_kernel(*a1, **kw1),
         lambda: mk.search_by_projection_plain(*a1, **kw1), k1_bound(a1), "match_kernel"),
        ("K2", "orb_slam3_tpu_torch/csrc/pose_kernel.cu",
         "orb_slam3_tpu/tracking/pose_kernel.py:96",
         lambda: pk.pose_ba(*a2, **kw2),
         lambda: pk.pose_ba_plain(*a2, **kw2), k2_bound(a2, kw2), "pose_kernel"),
    )
    for name, src, repl, fn, plain, (nbytes, ops), kname in specs:
        ms = time_ms(fn)
        enqueue_ms = host_ms(fn)
        # the plain versions' time is context, not a gate: 5 runs (50
        # until phase 12 came; K2's plain run is ~150 ms)
        plain_ms = time_ms(plain, runs=5, warmup=1)
        b_ms, b_by = bound_ms(nbytes, ops)
        dev_ms, dev_by = device_kernel_ms(fn, kname)
        dev_ev = events_device_ms(fn)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name], "max_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_ms": dev_ms, "device_ms_by": dev_by,
            "device_events_ms": dev_ev, "host_ms": enqueue_ms,
            "launch_floor_ms": floor_ms, "bytes": nbytes, "ops": ops,
        })
        print(f"[timing] {name}: {ms:.4f} ms per call (device {dev_ms:.5f} by {dev_by}, "
              f"{dev_ev:.5f} by events, host enqueue "
              f"{enqueue_ms:.5f}), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    rows[1]["cluster"] = pk.cluster_size(a2[3].shape[1])
    stages = stage_breakdown(step, args, *cfg_K)
    print(f"[timing] full step {step_ms:.3f} ms; stages {stages}")
    return {"kernels": rows, "step_ms": step_ms, "stages": stages, "gpu": gpu}


# ---------------------------------------------------------------- phase 7
BOOT_FRAMES = 18  # init within the first 10 frames, then 8 tracked frames
CPU_TRACK = 2     # frames the CPU plain path tracks after its init


class PartTimer:
    """Context manager factory for initialize_monocular / track_sequence's
    `timer`: host milliseconds per part name, with a device synchronise on
    both sides, and the kernels' launch counts per part entry."""

    def __init__(self):
        self.ms = {}
        self.launches = []  # (name, K1 launches, K2 launches) per entry

    def __call__(self, name):
        import contextlib

        import torch

        from orb_slam3_tpu_torch.frontend import match_kernel as mk
        from orb_slam3_tpu_torch.tracking import pose_kernel as pk

        @contextlib.contextmanager
        def part():
            torch.cuda.synchronize()
            k1, k2 = mk.launches, pk.launches
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            self.launches.append((name, mk.launches - k1, pk.launches - k2))

        return part()


def _rot_deg(R):
    import numpy as np

    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0))))


def _cpu_feats(f):
    import dataclasses

    return dataclasses.replace(f, **{k.name: getattr(f, k.name).cpu()
                                     for k in dataclasses.fields(f)})


def check_bootstrap(out, cfg, R_gt, t_gt, planes, what, n_track=8):
    """The bootstrap's gates: init within 10 frames with >= 100 landmarks,
    the BA lowered its cost, keyframe 1 against the truth (rotation 0.5 deg,
    translation direction 3 deg), >= 50 inliers on each of the n_track
    tracked frames, camera centres within 5% of the travelled path in the
    init's scale. Returns a summary dict."""
    import numpy as np

    res = out["init"]
    check(res is not None and res.success, f"{what}: no initialization within 10 frames")
    s = res.map
    j = int(round(float(s.kf_timestamp[res.kf0])))  # the reference frame's index
    i = out["init_frame"]
    n_lm = int(s.lm_valid.sum())
    st = res.ba_stats
    cost0, cost, acc = float(st.cost0), float(st.cost), int(st.accepted)
    print(f"[boot] {what}: init on frames {j} -> {i} ({'H' if res.used_h else 'F'}), "
          f"{res.n_matches} matches, {n_lm} landmarks; init BA cost {cost0:.6g} -> {cost:.6g}, "
          f"{acc} of 20 iterations accepted")
    failed = []

    def gate(cond, msg):
        if not cond:
            print(f"[boot] GATE FAILED: {msg}")
            failed.append(msg)

    gate(i < 10 and n_lm >= 100, f"{what}: init at frame {i} with {n_lm} landmarks")
    gate(cost < cost0 and acc >= 1, f"{what}: the initial BA did not lower its cost")

    # truth in the reference camera's frame (the map's world frame)
    R_rel = R_gt[i] @ R_gt[j].T
    t_rel = t_gt[i] - R_rel @ t_gt[j]
    R1, t1 = res.R.cpu().double().numpy(), res.t.cpu().double().numpy()
    eR = _rot_deg(R1.T @ R_rel)
    cos_t = float(t1 @ t_rel / (np.linalg.norm(t1) * np.linalg.norm(t_rel)))
    et = float(np.degrees(np.arccos(np.clip(cos_t, -1.0, 1.0))))
    print(f"[boot] {what}: keyframe 1 vs truth: rotation {eR:.4f} deg, translation "
          f"direction {et:.4f} deg")
    gate(eR <= 0.5 and et <= 3.0, f"{what}: keyframe 1 pose off the truth")

    ns = out["n_inliers"]
    print(f"[boot] {what}: inliers per tracked frame {ns} (frames {out['frames_tracked']})")
    gate(len(ns) == n_track and not out["lost"] and min(ns) >= 50,
         f"{what}: tracking lost or below 50 inliers: {ns}")
    check(len(out["poses"]) > 0, f"{what}: no frame tracked")

    def centre_in_ref(k):
        c = -R_gt[k].T @ t_gt[k]
        return R_gt[j] @ c + t_gt[j]

    # the scale fixed at init: the map's unit is the median landmark depth
    # in the reference camera; the truth's is the true depth of the same
    # landmarks' reference keypoints (ray cast into the scene's planes)
    from orb_slam3_tpu_torch import entry

    fl = s.kf_feat_lm[res.kf0].cpu().numpy()
    lm_ok = s.lm_valid.cpu().numpy()
    bound = (fl >= 0) & lm_ok[np.clip(fl, 0, None)]
    uv = s.kf_feat_xy[res.kf0].cpu().numpy()[bound]
    w, h = cfg.img_wh
    depth = entry.render_with_depth(planes, cfg.K.cpu().double().numpy(), (w, h), R_gt[j],
                                    t_gt[j])[1]
    px = np.clip(np.round(uv).astype(np.int64), 0, [w - 1, h - 1])
    z_true = depth[px[:, 1], px[:, 0]]
    z_est = s.lm_pos.cpu().numpy()[fl[bound], 2]
    scale = float(np.median(z_true[z_true > 0]) / np.median(z_est))
    est = [-R.cpu().double().numpy().T @ t.cpu().double().numpy() for R, t in out["poses"]]
    frames = out["frames_tracked"]
    truth = [centre_in_ref(k) for k in frames]
    path = sum(np.linalg.norm(centre_in_ref(k + 1) - centre_in_ref(k))
               for k in range(j, frames[-1]))
    errs = [float(np.linalg.norm(scale * e - c)) for e, c in zip(est, truth)]
    err = max(errs)
    print(f"[boot] {what}: init scale {scale:.5f} (median depth); centre error per tracked "
          f"frame in the init's scale "
          f"{[round(e, 5) for e in errs]}, max {err:.5f} over a path of {path:.4f} "
          f"({100 * err / path:.2f}%)")
    # one scale fitted over the tracked frames (least squares), as the JAX
    # suite's trajectory checks fit it: the shape of the trajectory
    E_, C_ = np.stack(est), np.stack(truth)
    fit = float(np.sum(E_ * C_) / np.sum(E_ * E_))
    errs_fit = [float(np.linalg.norm(fit * e - c)) for e, c in zip(est, truth)]
    err_fit = max(errs_fit)
    print(f"[boot] {what}: with one fitted scale {fit:.5f} ({100 * (fit / scale - 1):+.2f}% "
          f"from the init's): centre error {[round(e, 5) for e in errs_fit]}, max "
          f"{err_fit:.5f} ({100 * err_fit / path:.2f}% of the path)")
    gate(err_fit <= 0.05 * path, f"{what}: camera centres off the truth by more than 5%")
    return dict(ref_frame=j, init_frame=i, landmarks=n_lm, ba_cost0=cost0, ba_cost=cost,
                ba_accepted=acc, kf1_rot_deg=eR, kf1_dir_deg=et, inliers=ns,
                init_scale=scale, centre_err=errs, path=path,
                centre_err_pct=100 * err / path, fitted_scale=fit,
                centre_err_fitted_pct=100 * err_fit / path, failed=failed)


def phase_bootstrap(dev, gpu):
    """Phase 7: the monocular bootstrap at full width through
    entry.bootstrap, its gates, K1 / K2 against their plain versions on a
    real tracked frame's inputs, the CPU plain path on the card's features,
    and the timings."""
    import numpy as np
    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker

    t0 = time.perf_counter()
    frames, R_gt, t_gt, planes = entry.plane_sequence(BOOT_FRAMES)
    print(f"[boot] rendered {BOOT_FRAMES} PlaneScene frames in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = entry.tracker_config(dev, **SYNC)
    print(f"[boot] config: kmax {cfg.kmax}, lmax {cfg.lmax}, window {cfg.local_window}, "
          f"{cfg.orb.n_features} features x {cfg.orb.n_levels} levels")

    # the main path, with every K1 / K2 input recorded
    rec = {"k1": [], "k2": []}
    k1_orig, k2_orig = mk.search_by_projection_kernel, pk.pose_ba

    def k1_rec(*a, **kw):
        rec["k1"].append((a, kw))
        return k1_orig(*a, **kw)

    def k2_rec(*a, **kw):
        rec["k2"].append((a, kw))
        return k2_orig(*a, **kw)

    timer = PartTimer()
    mk.search_by_projection_kernel, pk.pose_ba = k1_rec, k2_rec
    try:
        mk.launches = 0
        pk.launches = 0
        t0 = time.perf_counter()
        out = entry.bootstrap(frames, cfg, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba = k1_orig, k2_orig
    print(f"[boot] main path (first run, builds nothing): {wall:.2f} s; launches {launches}")
    summary = check_bootstrap(out, cfg, R_gt, t_gt, planes, "card")
    per_frame = [(k1, k2) for name, k1, k2 in timer.launches if name == "track_frame"]
    print(f"[boot] launches per tracked frame (K1, K2): {per_frame}")
    check(len(per_frame) == 8 and all(k1 >= 1 and k2 >= 1 for k1, k2 in per_frame),
          f"a tracked frame skipped a kernel: {per_frame}")
    check(sum(k1 for k1, _ in per_frame) == launches["K1"]
          and sum(k2 for _, k2 in per_frame) == launches["K2"],
          "kernel launches outside the tracked frames")

    # each kernel against its plain version on one real tracked frame's inputs
    a1, kw1 = next(r for r in reversed(rec["k1"]) if r[0][0].shape[0] == cfg.lmax)
    a2, kw2 = next(r for r in reversed(rec["k2"]) if r[0][3].shape[1] == cfg.lmax)
    err_k1, n_ok = compare_k1(mk.search_by_projection_kernel(*a1, **kw1),
                              mk.search_by_projection_plain(*a1, **kw1))
    err_k2 = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2),
                        f"tracked frame N={cfg.lmax}")
    print(f"[boot] K1 == plain on a tracked frame (N={a1[0].shape[0]}, M={a1[4].shape[0]}, "
          f"{n_ok} matched); K2 vs plain N={a2[3].shape[1]}: max |err| {err_k2:.3g}")
    small = [r for r in rec["k2"] if r[0][3].shape[1] == cfg.orb.n_features]
    if small:
        a3, kw3, src = small[-1][0], small[-1][1], "the reference-keyframe fallback"
    else:
        a3, kw3 = k2_case(dev, 1, False, seed=11, N=cfg.orb.n_features)
        src = "a synthetic case (the fallback did not run)"
    err_k2 = max(err_k2, compare_k2(pk.pose_ba(*a3, **kw3), pk.pose_ba_plain(*a3, **kw3),
                                    f"N={cfg.orb.n_features}"))
    print(f"[boot] K2 vs plain at N={cfg.orb.n_features} on {src}: ok")

    # the same features through the CPU plain path: same init outcome and
    # the first CPU_TRACK tracked poses within 1e-3 (8 until phase 12 came:
    # each CPU frame costs ~2 s of plain K2 and the script keeps its budget)
    cfg_cpu = entry.tracker_config("cpu", **SYNC)
    t0 = time.perf_counter()
    out_cpu = entry.bootstrap_features([_cpu_feats(f) for f in out["feats"]], cfg_cpu,
                                       n_track=CPU_TRACK)
    print(f"[boot] CPU plain path on the card's features: {time.perf_counter() - t0:.1f} s")
    sum_cpu = check_bootstrap(out_cpu, cfg_cpu, R_gt, t_gt, planes, "CPU plain",
                              n_track=CPU_TRACK)
    check((sum_cpu["ref_frame"], sum_cpu["init_frame"]) == (summary["ref_frame"],
                                                           summary["init_frame"]),
          "the CPU plain path initialized on other frames")
    dpose = max(max((Rc - Rg.cpu()).abs().max().item(), (tc - tg.cpu()).abs().max().item())
                for (Rg, tg), (Rc, tc) in zip([(out["init"].R, out["init"].t)] + out["poses"],
                                              [(out_cpu["init"].R, out_cpu["init"].t)]
                                              + out_cpu["poses"]))
    print(f"[boot] card vs CPU plain path: keyframe 1 and tracked poses within {dpose:.3g}")
    check(dpose <= 1e-3, f"card and CPU plain poses differ by {dpose:.3g}")

    # repeatability: the init's BA from the same inputs gives the same bits
    res = out["init"]
    i = out["init_frame"]
    j = summary["ref_frame"]
    ref = (out["feats"][j], float(j))
    s0 = tracker.empty_map(cfg, device=dev)
    again = tracker.initialize_monocular(cfg, s0, ref, out["feats"][i], float(i), seed=i)
    fields = ("lm_pos", "kf_R", "kf_t", "lm_normal", "lm_max_dist")
    same = all(torch.equal(getattr(again.map, f), getattr(res.map, f)) for f in fields)
    spread = max((getattr(again.map, f) - getattr(res.map, f)).abs().max().item()
                 for f in fields)
    print(f"[boot] init repeated on the same frames: map bitwise equal: {same} "
          f"(max |diff| {spread:.3g})")

    # diagnostics: the two-view geometry before the BA, and whether the
    # card's extraction repeats bit for bit
    from orb_slam3_tpu_torch.frontend import matching, orb, two_view

    f_ref, f_cur = out["feats"][j], out["feats"][i]
    idx, ok = matching.search_for_initialization(
        f_ref.xy, f_ref.descriptors, f_ref.valid, f_cur.xy, f_cur.descriptors, f_cur.valid)
    tv = two_view.reconstruct(f_ref.xy, f_cur.xy[idx], ok, cfg.K,
                              generator=torch.Generator().manual_seed(i))
    R_rel = R_gt[i] @ R_gt[j].T
    t_rel = t_gt[i] - R_rel @ t_gt[j]
    t2 = tv["t"].cpu().double().numpy()
    d2 = float(np.degrees(np.arccos(np.clip(t2 @ t_rel / np.linalg.norm(t_rel), -1, 1))))
    print(f"[boot] two-view geometry before the BA: rotation "
          f"{_rot_deg(tv['R'].cpu().double().numpy().T @ R_rel):.4f} deg, translation "
          f"direction {d2:.4f} deg, {int(tv['n_good'])} good points, used H {bool(tv['used_h'])}")
    img0 = torch.as_tensor(frames[j], device=dev)
    e1, e2 = orb.extract(img0, cfg.orb), orb.extract(img0, cfg.orb)
    print(f"[boot] extraction repeated on the card: keypoints equal "
          f"{bool(torch.equal(e1.xy, e2.xy))}, descriptors equal "
          f"{bool(torch.equal(e1.descriptors, e2.descriptors))}")

    timing = bootstrap_timing(cfg, out, a1, kw1, a2, kw2, launches, gpu)
    failed = summary["failed"] + sum_cpu["failed"]
    timing["failed"] = failed
    timing.update(summary=summary, launches=launches, launches_per_frame=per_frame,
                  err={"K1": err_k1, "K2": err_k2}, wall_s=wall, repeatable=same,
                  repeat_max_diff=spread)
    return timing


def bootstrap_timing(cfg, out, a1, kw1, a2, kw2, launches, gpu):
    """Init parts and track_frame in ms (host clock, synchronised; medians
    of 3 and 8 runs after the main run), K1 / K2 per call, on the device and
    plain at N = lmax, CUDA kernels per tracked frame and the device busy
    share over the 8 tracked frames (torch.profiler)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker

    res, i = out["init"], out["init_frame"]
    j = int(round(float(res.map.kf_timestamp[res.kf0])))
    per_run = []
    for _ in range(3):
        t_init = PartTimer()
        s0 = tracker.empty_map(cfg, device=cfg.K.device)
        tracker.initialize_monocular(cfg, s0, (out["feats"][j], float(j)), out["feats"][i],
                                     float(i), seed=i, timer=t_init)
        per_run.append({k: sum(v) for k, v in t_init.ms.items()})
    init_ms = {k: statistics.median(r[k] for r in per_run) for k in per_run[0]}
    init_ms["total"] = statistics.median(sum(r.values()) for r in per_run)
    tracked = out["feats"][i + 1:i + 1 + len(out["n_inliers"])]
    t_track = PartTimer()
    again = entry.track_sequence(cfg, res, tracked, timer=t_track)
    if again["n_inliers"] != out["n_inliers"]:
        print(f"[boot timing] the tracking rerun's inliers {again['n_inliers']} differ from "
              f"the main run's {out['n_inliers']}")
    track_ms = statistics.median(t_track.ms["track_frame"])

    rows = {}
    for name, fn, plain, (nbytes, ops), kname in (
            ("K1", lambda: mk.search_by_projection_kernel(*a1, **kw1),
             lambda: mk.search_by_projection_plain(*a1, **kw1), k1_bound(a1), "match_kernel"),
            ("K2", lambda: pk.pose_ba(*a2, **kw2), lambda: pk.pose_ba_plain(*a2, **kw2),
             k2_bound(a2, kw2), "pose_kernel")):
        b_ms, b_by = bound_ms(nbytes, ops)
        dev_ms, dev_by = device_kernel_ms(fn, kname)
        rows[name] = dict(N=int(a1[0].shape[0] if name == "K1" else a2[3].shape[1]),
                          launches=launches[name], ms=time_ms(fn), device_ms=dev_ms,
                          device_ms_by=dev_by,
                          plain_ms=time_ms(plain, runs=5, warmup=1), bound_ms=b_ms,
                          bound_by=b_by, bytes=nbytes, ops=ops)

    runs = 2
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(runs):
            entry.track_sequence(cfg, res, tracked)
        b.record()
        torch.cuda.synchronize()
    busy_ms, n_kernels, by_name = device_busy(prof)
    n_frames = runs * len(tracked)
    top = sorted(by_name, reverse=True)[:8]
    print("[boot timing] device time per tracked frame by kernel: " + "; ".join(
        f"{k[:60]} x{c / n_frames:.1f} {us / 1000.0 / n_frames:.3f} ms" for us, c, k in top))
    busy = None if busy_ms is None else busy_ms / a.elapsed_time(b)
    print(f"[boot timing] {gpu}: init parts (ms, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in init_ms.items()))
    print(f"[boot timing] {gpu}: track_frame median {track_ms:.2f} ms over "
          f"{len(t_track.ms['track_frame'])} frames; {n_kernels / n_frames:.0f} CUDA kernels "
          f"per tracked frame; device busy {pct(busy)}")
    for name, r in rows.items():
        print(f"[boot timing] {gpu}: {name} at N={r['N']}: {r['ms']:.4f} ms per call, device "
              f"{r['device_ms']:.5f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} "
              f"ms ({r['bound_by']})")
    return dict(init_ms=init_ms, track_frame_ms=track_ms,
                top_kernels=[(k, c / n_frames, us / 1000.0 / n_frames) for us, c, k in top],
                track_frame_ms_all=t_track.ms["track_frame"],
                kernels_per_frame=n_kernels / n_frames, device_busy_share=busy, kernels=rows)


# ---------------------------------------------------------------- phase 8
SLAM_FRAMES = 40  # the orbit of tests/test_slam_mono.py


def _on(obj, dev):
    """A dataclass of tensors (MapState, KFPackage) with each tensor on dev."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev) for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})


def keyframe_stack(s, pkg, cfg, parent, sensor="mono"):
    """One keyframe's mapping as Tracker._insert_keyframe runs it:
    map_stage_pre -> local BA -> map_stage_post. Returns the pre stage's
    (state, kf row, BA rows, n_fixed) and the final state."""
    from orb_slam3_tpu_torch.mapping import pipeline

    sf = cfg.scale_factors()
    pre = pipeline.run_pre_stage(s, pkg, cfg, sensor, parent, sf)
    s2 = pipeline.run_visual_ba(pre[0], cfg, sf, pre[2], pre[3], sensor)
    return pre, pipeline.map_stage_post(s2, pre[2], cfg.local_window + 4)


def keyframe_stack_vs_cpu(s_in, pkg, cfg, parent, sensor, gpu, tag, min_agree=0.99,
                          pose_tol=1e-3, profiled=True):
    """One keyframe's mapping stack on the card (timed, and profiled unless
    `profiled` is False) and on the CPU plain path from the same input
    state: the same keyframe row, BA window and n_fixed, landmarks within
    1%, each row's bindings equal on at least `min_agree` of its features,
    keyframe poses within `pose_tol`."""
    import contextlib
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    window = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext())
    with window as prof:
        ev0.record()
        pre_g, s_g = keyframe_stack(s_in, pkg, cfg, parent, sensor)
        ev1.record()
        torch.cuda.synchronize()
    kf_wall = ev0.elapsed_time(ev1)
    busy_ms, n_kernels, by_name = device_busy(prof) if profiled else (None, None, [])
    kf_busy = None if busy_ms is None else busy_ms / kf_wall
    top = sorted(by_name, reverse=True)[:6]
    print(f"[{tag} timing] {gpu}: one keyframe's mapping stack {kf_wall:.1f} ms"
          + (f" under the profiler, {n_kernels} CUDA kernels, device busy {pct(kf_busy)}; top: "
             + "; ".join(f"{k[:50]} x{c} {us / 1000.0:.2f} ms" for us, c, k in top)
             if profiled else " (not profiled)"))
    cfg_cpu = dataclasses.replace(cfg, K=cfg.K.cpu())
    t0 = time.perf_counter()
    pre_c, s_c = keyframe_stack(_on(s_in, "cpu"), _on(pkg, "cpu"), cfg_cpu, parent, sensor)
    cpu_s = time.perf_counter() - t0
    check(pre_g[1] == pre_c[1], f"keyframe row {pre_g[1]} vs {pre_c[1]}")
    check(torch.equal(pre_g[2].cpu(), pre_c[2]) and int(pre_g[3]) == int(pre_c[3]),
          "BA window or n_fixed differs")
    agree_pre = compare_maps(pre_g[0], pre_c[0], "after map_stage_pre", min_agree)
    agree_post = compare_maps(s_g, s_c, "after BA and map_stage_post", min_agree)
    kv = s_c.kf_valid
    dpose = max((s_g.kf_R.cpu()[kv] - s_c.kf_R[kv]).abs().max().item(),
                (s_g.kf_t.cpu()[kv] - s_c.kf_t[kv]).abs().max().item())
    check(dpose <= pose_tol, f"keyframe poses after the BA differ by {dpose:.3g}")
    print(f"[{tag}] keyframe {pre_g[1]} (window {pre_g[2].tolist()}, n_fixed {int(pre_g[3])}) "
          f"card vs CPU plain ({cpu_s:.1f} s): after pre, landmarks {agree_pre[1]} vs "
          f"{agree_pre[2]}, bindings >= {100 * agree_pre[0]:.2f}% per row; after BA + post, "
          f"landmarks {agree_post[1]} vs {agree_post[2]}, bindings >= {100 * agree_post[0]:.2f}%"
          f", keyframe poses within {dpose:.3g}")
    return dict(ms=kf_wall, busy_share=kf_busy, kernels=n_kernels, cpu_s=cpu_s,
                pose_diff=dpose, bindings_agree=min(agree_pre[0], agree_post[0]))


def compare_maps(a, b, what, min_agree=0.99):
    """Landmark counts within 1%, each valid keyframe row's bindings equal on
    >= min_agree of features; returns (the worst row's agreement, landmarks
    a, b)."""
    n_a, n_b = int(a.lm_valid.sum()), int(b.lm_valid.sum())
    check(abs(n_a - n_b) <= 0.01 * n_b, f"{what}: landmarks {n_a} vs {n_b}")
    check(bool((a.kf_valid.cpu() == b.kf_valid.cpu()).all()), f"{what}: valid keyframes differ")
    rows = b.kf_valid.cpu().nonzero()[:, 0]
    agree = min(float((a.kf_feat_lm[r].cpu() == b.kf_feat_lm[r].cpu()).float().mean())
                for r in rows.tolist())
    check(agree >= min_agree, f"{what}: bindings agree on only {100 * agree:.2f}% of a row")
    return agree, n_a, n_b


def phase_slam(dev, gpu):
    """Phase 8: monocular SLAM with keyframes and local mapping at full
    width through entry.slam (System.track_monocular), its gates, K1 at the
    fuse call site, one keyframe's mapping stack on the card against the CPU
    plain path, and the timings."""
    import contextlib
    import statistics

    import numpy as np
    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.api import evaluate
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.mapping import fuse, pipeline
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    t0 = time.perf_counter()
    frames, R_gt, t_gt, _ = entry.plane_sequence(SLAM_FRAMES)
    print(f"[slam] rendered {SLAM_FRAMES} PlaneScene frames in {time.perf_counter() - t0:.1f} s")
    cfg = entry.tracker_config(dev, **SYNC)

    # the K1 launches inside each fuse call, the inputs of the last fuse
    # call's K1 and of the last keyframe's mapping stack
    rec = {"fuse_calls": 0, "fuse_k1": 0, "fuse_args": None, "pre": None, "frames": [],
           "fuse_new": []}
    fuse_orig, pre_orig = fuse.fuse_into_keyframe, pipeline.run_pre_stage
    k1_orig = mk.search_by_projection_kernel
    in_fuse = [False]

    def k1_rec(*a, **kw):
        if in_fuse[0]:
            rec["fuse_args"] = (a, kw)
        return k1_orig(*a, **kw)

    def fuse_rec(*a, **kw):
        n = mk.launches
        in_fuse[0] = True
        try:
            out = fuse_orig(*a, **kw)
            # new observations in the keyframe row, kept on the device
            s, row = a[2], a[3]
            rec["fuse_new"].append(((out.kf_feat_lm[row] >= 0) & (s.kf_feat_lm[row] < 0)).sum())
            return out
        finally:
            in_fuse[0] = False
            rec["fuse_calls"] += 1
            rec["fuse_k1"] += mk.launches - n

    def pre_rec(s, pkg, cfg_, base, parent, sf):
        rec["pre"] = (s, pkg, parent)
        return pre_orig(s, pkg, cfg_, base, parent, sf)

    def frame_timer(name):
        @contextlib.contextmanager
        def part():
            torch.cuda.synchronize()
            n_kf = len(GLOBAL_TIMER.samples["track.kf_insert_sync"])
            t1 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            rec["frames"].append(((time.perf_counter() - t1) * 1e3,
                                  len(GLOBAL_TIMER.samples["track.kf_insert_sync"]) > n_kf))
        return part()

    GLOBAL_TIMER.reset()
    fuse.fuse_into_keyframe, pipeline.run_pre_stage = fuse_rec, pre_rec
    mk.search_by_projection_kernel = k1_rec
    try:
        mk.launches = 0
        pk.launches = 0
        t0 = time.perf_counter()
        system = entry.slam(frames, cfg, timer=frame_timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches}
    finally:
        fuse.fuse_into_keyframe, pipeline.run_pre_stage = fuse_orig, pre_orig
        mk.search_by_projection_kernel = k1_orig
    stages = GLOBAL_TIMER.summary()
    samples = {k: list(v) for k, v in GLOBAL_TIMER.samples.items()}
    tr = system.tracker
    n_kf_ins = len(samples.get("track.kf_insert_sync", []))
    print(f"[slam] main path (entry.slam, {SLAM_FRAMES} frames): {wall:.2f} s; launches "
          f"{launches}; keyframes inserted after the init {n_kf_ins}; fuse calls "
          f"{rec['fuse_calls']} with {rec['fuse_k1']} K1 launches")

    # the gates of tests/test_slam_mono.py
    ts, R, t, ok = tr.poses()
    s = tr.map
    est = evaluate.camera_centers(R[ok], t[ok])
    gt = evaluate.camera_centers(R_gt[ok], t_gt[ok])
    rmse, n_ate, ate_scale = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=True)
    n_kf, n_lm = int(s.n_kf), int(s.lm_valid.sum())
    lm = s.kf_feat_lm.cpu().numpy()
    bound = lm[lm >= 0]
    on_valid = float(s.lm_valid.cpu().numpy()[bound].mean()) if bound.size else 0.0
    viol = invariants.check_all(s)
    print(f"[slam] state {tr.state} (OK={tracker.OK}); tracked {int(ok.sum())} of {len(ok)} "
          f"frames; scale-fitted ATE {rmse:.5f} (scale {ate_scale:.4f}, {n_ate} frames); "
          f"n_kf {n_kf} (valid {int(s.kf_valid.sum())}), landmarks {n_lm}, bindings on valid "
          f"landmarks {100 * on_valid:.2f}%, invariant violations {len(viol)}; arena kmax "
          f"{s.kmax} lmax {s.lmax}")
    failed = []
    for cond, msg in ((tr.state == tracker.OK, "state not OK at the end"),
                      (ok.sum() >= 0.7 * len(ok), f"only {int(ok.sum())} frames tracked"),
                      (rmse < 0.35, f"ATE {rmse:.4f}"),
                      (n_kf >= 3, f"n_kf {n_kf}"),
                      (n_lm > 150, f"{n_lm} landmarks"),
                      (on_valid >= 0.95, f"{100 * on_valid:.2f}% of bindings on valid landmarks"),
                      (not viol, f"invariants: {viol[:3]}")):
        if not cond:
            print(f"[slam] GATE FAILED: {msg}")
            failed.append(msg)

    # K1 at the fuse call site: one launch per fuse target, exact on the
    # real call's inputs and on the two cases the tracking call never meets
    check(rec["fuse_calls"] >= 4 and rec["fuse_k1"] == rec["fuse_calls"] == 4 * n_kf_ins,
          f"K1 at the fuse: {rec['fuse_k1']} launches for {rec['fuse_calls']} fuse targets "
          f"and {n_kf_ins} keyframes")
    check(launches["K1"] > rec["fuse_k1"] and launches["K2"] >= 2,
          f"the tracked frames skipped a kernel: {launches}")
    a, kw = rec["fuse_args"]
    n_kp = int(a[7].sum())
    # (the real call's landmark mask is already sparse: the covisibility
    # pool of the keyframe's neighbours, minus what it observes; the third
    # case adds 3% of all rows, wherever they project, non-finite included)
    gen = torch.Generator(device="cpu").manual_seed(8)
    more = a[3] | (torch.rand(a[3].shape[0], generator=gen) < 0.03).to(a[3].device)
    for name, args in (("real fuse call", a),
                       ("no valid keypoint", a[:7] + (torch.zeros_like(a[7]),) + a[8:]),
                       ("3% of all rows added", a[:3] + (more,) + a[4:])):
        got = mk.search_by_projection_kernel(*args, **kw)
        ref = mk.search_by_projection_plain(*args, **kw)
        torch.cuda.synchronize()
        for g, r, what in zip(got, ref, ("idx", "dist", "ok")):
            check(torch.equal(g, r), f"K1 at the fuse, {name}: {what} differs in "
                  f"{int((g != r).sum())} rows")
        print(f"[slam] K1 == plain everywhere at the fuse ({name}: N={args[0].shape[0]}, "
              f"M={args[4].shape[0]}, {int(args[3].sum())} landmarks and "
              f"{int(args[7].sum())} keypoints valid, {int(got[2].sum())} matched)")
    # the inversion's conflicts resolve to the highest landmark row on the card
    idx = torch.randint(0, 40, (cfg.lmax,), generator=gen, dtype=torch.int32)
    okc = torch.rand(cfg.lmax, generator=gen) < 0.3
    inv_cpu = fuse.invert_matches(idx, okc, cfg.orb.n_features)
    inv_dev = [fuse.invert_matches(idx.to(dev), okc.to(dev), cfg.orb.n_features).cpu()
               for _ in range(3)]
    check(all(torch.equal(x, inv_cpu) for x in inv_dev), "fuse inversion differs on the card")
    print("[slam] fuse inversion with conflicts: card == CPU (highest row) in 3 of 3 runs")

    # one keyframe's mapping stack on the card against the CPU plain path,
    # from the same input state; the card's run is timed and profiled
    s_in, pkg, parent = rec["pre"]
    stack = keyframe_stack_vs_cpu(s_in, pkg, cfg, parent, "mono", gpu, "slam")
    kf_wall, kf_busy, n_kernels = stack["ms"], stack["busy_share"], stack["kernels"]
    cpu_s, dpose = stack["cpu_s"], stack["pose_diff"]
    fuse_new = torch.stack(rec["fuse_new"]).cpu().tolist()
    per_kf = [sum(fuse_new[i:i + 4]) for i in range(0, len(fuse_new), 4)]
    print(f"[slam] fuse: new observations per keyframe {per_kf} (per call {fuse_new})")

    # timings: frames, extraction, the mapping parts, K1 at the fuse shape
    tracked_ms = [ms for (ms, kf), o in zip(rec["frames"], ok) if o and not kf]
    kf_ms = [ms for ms, kf in rec["frames"] if kf]
    img = torch.as_tensor(frames[-1], device=dev)
    extract_ms = time_ms(lambda: orb.extract(img, cfg.orb), runs=20)
    parts = {k: samples.get(v, []) for k, v in (("pre", "map.pre"), ("ba", "map.local_ba"),
                                                 ("post", "map.culling"))}
    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    fn = lambda: mk.search_by_projection_kernel(*a, **kw)  # noqa: E731
    plain = lambda: mk.search_by_projection_plain(*a, **kw)  # noqa: E731
    nbytes, ops = k1_bound(a)
    b_ms, b_by = bound_ms(nbytes, ops)
    dev_ms, dev_by = device_kernel_ms(fn, "match_kernel")
    k1_fuse = dict(N=int(a[0].shape[0]), M=int(a[4].shape[0]), keypoints_valid=n_kp,
                   launches=rec["fuse_k1"], ms=time_ms(fn), device_ms=dev_ms,
                   device_ms_by=dev_by,
                   plain_ms=time_ms(plain, runs=5, warmup=1), bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, ops=ops)
    print(f"[slam timing] {gpu}: tracked frame without a keyframe (extraction included): "
          f"median {med(tracked_ms):.2f} ms over {len(tracked_ms)} frames; ORB extraction "
          f"alone {extract_ms:.2f} ms; frame that inserts a keyframe: median {med(kf_ms):.1f} "
          f"ms over {len(kf_ms)} ({[round(x, 1) for x in kf_ms]})")
    print(f"[slam timing] {gpu}: mapping per keyframe (stage timer, synchronised), median ms: "
          + ", ".join(f"{k} {med(v):.1f}" for k, v in parts.items() if v)
          + "; per keyframe: " + "; ".join(
              f"{k} {[round(x, 1) for x in v]}" for k, v in parts.items()))
    print(f"[slam timing] {gpu}: K1 at the fuse (N={k1_fuse['N']}, M={k1_fuse['M']}): "
          f"{k1_fuse['ms']:.4f} ms per call, device {dev_ms:.5f} ms, plain "
          f"{k1_fuse['plain_ms']:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(failed=failed, launches=launches, fuse_calls=rec["fuse_calls"],
                fuse_k1=rec["fuse_k1"], keyframes_inserted=n_kf_ins, wall_s=wall,
                state=tr.state, tracked=int(ok.sum()), frames=len(ok), ate=rmse,
                ate_scale=ate_scale, n_kf=n_kf, landmarks=n_lm, bindings_on_valid=on_valid,
                violations=viol, tracked_frame_ms=med(tracked_ms), extract_ms=extract_ms,
                keyframe_frame_ms=kf_ms, mapping_ms=parts, keyframe_stack_ms=kf_wall,
                keyframe_busy_share=kf_busy, keyframe_kernels=n_kernels,
                keyframe_cpu_s=cpu_s, keyframe_pose_diff=dpose, fuse_new_per_keyframe=per_kf,
                stages={k: v["p50_ms"] for k, v in stages.items()}, k1_fuse=k1_fuse)


# ---------------------------------------------------------------- phase 9
# (name, sensor, PlaneScene seed, frames, baseline, first localization
# frame, th_depth): the configurations of tests/test_slam_rgbd_stereo.py at
# full width (th_depth 20: th_depth_m = bf * th_depth / fx = 2 m, under the
# scene's 4.2-6 m, so no VO point is valid), and the localization session
# again at th_depth 80 (8 m), where every paused frame carries valid VO
# points into the next
DEPTH_SESSIONS = (("rgbd", "rgbd", 1, 25, 0.1, None, 20.0),
                  ("stereo", "stereo", 2, 20, 0.12, None, 20.0),
                  ("localization", "rgbd", 6, 34, 0.1, 12, 20.0),
                  ("localization-vo", "rgbd", 6, 22, 0.1, 12, 80.0))


def depth_frames(sensor, seed, n, baseline):
    """PlaneScene frames along the orbit, rendered in numpy on a thread pool:
    (left, right) pairs for stereo, (image, depth) pairs for RGB-D."""
    from concurrent.futures import ThreadPoolExecutor

    from orb_slam3_tpu_torch import entry

    planes = entry.plane_scene(seed)
    R, t = entry.orbit_trajectory(n)
    K, wh = entry.FULL_K, entry.FULL_WH
    if sensor == "stereo":
        render = lambda i: entry.render_stereo(planes, K, wh, R[i], t[i], baseline)  # noqa: E731
    else:
        render = lambda i: entry.render_with_depth(planes, K, wh, R[i], t[i])  # noqa: E731
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(render, range(n))), R, t


def run_depth_session(dev, name, sensor, seed, n, baseline, localize_from, th_depth):
    """One phase-9 session through entry.slam (System.track_rgbd /
    track_stereo), the launch counters zeroed just before it, mapping paused
    from frame `localize_from` on. Every stage of the stage timer is
    synchronised at its end, so the per-frame split includes the device's
    time. Records each frame's time and launches, the K1 / K2 inputs of the
    last calls at the new call sites, the K1 launches inside the fuse, each
    fuse call's new observations (on the device, read once at the end) and
    the last keyframe's mapping inputs."""
    import contextlib

    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.api.system import System
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.mapping import fuse, pipeline
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    t0 = time.perf_counter()
    frames, R_gt, t_gt = depth_frames(sensor, seed, n, baseline)
    render_s = time.perf_counter() - t0
    cfg = entry.tracker_config(dev, sensor=sensor, bf=450.0 * baseline, th_depth=th_depth,
                               **SYNC)
    F, L = cfg.orb.n_features, cfg.lmax
    rec = {"frames": [], "fuse_new": [], "pre": None, "k2_stereo": None, "k1_vo": None,
           "k2_loc": None, "paused_at_kf": None,
           "sites": {"K1 vo": 0, "K2 loc": 0, "K1 fuse": 0}, "vo_valid": [], "vo_ok": []}
    k1_orig, k2_orig = mk.search_by_projection_kernel, pk.pose_ba
    fuse_orig, pre_orig = fuse.fuse_into_keyframe, pipeline.run_pre_stage
    stage_orig, pause_orig = GLOBAL_TIMER.stage, System.activate_localization_mode

    def k1_rec(*a, **kw):
        if a[0].shape[0] != F:  # N = lmax: tracking and the fuse
            return k1_orig(*a, **kw)
        rec["k1_vo"], n0 = (a, kw), mk.launches
        out = k1_orig(*a, **kw)
        rec["sites"]["K1 vo"] += mk.launches - n0
        rec["vo_valid"].append(a[3].sum())
        rec["vo_ok"].append(out[2].sum())
        return out

    def k2_rec(*a, **kw):
        N = a[3].shape[1]
        if kw.get("ur") is not None and N == L:
            rec["k2_stereo"] = (a, kw)
        if N != L + F:
            return k2_orig(*a, **kw)
        rec["k2_loc"], n0 = (a, kw), pk.launches
        out = k2_orig(*a, **kw)
        rec["sites"]["K2 loc"] += pk.launches - n0
        return out

    def fuse_rec(kind, K8, s, row, sf, **kw):
        n0 = mk.launches
        out = fuse_orig(kind, K8, s, row, sf, **kw)
        rec["sites"]["K1 fuse"] += mk.launches - n0
        rec["fuse_new"].append(((out.kf_feat_lm[row] >= 0) & (s.kf_feat_lm[row] < 0)).sum())
        return out

    def pre_rec(s, pkg, cfg_, base, parent, sf):
        rec["pre"] = (s, pkg, parent)
        return pre_orig(s, pkg, cfg_, base, parent, sf)

    def pause_rec(self):
        rec["paused_at_kf"] = int(self.tracker.map.n_kf)
        return pause_orig(self)

    def frame_timer(name):
        @contextlib.contextmanager
        def part():
            i = len(rec["frames"])
            n_kf = len(GLOBAL_TIMER.samples["track.kf_insert_sync"])
            k = (mk.launches, pk.launches, pk.stereo_launches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            rec["frames"].append(dict(
                ms=(time.perf_counter() - t1) * 1e3,
                kf=len(GLOBAL_TIMER.samples["track.kf_insert_sync"]) > n_kf,
                k1=mk.launches - k[0], k2=pk.launches - k[1], k2_stereo=pk.stereo_launches - k[2],
                paused=localize_from is not None and i >= localize_from))
        return part()

    GLOBAL_TIMER.reset()
    mk.search_by_projection_kernel, pk.pose_ba = k1_rec, k2_rec
    fuse.fuse_into_keyframe, pipeline.run_pre_stage = fuse_rec, pre_rec
    GLOBAL_TIMER.stage = lambda stage_name: GLOBAL_TIMER.stage_sync(stage_name, dev)
    System.activate_localization_mode = pause_rec
    try:
        mk.launches = pk.launches = pk.stereo_launches = 0
        t0 = time.perf_counter()
        system = entry.slam(frames, cfg, localize_from=localize_from, timer=frame_timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches, "K2_stereo": pk.stereo_launches,
                    **rec["sites"]}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba = k1_orig, k2_orig
        fuse.fuse_into_keyframe, pipeline.run_pre_stage = fuse_orig, pre_orig
        GLOBAL_TIMER.stage = stage_orig
        System.activate_localization_mode = pause_orig
    read = lambda v: torch.stack(v).cpu().tolist() if v else []  # noqa: E731
    fuse_new, vo_valid, vo_ok = read(rec["fuse_new"]), read(rec["vo_valid"]), read(rec["vo_ok"])
    samples = {k: list(v) for k, v in GLOBAL_TIMER.samples.items()}
    print(f"[depth {name}] {n} frames rendered in {render_s:.1f} s; main path "
          f"(entry.slam -> System.track_{sensor}, bf {cfg.bf:g}, th_depth {cfg.th_depth:g}): "
          f"{wall:.2f} s; launches {launches}")
    return dict(system=system, cfg=cfg, frames=frames, R_gt=R_gt, t_gt=t_gt, rec=rec,
                fuse_new=fuse_new, vo_valid=vo_valid, vo_ok=vo_ok, samples=samples,
                launches=launches, wall_s=wall)


def depth_gates(name, run):
    """The gates of tests/test_slam_rgbd_stereo.py. Returns (failed, summary)."""
    import numpy as np

    from orb_slam3_tpu_torch.api import evaluate
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.tracking import tracker

    tr = run["system"].tracker
    ts, R, t, ok = tr.poses()
    n = len(ok)
    s = tr.map
    summary = dict(state=tr.state, tracked=int(ok.sum()), frames=n, n_kf=int(s.n_kf),
                   landmarks=int(s.lm_valid.sum()), violations=invariants.check_all(s))
    conds = []
    if name.startswith("localization"):
        c_est = -tr.last["R"].cpu().double().numpy().T @ tr.last["t"].cpu().double().numpy()
        c_gt = -run["R_gt"][-1].T @ run["t_gt"][-1]
        d = float(np.linalg.norm(c_est - c_gt))
        summary.update(centre_err=d, n_kf_paused=run["rec"]["paused_at_kf"])
        conds = [(tr.state == tracker.OK, "state not OK at the end"),
                 (summary["n_kf"] == run["rec"]["paused_at_kf"],
                  f"n_kf {summary['n_kf']} changed from {run['rec']['paused_at_kf']} while paused"),
                 (d < 0.15, f"last camera centre {d:.4f} from the truth")]
    else:
        est = evaluate.camera_centers(R[ok], t[ok])
        gt = evaluate.camera_centers(run["R_gt"][ok], run["t_gt"][ok])
        rmse, _, scale = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=False)
        summary.update(ate=rmse, ate_scale=scale)
        gate = 0.10 if name == "rgbd" else 0.15
        conds = [(ok.sum() >= 0.8 * n, f"only {int(ok.sum())} of {n} frames tracked"),
                 (rmse < gate, f"unscaled ATE {rmse:.4f} (gate {gate})")]
    conds.append((not summary["violations"], f"invariants: {summary['violations'][:3]}"))
    failed = [f"{name}: {msg}" for cond, msg in conds if not cond]
    for msg in failed:
        print(f"[depth] GATE FAILED: {msg}")
    print(f"[depth {name}] " + ", ".join(f"{k} {v}" for k, v in summary.items()
                                       if k != "violations")
          + f", invariant violations {len(summary['violations'])}")
    return failed, summary


def phase_depth(dev, gpu):
    """Phase 9: pinhole stereo, RGB-D and localization mode at full width
    through System.track_stereo / track_rgbd, the gates
    of tests/test_slam_rgbd_stereo.py, K2's stereo template and the
    localization call sites against their plain versions on the sessions'
    own inputs, one depth keyframe's mapping stack on the card against the
    CPU plain path, and the timings."""
    import statistics

    import torch

    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import orb, stereo
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    runs, failed, out = {}, [], {"sessions": {}}
    for name, sensor, seed, n, baseline, loc, th_depth in DEPTH_SESSIONS:
        run = runs[name] = run_depth_session(dev, name, sensor, seed, n, baseline, loc,
                                             th_depth)
        f, summary = depth_gates(name, run)
        failed += f
        frames = run["rec"]["frames"]
        # K2's stereo template on every tracked depth frame; in localization
        # mode K1 at the VO call and K2 over map + VO rows
        tracked = frames[1:]
        check(all(fr["k2_stereo"] >= 1 for fr in tracked),
              f"{name}: a tracked frame launched no stereo K2: "
              f"{[fr['k2_stereo'] for fr in tracked]}")
        check(run["launches"]["K1"] >= 2 * len(tracked), f"{name}: K1 launches {run['launches']}")
        if loc is not None:
            n_paused = sum(fr["paused"] for fr in frames)
            # the VO buffer exists from the second paused frame on
            check(run["launches"]["K1 vo"] >= n_paused - 1 and run["launches"]["K2 loc"]
                  >= n_paused - 1, f"localization call sites: {run['launches']} over "
                  f"{n_paused} paused frames")
            print(f"[depth {name}] VO points per VO match: valid {run['vo_valid']}, "
                  f"matched {run['vo_ok']}")
            if run["system"].tracker.th_depth_m > 6.5:  # beyond the scene: real VO rows
                check(min(run["vo_valid"]) >= 100 and min(run["vo_ok"]) >= 50,
                      f"{name}: VO points valid {run['vo_valid']}, matched {run['vo_ok']}")
        s = run["samples"]
        plain_frames = [fr["ms"] for fr in tracked if not fr["kf"] and not fr["paused"]]
        loc_frames = [fr["ms"] for fr in tracked if fr["paused"]]
        kf_frames = [fr["ms"] for fr in tracked if fr["kf"]]
        fuse = run["fuse_new"]
        per_kf = [sum(fuse[i:i + 4]) for i in range(0, len(fuse), 4)]
        timing = dict(
            frame_ms=med(plain_frames), localization_frame_ms=med(loc_frames),
            keyframe_frame_ms=med(kf_frames), keyframe_frames=len(kf_frames),
            orb_extraction_ms=med(s.get("orb_extraction", [])),
            stereo_depth_ms=med(s.get("track.stereo_depth", [])),
            fused_step_ms=med(s.get("track.fused_step", [])),
            localization_step_ms=med(s.get("track.localization", [])),
            map_ms={k: med(s.get(v, [])) for k, v in (("pre", "map.pre"),
                                                      ("local_ba", "map.local_ba"),
                                                      ("culling", "map.culling"))},
            k1_per_frame=med([fr["k1"] for fr in tracked if not fr["kf"]]),
            k2_per_frame=med([fr["k2"] for fr in tracked if not fr["kf"]]),
            k2_stereo_per_frame=med([fr["k2_stereo"] for fr in tracked if not fr["kf"]]),
            fuse_new_per_keyframe=per_kf)
        print(f"[depth timing] {gpu}: {name}: frame without a keyframe median "
              f"{timing['frame_ms']} ms over {len(plain_frames)}"
              + (f"; localization-mode frame median {timing['localization_frame_ms']:.2f} ms "
                 f"over {len(loc_frames)}" if loc_frames else "")
              + f"; per frame (synchronised stages, medians): orb_extraction "
              f"{timing['orb_extraction_ms']:.2f} ms"
              + (" (both images)" if sensor == "stereo" else "")
              + f", track.stereo_depth {timing['stereo_depth_ms']:.2f} ms, track.fused_step "
              f"{timing['fused_step_ms']} ms"
              + (f", track.localization {timing['localization_step_ms']:.2f} ms"
                 if loc_frames else ""))
        print(f"[depth timing] {gpu}: {name}: keyframe frame median {timing['keyframe_frame_ms']}"
              f" ms over {len(kf_frames)}; map.pre / local_ba / culling medians "
              f"{timing['map_ms']}; launches per frame without a keyframe: K1 "
              f"{timing['k1_per_frame']}, K2 {timing['k2_per_frame']} (stereo "
              f"{timing['k2_stereo_per_frame']}); fuse new observations per keyframe {per_kf}")
        out["sessions"][name] = dict(summary, launches=run["launches"], wall_s=run["wall_s"],
                                     **timing)

    # K2's stereo template on a tracked stereo frame's real inputs
    a2, kw2 = runs["stereo"]["rec"]["k2_stereo"]
    n_mono = int(((kw2["ur"] < 0) & a2[6]).sum())
    err_stereo = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2),
                            "stereo template on a tracked stereo frame")
    print(f"[depth] K2 stereo template vs plain on a tracked stereo frame (N={a2[3].shape[1]}, "
          f"{int(a2[6].sum())} valid rows, {n_mono} of them mono): mask equal, max |err| "
          f"{err_stereo:.3g}")
    # the localization call sites, on the last paused frame of the session
    # whose VO points are valid
    a1v, kw1v = runs["localization-vo"]["rec"]["k1_vo"]
    err_k1, n_ok = compare_k1(mk.search_by_projection_kernel(*a1v, **kw1v),
                              mk.search_by_projection_plain(*a1v, **kw1v))
    a2l, kw2l = runs["localization-vo"]["rec"]["k2_loc"]
    err_loc = compare_k2(pk.pose_ba(*a2l, **kw2l), pk.pose_ba_plain(*a2l, **kw2l),
                         "mono template over map + VO rows")
    print(f"[depth] localization call sites: K1 at the VO points == plain (N={a1v[0].shape[0]},"
          f" {int(a1v[3].sum())} valid VO points, {n_ok} matched); K2 mono over map + VO rows "
          f"(N={a2l[3].shape[1]}, {int(a2l[6].sum())} valid) vs plain: max |err| {err_loc:.3g}")

    # one depth keyframe's mapping stack on the card against the CPU plain path
    run = runs["rgbd"]
    cfg = run["cfg"]
    s_in, pkg, parent = run["rec"]["pre"]
    kf_stack = keyframe_stack_vs_cpu(s_in, pkg, cfg, parent, "rgbd", gpu, "depth",
                                     min_agree=1.0, pose_tol=1e-4)

    # the plain-torch stages of the depth frontend, timed alone on a real frame
    img = torch.as_tensor(runs["stereo"]["frames"][-1][0], device=dev)
    img_r = torch.as_tensor(runs["stereo"]["frames"][-1][1], device=dev)
    sf = cfg.scale_factors()
    fl, fr = orb.extract(img, cfg.orb), orb.extract(img_r, cfg.orb)
    sargs = (fl.xy, fl.octave, fl.descriptors, fl.valid, fr.xy, fr.octave, fr.descriptors,
             fr.valid, img, img_r, sf, runs["stereo"]["cfg"].bf, 0.1)
    dmap = torch.as_tensor(runs["rgbd"]["frames"][-1][1], device=dev)
    frontend = dict(
        extract_ms=time_ms(lambda: orb.extract(img, cfg.orb), runs=20),
        match_stereo_ms=time_ms(lambda: stereo.match_stereo(*sargs), runs=20),
        depth_from_rgbd_ms=time_ms(lambda: stereo.depth_from_rgbd(fl.xy, dmap, cfg.bf), runs=20))
    print(f"[depth timing] {gpu}: alone on a real frame (CUDA events, median of 20): ORB "
          f"extraction {frontend['extract_ms']:.2f} ms per image, match_stereo "
          f"{frontend['match_stereo_ms']:.3f} ms, depth_from_rgbd "
          f"{frontend['depth_from_rgbd_ms']:.3f} ms")
    rows = {}
    for kname, fn, plain, bound, N, prof_name in (
            ("K2_stereo", lambda: pk.pose_ba(*a2, **kw2), lambda: pk.pose_ba_plain(*a2, **kw2),
             k2_bound(a2, kw2), a2[3].shape[1], "pose_kernel"),
            ("K1_vo", lambda: mk.search_by_projection_kernel(*a1v, **kw1v),
             lambda: mk.search_by_projection_plain(*a1v, **kw1v), k1_bound(a1v),
             a1v[0].shape[0], "match_kernel"),
            ("K2_loc", lambda: pk.pose_ba(*a2l, **kw2l), lambda: pk.pose_ba_plain(*a2l, **kw2l),
             k2_bound(a2l, kw2l), a2l[3].shape[1], "pose_kernel")):
        b_ms, b_by = bound_ms(*bound)
        dev_ms, dev_by = device_kernel_ms(fn, prof_name)
        rows[kname] = dict(N=int(N), ms=time_ms(fn, runs=20), device_ms=dev_ms,
                           device_ms_by=dev_by,
                           plain_ms=time_ms(plain, runs=3, warmup=1), bound_ms=b_ms,
                           bound_by=b_by)
        print(f"[depth timing] {gpu}: {kname} (N={N}): {rows[kname]['ms']:.4f} ms per call, "
              f"device {dev_ms:.5f} ms, plain {rows[kname]['plain_ms']:.3f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in ("K1", "K2", "K2_stereo", "K1 vo", "K2 loc", "K1 fuse")}
    out.update(failed=failed, launches=launches, err={"K1": err_k1,
                                                      "K2": max(err_stereo, err_loc)},
               keyframe_stack=kf_stack, frontend=frontend, call_sites=rows)
    return out


# ---------------------------------------------------------------- phase 10
# (name, frames, PlaneScene seed): the fisheye rig of tests/test_slam_fisheye.py
# (KB8 K8, 512x384, 0.3 m baseline) and the legacy EuRoC stereo file
# (752x480, raw images through the cam0 rad-tan distortion, 0.11 m
# baseline) on phase 9's stereo scene
FISHEYE_K8 = (260.0, 260.0, 256.0, 192.0, 0.01, -0.005, 0.002, -0.001)
FISHEYE_WH, FISHEYE_BASE = (512, 384), 0.3
# the fisheye session runs 10 frames (20 until phase 11 came): its frames
# cost ~1.2 s each, all of it the host-bound plain KB8 pose BA, and the
# script keeps to its time budget with phase 11
SETTINGS_SESSIONS = (("fisheye-stereo-full", 10, 5), ("euroc-rectified-full", 20, 2))


def settings_frames(name, n, seed):
    """(left, right) pairs along the orbit, rendered in numpy on a thread
    pool: KB8 images of the fisheye rig, or raw images through the EuRoC
    camera's rad-tan distortion."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from orb_slam3_tpu_torch import entry

    planes = entry.plane_scene(seed)
    R, t = entry.orbit_trajectory(n)
    if name.startswith("fisheye"):
        base, rays = FISHEYE_BASE, entry.kb8_rays(FISHEYE_K8, FISHEYE_WH)
    else:
        base, rays = entry.EUROC_BASELINE, entry.radtan_rays(entry.EUROC_K, entry.EUROC_D, entry.FULL_WH)
    pair = lambda i: (entry.render_rays(planes, rays, R[i], t[i]),  # noqa: E731
                      entry.render_rays(planes, rays, R[i], t[i] - np.array([base, 0.0, 0.0])))
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(pair, range(n))), R, t


def settings_text(name):
    from orb_slam3_tpu_torch import entry

    if name.startswith("fisheye"):
        return entry.kb8_stereo_settings(FISHEYE_K8, FISHEYE_WH, FISHEYE_BASE, 1000, 8, 20.0)
    return entry.euroc_legacy_settings()


def run_settings_session(dev, name, n, seed, tmpdir):
    """One phase-10 session through entry.slam(settings_path=...) ->
    System(settings_path, "stereo").track_stereo, the launch counters zeroed
    just before it, every stage synchronised at its end. Records each
    frame's time and launches, K1's launches at the right-camera call site
    and that site's inputs, the inputs of the last match_stereo_fisheye,
    pose_optimize_two_cam and KB8 pose BA calls, the last tracking K1 / K2
    calls of the pinhole session and the last keyframe's mapping inputs."""
    import contextlib
    import os

    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.api import settings
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import stereo
    from orb_slam3_tpu_torch.mapping import fuse, pipeline
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import track
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    t0 = time.perf_counter()
    frames, R_gt, t_gt = settings_frames(name, n, seed)
    render_s = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(settings_text(name))
    rec = {"frames": [], "pre": None, "rfeat": None, "k1_right": None, "k1_track": None,
           "k2_stereo": None, "msf": None, "two_cam": None, "kb8_ba": None,
           "sites": {"K1 right": 0, "K1 fuse": 0}}
    o = dict(k1=mk.search_by_projection_kernel, k2=pk.pose_ba, tfv=track.track_frame_visual,
             mlm=track.match_local_map, msf=stereo.match_stereo_fisheye,
             two=track.pose_optimize_two_cam, pos=track.pose_optimize_stereo,
             fuse=fuse.fuse_into_keyframe, pre=pipeline.run_pre_stage, stage=GLOBAL_TIMER.stage,
             ttc=settings.to_tracker_config)
    site = [None]

    def ttc_sync(s, device=None, **overrides):
        # the settings file's tracker config, on the synchronous schedule
        return o["ttc"](s, device=device, **SYNC, **overrides)

    def k1_rec(*a, **kw):
        if site[0] == "right":
            rec["k1_right"] = (a, kw)
        elif site[0] is None:
            rec["k1_track"] = (a, kw)
        return o["k1"](*a, **kw)

    def k2_rec(*a, **kw):
        if kw.get("ur") is not None:
            rec["k2_stereo"] = (a, kw)
        return o["k2"](*a, **kw)

    def tfv_rec(*a, **kw):
        rec["rfeat"] = kw.get("rfeat_xy")
        return o["tfv"](*a, **kw)

    def mlm_rec(*a, **kw):
        right = rec["rfeat"] is not None and a[10] is rec["rfeat"]
        site[0], n0 = ("right" if right else None), mk.launches
        try:
            return o["mlm"](*a, **kw)
        finally:
            if right:
                rec["sites"]["K1 right"] += mk.launches - n0
            site[0] = None

    def msf_rec(*a, **kw):
        rec["msf"] = (a, kw)
        return o["msf"](*a, **kw)

    def two_rec(*a, **kw):
        rec["two_cam"] = (a, kw)
        return o["two"](*a, **kw)

    def pos_rec(kind, *a, **kw):
        if kind == cam.KB8:
            rec["kb8_ba"] = (a, kw)
        return o["pos"](kind, *a, **kw)

    def fuse_rec(*a, **kw):
        site[0], n0 = "fuse", mk.launches
        try:
            return o["fuse"](*a, **kw)
        finally:
            rec["sites"]["K1 fuse"] += mk.launches - n0
            site[0] = None

    def pre_rec(s, pkg, cfg_, base, parent, sf):
        rec["pre"] = (s, pkg, parent, cfg_)
        return o["pre"](s, pkg, cfg_, base, parent, sf)

    def frame_timer(_name):
        @contextlib.contextmanager
        def part():
            n_kf = len(GLOBAL_TIMER.samples["track.kf_insert_sync"])
            k = (mk.launches, pk.launches, pk.stereo_launches, rec["sites"]["K1 right"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            rec["frames"].append(dict(
                ms=(time.perf_counter() - t1) * 1e3,
                kf=len(GLOBAL_TIMER.samples["track.kf_insert_sync"]) > n_kf,
                k1=mk.launches - k[0], k2=pk.launches - k[1],
                k2_stereo=pk.stereo_launches - k[2], k1_right=rec["sites"]["K1 right"] - k[3]))
        return part()

    GLOBAL_TIMER.reset()
    mk.search_by_projection_kernel, pk.pose_ba = k1_rec, k2_rec
    track.track_frame_visual, track.match_local_map = tfv_rec, mlm_rec
    stereo.match_stereo_fisheye, track.pose_optimize_two_cam = msf_rec, two_rec
    track.pose_optimize_stereo = pos_rec
    fuse.fuse_into_keyframe, pipeline.run_pre_stage = fuse_rec, pre_rec
    settings.to_tracker_config = ttc_sync
    GLOBAL_TIMER.stage = lambda stage_name: GLOBAL_TIMER.stage_sync(stage_name, dev)
    try:
        mk.launches = pk.launches = pk.stereo_launches = 0
        t0 = time.perf_counter()
        system = entry.slam(frames, settings_path=path, sensor="stereo", device=dev,
                            timer=frame_timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches, "K2_stereo": pk.stereo_launches,
                    **rec["sites"]}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba = o["k1"], o["k2"]
        track.track_frame_visual, track.match_local_map = o["tfv"], o["mlm"]
        stereo.match_stereo_fisheye, track.pose_optimize_two_cam = o["msf"], o["two"]
        track.pose_optimize_stereo = o["pos"]
        fuse.fuse_into_keyframe, pipeline.run_pre_stage = o["fuse"], o["pre"]
        settings.to_tracker_config = o["ttc"]
        GLOBAL_TIMER.stage = o["stage"]
    cfg = system.tracker.cfg
    check(not cfg.async_mapping and cfg.pipeline_depth == 1,
          f"{name}: the settings session is not on the synchronous schedule")
    print(f"[settings {name}] {n} frames rendered in {render_s:.1f} s; main path "
          f"(entry.slam(settings_path) -> System.track_stereo, kind {cfg.kind}, "
          f"stereo_fisheye {cfg.stereo_fisheye}, bf {cfg.bf:.4g}, th_depth {cfg.th_depth:g}, "
          f"rectifier {system.rectifier is not None}): {wall:.2f} s; launches {launches}")
    return dict(system=system, cfg=cfg, frames=frames, R_gt=R_gt, t_gt=t_gt, rec=rec,
                samples={k: list(v) for k, v in GLOBAL_TIMER.samples.items()},
                launches=launches, wall_s=wall)


def settings_gates(name, run):
    """test_slam_fisheye.py's gates (>= 70% tracked, unscaled ATE < 0.05) or
    test_slam_rgbd_stereo.py::test_stereo_end_to_end's (>= 80%, < 0.15), and
    the Atlas invariants. Returns (failed, summary)."""
    from orb_slam3_tpu_torch.api import evaluate
    from orb_slam3_tpu_torch.atlas import invariants

    tr = run["system"].tracker
    ts, R, t, ok = tr.poses()
    n, s = len(ok), tr.map
    est = evaluate.camera_centers(R[ok], t[ok])
    gt = evaluate.camera_centers(run["R_gt"][ok], run["t_gt"][ok])
    rmse, _, _ = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=False)
    summary = dict(state=tr.state, tracked=int(ok.sum()), frames=n, ate=rmse,
                   n_kf=int(s.n_kf), landmarks=int(s.lm_valid.sum()),
                   violations=invariants.check_all(s))
    frac, gate = (0.7, 0.05) if name.startswith("fisheye") else (0.8, 0.15)
    conds = [(ok.sum() >= frac * n, f"only {int(ok.sum())} of {n} frames tracked"),
             (rmse < gate, f"unscaled ATE {rmse:.4f} (gate {gate})"),
             (not summary["violations"], f"invariants: {summary['violations'][:3]}")]
    failed = [f"{name}: {msg}" for cond, msg in conds if not cond]
    for msg in failed:
        print(f"[settings] GATE FAILED: {msg}")
    print(f"[settings {name}] " + ", ".join(f"{k} {v}" for k, v in summary.items()
                                          if k != "violations")
          + f", invariant violations {len(summary['violations'])}")
    return failed, summary


def _cpu(a):
    import torch

    return a.cpu() if torch.is_tensor(a) else a


def kb8_checks(run, gpu):
    """The fisheye session's card-vs-CPU checks on its own inputs: K1 at the
    right-camera call site exactly, match_stereo_fisheye (good equal on >=
    99% of rows, depth within 1e-4 relative where both are good), the KB8
    pose_optimize_two_cam (R within 1e-5, t within 1e-4), and the KB8 pose
    BA's time and CUDA kernels per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import stereo
    from orb_slam3_tpu_torch.tracking import track

    rec, out = run["rec"], {}
    a1, kw1 = rec["k1_right"]
    err_k1, n_ok = compare_k1(mk.search_by_projection_kernel(*a1, **kw1),
                              mk.search_by_projection_plain(*a1, **kw1))
    print(f"[fisheye] K1 at the right-camera call site == plain (N={a1[0].shape[0]}, "
          f"M={a1[4].shape[0]}, {int(a1[3].sum())} visible, {n_ok} matched)")
    (a, kw) = rec["msf"]
    d_g, g_g = (x.cpu() for x in stereo.match_stereo_fisheye(*a, **kw))
    d_c, g_c = stereo.match_stereo_fisheye(*[_cpu(x) for x in a], **kw)
    agree = float((g_g == g_c).float().mean())
    both = g_g & g_c
    rel = float(((d_g[both] - d_c[both]).abs() / d_c[both]).max()) if bool(both.any()) else 0.0
    check(agree >= 0.99 and rel <= 1e-4 and int(g_c.sum()) >= 100,
          f"match_stereo_fisheye card vs CPU: good agree {agree:.4f}, depth rel {rel:.3g}, "
          f"{int(g_c.sum())} good")
    (a, kw) = rec["two_cam"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    og = [x.cpu() for x in track.pose_optimize_two_cam(*a, **kw)]
    two_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    oc = track.pose_optimize_two_cam(*[_cpu(x) for x in a], **kw)
    two_cpu_s = time.perf_counter() - t0
    dR, dt = float((og[0] - oc[0]).abs().max()), float((og[1] - oc[1]).abs().max())
    m_agree = min(float((og[2] == oc[2]).float().mean()), float((og[3] == oc[3]).float().mean()))
    check(dR <= 1e-5 and dt <= 1e-4 and m_agree >= 0.99,
          f"KB8 pose_optimize_two_cam card vs CPU: R {dR:.3g}, t {dt:.3g}, masks {m_agree:.4f}")
    print(f"[fisheye] card vs CPU: match_stereo_fisheye good agree {100 * agree:.2f}% "
          f"({int(g_c.sum())} good of {g_c.shape[0]}), depth within {rel:.3g} relative; "
          f"pose_optimize_two_cam R {dR:.3g}, t {dt:.3g}, inliers {int(og[4])} vs {int(oc[4])}")
    # the plain KB8 pose BA: one call timed (the session has warmed it up),
    # one call profiled for its CUDA kernels (device activity only: the
    # host-side events of ~10k launches take seconds to gather); the
    # two-camera BA was timed by its card-vs-CPU call above
    (a, kw) = rec["kb8_ba"]
    fn = lambda: track.pose_optimize_stereo(cam.KB8, *a, **kw)  # noqa: E731
    ba_ms = time_ms(fn, runs=1, warmup=0)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ms, n_kernels, _ = device_busy(prof)
    prof_s = time.perf_counter() - t0
    msf_ms = time_ms(lambda: stereo.match_stereo_fisheye(*rec["msf"][0]), runs=10)
    print(f"[fisheye] seconds: the two-camera BA on the CPU {two_cpu_s:.1f}, the profiled KB8 "
          f"pose BA call {prof_s:.1f}")
    out.update(err_k1=err_k1, msf_agree=agree, msf_rel=rel, two_cam_dR=dR, two_cam_dt=dt,
               kb8_pose_ba_ms=ba_ms, kb8_pose_ba_kernels=n_kernels,
               kb8_pose_ba_busy_ms=busy_ms, two_cam_ms=two_ms, match_stereo_fisheye_ms=msf_ms,
               kb8_pose_ba_rows=int(a[4].shape[0]), kb8_pose_ba_valid=int(a[8].sum()))
    # a = (K, bf, R0, t0, uv, ur, Xw, inv_sigma2, valid)
    print(f"[fisheye timing] {gpu}: plain KB8 pose_optimize_stereo (N={a[4].shape[0]}, "
          f"{int(a[8].sum())} valid) {ba_ms:.2f} ms per call, {n_kernels} CUDA kernels per call"
          f" (device busy {busy_ms} ms); pose_optimize_two_cam {two_ms:.2f} ms; "
          f"match_stereo_fisheye {msf_ms:.3f} ms")
    return out


def rectified_checks(run, dev, gpu):
    """The EuRoC session's card-vs-CPU checks: the StereoRectifier on one raw
    pair (max |diff| <= 1e-3), the rad-tan keypoint path on one raw frame
    through Tracker._extract with the raw camera's dist_coeffs (>= 97% of
    keypoints the same, undistorted xy within 1e-3 px where they are), and
    K1 / K2 at the session's last tracking calls against their plain
    versions."""
    import numpy as np
    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import orb, rectify
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker

    raw_l, raw_r = run["frames"][-1]
    rg = run["system"].rectifier
    maps = (rg.map_l.cpu(), rg.map_r.cpu())
    out_g = [x.cpu() for x in rg(raw_l, raw_r)]
    out_c = [rectify.remap_bilinear(torch.from_numpy(im), m) for im, m in zip((raw_l, raw_r),
                                                                              maps)]
    d_rect = max(float((g - c).abs().max()) for g, c in zip(out_g, out_c))
    check(d_rect <= 1e-3, f"StereoRectifier card vs CPU: max |diff| {d_rect:.3g}")
    rect_ms = time_ms(lambda: rg(raw_l, raw_r), runs=20)
    # the rad-tan keypoint path: a pinhole camera with the raw distortion
    cfg = dict(K=np.asarray(list(entry.EUROC_K) + [0.0] * 4, np.float32), img_wh=entry.FULL_WH,
               dist_coeffs=np.asarray(entry.EUROC_D, np.float32), kmax=8, lmax=1024, **SYNC)
    tg = tracker.Tracker(tracker.TrackerConfig(**cfg), device=dev)
    tc = tracker.Tracker(tracker.TrackerConfig(**cfg), device="cpu")
    img = torch.from_numpy(raw_l)
    fg, fc = tg._extract(img.to(dev)), tc._extract(img)
    rawg, rawc = orb.extract(img.to(dev), tg.cfg.orb), orb.extract(img, tc.cfg.orb)
    same = (rawg.valid.cpu() & rawc.valid & (rawg.xy.cpu() == rawc.xy).all(dim=1)
            & (rawg.octave.cpu() == rawc.octave))
    frac = float(same.sum()) / max(int(rawc.valid.sum()), 1)
    dxy = float((fg.xy.cpu()[same] - fc.xy[same]).abs().max())
    moved = float((fc.xy[same] - rawc.xy[same]).abs().max())
    check(frac >= 0.97 and dxy <= 1e-3 and moved > 1.0,
          f"rad-tan keypoints card vs CPU: {100 * frac:.2f}% the same, undistorted xy within "
          f"{dxy:.3g} px, moved by up to {moved:.3g} px")
    a1, kw1 = run["rec"]["k1_track"]
    err_k1, n_ok = compare_k1(mk.search_by_projection_kernel(*a1, **kw1),
                              mk.search_by_projection_plain(*a1, **kw1))
    a2, kw2 = run["rec"]["k2_stereo"]
    err_k2 = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2),
                        "stereo template in the rectified session")
    print(f"[euroc] card vs CPU: StereoRectifier max |diff| {d_rect:.3g}; rad-tan keypoints "
          f"{100 * frac:.2f}% the same, undistorted within {dxy:.3g} px (moved up to "
          f"{moved:.1f} px); K1 == plain at the last tracking call (N={a1[0].shape[0]}, "
          f"{n_ok} matched); K2 stereo vs plain (N={a2[3].shape[1]}, {int(a2[6].sum())} valid): "
          f"max |err| {err_k2:.3g}")
    print(f"[euroc timing] {gpu}: StereoRectifier alone {rect_ms:.3f} ms per pair")
    return dict(rect_diff=d_rect, radtan_same=frac, radtan_dxy=dxy, err_k1=err_k1,
                err_k2=err_k2, rectify_ms=rect_ms)


def phase_settings(dev, gpu):
    """Phase 10: the fisheye-stereo rig and the rectified EuRoC rig at full
    width through System(settings_path), their gates, the card-vs-CPU checks
    on their inputs, one fisheye keyframe's mapping stack against the CPU
    plain path, and the timings."""
    import statistics
    import tempfile

    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    runs, failed, out = {}, [], {"sessions": {}}
    with tempfile.TemporaryDirectory() as tmpdir:
        for name, n, seed in SETTINGS_SESSIONS:
            t_s = time.perf_counter()
            run = runs[name] = run_settings_session(dev, name, n, seed, tmpdir)
            f, summary = settings_gates(name, run)
            failed += f
            frames = run["rec"]["frames"]
            tracked = frames[1:]
            fisheye = name.startswith("fisheye")
            if fisheye:
                check(all(fr["k1_right"] >= 1 for fr in tracked),
                      f"{name}: a tracked frame made no right-camera K1 launch: "
                      f"{[fr['k1_right'] for fr in tracked]}")
                check(run["launches"]["K2"] == 0, f"{name}: K2 launched for the KB8 camera")
            else:
                check(all(fr["k2_stereo"] >= 1 for fr in tracked),
                      f"{name}: a tracked frame launched no stereo K2")
            s = run["samples"]
            plain = [fr["ms"] for fr in tracked if not fr["kf"]]
            kf = [fr["ms"] for fr in tracked if fr["kf"]]
            timing = dict(
                frame_ms=med(plain), keyframe_frame_ms=med(kf), keyframe_frames=len(kf),
                stages={k: med(s.get(k, [])) for k in (
                    "orb_extraction", "track.rectify", "track.stereo_depth", "track.fused_step",
                    "map.pre", "map.local_ba", "map.culling")},
                k1_per_frame=med([fr["k1"] for fr in tracked if not fr["kf"]]),
                k1_right_per_frame=med([fr["k1_right"] for fr in tracked if not fr["kf"]]),
                k2_per_frame=med([fr["k2"] for fr in tracked if not fr["kf"]]))
            print(f"[settings timing] {gpu}: {name}: frame without a keyframe median "
                  f"{timing['frame_ms']} ms over {len(plain)}; keyframe frame median "
                  f"{timing['keyframe_frame_ms']} ms over {len(kf)}; synchronised stage medians "
                  f"{timing['stages']}; launches per frame without a keyframe: K1 "
                  f"{timing['k1_per_frame']} (right camera {timing['k1_right_per_frame']}), K2 "
                  f"{timing['k2_per_frame']}; K1 by call site {run['launches']}")
            out["sessions"][name] = dict(summary, launches=run["launches"], wall_s=run["wall_s"],
                                         **timing)
        print(f"[settings {name}] session with its gates: {time.perf_counter() - t_s:.1f} s")
    fe, eu = runs["fisheye-stereo-full"], runs["euroc-rectified-full"]
    t0 = time.perf_counter()
    kb8 = kb8_checks(fe, gpu)
    t1 = time.perf_counter()
    s_in, pkg, parent, cfg = fe["rec"]["pre"]
    kf_stack = keyframe_stack_vs_cpu(s_in, pkg, cfg, parent, "stereo", gpu, "fisheye",
                                     profiled=False)
    t2 = time.perf_counter()
    rect = rectified_checks(eu, dev, gpu)
    print(f"[settings] check seconds: fisheye card vs CPU and KB8 timing {t1 - t0:.1f}, "
          f"keyframe stack {t2 - t1:.1f}, rectified checks {time.perf_counter() - t2:.1f}")
    # K1 at the right-camera call site and K2 on the rectified session's
    # inputs: time, device time, plain time and bound
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    a1, kw1 = fe["rec"]["k1_right"]
    a2, kw2 = eu["rec"]["k2_stereo"]
    rows = {}
    for kname, fn, plain, bound, N, prof_name in (
            ("K1_right", lambda: mk.search_by_projection_kernel(*a1, **kw1),
             lambda: mk.search_by_projection_plain(*a1, **kw1), k1_bound(a1), a1[0].shape[0],
             "match_kernel"),
            ("K2_rectified", lambda: pk.pose_ba(*a2, **kw2), lambda: pk.pose_ba_plain(*a2, **kw2),
             k2_bound(a2, kw2), a2[3].shape[1], "pose_kernel")):
        b_ms, b_by = bound_ms(*bound)
        dev_ms, dev_by = device_kernel_ms(fn, prof_name)
        rows[kname] = dict(N=int(N), ms=time_ms(fn, runs=20), device_ms=dev_ms,
                           device_ms_by=dev_by, plain_ms=time_ms(plain, runs=3, warmup=1),
                           bound_ms=b_ms, bound_by=b_by)
        print(f"[settings timing] {gpu}: {kname} (N={N}): {rows[kname]['ms']:.4f} ms per call, "
              f"device {dev_ms:.5f} ms, plain {rows[kname]['plain_ms']:.3f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in ("K1", "K2", "K2_stereo", "K1 right", "K1 fuse")}
    out.update(failed=failed, launches=launches, kb8=kb8, rectified=rect,
               keyframe_stack=kf_stack, call_sites=rows,
               err={"K1": max(kb8["err_k1"], rect["err_k1"]), "K2": rect["err_k2"]})
    return out


# ---------------------------------------------------------------- phase 11
LOOP_K = (450.0, 450.0, 376.0, 240.0)
LOOP_FRAMES, LOOP_RADIUS, LOOP_TURNS = 110, 1.6, 1.12
RELOC_FRAMES, MERGE_FRAMES = 14, 24


def loop_sessions():
    """(name, frames, R_gt, t_gt, cfg fields, vocabulary views, until) of
    phase 11's three sessions: tests/test_loop_reloc.py's relocalization
    (PlaneScene seed 5: 14 frames, 3 blank frames, a resume at frame 6's
    view) and multimap merge (seed 6 along the orbit with advance 0.05: 24
    frames, 7 blank ones, a resume over frames 40 -> 6 in steps of 2 until
    the maps merge), and tests/test_loop_closing.py's closed loop (the numpy
    room scene, seed 3, exposure jitter 0.04, 110 frames of 1.12 turns).
    The closed loop runs on the free-running schedule (the background
    mapper's thread), the other two on the synchronous one.
    Every frame is an (image, depth map) pair at 752x480, ray-cast on the
    card (entry.QuadScene; the plane scenes as entry.plane_quads, within
    0.005 grey levels of entry.render_with_depth); the vocabulary views are
    held out (the first 3 orbit views, or 4 views of a smaller circle)."""
    import numpy as np

    from orb_slam3_tpu_torch import entry

    K, wh = entry.FULL_K, entry.FULL_WH
    blank = (np.zeros((wh[1], wh[0]), np.float32), np.ones((wh[1], wh[0]), np.float32))
    out = [reloc_session(dict(kf_max_frames=5, **SYNC))]
    scene = entry.QuadScene(K, wh, entry.plane_quads(entry.plane_scene(6)))
    R, t = entry.orbit_trajectory(60, advance=0.05)
    frames = [scene.render_with_depth(R[i], t[i])
              for i in list(range(MERGE_FRAMES)) + list(range(40, 4, -2))]
    R3, t3 = entry.orbit_trajectory(3)
    views = [scene.render(R3[i], t3[i]) for i in range(3)]
    out.append(("merge-full", frames[:MERGE_FRAMES] + [blank] * 7 + frames[MERGE_FRAMES:],
                R, t, dict(kf_max_frames=2, **SYNC), views,
                lambda sys_: sys_.tracker.loop_closer.n_merges > 0))
    scene = entry.room_scene(np.array(LOOP_K), img_wh=wh, seed=3, exposure_jitter=0.04)
    Rv, tv = entry.loop_trajectory(4, radius=1.0, start_angle=0.4)
    views = [scene.render(Rv[i], tv[i]) for i in range(4)]
    R, t = entry.loop_trajectory(LOOP_FRAMES, radius=LOOP_RADIUS, loops=LOOP_TURNS)
    frames = [scene.render_with_depth(R[i], t[i]) for i in range(LOOP_FRAMES)]
    # the closed loop on the free-running schedule (the TrackerConfig
    # defaults: the background mapper thread, pipeline depth 6)
    out.append(("loop-full", frames, R, t, dict(kf_max_frames=2), views, None))
    return out


def reloc_session(fields):
    """reloc-full's (name, frames, R_gt, t_gt, cfg fields, vocabulary views,
    until): tests/test_loop_reloc.py's blackout, PlaneScene seed 5, 14
    frames, 3 blank frames, a resume at frame 6's view."""
    import numpy as np

    from orb_slam3_tpu_torch import entry

    K, wh = entry.FULL_K, entry.FULL_WH
    blank = (np.zeros((wh[1], wh[0]), np.float32), np.ones((wh[1], wh[0]), np.float32))
    scene = entry.QuadScene(K, wh, entry.plane_quads(entry.plane_scene(5)))
    R, t = entry.orbit_trajectory(RELOC_FRAMES)
    frames = [scene.render_with_depth(R[i], t[i]) for i in list(range(RELOC_FRAMES)) + [6]]
    return ("reloc-full", frames[:RELOC_FRAMES] + [blank] * 3 + frames[-1:], R, t, fields,
            [f[0] for f in frames[:3]], None)


def kf_ate(s, R_gt, t_gt, dt=0.05):
    """tests/test_loop_closing.py's _kf_ate: unscaled RMS ATE of the valid
    keyframes against the truth, matched by timestamp."""
    import numpy as np

    from orb_slam3_tpu_torch.api import evaluate

    rows = np.flatnonzero(s.kf_valid.cpu().numpy())
    idx = np.clip(np.round(s.kf_timestamp.cpu().numpy()[rows] / dt).astype(int), 0,
                  len(R_gt) - 1)
    est = evaluate.camera_centers(s.kf_R.cpu().numpy()[rows], s.kf_t.cpu().numpy()[rows])
    gt = evaluate.camera_centers(R_gt[idx], t_gt[idx])
    return evaluate.ate_rmse(idx.astype(float), est, idx.astype(float), gt, with_scale=False)[0]


def run_loop_session(dev, name, frames, R_gt, t_gt, fields, views, until):
    """One phase-11 session through entry.slam(vocabulary=...) ->
    System.track_rgbd, the launch counters zeroed just before it, every
    stage of the stage timer synchronised at its end. Records each frame's
    time and launches; K1's launches inside merge_duplicates_at_keyframe
    (the merge site) and the last call's inputs; K2's launches inside the
    relocalization and that call's inputs; each relocalization attempt's
    time and outcome; the state after every frame that the gates read. The
    launches of a call site count the launching thread's own (K1's fuse and
    merge sites run on the mapper thread in an asynchronous session)."""
    import contextlib
    import threading

    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.mapping import fuse
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    cfg = entry.tracker_config(dev, sensor="rgbd", bf=450.0 * 0.1, th_depth=20.0, **fields)
    t0 = time.perf_counter()
    voc = entry.train_vocabulary(views, cfg)
    voc_s = time.perf_counter() - t0
    rec = {"frames": [], "k1_merge": None, "merge_call": None, "k2_reloc": None,
           "reloc": [], "states": [], "n_maps": [], "ate_pre": None,
           "sites": {"K1 merge": 0, "K1 fuse": 0, "K2 reloc": 0}}
    o = dict(k1=mk.search_by_projection_kernel, k2=pk.pose_ba, fuse=fuse.fuse_into_keyframe,
             merge=fuse.merge_duplicates_at_keyframe, reloc=tracker.Tracker._try_relocalize,
             stage=GLOBAL_TIMER.stage)
    site = threading.local()

    def own(mod):
        return mod.launches_by_thread.get(threading.current_thread().name, 0)

    def k1_rec(*a, **kw):
        if getattr(site, "name", None) == "merge":
            rec["k1_merge"] = (a, kw)
        return o["k1"](*a, **kw)

    def k2_rec(*a, **kw):
        if getattr(site, "name", None) == "reloc":
            rec["k2_reloc"] = (a, kw)
        return o["k2"](*a, **kw)

    def fuse_rec(*a, **kw):
        n0 = own(mk)
        try:
            return o["fuse"](*a, **kw)
        finally:
            rec["sites"]["K1 fuse"] += own(mk) - n0

    def merge_rec(kind, K8, s, row, sf, **kw):
        rec["merge_call"] = (kind, K8, s, row, sf, kw)
        site.name, n0 = "merge", own(mk)
        try:
            return o["merge"](kind, K8, s, row, sf, **kw)
        finally:
            rec["sites"]["K1 merge"] += own(mk) - n0
            site.name = None

    def reloc_rec(self, feats):
        site.name, n0 = "reloc", own(pk)
        torch.cuda.current_stream().synchronize()
        t1 = time.perf_counter()
        try:
            ok = o["reloc"](self, feats)
        finally:
            torch.cuda.current_stream().synchronize()
            rec["sites"]["K2 reloc"] += own(pk) - n0
            site.name = None
        rec["reloc"].append(dict(ms=(time.perf_counter() - t1) * 1e3, ok=ok))
        return ok

    n1 = int(LOOP_FRAMES / LOOP_TURNS * 0.72)

    def after_frame(sys_):
        tr = sys_.tracker
        rec["states"].append(tr.state)
        rec["n_maps"].append(int(tr.map.n_maps))
        if name == "loop-full" and len(rec["states"]) == n1:
            # the map of the loop's first part, measured at a barrier on
            # the asynchronous schedule (every queued keyframe mapped)
            tr.sync_mapping()
            rec["ate_pre"] = kf_ate(tr.map, R_gt, t_gt)
            rec["state_pre"] = tr.state
        return until is not None and until(sys_)

    def n_keyframes():
        return (len(GLOBAL_TIMER.samples["track.kf_insert_sync"])
                + len(GLOBAL_TIMER.samples["track.kf_request"]))

    def frame_timer(_name):
        # the tracker's own stream: an asynchronous session's frame does
        # not wait for the mapper's
        @contextlib.contextmanager
        def part():
            n_kf = n_keyframes()
            k = (own(mk), own(pk), rec["sites"]["K1 merge"], rec["sites"]["K2 reloc"])
            torch.cuda.current_stream().synchronize()
            t1 = time.perf_counter()
            yield
            torch.cuda.current_stream().synchronize()
            rec["frames"].append(dict(
                ms=(time.perf_counter() - t1) * 1e3, kf=n_keyframes() > n_kf,
                k1=own(mk) - k[0], k2=own(pk) - k[1],
                k1_merge=rec["sites"]["K1 merge"] - k[2], k2_reloc=rec["sites"]["K2 reloc"] - k[3]))
        return part()

    GLOBAL_TIMER.reset()
    mk.search_by_projection_kernel, pk.pose_ba = k1_rec, k2_rec
    fuse.fuse_into_keyframe, fuse.merge_duplicates_at_keyframe = fuse_rec, merge_rec
    tracker.Tracker._try_relocalize = reloc_rec
    GLOBAL_TIMER.stage = lambda stage_name: GLOBAL_TIMER.stage_sync(stage_name, dev)
    try:
        mk.launches = pk.launches = 0
        mk.launches_by_thread.clear()
        pk.launches_by_thread.clear()
        t0 = time.perf_counter()
        system = entry.slam(frames, cfg, vocabulary=voc, timer=frame_timer, until=after_frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches, **rec["sites"],
                    "K1 mapper thread": mk.launches_by_thread.get("mapper", 0)}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba = o["k1"], o["k2"]
        fuse.fuse_into_keyframe, fuse.merge_duplicates_at_keyframe = o["fuse"], o["merge"]
        tracker.Tracker._try_relocalize = o["reloc"]
        GLOBAL_TIMER.stage = o["stage"]
    tr = system.tracker
    m = tr.async_mapper
    gba = tr.gba if tr.gba is not None else (m.gba if m is not None else None)
    gba_s = None
    if gba is not None:
        t1 = time.perf_counter()
        gba.join(timeout=600)  # the background campaign of the session's loop
        gba_s = time.perf_counter() - t1
        check(not gba.failed, f"{name}: the background global BA failed: {gba.error}")
    schedule = ("the free-running mapper thread, pipeline depth "
                f"{tr.cfg.pipeline_depth}" if tr.cfg.async_mapping else "synchronous")
    mapper = (f"; mapper: {m.n_processed} packages, {m.n_ba_runs} BAs, {m.n_ba_skips} skipped, "
              f"longest queue {m.max_queue_seen}" if m is not None else "")
    print(f"[loop {name}] schedule: {schedule}{mapper}")
    print(f"[loop {name}] vocabulary trained in {voc_s:.1f} s ({voc.n_words} words); main path "
          f"(entry.slam(vocabulary) -> System.track_rgbd, {len(rec['frames'])} frames): "
          f"{wall:.2f} s; launches {launches}; loops {tr.loop_closer.n_loops}, merges "
          f"{tr.loop_closer.n_merges}; relocalizations {[r['ok'] for r in rec['reloc']]}; "
          f"background GBA waited {gba_s} s")
    return dict(system=system, cfg=cfg, R_gt=R_gt, t_gt=t_gt, rec=rec, launches=launches,
                samples={k: list(v) for k, v in GLOBAL_TIMER.samples.items()}, wall_s=wall)


def loop_gates(name, run):
    """The gates of tests/test_loop_reloc.py / tests/test_loop_closing.py
    for the session. Returns (failed, summary)."""
    import numpy as np

    from orb_slam3_tpu_torch.api import evaluate
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.tracking import tracker

    tr, rec = run["system"].tracker, run["rec"]
    s = tr.map
    lost = (tracker.RECENTLY_LOST, tracker.LOST)
    summary = dict(state=tr.state, frames=len(rec["frames"]), n_kf=int(s.kf_valid.sum()),
                   n_maps=int(s.n_maps), loops=tr.loop_closer.n_loops,
                   merges=tr.loop_closer.n_merges)
    if name == "reloc-full":
        est = evaluate.camera_centers(tr.last["R"].cpu().numpy()[None],
                                      tr.last["t"].cpu().numpy()[None])[0]
        gt = evaluate.camera_centers(run["R_gt"][6][None], run["t_gt"][6][None])[0]
        summary["centre_err"] = float(np.linalg.norm(est - gt))
        conds = [(rec["states"][RELOC_FRAMES - 1] == tracker.OK, "not OK before the blackout"),
                 (rec["states"][RELOC_FRAMES + 2] in lost,
                  f"state {rec['states'][RELOC_FRAMES + 2]} after the blank frames"),
                 (tr.state == tracker.OK, f"state {tr.state} after the resume"),
                 (summary["centre_err"] < 0.15, f"camera centre {summary['centre_err']:.4f} off"),
                 (int(s.n_maps) == 1, f"{int(s.n_maps)} maps")]
    elif name == "merge-full":
        ids = s.kf_map_id.cpu().numpy()[s.kf_valid.cpu().numpy()]
        summary["map_ids"] = sorted(set(ids.tolist()))
        conds = [(rec["states"][MERGE_FRAMES - 1] == tracker.OK, "not OK before the blackout"),
                 (rec["n_maps"][MERGE_FRAMES + 6] == 2,
                  f"{rec['n_maps'][MERGE_FRAMES + 6]} maps after the blackout"),
                 (tr.loop_closer.n_merges >= 1, "the maps never merged"),
                 (len(summary["map_ids"]) == 1, f"map ids {summary['map_ids']} at the end")]
    else:
        ate_pre, ate_post = rec["ate_pre"], kf_ate(s, run["R_gt"], run["t_gt"])
        ok = tr.poses()[3]
        summary.update(ate_pre=ate_pre, ate_post=ate_post, last10_tracked=bool(ok[-10:].all()),
                       violations=invariants.check_all(s), async_mapping=tr.cfg.async_mapping)
        # tests/test_loop_closing.py's gates, and on the free-running
        # schedule tests/test_async_accuracy.py::test_async_loop_closing's
        conds = [(tr.cfg.async_mapping, "loop-full is not on the free-running schedule"),
                 (tr.loop_closer.n_loops + tr.loop_closer.n_merges >= 1,
                  "no loop or merge closed on the free-running schedule"),
                 (ate_post < 0.20, f"async post-loop keyframe ATE {ate_post:.4f} (gate 0.20)"),
                 (rec.get("state_pre") == tracker.OK, "not OK after phase 1"),
                 (ate_pre < 0.10, f"phase-1 keyframe ATE {ate_pre:.4f}"),
                 (tr.loop_closer.n_loops >= 1, "no loop closed"),
                 (ate_post < max(1.05 * ate_pre, 0.05),
                  f"ATE worsened across the loop: {ate_pre:.4f} -> {ate_post:.4f}"),
                 (ate_post < 0.12, f"post-loop ATE {ate_post:.4f}"),
                 (summary["last10_tracked"], "tracking lost in the last 10 frames"),
                 (not summary["violations"], f"invariants: {summary['violations'][:3]}")]
    failed = [f"{name}: {msg}" for cond, msg in conds if not cond]
    for msg in failed:
        print(f"[loop] GATE FAILED: {msg}")
    print(f"[loop {name}] " + ", ".join(f"{k} {v}" for k, v in summary.items()
                                      if k != "violations"))
    return failed, summary


def merge_site_checks(run, gpu):
    """K1 at the merge site exactly equal to its plain version on the last
    merge call's inputs, and that merge_duplicates_at_keyframe from the same
    state on the card and on the CPU plain path: the same kf_feat_lm,
    lm_valid and pair count."""
    import dataclasses

    import torch

    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.mapping import fuse

    a1, kw1 = run["rec"]["k1_merge"]
    err, n_ok = compare_k1(mk.search_by_projection_kernel(*a1, **kw1),
                           mk.search_by_projection_plain(*a1, **kw1))
    kind, K8, s, row, sf, kw = run["rec"]["merge_call"]
    sg, ng = fuse.merge_duplicates_at_keyframe(kind, K8, s, row, sf, **kw)
    s_cpu = dataclasses.replace(s, **{f.name: getattr(s, f.name).cpu()
                                      for f in dataclasses.fields(s)})
    sc, nc = fuse.merge_duplicates_at_keyframe(kind, K8.cpu(), s_cpu, row, sf.cpu(), **kw)
    same = (torch.equal(sg.kf_feat_lm.cpu(), sc.kf_feat_lm)
            and torch.equal(sg.lm_valid.cpu(), sc.lm_valid) and int(ng) == int(nc))
    check(same, f"merge_duplicates_at_keyframe card vs CPU: pairs {int(ng)} vs {int(nc)}, "
          f"kf_feat_lm equal {torch.equal(sg.kf_feat_lm.cpu(), sc.kf_feat_lm)}, lm_valid equal "
          f"{torch.equal(sg.lm_valid.cpu(), sc.lm_valid)}")
    print(f"[loop] {gpu}: K1 at the merge site == plain (N={a1[0].shape[0]}, M={a1[4].shape[0]},"
          f" {int(a1[3].sum())} projected, {n_ok} matched); merge_duplicates_at_keyframe on "
          f"keyframe {row}: card == CPU plain ({int(ng)} duplicate pairs)")
    return err, int(ng)


def phase_loop(dev, gpu):
    """Phase 11: relocalization, loop closing and map merging at full width
    (reloc-full, loop-full, merge-full) with their gates, K1 at the merge
    site and K2 at the relocalization site against their plain versions on
    the sessions' inputs, the merge on the card against the CPU plain path,
    the timings, and System.run_global_ba on the loop map."""
    import statistics

    import torch

    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    t0 = time.perf_counter()
    sessions = loop_sessions()
    print(f"[loop] frames and vocabulary views rendered in {time.perf_counter() - t0:.1f} s")
    runs, failed, out = {}, [], {"sessions": {}}
    for name, frames, R_gt, t_gt, fields, views, until in sessions:
        t_s = time.perf_counter()
        run = runs[name] = run_loop_session(dev, name, frames, R_gt, t_gt, fields, views, until)
        f, summary = loop_gates(name, run)
        failed += f
        fr, s = run["rec"]["frames"], run["samples"]
        plain = [x["ms"] for x in fr[1:] if not x["kf"]]
        kf = [x["ms"] for x in fr[1:] if x["kf"]]
        timing = dict(
            frame_ms=med(plain), keyframe_frame_ms=med(kf), keyframe_frames=len(kf),
            # (the mapper thread brackets the loop closer as map.loop_detect)
            on_keyframe_ms=med(s.get("loop.on_keyframe", []) or s.get("map.loop_detect", [])),
            on_keyframe_query_ms=med(s.get("loop.query", [])),
            on_keyframe_cascade_ms=med(s.get("loop.cascade", [])),
            correction_ms={k.split(".")[-1]: s[k] for k in (
                "loop.correct.transport", "loop.correct.essential_graph",
                "loop.correct.fuse_window") if k in s},
            reloc_attempt_ms=[r["ms"] for r in run["rec"]["reloc"]],
            stages={k: med(s.get(k, [])) for k in (
                "orb_extraction", "track.stereo_depth", "track.fused_step", "map.pre",
                "map.local_ba", "map.culling")})
        print(f"[loop timing] {gpu}: {name}: frame without a keyframe median {timing['frame_ms']}"
              f" ms over {len(plain)}; keyframe frame median {timing['keyframe_frame_ms']} ms "
              f"over {len(kf)}; on_keyframe median {timing['on_keyframe_ms']} ms (query "
              f"{timing['on_keyframe_query_ms']}, cascade {timing['on_keyframe_cascade_ms']} "
              f"per call); correction parts {timing['correction_ms']}; relocalization attempts "
              f"{timing['reloc_attempt_ms']} ms; stage medians {timing['stages']}; launches "
              f"{run['launches']}")
        out["sessions"][name] = dict(summary, launches=run["launches"], wall_s=run["wall_s"],
                                     **timing)
        print(f"[loop {name}] session with its gates: {time.perf_counter() - t_s:.1f} s")
    loop, reloc, merge = runs["loop-full"], runs["reloc-full"], runs["merge-full"]
    for nm, r in (("loop-full", loop), ("merge-full", merge)):
        check(r["launches"]["K1 merge"] >= 1, f"{nm}: K1 never launched at the merge site")
    check(reloc["launches"]["K2 reloc"] >= 1, "reloc-full: K2 never launched at the reloc site")
    err_k1, n_pairs = merge_site_checks(loop, gpu)
    a2, kw2 = reloc["rec"]["k2_reloc"]
    err_k2 = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2),
                        "relocalization site")
    print(f"[loop] {gpu}: K2 at the relocalization site vs plain (N={a2[3].shape[1]}, "
          f"{int(a2[6].sum())} valid rows): max |err| {err_k2:.3g}")
    # global BA on the loop map, synchronously, after the session
    sys_ = loop["system"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sys_.run_global_ba()
    torch.cuda.synchronize()
    gba_ms = (time.perf_counter() - t1) * 1e3
    out["run_global_ba_ms"] = gba_ms
    out["run_global_ba_keyframes"] = int(sys_.tracker.map.kf_valid.sum())
    print(f"[loop timing] {gpu}: System.run_global_ba on the loop map "
          f"({out['run_global_ba_keyframes']} keyframes, 10 iterations): {gba_ms:.1f} ms")
    for r in runs.values():
        r["system"].shutdown()
    rows = {}
    a1, kw1 = loop["rec"]["k1_merge"]
    for kname, fn, plain, bound, N, prof_name in (
            ("K1_merge", lambda: mk.search_by_projection_kernel(*a1, **kw1),
             lambda: mk.search_by_projection_plain(*a1, **kw1), k1_bound(a1), a1[0].shape[0],
             "match_kernel"),
            ("K2_reloc", lambda: pk.pose_ba(*a2, **kw2), lambda: pk.pose_ba_plain(*a2, **kw2),
             k2_bound(a2, kw2), a2[3].shape[1], "pose_kernel")):
        b_ms, b_by = bound_ms(*bound)
        dev_ms, dev_by = device_kernel_ms(fn, prof_name)
        rows[kname] = dict(N=int(N), ms=time_ms(fn, runs=20), device_ms=dev_ms,
                           device_ms_by=dev_by, plain_ms=time_ms(plain, runs=3, warmup=1),
                           bound_ms=b_ms, bound_by=b_by)
        print(f"[loop timing] {gpu}: {kname} (N={N}): {rows[kname]['ms']:.4f} ms per call, "
              f"device {dev_ms:.5f} ms ({dev_by}), plain {rows[kname]['plain_ms']:.3f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in ("K1", "K2", "K1 merge", "K1 fuse", "K2 reloc", "K1 mapper thread")}
    out.update(failed=failed, launches=launches, call_sites=rows, merge_pairs=n_pairs,
               err={"K1": err_k1, "K2": err_k2})
    return out


# ---------------------------------------------------------------- phase 12
# (name, sensor, PlaneScene seed, frames): tests/test_slam_vi.py's session
# (two planes, seed 3, 160 frames at 10 fps, 200 Hz IMU) and the two
# sessions of tests/test_slam_vi_depth.py (seeds 8 and 9, 36 frames, a
# gentle lead-in of 6 frames), at their 512x384, K = (350, 350, 256, 192),
# kmax 64, lmax 8192, window 6, kf_max_frames 3, with ORB at
# OrbConfig(1000, 8)
VI_SESSIONS = (("vi-mono-full", "mono-imu", 3, 160), ("vi-stereo-full", "stereo-imu", 8, 36),
               ("vi-rgbd-full", "rgbd-imu", 9, 36))
VI_WH, VI_K, VI_BASELINE, VI_GENTLE = (512, 384), (350.0, 350.0, 256.0, 192.0), 0.12, 6


def vi_frames(sensor, seed, n):
    """The session's frames (rendered in numpy on a thread pool), truth and
    IMU packets: frame i is taken at (i + 1) / 10 s with packet i."""
    from concurrent.futures import ThreadPoolExecutor

    from orb_slam3_tpu_torch import entry

    planes = entry.plane_scene(seed)
    if sensor == "mono-imu":
        R, t, imu = entry.vi_render_trajectory(n)
        render = lambda i: entry.render_planes(planes, VI_K, VI_WH, R[i], t[i])  # noqa: E731
    else:
        R, t, imu = entry.vi_depth_trajectory(n, n_gentle=VI_GENTLE)
        if sensor == "stereo-imu":
            render = lambda i: entry.render_stereo(  # noqa: E731
                planes, VI_K, VI_WH, R[i], t[i], VI_BASELINE)
        else:
            render = lambda i: entry.render_with_depth(  # noqa: E731
                planes, VI_K, VI_WH, R[i], t[i])
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(render, range(n))), R, t, imu


def _imu_snapshot(imu):
    """A copy of an ImuState that later frames do not change."""
    import copy

    c = copy.copy(imu)
    c.kf_buffers = dict(imu.kf_buffers)
    c._cur = tuple(list(x) for x in imu._cur)
    return c


def run_vi_session(dev, name, sensor, seed, n):
    """One phase-12 session through entry.slam (System.track_* with the IMU
    packets), the launch counters zeroed just before it, every stage of the
    stage timer synchronised. Records per frame its time, launches and
    whether the IMU was initialized; the K1 / K2 inputs at the inertial
    tracking site (the first call of the last inertial frame: the window
    at the IMU's prediction), K1's inputs at the last fuse_recent call, the
    last pose_inertial_optimize call, the state before the last
    run_vi_local_ba, each inertial init / refinement's time and event, and
    one inertial keyframe under the profiler."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.mapping import fuse
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker as trk
    from orb_slam3_tpu_torch.tracking import vi_pose_opt, vi_tracker
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    t0 = time.perf_counter()
    frames, R_gt, t_gt, imu = vi_frames(sensor, seed, n)
    render_s = time.perf_counter() - t0
    base = sensor.split("-")[0]
    cfg = entry.tracker_config(dev, img_wh=VI_WH, K=VI_K, sensor=sensor,
                               orb=orb.OrbConfig(n_features=1000, n_levels=8), kmax=64, lmax=8192,
                               local_window=6, kf_max_frames=3, **SYNC,
                               **({} if base == "mono" else dict(bf=VI_K[0] * VI_BASELINE)))
    rec = {"frames": [], "site": None, "k1_fuse": None, "vpo": None, "vba": None,
           "events": [], "kf_profile": None, "states": [],
           "sites": {"K1 inertial": 0, "K2 inertial": 0, "K1 fuse": 0}}
    flags = {"inertial": False, "first": None, "fuse": False}
    k1_orig, k2_orig, fuse_orig = mk.search_by_projection_kernel, pk.pose_ba, fuse.fuse_into_keyframe
    vpo_orig, vba_orig = vi_pose_opt.pose_inertial_optimize, vi_tracker.run_vi_local_ba
    init_orig, refine_orig = vi_tracker.try_initialize_imu, vi_tracker.try_refine_imu
    inertial_orig = trk.Tracker._track_frame_inertial
    kf_orig = trk.Tracker._insert_keyframe_inertial
    stage_orig = GLOBAL_TIMER.stage

    def k1_rec(*a, **kw):
        if flags["fuse"]:
            rec["k1_fuse"] = (a, kw)
            rec["sites"]["K1 fuse"] += 1
        elif flags["inertial"]:
            rec["sites"]["K1 inertial"] += 1
            if flags["first"] is not None and flags["first"][0] is None:
                flags["first"][0] = (a, kw)
        return k1_orig(*a, **kw)

    def k2_rec(*a, **kw):
        if flags["inertial"]:
            rec["sites"]["K2 inertial"] += 1
            if flags["first"] is not None and flags["first"][1] is None:
                flags["first"][1] = (a, kw)
        return k2_orig(*a, **kw)

    def fuse_rec(*a, **kw):
        flags["fuse"] = True
        try:
            return fuse_orig(*a, **kw)
        finally:
            flags["fuse"] = False

    def inertial_rec(self, *a, **kw):
        flags["inertial"], flags["first"] = True, [None, None]
        try:
            return inertial_orig(self, *a, **kw)
        finally:
            flags["inertial"] = False
            if flags["first"][0] is not None and flags["first"][1] is not None:
                rec["site"] = tuple(flags["first"])
            flags["first"] = None

    def vpo_rec(*a, **kw):
        rec["vpo"] = (a, kw)
        return vpo_orig(*a, **kw)

    def vba_rec(tracker, rows, n_fixed, **kw):
        if not kw:  # the keyframe's local VI BA (the full BAs pass their priors)
            rec["vba"] = dict(map=tracker.map, imu=_imu_snapshot(tracker.imu), rows=rows,
                              n_fixed=n_fixed, cfg=tracker.cfg, sf=tracker.scale_factors)
        return vba_orig(tracker, rows, n_fixed, **kw)

    def timed(fn, kind):
        def call(tracker, *a, **kw):
            n_ev = len(tracker.debug_events)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(tracker, *a, **kw)
            torch.cuda.synchronize()
            for e in tracker.debug_events[n_ev:]:
                if "scale" in e:
                    rec["events"].append(dict(kind=kind, event=e["event"], scale=e["scale"],
                                              ms=(time.perf_counter() - t1) * 1e3))
                    break
            return out
        return call

    def kf_rec(self, *a, **kw):
        if rec["kf_profile"] is not None or not self.imu.initialized or self.imu.viba_stage < 1:
            return kf_orig(self, *a, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            out = kf_orig(self, *a, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        busy_ms, n_kernels, _ = device_busy(prof)
        rec["kf_profile"] = dict(ms=wall, busy_ms=busy_ms, kernels=n_kernels,
                                 busy_share=None if busy_ms is None else busy_ms / wall)
        return out

    def frame_timer(name_):
        @contextlib.contextmanager
        def part():
            n_kf = len(GLOBAL_TIMER.samples["track.kf_insert_sync"])
            k = (mk.launches, pk.launches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            rec["frames"].append(dict(
                ms=(time.perf_counter() - t1) * 1e3,
                kf=len(GLOBAL_TIMER.samples["track.kf_insert_sync"]) > n_kf,
                k1=mk.launches - k[0], k2=pk.launches - k[1]))
        return part()

    def until(system):
        tr = system.tracker
        rec["states"].append(tr.state)
        rec["frames"][-1].update(imu_init=tr.imu.initialized, ok=tr.state == trk.OK)
        return False

    GLOBAL_TIMER.reset()
    mk.search_by_projection_kernel, pk.pose_ba, fuse.fuse_into_keyframe = k1_rec, k2_rec, fuse_rec
    vi_pose_opt.pose_inertial_optimize, vi_tracker.run_vi_local_ba = vpo_rec, vba_rec
    vi_tracker.try_initialize_imu = timed(init_orig, "init")
    vi_tracker.try_refine_imu = timed(refine_orig, "refine")
    trk.Tracker._track_frame_inertial, trk.Tracker._insert_keyframe_inertial = inertial_rec, kf_rec
    GLOBAL_TIMER.stage = lambda stage_name: GLOBAL_TIMER.stage_sync(stage_name, dev)
    try:
        mk.launches = pk.launches = pk.stereo_launches = 0
        t0 = time.perf_counter()
        system = entry.slam(frames, cfg, timer=frame_timer, imu=imu, until=until,
                            timestamps=[(i + 1) / 10.0 for i in range(n)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches, "K2_stereo": pk.stereo_launches,
                    **rec["sites"]}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba, fuse.fuse_into_keyframe = (
            k1_orig, k2_orig, fuse_orig)
        vi_pose_opt.pose_inertial_optimize, vi_tracker.run_vi_local_ba = vpo_orig, vba_orig
        vi_tracker.try_initialize_imu, vi_tracker.try_refine_imu = init_orig, refine_orig
        trk.Tracker._track_frame_inertial, trk.Tracker._insert_keyframe_inertial = (
            inertial_orig, kf_orig)
        GLOBAL_TIMER.stage = stage_orig
    samples = {k: list(v) for k, v in GLOBAL_TIMER.samples.items()}
    print(f"[vi {name}] {n} frames rendered in {render_s:.1f} s; main path (entry.slam -> "
          f"System.track_{base}(..., imu=...)): {wall:.2f} s; launches {launches}")
    return dict(system=system, cfg=cfg, R_gt=R_gt, t_gt=t_gt, rec=rec, samples=samples,
                launches=launches, wall_s=wall)


def vi_gates(name, run):
    """The gates of tests/test_slam_vi.py (mono) and tests/test_slam_vi_depth.py
    (stereo, RGB-D). Returns (failed, summary)."""
    import numpy as np

    from orb_slam3_tpu_torch.api import evaluate
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.tracking import tracker as trk

    tr = run["system"].tracker
    ts, R, t, ok = tr.poses()
    n = len(ok)
    est = evaluate.camera_centers(R[ok], t[ok])
    gt = evaluate.camera_centers(run["R_gt"][ok], run["t_gt"][ok])
    rmse, _, _ = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=False)
    summary = dict(tracked=int(ok.sum()), frames=n, n_kf=int(tr.map.kf_valid.sum()),
                   landmarks=int(tr.map.lm_valid.sum()), imu_initialized=tr.imu.initialized,
                   imu_bad=tr.imu.bad, viba_stage=tr.imu.viba_stage, ate=rmse,
                   events=[(e["event"], round(e["scale"], 5)) for e in tr.debug_events
                           if "scale" in e],
                   violations=invariants.check_all(tr.map))
    conds = [(ok.sum() >= 0.6 * n, f"only {int(ok.sum())} of {n} frames tracked"),
             (tr.imu.initialized, "IMU never initialized"),
             (not summary["violations"], f"invariants: {summary['violations'][:3]}")]
    if name == "vi-mono-full":
        _, _, s_fit = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=True)
        summary["scale_fit"] = s_fit
        conds += [(abs(s_fit - 1.0) < 0.05, f"metric scale off: {s_fit:.4f}"),
                  (tr.imu.viba_stage >= 1, "VIBA1 never ran"),
                  (rmse < 0.5, f"unscaled ATE {rmse:.4f} (gate 0.5)")]
    else:
        states = run["rec"]["states"]
        conds += [(states[VI_GENTLE - 2] == trk.NOT_INITIALIZED,
                   "map anchored without accelerometer excitation"),
                  (not tr.imu.bad, "bad IMU"),
                  (rmse < 0.25, f"unscaled ATE {rmse:.4f} (gate 0.25)")]
    failed = [f"{name}: {msg}" for cond, msg in conds if not cond]
    for msg in failed:
        print(f"[vi] GATE FAILED: {msg}")
    print(f"[vi {name}] " + ", ".join(f"{k} {v}" for k, v in summary.items()
                                     if k != "violations")
          + f", invariant violations {len(summary['violations'])}")
    return failed, summary


def _vi_solvers_vs_cpu(run, gpu):
    """The last keyframe's run_vi_local_ba and the last
    pose_inertial_optimize rerun on the card and on the CPU from the same
    state: poses within 1e-3 (BA) / 1e-4 (tracking), velocities within
    1e-2 / 1e-3, biases within 1e-3 / 1e-4; the pose-inertial call timed and
    its CUDA kernels counted."""
    import dataclasses
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_tpu_torch.tracking import vi_pose_opt, vi_tracker

    def mv(x, dev):
        if isinstance(x, dict):
            return {k: mv(v, dev) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(mv(v, dev) for v in x)
        return x.to(dev) if torch.is_tensor(x) else x

    out = {}
    # the keyframe's visual-inertial local BA
    v = run["rec"]["vba"]
    maps = {}
    for dev in ("cuda", "cpu"):
        imu = _imu_snapshot(v["imu"])
        imu.device = torch.device(dev)
        for k in ("Rbc", "tbc", "bg", "ba", "vel"):
            setattr(imu, k, getattr(imu, k).to(dev))
        stub = types.SimpleNamespace(cfg=dataclasses.replace(v["cfg"], K=v["cfg"].K.to(dev)),
                                     imu=imu, map=_on(v["map"], dev), scale_factors=v["sf"].to(dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        check(vi_tracker.run_vi_local_ba(stub, v["rows"], v["n_fixed"]), "VI BA rerun refused")
        torch.cuda.synchronize()
        out[f"vi_local_ba_{dev}_ms"] = (time.perf_counter() - t1) * 1e3
        maps[dev] = stub.map
    g, c = maps["cuda"], maps["cpu"]
    rows = sorted(set(int(r) for r in v["rows"]))
    diffs = {k: float((getattr(g, k).cpu()[rows] - getattr(c, k)[rows]).abs().max())
             for k in ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")}
    tol = {"kf_R": 1e-3, "kf_t": 1e-3, "kf_vel": 1e-2, "kf_bg": 1e-3, "kf_ba": 1e-3}
    for k, d in diffs.items():
        check(d <= tol[k], f"run_vi_local_ba card vs CPU: {k} differs by {d:.3g}")
    out["vi_local_ba_diff"] = diffs
    # the tracking-time pose-inertial optimization
    a, kw = run["rec"]["vpo"]
    res = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res[dev] = vi_pose_opt.pose_inertial_optimize(*mv(a, dev), **mv(kw, dev))
        torch.cuda.synchronize()
        out[f"pose_inertial_{dev}_ms"] = (time.perf_counter() - t1) * 1e3
    vd = {k: float((res["cuda"][0][k].cpu() - res["cpu"][0][k]).abs().max())
          for k in ("R", "t", "v", "bg", "ba")}
    tolp = {"R": 1e-4, "t": 1e-4, "v": 1e-3, "bg": 1e-4, "ba": 1e-4}
    for k, d in vd.items():
        check(d <= tolp[k], f"pose_inertial_optimize card vs CPU: {k} differs by {d:.3g}")
    out["pose_inertial_diff"] = vd
    out["pose_inertial_inliers_equal"] = bool(torch.equal(res["cuda"][1].cpu(), res["cpu"][1]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vi_pose_opt.pose_inertial_optimize(*a, **kw)
        torch.cuda.synchronize()
    out["pose_inertial_kernels"] = device_busy(prof)[1]
    out["pose_inertial_ms"] = time_ms(lambda: vi_pose_opt.pose_inertial_optimize(*a, **kw),
                                      runs=5, warmup=1)
    print(f"[vi] {gpu}: run_vi_local_ba card vs CPU from the same state ({len(rows)} keyframes): "
          f"max |diff| {diffs}; pose_inertial_optimize card vs CPU: {vd}, inliers equal "
          f"{out['pose_inertial_inliers_equal']}; on the card {out['pose_inertial_ms']:.1f} ms "
          f"and {out['pose_inertial_kernels']} CUDA kernels per call "
          f"({'free previous frame' if kw.get('free_prev') else 'last keyframe'} variant), "
          f"CPU {out['pose_inertial_cpu_ms']:.1f} ms; run_vi_local_ba card "
          f"{out['vi_local_ba_cuda_ms']:.1f} ms, CPU {out['vi_local_ba_cpu_ms']:.1f} ms")
    return out


def phase_vi(dev, gpu):
    """Phase 12: visual-inertial SLAM (mono / stereo / RGB-D with an IMU) at
    full width through entry.slam, the gates of tests/test_slam_vi.py and
    tests/test_slam_vi_depth.py, K1 and K2 at the inertial tracking site
    and K1 at the fuse_recent site against their plain versions, the
    inertial solvers on the card against the CPU, and the timings."""
    import statistics

    import torch

    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    runs, failed, out = {}, [], {"sessions": {}}
    for name, sensor, seed, n in VI_SESSIONS:
        run = runs[name] = run_vi_session(dev, name, sensor, seed, n)
        f, summary = vi_gates(name, run)
        failed += f
        frames = [fr for fr in run["rec"]["frames"] if "ok" in fr]
        inertial = [fr for fr in frames[1:] if fr["ok"] and fr["imu_init"]]
        # K1 and K2 launch on every tracked frame after the IMU init
        check(inertial and all(fr["k1"] >= 1 and fr["k2"] >= 1 for fr in inertial),
              f"{name}: a tracked inertial frame launched no K1 or K2: "
              f"{[(fr['k1'], fr['k2']) for fr in inertial]}")
        s = run["samples"]
        before = [fr["ms"] for fr in frames if fr["ok"] and not fr["kf"] and not fr["imu_init"]]
        after = [fr["ms"] for fr in inertial if not fr["kf"]]
        kf_frames = [fr["ms"] for fr in frames if fr["kf"]]
        ev = run["rec"]["events"]
        timing = dict(
            frame_ms_before_imu_init=med(before), frame_ms_after_imu_init=med(after),
            keyframe_frame_ms=med(kf_frames), keyframe_frames=len(kf_frames),
            inertial_frames=len(inertial),
            orb_extraction_ms=med(s.get("orb_extraction", [])),
            fused_step_ms=med(s.get("track.fused_step", [])),
            imu_predict_ms=med(s.get("track.imu_predict", [])),
            vi_refine_ms=med(s.get("track.vi_refine", [])),
            vi_local_ba_ms=med(s.get("map.vi_local_ba", [])),
            visual_local_ba_ms=med(s.get("map.local_ba", [])),
            fuse_ms=med(s.get("map.fuse", [])), triangulate_ms=med(s.get("map.triangulate", [])),
            imu_init_ms=[e["ms"] for e in ev if e["kind"] == "init"],
            refine_ms={e["event"]: e["ms"] for e in ev if e["kind"] == "refine"},
            k1_per_inertial_frame=med([fr["k1"] for fr in inertial if not fr["kf"]]),
            k2_per_inertial_frame=med([fr["k2"] for fr in inertial if not fr["kf"]]),
            keyframe_profile=run["rec"]["kf_profile"])
        print(f"[vi timing] {gpu}: {name}: frame without a keyframe median "
              f"{timing['frame_ms_before_imu_init']} ms before the IMU init, "
              f"{timing['frame_ms_after_imu_init']} ms after ({len(after)} frames); keyframe "
              f"frame median {timing['keyframe_frame_ms']} ms over {len(kf_frames)}; per frame "
              f"(synchronised stages, medians): orb_extraction {timing['orb_extraction_ms']} ms, "
              f"track.fused_step {timing['fused_step_ms']} ms, track.imu_predict "
              f"{timing['imu_predict_ms']} ms, track.vi_refine {timing['vi_refine_ms']} ms; "
              f"map.vi_local_ba {timing['vi_local_ba_ms']} ms, map.local_ba (before the init) "
              f"{timing['visual_local_ba_ms']} ms, map.fuse {timing['fuse_ms']} ms; IMU init "
              f"{timing['imu_init_ms']} ms, refinements {timing['refine_ms']}; launches per "
              f"inertial frame K1 {timing['k1_per_inertial_frame']}, K2 "
              f"{timing['k2_per_inertial_frame']}; one inertial keyframe under the profiler "
              f"{timing['keyframe_profile']}")
        out["sessions"][name] = dict(summary, launches=run["launches"], wall_s=run["wall_s"],
                                     **timing)

    # K1 and K2 at the inertial tracking site and K1 at the fuse_recent site
    mono = runs["vi-mono-full"]
    (a1, kw1), (a2, kw2) = mono["rec"]["site"]
    err_k1, n_ok = compare_k1(mk.search_by_projection_kernel(*a1, **kw1),
                              mk.search_by_projection_plain(*a1, **kw1))
    err_k2 = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2),
                        "at the inertial tracking site")
    a1f, kw1f = mono["rec"]["k1_fuse"]
    err_fuse, n_fuse = compare_k1(mk.search_by_projection_kernel(*a1f, **kw1f),
                                  mk.search_by_projection_plain(*a1f, **kw1f))
    a2s, kw2s = runs["vi-stereo-full"]["rec"]["site"][1]
    err_k2s = compare_k2(pk.pose_ba(*a2s, **kw2s), pk.pose_ba_plain(*a2s, **kw2s),
                         "stereo template at the stereo-inertial tracking site")
    print(f"[vi] inertial tracking site of the last inertial frame: K1 at the IMU-predicted "
          f"pose == plain (N={a1[0].shape[0]}, {n_ok} matched), K2 vs plain max |err| "
          f"{err_k2:.3g} (N={a2[3].shape[1]}, {int(a2[6].sum())} valid), K2's stereo template "
          f"at the stereo-inertial site {err_k2s:.3g}; K1 at the last fuse_recent call == plain "
          f"(N={a1f[0].shape[0]}, {n_fuse} matched)")
    solvers = _vi_solvers_vs_cpu(mono, gpu)

    # preintegration of one frame's packet (20 samples) alone, and its host enqueue
    imu = mono["system"].tracker.imu
    win = imu._frame_meas
    preint_ms = time_ms(lambda: imu._integrate(*win, imu.bg, imu.ba), runs=10, warmup=2)
    print(f"[vi timing] {gpu}: preintegration of one frame's window ({len(win[2])} samples): "
          f"{preint_ms:.2f} ms (CUDA events, median of 10)")
    rows = {}
    for kname, fn, plain, bound, N, prof_name in (
            ("K1_inertial", lambda: mk.search_by_projection_kernel(*a1, **kw1),
             lambda: mk.search_by_projection_plain(*a1, **kw1), k1_bound(a1), a1[0].shape[0],
             "match_kernel"),
            ("K2_inertial", lambda: pk.pose_ba(*a2, **kw2), lambda: pk.pose_ba_plain(*a2, **kw2),
             k2_bound(a2, kw2), a2[3].shape[1], "pose_kernel"),
            ("K1_fuse_recent", lambda: mk.search_by_projection_kernel(*a1f, **kw1f),
             lambda: mk.search_by_projection_plain(*a1f, **kw1f), k1_bound(a1f),
             a1f[0].shape[0], "match_kernel")):
        b_ms, b_by = bound_ms(*bound)
        dev_ms, dev_by = device_kernel_ms(fn, prof_name, runs=10)
        rows[kname] = dict(N=int(N), ms=time_ms(fn, runs=10), device_ms=dev_ms,
                           device_ms_by=dev_by, plain_ms=time_ms(plain, runs=3, warmup=1),
                           bound_ms=b_ms, bound_by=b_by)
        print(f"[vi timing] {gpu}: {kname} (N={N}): {rows[kname]['ms']:.4f} ms per call, "
              f"device {dev_ms:.5f} ms ({dev_by}), plain {rows[kname]['plain_ms']:.3f} ms, "
              f"bound {b_ms:.6f} ms ({b_by})")
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in ("K1", "K2", "K2_stereo", "K1 inertial", "K2 inertial", "K1 fuse")}
    out.update(failed=failed, launches=launches, solvers=solvers, preint_frame_ms=preint_ms,
               err={"K1": max(err_k1, err_fuse), "K2": max(err_k2, err_k2s)}, call_sites=rows)
    return out


# ---------------------------------------------------------------- phase 13
# the free-running default schedule (TrackerConfig: the background mapper on
# its own thread and CUDA stream, pipeline depth 6): phase 8's monocular
# session twice, phase 9's RGB-D session, phase 11's blackout, and
# tests/test_async_accuracy.py::test_async_vi_init_and_metric_scale's
# 60-frame mono-inertial session at phase 12's config
ASYNC_VI_FRAMES = 60
MAPPER_STAGES = ("map.pre", "map.local_ba", "map.culling", "map.loop_detect", "map.imu_stage")


def run_async_session(dev, name, frames, cfg, voc=None, imu=None, timestamps=None,
                      settle_at=(), profile=False):
    """One phase-13 session through entry.slam on the free-running schedule,
    the launch counters zeroed just before it. Records per frame its time
    (the tracker's stream synchronised around it, not the mapper's),
    whether the mapper was busy at its start or end, whether it requested a
    keyframe, the frames in flight after it and the tracking thread's
    launches; each fuse call's thread and stream and the last one's K1
    inputs; the K2 inputs of the last pipelined frame's fused step and the
    number of chained steps. Settles the pipeline after the frames in
    `settle_at` and records the state there. With `profile`, the device is
    traced over 5 frames from the first frame (after frame 10) that starts
    with the mapper busy."""
    import contextlib
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.mapping import fuse
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker as trk
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    rec = {"frames": [], "fuse": [], "k1_fuse": None, "k2_step": None, "chained": 0,
           "settled": {}, "tracker": None, "window": None, "fuse_k1": 0}
    o = dict(k1=mk.search_by_projection_kernel, k2=pk.pose_ba, fuse=fuse.fuse_into_keyframe,
             tf=trk.track_frame)
    local = threading.local()

    def k1_rec(*a, **kw):
        if getattr(local, "fuse", False):
            rec["k1_fuse"] = (a, kw)
        return o["k1"](*a, **kw)

    def k2_rec(*a, **kw):
        if getattr(local, "step", False):
            rec["k2_step"] = (a, kw)
        return o["k2"](*a, **kw)

    def fuse_rec(*a, **kw):
        me = threading.current_thread().name
        rec["fuse"].append((me, torch.cuda.current_stream().cuda_stream))
        local.fuse, n0 = True, mk.launches_by_thread.get(me, 0)
        try:
            return o["fuse"](*a, **kw)
        finally:
            local.fuse = False
            rec["fuse_k1"] += mk.launches_by_thread.get(me, 0) - n0

    def tf_rec(*a, **kw):
        # the fused visual step of a pipelined frame (depth > 1)
        tr = rec["tracker"]
        local.step = tr is not None and tr._depth() > 1
        rec["chained"] += kw.get("chain") is not None
        try:
            return o["tf"](*a, **kw)
        finally:
            local.step = False

    def mapper_busy():
        tr = rec["tracker"]
        return tr is not None and tr.async_mapper is not None and not tr.async_mapper.idle()

    def tracking_launches():
        name_ = threading.current_thread().name
        return mk.launches_by_thread.get(name_, 0), pk.launches_by_thread.get(name_, 0)

    def frame_timer(_name):
        @contextlib.contextmanager
        def part():
            i = len(rec["frames"])
            busy0 = mapper_busy()
            w = rec["window"]
            if profile and w is None and i >= 10 and busy0:
                torch.cuda.synchronize()
                prof = torch_profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                w = rec["window"] = dict(prof=prof, t0=time.perf_counter(), frames=0, busy=0)
            n_kf = len(GLOBAL_TIMER.samples["track.kf_request"])
            k = tracking_launches()
            torch.cuda.current_stream().synchronize()
            t1 = time.perf_counter()
            yield
            torch.cuda.current_stream().synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            busy1 = mapper_busy()
            tr = rec["tracker"]
            k2 = tracking_launches()
            rec["frames"].append(dict(
                ms=ms, busy=busy0 or busy1, kf=len(GLOBAL_TIMER.samples["track.kf_request"]) > n_kf,
                in_flight=len(tr._pipeline) if tr is not None else 0,
                k1=k2[0] - k[0], k2=k2[1] - k[1]))
            if w is not None and "prof" in w:
                w["frames"] += 1
                w["busy"] += busy0 or busy1
                if w["frames"] == 5:
                    torch.cuda.synchronize()
                    w["wall_ms"] = (time.perf_counter() - w["t0"]) * 1e3
                    w["prof"].stop()
                    w["busy_ms"], w["kernels"], _ = device_busy(w.pop("prof"))
        return part()

    def after_frame(sys_):
        rec["tracker"] = sys_.tracker
        i = len(rec["frames"]) - 1
        if i in settle_at:
            sys_.tracker.settle()
            rec["settled"][i] = sys_.tracker.state
        return False

    GLOBAL_TIMER.reset()
    mk.search_by_projection_kernel, pk.pose_ba = k1_rec, k2_rec
    fuse.fuse_into_keyframe, trk.track_frame = fuse_rec, tf_rec
    try:
        mk.launches = pk.launches = pk.stereo_launches = 0
        mk.launches_by_thread.clear()
        pk.launches_by_thread.clear()
        t0 = time.perf_counter()
        system = entry.slam(frames, cfg, vocabulary=voc, imu=imu, timestamps=timestamps,
                            timer=frame_timer, until=after_frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches, "K1 fuse": rec["fuse_k1"],
                    "K1 mapper thread": mk.launches_by_thread.get("mapper", 0),
                    "K2 mapper thread": pk.launches_by_thread.get("mapper", 0)}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba = o["k1"], o["k2"]
        fuse.fuse_into_keyframe, trk.track_frame = o["fuse"], o["tf"]
    tr = system.tracker
    m = tr.async_mapper
    check(m is not None and not m.inline and m._stream is not None,
          f"{name}: the session did not map on the mapper thread's own stream")
    stream = m._stream.cuda_stream
    off = [(t, st) for t, st in rec["fuse"] if t != "mapper" or st != stream]
    check(rec["fuse"] and not off,
          f"{name}: {len(off)} of {len(rec['fuse'])} fuse calls off the mapper's stream")
    print(f"[async {name}] main path (entry.slam, {len(frames)} frames, free-running mapper, "
          f"pipeline depth {tr.cfg.pipeline_depth}): {wall:.2f} s; launches {launches}; "
          f"{len(rec['fuse'])} fuse calls, all on the mapper thread's stream")
    return dict(system=system, rec=rec, launches=launches, wall_s=wall, mapper=m,
                samples={k: list(v) for k, v in GLOBAL_TIMER.samples.items()})


def async_summary(name, run, gpu):
    """Print and return the session's timings: frame ms with the mapper busy
    and idle, keyframe-request frames, the mapper's per-package stages, its
    counters, the frames in flight, the busy share of a profiled window."""
    import statistics

    med = lambda v: round(statistics.median(v), 3) if v else None  # noqa: E731
    fr, m, s = run["rec"]["frames"], run["mapper"], run["samples"]
    tracked = fr[1:]
    busy = [f["ms"] for f in tracked if f["busy"] and not f["kf"]]
    idle = [f["ms"] for f in tracked if not f["busy"] and not f["kf"]]
    # the first package blocks until it is mapped, as in the JAX tracker
    kf_frames = [i for i, f in enumerate(fr) if f["kf"]]
    kf = [fr[i]["ms"] for i in kf_frames[1:]]
    in_flight = [f["in_flight"] for f in fr]
    out = dict(frame_ms_mapper_busy=med(busy), frames_mapper_busy=len(busy),
               frame_ms_mapper_idle=med(idle), frames_mapper_idle=len(idle),
               keyframe_request_ms=med(kf), keyframe_requests=len(kf_frames),
               first_keyframe_request_ms=fr[kf_frames[0]]["ms"] if kf_frames else None,
               mapper_stage_ms={k: med(s.get(k, [])) for k in MAPPER_STAGES},
               mapper_stage_n={k: len(s.get(k, [])) for k in MAPPER_STAGES},
               n_processed=m.n_processed, n_ba_runs=m.n_ba_runs, n_ba_skips=m.n_ba_skips,
               longest_queue=m.max_queue_seen, in_flight_max=max(in_flight),
               in_flight_mean=sum(in_flight) / len(in_flight),
               chained_steps=run["rec"]["chained"], wall_s=run["wall_s"],
               launches=run["launches"])
    w = run["rec"]["window"]
    if w is not None and "wall_ms" in w:
        share = None if w["busy_ms"] is None else w["busy_ms"] / w["wall_ms"]
        out.update(busy_window_ms=w["wall_ms"], busy_window_frames_with_mapper_busy=w["busy"],
                   busy_window_kernels=w["kernels"], busy_window_device_share=share)
    print(f"[async timing] {gpu}: {name}: frame without a keyframe request, mapper busy: median "
          f"{out['frame_ms_mapper_busy']} ms over {len(busy)}; mapper idle: median "
          f"{out['frame_ms_mapper_idle']} ms over {len(idle)}; keyframe-request frame: median "
          f"{out['keyframe_request_ms']} ms over {len(kf)} (the first, which blocks: "
          f"{out['first_keyframe_request_ms']} ms)")
    print(f"[async timing] {gpu}: {name}: mapper per package (stage timer, its stream "
          f"synchronised), median ms {out['mapper_stage_ms']} (n {out['mapper_stage_n']}); "
          f"packages {m.n_processed}, BAs {m.n_ba_runs}, skipped {m.n_ba_skips}, longest queue "
          f"{m.max_queue_seen}; frames in flight after a frame: max {out['in_flight_max']}, mean "
          f"{out['in_flight_mean']:.2f} (state-machine lag), chained steps "
          f"{out['chained_steps']}")
    if "busy_window_ms" in out:
        print(f"[async timing] {gpu}: {name}: device busy over {out['busy_window_ms']:.1f} ms "
              f"of 5 frames ({w['busy']} with a package being mapped): "
              f"{pct(out['busy_window_device_share'])} (kernel time of both streams summed, "
              f"{w['kernels']} kernels)")
    return out


def async_gates(name, run, R_gt, t_gt):
    """The gates of the matching tests/test_async_accuracy.py test. Returns
    (failed, summary)."""
    import numpy as np

    from orb_slam3_tpu_torch.api import evaluate
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.tracking import tracker as trk

    tr = run["system"].tracker
    ts, R, t, ok = tr.poses()
    n = len(ok)
    est = evaluate.camera_centers(R[ok], t[ok])
    gt = evaluate.camera_centers(R_gt[:n][ok], t_gt[:n][ok]) if name != "async-reloc-full" \
        else None
    summary = dict(state=tr.state, tracked=int(ok.sum()), frames=n,
                   n_kf=int(tr.map.kf_valid.sum()), landmarks=int(tr.map.lm_valid.sum()),
                   violations=invariants.check_all(tr.map))
    conds = [(not summary["violations"], f"invariants: {summary['violations'][:3]}")]
    if name.startswith("async-mono-full"):
        rmse, _, s_fit = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=True)
        summary.update(ate=rmse, scale=s_fit)
        conds += [(tr.state == trk.OK, "state not OK"),
                  (ok.sum() >= 0.7 * n, f"only {int(ok.sum())} of {n} frames tracked"),
                  (rmse < 0.35, f"async mono ATE {rmse:.4f}")]
    elif name == "async-rgbd-full":
        rmse, _, _ = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=False)
        summary.update(ate=rmse)
        conds += [(tr.state == trk.OK, "state not OK"),
                  (ok.sum() >= 0.8 * n, f"only {int(ok.sum())} of {n} frames tracked"),
                  (rmse < 0.10, f"async RGB-D metric ATE {rmse:.4f}")]
    elif name == "async-reloc-full":
        st = run["rec"]["settled"]
        after_blank, resumed = st.get(RELOC_FRAMES + 2), st.get(n - 1)
        c = evaluate.camera_centers(tr.last["R"].cpu().numpy()[None],
                                    tr.last["t"].cpu().numpy()[None])[0]
        c_gt = evaluate.camera_centers(R_gt[6][None], t_gt[6][None])[0]
        summary.update(state_after_blank=after_blank, state_after_resume=resumed,
                       centre_err=float(np.linalg.norm(c - c_gt)))
        conds += [(after_blank is not None and after_blank != trk.OK,
                   f"state {after_blank} after the blank frames"),
                  (resumed == trk.OK, "never relocalized after the blackout (async)")]
    else:
        rmse, _, s_fit = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=True)
        summary.update(ate=rmse, scale_fit=s_fit, imu_initialized=tr.imu.initialized,
                       viba_stage=tr.imu.viba_stage,
                       events=[(e["event"], round(e["scale"], 5)) for e in tr.debug_events
                               if "scale" in e])
        conds += [(tr.imu.initialized, "async VI never initialized the IMU"),
                  (ok.sum() >= 0.6 * n, f"only {int(ok.sum())} of {n} frames tracked"),
                  (abs(s_fit - 1.0) < 0.2, f"async VI metric scale {s_fit:.3f}")]
    failed = [f"{name}: {msg}" for cond, msg in conds if not cond]
    for msg in failed:
        print(f"[async] GATE FAILED: {msg}")
    print(f"[async {name}] " + ", ".join(f"{k} {v}" for k, v in summary.items()
                                       if k != "violations")
          + f", invariant violations {len(summary['violations'])}")
    return failed, summary


def phase_async(dev, gpu):
    """Phase 13: the free-running default schedule at full width, its four
    cells with the gates of tests/test_async_accuracy.py, K1 at the fuse on
    the mapper's stream and K2 on a pipelined frame's inputs against their
    plain versions, and the timings."""
    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    t0 = time.perf_counter()
    mono_frames, R_m, t_m, _ = entry.plane_sequence(SLAM_FRAMES)
    rgbd_frames, R_d, t_d = depth_frames("rgbd", 1, 25, 0.1)
    _, reloc_frames, R_r, t_r, fields_r, views_r, _ = reloc_session(dict(kf_max_frames=5))
    vi_fr, R_v, t_v, vi_imu = vi_frames("mono-imu", 3, ASYNC_VI_FRAMES)
    print(f"[async] frames rendered in {time.perf_counter() - t0:.1f} s")
    cells = [("async-mono-full", mono_frames, R_m, t_m, entry.tracker_config(dev), {}),
             ("async-mono-full (repeat)", mono_frames, R_m, t_m, entry.tracker_config(dev),
              dict(profile=True)),
             ("async-rgbd-full", rgbd_frames, R_d, t_d,
              entry.tracker_config(dev, sensor="rgbd", bf=450.0 * 0.1, th_depth=20.0), {}),
             ("async-reloc-full", reloc_frames, R_r, t_r,
              entry.tracker_config(dev, sensor="rgbd", bf=450.0 * 0.1, th_depth=20.0,
                                   **fields_r),
              dict(settle_at=(RELOC_FRAMES + 2, len(reloc_frames) - 1))),
             ("async-vi-full", vi_fr, R_v, t_v,
              entry.tracker_config(dev, img_wh=VI_WH, K=VI_K, sensor="mono-imu",
                                   orb=orb.OrbConfig(n_features=1000, n_levels=8), kmax=64,
                                   lmax=8192, local_window=6, kf_max_frames=3),
              dict(imu=vi_imu, timestamps=[(i + 1) / 10.0 for i in range(ASYNC_VI_FRAMES)]))]
    failed, out, runs = [], {"cells": {}}, {}
    for name, frames, R_gt, t_gt, cfg, kw in cells:
        t_c = time.perf_counter()
        check(cfg.async_mapping and not cfg.deterministic_mapping and cfg.pipeline_depth == 6,
              f"{name}: not the default free-running schedule")
        if name == "async-reloc-full":
            kw = dict(kw, voc=entry.train_vocabulary(views_r, cfg))
        run = runs[name] = run_async_session(dev, name, frames, cfg, **kw)
        f, summary = async_gates(name, run, R_gt, t_gt)
        failed += f
        out["cells"][name] = dict(summary, **async_summary(name, run, gpu))
        # System.shutdown stops the cell's mapper thread
        run["system"].shutdown()
        check(run["system"].tracker.async_mapper is None and not run["mapper"]._thread.is_alive(),
              f"{name}: the mapper thread outlived shutdown()")
        print(f"[async {name}] cell with its gates: {time.perf_counter() - t_c:.1f} s")
    a, b = (out["cells"][k]["ate"] for k in ("async-mono-full", "async-mono-full (repeat)"))
    out["schedule_consistency"] = [a, b]
    print(f"[async] schedule consistency (tests/test_async_accuracy.py): ATE {a:.5f} and "
          f"{b:.5f} over two free-running runs (gate: both < 0.35)")
    if max(a, b) >= 0.35:
        failed.append(f"schedule consistency: ATEs {a:.4f}, {b:.4f}")

    # K1 at the fuse on the mapper's stream, and K2 on a pipelined frame's
    # inputs, against their plain versions; the kernel call on a side stream
    # as the mapper makes it
    mono = runs["async-mono-full"]
    a1, kw1 = mono["rec"]["k1_fuse"]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = mk.search_by_projection_kernel(*a1, **kw1)
    torch.cuda.synchronize()
    err_k1, n_ok = compare_k1(got, mk.search_by_projection_plain(*a1, **kw1))
    a2, kw2 = mono["rec"]["k2_step"]
    err_k2 = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2),
                        "pipelined frame")
    print(f"[async] {gpu}: K1 at the fuse on the mapper's stream == plain (N={a1[0].shape[0]}, "
          f"M={a1[4].shape[0]}, {n_ok} matched); K2 on a pipelined frame's inputs vs plain "
          f"(N={a2[3].shape[1]}): max |err| {err_k2:.3g}")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("K1", "K2", "K1 fuse", "K1 mapper thread", "K2 mapper thread")}
    check(launches["K1 fuse"] >= 1 and launches["K2 mapper thread"] == 0,
          f"launches by the mapper thread: {launches}")
    out.update(failed=failed, launches=launches, err={"K1": err_k1, "K2": err_k2})
    return out


# ---------------------------------------------------------------- phase 14
RESUME_FRAMES = 20  # session 1 of tests/test_loop_reloc.py's resume test


def _fetch(url, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


class ViewerClient:
    """Fetches every endpoint of a live viewer in a loop, from a thread of
    its own, until stopped: what a browser on the page does."""

    ENDPOINTS = ("/", "/stats.json", "/map.png", "/frame.png", "/map3d")

    def __init__(self, port):
        import threading

        self.base = f"http://127.0.0.1:{port}"
        self.ok = {e: 0 for e in self.ENDPOINTS}
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="viewer-client", daemon=True)

    def _run(self):
        from orb_slam3_tpu_torch.utils import png

        while not self._stop.is_set():
            for e in self.ENDPOINTS:
                try:
                    code, body = _fetch(self.base + e)
                    good = code == 200 and (body[:8] == png.SIGNATURE if e.endswith(".png")
                                            else len(body) > 0)
                    if good:
                        self.ok[e] += 1
                    else:
                        self.errors.append(f"{e}: {code} {body[:80]!r}")
                except Exception as ex:  # noqa: BLE001 -- recorded, gated by the phase
                    self.errors.append(f"{e}: {ex!r}")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def resume_frames():
    """tests/test_loop_reloc.py::test_atlas_resume_relocalizes_into_loaded_map
    at full width: PlaneScene seed 7 along the orbit with advance 0.05,
    ray-cast on the card; the vocabulary's held-out views are the first 3
    orbit views."""
    from orb_slam3_tpu_torch import entry

    scene = entry.QuadScene(entry.FULL_K, entry.FULL_WH, entry.plane_quads(entry.plane_scene(7)))
    R, t = entry.orbit_trajectory(40, advance=0.05)
    frames = {i: scene.render_with_depth(R[i], t[i])
              for i in list(range(RESUME_FRAMES)) + list(range(2, 40, 2))}
    R3, t3 = entry.orbit_trajectory(3)
    return frames, [scene.render(R3[i], t3[i]) for i in range(3)]


def phase_io(dev, gpu):
    """Phase 14: persistence and I/O at full width. The EuRoC driver over a
    folder written with the port's PNG codec (tests/test_slam_mono.py's
    gates), a saved Atlas resumed by System(atlas_path=...) with the live
    viewer serving from another thread (tests/test_loop_reloc.py's resume
    gates), save_map_3d and the PLY; K1 and K2's launches on both paths
    (the driver's session and the resumed one; session 1 of the resume is
    set-up), K1's at the fuse and the merge, and the mapper thread's."""
    import dataclasses
    import json
    import os
    import pathlib
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from orb_slam3_tpu_torch import drivers, entry
    from orb_slam3_tpu_torch.api import datasets, evaluate, viz
    from orb_slam3_tpu_torch.api.system import System
    from orb_slam3_tpu_torch.atlas import invariants
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.mapping import fuse
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker
    from orb_slam3_tpu_torch.utils import png
    from orb_slam3_tpu_torch.utils.frameloader import FrameLoader
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    # K1 by call site, on whichever thread calls it (the free-running
    # sessions fuse and merge on the mapper thread); each path's counts are
    # the differences over that path's run alone
    o = dict(fuse=fuse.fuse_into_keyframe, merge=fuse.merge_duplicates_at_keyframe)
    sites, lock = {"K1 fuse": 0, "K1 merge": 0}, threading.Lock()

    def counted(fn, key):
        def call(*a, **kw):
            me = threading.current_thread().name
            n0 = mk.launches_by_thread.get(me, 0)
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    sites[key] += mk.launches_by_thread.get(me, 0) - n0
        return call

    def snapshot():
        with lock:
            return {**sites, "K1 mapper thread": mk.launches_by_thread.get("mapper", 0)}

    def since(snap):
        now = snapshot()
        return {k: now[k] - snap[k] for k in snap}

    failed, out = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    fuse.fuse_into_keyframe = counted(o["fuse"], "K1 fuse")
    fuse.merge_duplicates_at_keyframe = counted(o["merge"], "K1 merge")
    try:
        # 1. the EuRoC driver over a folder of PNG files
        frames, R_gt, t_gt, _ = entry.plane_sequence(SLAM_FRAMES)
        root = f"{tmp}/euroc"
        t0 = time.perf_counter()
        entry.write_euroc_folder(root, frames)
        write_s = time.perf_counter() - t0
        n_bytes = sum(p.stat().st_size for p in pathlib.Path(root).rglob("*.png"))
        paths = [f.img_path for f in datasets.load_euroc(root)]
        t0 = time.perf_counter()
        decoded = sum(1 for _ in FrameLoader(paths))
        decode_ms = (time.perf_counter() - t0) * 1e3 / max(decoded, 1)
        yaml = f"{tmp}/euroc.yaml"
        with open(yaml, "w") as f:
            f.write(entry.pinhole_settings(entry.FULL_K, entry.FULL_WH, 1000, 8))
        GLOBAL_TIMER.reset()
        snap = snapshot()
        mk.launches = pk.launches = 0
        res = drivers.run_euroc(root, yaml, "mono", out=f"{tmp}/traj.txt",
                                atlas_out=f"{tmp}/euroc_atlas.npz", device=dev,
                                log=lambda *a: None)
        torch.cuda.synchronize()  # the driver's session is shut down: its mapper too
        launches_drv = {"K1": mk.launches, "K2": pk.launches, **since(snap)}
        drv_frames = list(GLOBAL_TIMER.samples["frame_total"])
        tr = res["system"].tracker
        ts, R, t, ok = tr.poses()
        s = tr.map
        est = evaluate.camera_centers(R[ok], t[ok])
        gt = evaluate.camera_centers(R_gt[ok], t_gt[ok])
        rmse, _, ate_scale = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=True)
        n_kf, n_lm = int(s.n_kf), int(s.lm_valid.sum())
        lm = s.kf_feat_lm.cpu().numpy()
        bound = lm[lm >= 0]
        on_valid = float(s.lm_valid.cpu().numpy()[bound].mean()) if bound.size else 0.0
        viol = invariants.check_all(s)
        print(f"[io] {gpu}: wrote {SLAM_FRAMES} frames as a EuRoC folder ({n_bytes} bytes of "
              f"PNG) in {write_s:.2f} s; the loader alone {decode_ms:.2f} ms a frame; the "
              f"driver (decoder: {FrameLoader.decoder}): "
              f"{res['fps']:.2f} fps over {res['frames']} frames ({res['seconds']:.2f} s), "
              f"launches {launches_drv}; save_atlas {res['save_atlas_bytes']} bytes in "
              f"{res['save_atlas_ms']:.1f} ms")
        print(f"[io] driver frames (host ms, enqueue; the last one settles): median "
              f"{statistics.median(drv_frames):.1f}, first five "
              f"{[round(x, 1) for x in drv_frames[:5]]}, largest five "
              f"{sorted(round(x, 1) for x in drv_frames)[-5:]}")
        print(f"[io] driver session: state {tr.state}, tracked {int(ok.sum())}/{len(ok)}, "
              f"scale-fitted ATE {rmse:.5f} (scale {ate_scale:.4f}), n_kf {n_kf}, landmarks "
              f"{n_lm}, bindings on valid {100 * on_valid:.2f}%, violations {len(viol)}")
        for cond, msg in ((tr.state == tracker.OK, "driver: state not OK at the end"),
                          (ok.sum() >= 0.7 * len(ok), f"driver: {int(ok.sum())} tracked"),
                          (rmse < 0.35, f"driver: ATE {rmse:.4f}"),
                          (n_kf >= 3, f"driver: n_kf {n_kf}"),
                          (n_lm > 150, f"driver: {n_lm} landmarks"),
                          (on_valid >= 0.95, f"driver: bindings on valid {on_valid:.3f}"),
                          (not viol, f"driver: invariants {viol[:3]}"),
                          (launches_drv["K1"] >= SLAM_FRAMES // 2 and launches_drv["K2"] >= 2
                           and launches_drv["K1 fuse"] >= 1,
                           f"driver: launches {launches_drv}")):
            if not cond:
                print(f"[io] GATE FAILED: {msg}")
                failed.append(msg)
        out["driver"] = dict(fps=res["fps"], seconds=res["seconds"], frames=res["frames"],
                             decoder=FrameLoader.decoder, png_bytes=n_bytes, write_s=write_s,
                             decode_ms=decode_ms, frame_ms=drv_frames,
                             save_atlas_bytes=res["save_atlas_bytes"],
                             save_atlas_ms=res["save_atlas_ms"], launches=launches_drv,
                             tracked=int(ok.sum()), ate=rmse, n_kf=n_kf, landmarks=n_lm)

        # 2. the resume, with the viewer serving from another thread
        t0 = time.perf_counter()
        fr, views = resume_frames()
        fields = dict(sensor="rgbd", bf=450.0 * 0.1, th_depth=20.0, kf_max_frames=2)
        cfg = entry.tracker_config(dev, **fields)
        voc = entry.train_vocabulary(views, cfg)
        s1 = System(config=cfg, vocabulary=voc)
        for i in range(RESUME_FRAMES):
            s1.track_rgbd(*fr[i], i * 0.05)
        s1.tracker.sync_mapping()
        saved = s1.tracker.map
        state1, n_kf1 = s1.tracker.state, int(saved.kf_valid.sum())
        path = f"{tmp}/session1.npz"
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s1.save_atlas(path)
        save_ms = (time.perf_counter() - t1) * 1e3
        s1.shutdown()
        t1 = time.perf_counter()
        s2 = System(config=entry.tracker_config(dev, **fields), vocabulary=voc, atlas_path=path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t1) * 1e3
        t2 = s2.tracker
        n_db = int(t2.loop_closer.db.valid.sum())
        same = all(torch.equal(getattr(t2.map, f.name), getattr(saved, f.name))
                   for f in dataclasses.fields(saved) if f.name not in ("active_map", "n_maps"))
        viewer = s2.start_viewer(port=0)
        merged, frame_ms = False, []
        with ViewerClient(viewer.port) as client:
            snap = snapshot()
            mk.launches = pk.launches = 0
            for k, i in enumerate(range(2, 40, 2)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                s2.track_rgbd(*fr[i], 100.0 + k * 0.05)
                t2.sync_mapping()
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t1) * 1e3)
                if t2.loop_closer.n_merges > 0:
                    merged = True
                    break
            launches_res = {"K1": mk.launches, "K2": pk.launches, **since(snap)}
            time.sleep(0.5)  # one more round of every endpoint on the final map
        ids = np.unique(t2.map.kf_map_id.cpu().numpy()[t2.map.kf_valid.cpu().numpy()])
        stats = json.loads(_fetch(f"http://127.0.0.1:{viewer.port}/stats.json")[1])
        pngs = {e: _fetch(f"http://127.0.0.1:{viewer.port}{e}")[1][:8] == png.SIGNATURE
                for e in ("/map.png", "/frame.png")}
        _fetch(f"http://127.0.0.1:{viewer.port}/cmd?localization=1")
        paused = s2.localization_only
        _fetch(f"http://127.0.0.1:{viewer.port}/cmd?localization=0")
        # 3. the 3D map and the PLY
        t1 = time.perf_counter()
        s2.save_map_3d(f"{tmp}/map.html")
        map3d_ms = (time.perf_counter() - t1) * 1e3
        viz.save_map_ply(f"{tmp}/map.ply", t2.map)
        with open(f"{tmp}/map.ply") as f:
            n_vertex = int([ln for ln in f.read(400).splitlines()
                            if ln.startswith("element vertex")][0].split()[-1])
        want_vertex = int(t2.map.lm_valid.sum()) + int(t2.map.kf_valid.sum())
        html_bytes = os.path.getsize(f"{tmp}/map.html")
        print(f"[io] {gpu}: resume session 1: state {state1}, {n_kf1} keyframes, save_atlas "
              f"{os.path.getsize(path)} bytes in {save_ms:.1f} ms; "
              f"System(atlas_path) {load_ms:.1f} ms, database {n_db} keyframes, loaded map "
              f"{'equal' if same else 'NOT equal'} to the saved one")
        print(f"[io] resumed session: merged {merged} after {len(frame_ms)} frames (ms "
              f"{[round(x, 1) for x in frame_ms]}), map ids {ids.tolist()}, launches "
              f"{launches_res}; viewer served {client.ok} with {len(client.errors)} errors "
              f"{client.errors[:3]}, final stats {stats}, PNG signatures {pngs}, "
              f"localization toggled {paused}; save_map_3d {html_bytes} bytes in "
              f"{map3d_ms:.1f} ms, PLY {n_vertex} vertices (expected {want_vertex})")
        s2.shutdown()
        for cond, msg in ((state1 == tracker.OK and n_kf1 >= 8,
                           f"resume: session 1 state {state1}, {n_kf1} keyframes"),
                          (same, "resume: the loaded map differs from the saved one"),
                          (n_db >= 8, f"resume: database of {n_db} keyframes"),
                          (merged, "resume: the resumed session never merged"),
                          (len(ids) == 1, f"resume: map ids {ids.tolist()} at the end"),
                          (launches_res["K1"] >= 1 and launches_res["K2"] >= 1,
                           f"resume: launches {launches_res}"),
                          (all(v >= 1 for v in client.ok.values()) and not client.errors,
                           f"viewer: served {client.ok}, errors {client.errors[:3]}"),
                          (all(pngs.values()) and stats["n_keyframes"] >= 8,
                           f"viewer: {pngs} {stats}"),
                          (paused, "viewer: /cmd?localization=1 did not pause mapping"),
                          (n_vertex == want_vertex, f"PLY: {n_vertex} vs {want_vertex}")):
            if not cond:
                print(f"[io] GATE FAILED: {msg}")
                failed.append(msg)
        out["resume"] = dict(session1_kf=n_kf1, save_atlas_ms=save_ms,
                             atlas_bytes=os.path.getsize(path),
                             load_ms=load_ms, database=n_db, merged=merged,
                             frames_to_merge=len(frame_ms), frame_ms=frame_ms,
                             launches=launches_res, viewer_served=client.ok,
                             map3d_ms=map3d_ms, wall_s=time.perf_counter() - t0)
        out["resumed_map"] = t2.map
        out["K8"] = cfg.K
    finally:
        fuse.fuse_into_keyframe, fuse.merge_duplicates_at_keyframe = o["fuse"], o["merge"]
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: launches_drv[k] + launches_res[k] for k in launches_drv}
    print(f"[io] launches of the driver's and the resumed session by site: {launches}")
    out.update(failed=failed, launches=launches, err={"K1": 0.0, "K2": 0.0})
    return out


# ---------------------------------------------------------------- phase 15
FLEET_B = 8


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_parallel(dev, gpu, resumed_map, K8):
    """Phase 15: the landmark-sharded global BA over an NCCL world of one on
    the resumed map against GlobalBARunner; the fleet step at B = 8 at full
    width against each session's own step, K2 launched once over the batch
    and held against its plain version; extract_batched against extract at
    full width; their times."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.frontend import camera as cam
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.frontend import orb
    from orb_slam3_tpu_torch.mapping import global_ba
    from orb_slam3_tpu_torch.parallel import fleet, map_ba, multihost
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    failed, out = [], {}
    # 1. the global BA over an NCCL world of one
    s = resumed_map
    multihost.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device=dev)
    try:
        backend = dist.get_backend()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_dist = map_ba.distributed_global_ba(s, K8, num_iters=10, device=dev)
        torch.cuda.synchronize()
        dist_ms = (time.perf_counter() - t0) * 1e3
        s_one = map_ba.distributed_global_ba(s, K8, num_iters=10, cam_bucket=1, edge_bucket=1,
                                             device=dev)
    finally:
        dist.destroy_process_group()
    # the runner as one chunk of 10 iterations: the same LM schedule (its
    # chunks restart lambda; they are its abort granularity)
    t0 = time.perf_counter()
    s_run = global_ba.GlobalBARunner(K8, cam.PINHOLE, num_iters=10, chunk=10).run(s)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    s_gba = global_ba.global_ba(s, K8, num_iters=10)
    bits = all(torch.equal(getattr(s_one, k), getattr(s_gba, k)) for k in ("kf_R", "kf_t",
                                                                           "lm_pos"))
    kv, lv = s.kf_valid, s.lm_valid
    dR = (s_dist.kf_R[kv] - s_run.kf_R[kv]).abs().max().item()
    dt = (s_dist.kf_t[kv] - s_run.kf_t[kv]).abs().max().item()
    dX = (s_dist.lm_pos[lv] - s_run.lm_pos[lv]).abs().max().item()
    moved = (s_dist.kf_t[kv] - s.kf_t[kv]).abs().max().item()
    print(f"[parallel] {gpu}: distributed_global_ba over {backend} (world of one), "
          f"{int(kv.sum())} keyframes, {int(lv.sum())} landmarks: {dist_ms:.1f} ms; "
          f"GlobalBARunner {run_ms:.1f} ms; poses |dR| {dR:.3g} |dt| {dt:.3g}, points "
          f"{dX:.3g} (gates 5e-3 / 2e-2; moved {moved:.3g}); buckets of 1 against global_ba: "
          f"{'the same bits' if bits else 'not bitwise equal'}")
    if not (dR <= 5e-3 and dt <= 5e-3 and dX <= 2e-2):
        failed.append(f"distributed GBA vs GlobalBARunner: {dR:.3g} {dt:.3g} {dX:.3g}")
    out["gba"] = dict(backend=backend, dist_ms=dist_ms, runner_ms=run_ms, dR=dR, dt=dt, dX=dX,
                      same_bits_as_global_ba=bits, keyframes=int(kv.sum()),
                      landmarks=int(lv.sum()))

    # 2. the fleet at B = 8: track-full's scene from 8 perturbed start poses
    cfg = orb.OrbConfig(n_features=1000, n_levels=8)
    K = cam.make_pinhole(*entry.FULL_K, device=dev)
    img_np = entry.blob_frame(FULL_H, FULL_W, seed=1)
    f0 = orb.extract(torch.from_numpy(img_np).to(dev), cfg)
    cols = [[] for _ in range(9)]
    for b in range(FLEET_B):
        xi = np.asarray(entry.START_XI) * (0.4 + 0.2 * b) * (1 if b % 2 else -1)
        sc = entry.make_scene(f0.xy.cpu().numpy(), f0.octave.cpu().numpy(),
                              f0.descriptors.cpu().numpy(), f0.valid.cpu().numpy(),
                              K.cpu().numpy(), cfg.n_levels, FULL_L, seed=2, start_xi=xi)
        for i, a in enumerate([img_np] + [sc[k] for k in (
                "lm_pos", "lm_desc", "lm_valid", "lm_max_dist", "lm_min_dist", "lm_normal",
                "R0", "t0")]):
            cols[i].append(a)
    args = [torch.from_numpy(np.ascontiguousarray(np.stack(c))).to(dev) for c in cols]
    step = fleet.make_fleet_step(cfg, K, img_wh=(FULL_W, FULL_H), device=dev)
    step(*args)  # warm the allocator
    rec = {}
    k2_orig = pk.pose_ba

    def k2_rec(*a, **kw):
        rec["k2"] = (a, kw)
        return k2_orig(*a, **kw)

    pk.pose_ba = k2_rec
    try:
        mk.launches = pk.launches = 0
        R, t, n = step(*args)
        torch.cuda.synchronize()
        launches = {"K1": mk.launches, "K2": pk.launches}
    finally:
        pk.pose_ba = k2_orig
    sf = cfg.scale_factors(dev)
    one = [lambda b=b: fleet._track_one(*(a[b] for a in args), cfg_orb=cfg, kind=cam.PINHOLE,
                                        K=K, img_wh=(float(FULL_W), float(FULL_H)),
                                        scale_factors=sf, match_radius=15.0)
           for b in range(FLEET_B)]
    eR = et = 0.0
    n_eq = True
    for b in range(FLEET_B):
        Rb, tb, nb = one[b]()
        eR = max(eR, (R[b] - Rb).abs().max().item())
        et = max(et, (t[b] - tb).abs().max().item())
        n_eq &= int(nb) == int(n[b])
    a2, kw2 = rec["k2"]
    err_k2 = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2), "fleet B=8")
    step_ms = time_ms(lambda: step(*args), runs=10, warmup=2)
    seq_ms = time_ms(lambda: [f() for f in one], runs=5, warmup=1)
    fn = lambda: pk.pose_ba(*a2, **kw2)  # noqa: E731
    k2_ms = time_ms(fn, runs=20)
    k2_dev, k2_by = device_kernel_ms(fn, "pose_kernel")
    k2_plain = time_ms(lambda: pk.pose_ba_plain(*a2, **kw2), runs=2, warmup=0)
    nbytes, ops = k2_bound(a2, kw2)
    b_ms, b_by = bound_ms(nbytes, ops)
    print(f"[parallel] {gpu}: fleet B={FLEET_B} at {FULL_W}x{FULL_H}, L={FULL_L}: launches "
          f"{launches} (K2 cluster {pk.cluster_size(a2[3].shape[1])} CTAs x {a2[3].shape[0]} "
          f"problems); n {n.tolist()}; against each session's own step: |dR| {eR:.3g} "
          f"|dt| {et:.3g}, n equal {n_eq}; K2 vs plain at B=8 max |err| {err_k2:.3g}")
    print(f"[parallel] {gpu}: fleet step {step_ms:.3f} ms; 8 sequential single-session steps "
          f"{seq_ms:.3f} ms; K2 at B=8: {k2_ms:.4f} ms per call, device {k2_dev:.5f} ms "
          f"({k2_by}), plain {k2_plain:.2f} ms, bound {b_ms:.6f} ms ({b_by})")
    for cond, msg in ((launches == {"K1": FLEET_B, "K2": 1}, f"fleet launches {launches}"),
                      (eR <= 1e-5 and et <= 1e-4 and n_eq,
                       f"fleet vs single session: {eR:.3g} {et:.3g} n equal {n_eq}"),
                      (int(n.min()) >= 0.9 * sc["n_frame"],
                       f"fleet inliers {n.tolist()} of {sc['n_frame']}")):
        if not cond:
            print(f"[parallel] GATE FAILED: {msg}")
            failed.append(msg)
    out["fleet"] = dict(B=FLEET_B, launches=launches, n=n.tolist(), dR=eR, dt=et,
                        step_ms=step_ms, sequential_ms=seq_ms)
    k2_fleet = dict(B=FLEET_B, N=int(a2[3].shape[1]), launches=launches["K2"], ms=k2_ms,
                    device_ms=k2_dev, device_ms_by=k2_by, plain_ms=k2_plain, bound_ms=b_ms,
                    bound_by=b_by, bytes=nbytes, ops=ops, max_abs_err=err_k2)

    # 3. batched extraction against extract at full width
    img = args[0][0]
    a = orb.extract(img, cfg)
    b_ = orb.extract_batched(img, cfg)
    bad = []
    off_a = off_b = 0
    for lvl, nl in enumerate(cfg.features_per_level()):
        na = int((a.octave == lvl).sum())
        sa, sb = slice(off_a, off_a + na), slice(off_b, off_b + na)
        v = a.valid[sa]
        if not torch.equal(b_.valid[sb], v):
            bad.append(f"level {lvl}: valid")
        elif v.any():
            if (b_.xy[sb][v] - a.xy[sa][v]).abs().max().item() > 1e-4:
                bad.append(f"level {lvl}: xy")
            if not torch.equal(b_.descriptors[sb][v], a.descriptors[sa][v]):
                bad.append(f"level {lvl}: descriptors")
            if (b_.angle[sb][v] - a.angle[sa][v]).abs().max().item() > 1e-5:
                bad.append(f"level {lvl}: angle")
        off_a, off_b = off_a + na, off_b + nl
    e_ms = time_ms(lambda: orb.extract(img, cfg), runs=20)
    eb_ms = time_ms(lambda: orb.extract_batched(img, cfg), runs=20)
    kernels = {}
    for name, fn in (("extract", lambda: orb.extract(img, cfg)),
                     ("extract_batched", lambda: orb.extract_batched(img, cfg))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels[name] = device_busy(prof)[1]
    print(f"[parallel] {gpu}: extract_batched vs extract at {FULL_W}x{FULL_H}: "
          f"{'equal on every valid keypoint' if not bad else bad}; {eb_ms:.2f} ms against "
          f"{e_ms:.2f} ms; CUDA kernels per call {kernels}")
    if bad:
        failed.append(f"extract_batched: {bad}")
    out["extract_batched"] = dict(ms=eb_ms, extract_ms=e_ms, kernels=kernels)
    out.update(failed=failed, launches=launches, err={"K1": 0.0, "K2": err_k2},
               k2_fleet=k2_fleet)
    return out

# ---------------------------------------------------------------- phase 16
# tests/test_reference_scale.py's session (the room, seed 21, 420 frames of
# 2.3 turns, frames 180-186 blank) and tests/test_compaction.py's churn
# (PlaneScene seed 11, 60 frames, a keyframe every frame, kmax 16)
SCALE_FRAMES, SCALE_TURNS, SCALE_BLACKOUT, SCALE_BLANK = 420, 2.3, 180, 7
CHURN_FRAMES = 60


def scale_cells(dev):
    """(name, frames, R_gt, t_gt, cfg, vocabulary views, timestamps) of
    phase 16's two cells at full width (752x480, FULL_K, OrbConfig(1000, 8),
    RGB-D, th_depth 20). scale-full: the room ray-cast on the card (seed 21),
    loop_trajectory(420, radius 1.6, 2.3 turns), frames 180-186 a zero image
    with unit depth, timestamps i * 0.1, bf 45, kmax 64, lmax 8192, window 6,
    kf_max_frames 2, the deterministic schedule (the mapper stepped inline);
    the vocabulary's 4 held-out views of a circle of radius 1.0. churn-full:
    PlaneScene seed 11 as a QuadScene, orbit_trajectory(60, advance 0.02),
    timestamps i * 0.05, bf 35, kmax 16, lmax 2048, window 5, kf_max_frames
    1, synchronous. Frames are rendered as the session consumes them."""
    import numpy as np

    from orb_slam3_tpu_torch import entry

    K, wh = entry.FULL_K, entry.FULL_WH
    blank = (np.zeros((wh[1], wh[0]), np.float32), np.ones((wh[1], wh[0]), np.float32))
    room = entry.room_scene(np.array(K), img_wh=wh, seed=21, device=dev)
    R, t = entry.loop_trajectory(SCALE_FRAMES, radius=1.6, loops=SCALE_TURNS)
    Rv, tv = entry.loop_trajectory(4, radius=1.0, start_angle=0.4)

    def room_frames():
        for i in range(SCALE_FRAMES):
            blackout = SCALE_BLACKOUT <= i < SCALE_BLACKOUT + SCALE_BLANK
            yield blank if blackout else room.render_with_depth(R[i], t[i])

    cfg = entry.tracker_config(dev, sensor="rgbd", bf=450.0 * 0.1, th_depth=20.0, kmax=64,
                               lmax=8192, local_window=6, kf_max_frames=2,
                               deterministic_mapping=True)
    out = [("scale-full", room_frames(), R, t, cfg,
            [room.render(Rv[i], tv[i]) for i in range(4)],
            [i * 0.1 for i in range(SCALE_FRAMES)])]
    planes = entry.QuadScene(K, wh, entry.plane_quads(entry.plane_scene(11)), device=dev)
    Rc, tc = entry.orbit_trajectory(CHURN_FRAMES, advance=0.02)
    cfg = entry.tracker_config(dev, sensor="rgbd", bf=35.0, th_depth=20.0, kmax=16, lmax=2048,
                               local_window=5, kf_max_frames=1, **SYNC)
    out.append(("churn-full", (planes.render_with_depth(Rc[i], tc[i])
                               for i in range(CHURN_FRAMES)), Rc, tc, cfg, None, None))
    return out


def run_scale_cell(dev, name, frames, cfg, views, timestamps):
    """One phase-16 session through entry.slam -> System.track_rgbd, the
    launch counters zeroed just before it. Records each frame's host time
    (the device synchronised around it); the frames at which
    the arena compacted and grew (with kmax / lmax), the Atlas gained a map,
    a loop closed and the maps merged; K1's launches at the fuse and merge
    sites and the inputs of its call at the largest N of each site; K2's
    launches at the relocalization site and the stereo call with the most
    valid rows; each essential-graph solve's ms and size."""
    import contextlib

    import torch

    from orb_slam3_tpu_torch import entry
    from orb_slam3_tpu_torch.atlas import ops as atlas_ops
    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.graphopt import essential
    from orb_slam3_tpu_torch.mapping import fuse
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk
    from orb_slam3_tpu_torch.tracking import tracker
    from orb_slam3_tpu_torch.utils.timing import GLOBAL_TIMER

    voc = None
    if views is not None:
        t0 = time.perf_counter()
        voc = entry.train_vocabulary(views, cfg)
        print(f"[scale {name}] vocabulary trained in {time.perf_counter() - t0:.1f} s "
              f"({voc.n_words} words)")
    rec = {"frames": [], "events": [], "k1": {}, "k2": [], "essential": [], "reloc": [], "sites": {"K1 fuse": 0, "K1 merge": 0, "K2 reloc": 0}, "site": None}
    o = dict(k1=mk.search_by_projection_kernel, k2=pk.pose_ba, fuse=fuse.fuse_into_keyframe,
             merge=fuse.merge_duplicates_at_keyframe, reloc=tracker.Tracker._try_relocalize,
             compact=atlas_ops.compact, grow=atlas_ops.grow,
             eg=essential.optimize_essential_graph, stage=GLOBAL_TIMER.stage)

    def event(kind, **kw):
        rec["events"].append(dict(kind=kind, frame=len(rec["frames"]), **kw))

    def k1_rec(*a, **kw):
        site = rec["site"] or "track"
        best = rec["k1"].get(site)
        if best is None or a[0].shape[0] >= best[0]:
            rec["k1"][site] = (a[0].shape[0], a, kw)
        return o["k1"](*a, **kw)

    def k2_rec(*a, **kw):
        if kw.get("ur") is not None:  # the stereo template (RGB-D tracking)
            rec["k2"].append((a[6].sum(), a, kw))
        return o["k2"](*a, **kw)

    def at_site(site, fn, counter, mod):
        def wrapped(*a, **kw):
            prev, rec["site"] = rec["site"], site
            n0 = mod.launches
            try:
                return fn(*a, **kw)
            finally:
                rec["sites"][counter] += mod.launches - n0
                rec["site"] = prev
        return wrapped

    def reloc_rec(self, feats):
        ok = at_site("reloc", o["reloc"], "K2 reloc", pk)(self, feats)
        rec["reloc"].append((len(rec["frames"]), ok))
        return ok

    def compact_rec(s):
        out = o["compact"](s)
        event("compact", kmax=s.kmax, lmax=s.lmax)
        return out

    def grow_rec(s, kmax=None, lmax=None):
        event("grow", kmax=kmax or s.kmax, lmax=lmax or s.lmax)
        return o["grow"](s, kmax=kmax, lmax=lmax)

    def eg_rec(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = o["eg"](*a, **kw)
        torch.cuda.synchronize()
        rec["essential"].append(dict(ms=(time.perf_counter() - t1) * 1e3, K=a[0].shape[0],
                                     edges=int(a[4].shape[0]), frame=len(rec["frames"])))
        return out

    last = {"maps": 1, "loops": 0, "merges": 0}

    def after_frame(sys_):
        tr = sys_.tracker
        now = {"maps": int(tr.map.n_maps),
               "loops": tr.loop_closer.n_loops if tr.loop_closer else 0,
               "merges": tr.loop_closer.n_merges if tr.loop_closer else 0}
        for k, kind in (("maps", "new map"), ("loops", "loop"), ("merges", "merge")):
            if now[k] > last[k]:
                rec["events"].append(dict(kind=kind, frame=len(rec["frames"]) - 1,
                                          n_kf=int(tr.map.kf_valid.sum())))
        last.update(now)
        return False

    def frame_timer(_name):
        @contextlib.contextmanager
        def part():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            rec["frames"].append(time.perf_counter() - t1)
        return part()

    GLOBAL_TIMER.reset()
    mk.search_by_projection_kernel, pk.pose_ba = k1_rec, k2_rec
    GLOBAL_TIMER.stage = lambda stage_name: GLOBAL_TIMER.stage_sync(stage_name, dev)
    fuse.fuse_into_keyframe = at_site("fuse", o["fuse"], "K1 fuse", mk)
    fuse.merge_duplicates_at_keyframe = at_site("merge", o["merge"], "K1 merge", mk)
    tracker.Tracker._try_relocalize = reloc_rec
    atlas_ops.compact, atlas_ops.grow = compact_rec, grow_rec
    essential.optimize_essential_graph = eg_rec
    try:
        mk.launches = pk.launches = 0
        mk.launches_by_thread.clear()
        pk.launches_by_thread.clear()
        t0 = time.perf_counter()
        system = entry.slam(frames, cfg, vocabulary=voc, timer=frame_timer, until=after_frame,
                            timestamps=timestamps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": mk.launches, "K2": pk.launches, **rec["sites"]}
    finally:
        mk.search_by_projection_kernel, pk.pose_ba = o["k1"], o["k2"]
        fuse.fuse_into_keyframe, fuse.merge_duplicates_at_keyframe = o["fuse"], o["merge"]
        tracker.Tracker._try_relocalize = o["reloc"]
        atlas_ops.compact, atlas_ops.grow = o["compact"], o["grow"]
        essential.optimize_essential_graph = o["eg"]
        GLOBAL_TIMER.stage = o["stage"]
    print(f"[scale {name}] main path (entry.slam -> System.track_rgbd, {len(rec['frames'])} "
          f"frames, {'deterministic' if cfg.deterministic_mapping else 'synchronous'} "
          f"schedule): {wall:.2f} s; launches {launches}; relocalization attempts (frame, "
          f"ok) {rec['reloc']}")
    return dict(system=system, rec=rec, launches=launches, wall_s=wall,
                samples={k: list(v) for k, v in GLOBAL_TIMER.samples.items()})


def scale_gates(name, run, R_gt, t_gt):
    """The gates of tests/test_reference_scale.py::test_reference_scale_session
    (scale-full) or tests/test_compaction.py::
    test_e2e_churn_compacts_and_grows (churn-full). Returns (failed,
    summary)."""
    import numpy as np

    from orb_slam3_tpu_torch.api import evaluate
    from orb_slam3_tpu_torch.atlas import invariants

    tr, rec = run["system"].tracker, run["rec"]
    s = tr.map
    kv = s.kf_valid.cpu().numpy()
    frame_s = rec["frames"]
    violations = invariants.check_all(s)
    ev = rec["events"]
    summary = dict(frames=len(frame_s), n_kf=int(kv.sum()), n_kf_alloc=int(s.n_kf),
                   kmax=s.kmax, lmax=s.lmax, n_lm=int(s.lm_valid.sum()),
                   compactions=[e["frame"] for e in ev if e["kind"] == "compact"],
                   growths=[(e["frame"], e["kmax"], e["lmax"]) for e in ev
                            if e["kind"] == "grow"],
                   new_maps=[e["frame"] for e in ev if e["kind"] == "new map"],
                   loops=[e["frame"] for e in ev if e["kind"] == "loop"],
                   merges=[(e["frame"], e["n_kf"]) for e in ev if e["kind"] == "merge"],
                   violations=violations)
    if name == "scale-full":
        n = len(R_gt)
        ids = s.kf_map_id.cpu().numpy()[kv]
        kc = evaluate.camera_centers(s.kf_R.cpu().numpy()[kv], s.kf_t.cpu().numpy()[kv])
        kts = s.kf_timestamp.cpu().numpy()[kv]
        fr = np.clip((kts / 0.1 + 0.5).astype(int), 0, n - 1)
        gtc = evaluate.camera_centers(R_gt[fr], t_gt[fr])
        ate = evaluate.ate_rmse(kts, kc, kts, gtc, with_scale=False)[0]
        early, late = np.median(frame_s[40:140]), np.median(frame_s[-100:])
        summary.update(n_maps=int(s.n_maps), n_merges=tr.loop_closer.n_merges,
                       n_loops=tr.loop_closer.n_loops, map_ids=sorted(set(ids.tolist())),
                       ate=float(ate), early_median_s=float(early), late_median_s=float(late))
        conds = [(int(s.n_maps) >= 2, "the blackout never spawned a second map"),
                 (tr.loop_closer.n_merges >= 1, "the maps never merged after the loss"),
                 (len(summary["map_ids"]) == 1, f"atlas not unified: maps {summary['map_ids']}"),
                 (summary["n_kf"] >= 100, f"only {summary['n_kf']} keyframes"),
                 (s.kmax > 64, "the arena never grew"),
                 (ate < 0.30, f"reference-scale ATE {ate:.4f}"),
                 (late < 4.0 * early + 0.05,
                  f"per-frame cost grew: early {early:.4f} s, late {late:.4f} s"),
                 (not violations, f"invariants: {violations[:3]}")]
    else:
        ts, R, tt, ok = tr.poses()
        n = len(R_gt)
        est = evaluate.camera_centers(R[ok], tt[ok])
        gt = evaluate.camera_centers(R_gt[:len(ok)][ok], t_gt[:len(ok)][ok])
        ate = evaluate.ate_rmse(ts[ok], est, ts[ok], gt, with_scale=False)[0]
        summary.update(tracked=int(ok.sum()), ate=float(ate))
        conds = [(ok.sum() >= 0.8 * n, f"tracked {int(ok.sum())}/{n}"),
                 (ate < 0.15, f"churn ATE {ate:.4f}"),
                 (not violations, f"invariants: {violations[:3]}"),
                 (int(s.n_kf) < 60, f"n_kf {int(s.n_kf)}: the arena never cycled")]
    failed = [f"{name}: {msg}" for cond, msg in conds if not cond]
    for msg in failed:
        print(f"[scale] GATE FAILED: {msg}")
    print(f"[scale {name}] " + ", ".join(f"{k} {v}" for k, v in summary.items()
                                       if k != "violations"))
    return failed, summary


def phase_scale(dev, gpu):
    """Phase 16: the reference's operating regime at full width (scale-full,
    churn-full) with the gates of their tests, the frames at which the
    arena compacted and grew, the Atlas gained a map and the maps merged;
    K1 at the largest N of its tracking, fuse and merge sites exactly equal
    to its plain version, K2's stereo template at the session's most valid
    rows within R 1e-5 / t 1e-4; System.run_global_ba on the unified map;
    the per-frame medians and each kernel's times at those shapes."""
    import statistics

    import torch

    from orb_slam3_tpu_torch.frontend import match_kernel as mk
    from orb_slam3_tpu_torch.tracking import pose_kernel as pk

    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    failed, out, runs = [], {"cells": {}}, {}
    errs = {"K1": 0.0, "K2": 0.0}
    rows = {}
    for name, frames, R_gt, t_gt, cfg, views, timestamps in scale_cells(dev):
        t_c = time.perf_counter()
        run = runs[name] = run_scale_cell(dev, name, frames, cfg, views, timestamps)
        f, summary = scale_gates(name, run, R_gt, t_gt)
        failed += f
        tr, rec, smp = run["system"].tracker, run["rec"], run["samples"]
        m = tr.async_mapper
        gba = tr.gba if tr.gba is not None else (m.gba if m is not None else None)
        if gba is not None:
            t1 = time.perf_counter()
            gba.join(timeout=600)
            summary["background_gba_wait_s"] = time.perf_counter() - t1
            check(not gba.failed, f"{name}: the background global BA failed: {gba.error}")
        print(f"[scale {name}] background global BA at the end: "
              f"{'waited %.1f s' % summary['background_gba_wait_s'] if gba else 'none'}")
        fr = rec["frames"]
        summary.update(
            wall_s=run["wall_s"], launches=run["launches"],
            frame_ms=med([x * 1e3 for x in fr]),
            essential_graph=rec["essential"],
            stages={k: med(smp.get(k, [])) for k in (
                "orb_extraction", "track.stereo_depth", "track.fused_step", "map.pre",
                "map.local_ba", "map.culling", "map.loop_detect", "loop.query", "loop.cascade")})
        for k in ("K1", "K2"):
            check(run["launches"][k] >= 1, f"{name}: {k} never launched")
        # K1 at the largest N of each site, exactly equal to plain
        for site, (N, a1, kw1) in sorted(rec["k1"].items()):
            err, n_ok = compare_k1(mk.search_by_projection_kernel(*a1, **kw1),
                                   mk.search_by_projection_plain(*a1, **kw1))
            errs["K1"] = max(errs["K1"], err)
            summary[f"k1_{site}_max_N"] = int(N)
            print(f"[scale {name}] {gpu}: K1 at the {site} site's largest N == plain (N={N}, "
                  f"M={a1[4].shape[0]}, {int(a1[3].sum())} projected, {n_ok} matched)")
        # K2's stereo template at the call with the most valid rows
        nv = torch.stack([x[0] for x in rec["k2"]]).cpu()
        _, a2, kw2 = rec["k2"][int(torch.argmax(nv))]
        err = compare_k2(pk.pose_ba(*a2, **kw2), pk.pose_ba_plain(*a2, **kw2),
                         f"{name} stereo template at the most valid rows")
        errs["K2"] = max(errs["K2"], err)
        summary["k2_max_valid_rows"] = int(nv.max())
        print(f"[scale {name}] {gpu}: K2's stereo template at the most valid rows vs plain "
              f"(N={a2[3].shape[1]}, {int(nv.max())} valid rows): max |err| {err:.3g}")
        if name == "scale-full":
            big = max(rec["k1"].values(), key=lambda x: x[0])
            rows["K1_scale"] = (big, "match_kernel")
            rows["K2_scale"] = ((a2[3].shape[1], a2, kw2), "pose_kernel")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run["system"].run_global_ba()
            torch.cuda.synchronize()
            summary["run_global_ba_ms"] = (time.perf_counter() - t1) * 1e3
            summary["run_global_ba_keyframes"] = int(tr.map.kf_valid.sum())
        print(f"[scale timing] {gpu}: {name}: a frame median {summary['frame_ms']} ms; early "
              f"(frames 40-140) {summary.get('early_median_s')} s, late (last 100) "
              f"{summary.get('late_median_s')} s; stage medians {summary['stages']}; essential "
              f"graph solves {rec['essential']}; run_global_ba "
              f"{summary.get('run_global_ba_ms')} ms over "
              f"{summary.get('run_global_ba_keyframes')} keyframes")
        run["system"].shutdown()
        out["cells"][name] = summary
        print(f"[scale {name}] cell with its gates: {time.perf_counter() - t_c:.1f} s")
    for kname, ((N, a, kw), prof_name) in rows.items():
        if kname.startswith("K1"):
            fn = lambda: mk.search_by_projection_kernel(*a, **kw)  # noqa: E731
            plain = lambda: mk.search_by_projection_plain(*a, **kw)  # noqa: E731
            b_ms, b_by = bound_ms(*k1_bound(a))
        else:
            fn = lambda: pk.pose_ba(*a, **kw)  # noqa: E731
            plain = lambda: pk.pose_ba_plain(*a, **kw)  # noqa: E731
            b_ms, b_by = bound_ms(*k2_bound(a, kw))
        dev_ms, dev_by = device_kernel_ms(fn, prof_name)
        rows[kname] = dict(N=int(N), ms=time_ms(fn, runs=20), device_ms=dev_ms,
                           device_ms_by=dev_by, plain_ms=time_ms(plain, runs=3, warmup=1),
                           bound_ms=b_ms, bound_by=b_by)
        print(f"[scale timing] {gpu}: {kname} (N={N}): {rows[kname]['ms']:.4f} ms per call, "
              f"device {dev_ms:.5f} ms ({dev_by}), plain {rows[kname]['plain_ms']:.3f} ms, "
              f"bound {b_ms:.6f} ms ({b_by})")
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in ("K1", "K2", "K1 fuse", "K1 merge", "K2 reloc")}
    out.update(failed=failed, launches=launches, call_sites=rows, err=errs)
    return out


def main():
    import torch

    # a fatal signal prints every thread's Python stack (the mapper's too)
    faulthandler.enable()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    gpu = gpu_line()
    print(gpu)
    try:
        from orb_slam3_tpu_torch import device
        from orb_slam3_tpu_torch.kernels import build
    except ImportError as e:
        print(f"FAIL: the port's package is not next to this script: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = device.resolve("cuda")
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    secs = build.build_all()
    print(f"[build] kernels built in {secs:.2f} s")
    for p in build.sources():
        log = build.log_path(p.stem)
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    print(f"[build] {p.stem}: {line.strip()}")

    errs = {"K1": phase_k1(dev), "K2": phase_k2(dev)}
    step, args, rec, launches, cfg_K = phase_slice(dev)
    report = phase_timing(step, args, rec, launches, errs, gpu, cfg_K)
    boot = phase_bootstrap(dev, gpu)
    print(f"[phase] phases 1-7 took {time.perf_counter() - t_start:.1f} s")
    slam = phase_slam(dev, gpu)
    print(f"[phase] phases 1-8 took {time.perf_counter() - t_start:.1f} s")
    depth = phase_depth(dev, gpu)
    print(f"[phase] phases 1-9 took {time.perf_counter() - t_start:.1f} s")
    t10 = time.perf_counter()
    settings = phase_settings(dev, gpu)
    print(f"[phase] phase 10 took {time.perf_counter() - t10:.1f} s")
    t11 = time.perf_counter()
    loop = phase_loop(dev, gpu)
    print(f"[phase] phase 11 took {time.perf_counter() - t11:.1f} s")
    t12 = time.perf_counter()
    vi = phase_vi(dev, gpu)
    print(f"[phase] phase 12 took {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    asy = phase_async(dev, gpu)
    print(f"[phase] phase 13 took {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    io = phase_io(dev, gpu)
    resumed_map, K8 = io.pop("resumed_map"), io.pop("K8")
    print(f"[phase] phase 14 took {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    par = phase_parallel(dev, gpu, resumed_map, K8)
    print(f"[phase] phase 15 took {time.perf_counter() - t15:.1f} s; phases 14-15 "
          f"{time.perf_counter() - t14:.1f} s")
    t16 = time.perf_counter()
    scale = phase_scale(dev, gpu)
    print(f"[phase] phase 16 took {time.perf_counter() - t16:.1f} s")
    # each kernel's row: its launches on the five main paths (and by call
    # site), the bootstrap's numbers at N = lmax, K1's at the fuse, the
    # depth sessions' and the settings sessions' call sites
    for row in report["kernels"]:
        name = row["name"]
        b = boot["kernels"][name]
        row["launches_by_path"] = {"track-full": row["launches"],
                                   "bootstrap": boot["launches"][name],
                                   "slam": slam["launches"][name],
                                   "slam-depth": depth["launches"][name],
                                   "slam-settings": settings["launches"][name],
                                   "slam-loop": loop["launches"][name],
                                   "slam-vi": vi["launches"][name],
                                   "slam-async": asy["launches"][name],
                                   "io (EuRoC driver, resume)": io["launches"][name],
                                   "parallel (fleet)": par["launches"][name],
                                   "scale (scale-full, churn-full)": scale["launches"][name]}
        row["launches"] = sum(row["launches_by_path"].values())
        row["max_abs_err"] = row["max_err"] = max(row["max_abs_err"], boot["err"][name],
                                                  depth["err"][name], settings["err"][name],
                                                  loop["err"][name], vi["err"][name],
                                                  asy["err"][name], io["err"][name],
                                                  par["err"][name], scale["err"][name])
        row["bootstrap"] = b
    k1, k2 = report["kernels"]
    # phase 13's fuse runs on the mapper thread (its launches counted per
    # thread); loop-full's mapper thread launches K1 at the fuse and merge
    async_fuse_k1 = asy["launches"]["K1 fuse"]
    fuse_k1 = (slam["fuse_k1"] + depth["launches"]["K1 fuse"] + settings["launches"]["K1 fuse"]
               + loop["launches"]["K1 fuse"] + vi["launches"]["K1 fuse"] + async_fuse_k1
               + io["launches"]["K1 fuse"] + scale["launches"]["K1 fuse"])
    right_k1 = settings["launches"]["K1 right"]
    merge_k1 = (loop["launches"]["K1 merge"] + io["launches"]["K1 merge"]
                + scale["launches"]["K1 merge"])
    k1["launches_by_site"] = {
        "track (match_local_map)": k1["launches"] - fuse_k1 - depth["launches"]["K1 vo"]
        - right_k1 - merge_k1,
        "fuse (fuse_into_keyframe)": fuse_k1,
        "localization VO points": depth["launches"]["K1 vo"],
        "right camera (fisheye two-camera stage)": right_k1,
        "merge (merge_duplicates_at_keyframe)": merge_k1,
        "of which inertial tracking (after the IMU init)": vi["launches"]["K1 inertial"],
        "of which the fuse on the mapper thread's stream (phase 13)": async_fuse_k1,
        "of which the fuse and merge on the mapper thread's stream (loop-full)":
        loop["launches"]["K1 mapper thread"]}
    k1["fuse"] = slam["k1_fuse"]
    k1["vo"] = depth["call_sites"]["K1_vo"]
    k1["right_camera"] = settings["call_sites"]["K1_right"]
    k2["launches_by_site"] = {"stereo template (depth tracking)": depth["launches"]["K2_stereo"]
                              + settings["launches"]["K2_stereo"] + scale["launches"]["K2"]
                              - scale["launches"]["K2 reloc"],
                              "mono over map + VO rows": depth["launches"]["K2 loc"],
                              "relocalization (after MLPnP)": loop["launches"]["K2 reloc"]
                              + scale["launches"]["K2 reloc"],
                              "of which inertial tracking (after the IMU init)":
                              vi["launches"]["K2 inertial"]}
    k1["merge"] = loop["call_sites"]["K1_merge"]
    k2["reloc"] = loop["call_sites"]["K2_reloc"]
    k2["stereo"] = depth["call_sites"]["K2_stereo"]
    k2["localization"] = depth["call_sites"]["K2_loc"]
    k2["rectified"] = settings["call_sites"]["K2_rectified"]
    k1["inertial"] = vi["call_sites"]["K1_inertial"]
    k1["fuse_recent"] = vi["call_sites"]["K1_fuse_recent"]
    k2["inertial"] = vi["call_sites"]["K2_inertial"]
    k2["fleet"] = par.pop("k2_fleet")
    k1["launches_by_site"]["of which the EuRoC driver and the resumed session (phase 14)"] = \
        io["launches"]["K1"]
    k1["launches_by_site"]["of which the fuse and merge on the mapper thread (phase 14)"] = \
        io["launches"]["K1 mapper thread"]
    k1["launches_by_site"]["of which the fleet (phase 15, once per session)"] = \
        par["launches"]["K1"]
    k2["launches_by_site"]["of which the EuRoC driver and the resumed session (phase 14)"] = \
        io["launches"]["K2"]
    k2["launches_by_site"]["fleet (B = 8, once per fleet step)"] = par["launches"]["K2"]
    for k, kn in ((k1, "K1"), (k2, "K2")):
        k["launches_by_site"]["of which phase 16 (scale-full, churn-full)"] = \
            scale["launches"][kn]
        k["scale"] = scale["call_sites"].get(f"{kn}_scale")
    k1["launches_by_site"]["of which the fuse in phase 16"] = scale["launches"]["K1 fuse"]
    k1["launches_by_site"]["of which the merge in phase 16"] = scale["launches"]["K1 merge"]
    k2["launches_by_site"]["of which the relocalization in phase 16"] = \
        scale["launches"]["K2 reloc"]
    report["bootstrap"] = {k: v for k, v in boot.items() if k != "kernels"}
    report["slam"] = {k: v for k, v in slam.items() if k != "k1_fuse"}
    report["slam_depth"] = {k: v for k, v in depth.items() if k != "call_sites"}
    report["slam_settings"] = {k: v for k, v in settings.items() if k != "call_sites"}
    report["slam_loop"] = {k: v for k, v in loop.items() if k != "call_sites"}
    report["slam_vi"] = {k: v for k, v in vi.items() if k != "call_sites"}
    report["slam_async"] = asy
    report["io"] = io
    report["parallel"] = par
    report["scale"] = {k: v for k, v in scale.items() if k != "call_sites"}
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    failed = (boot["failed"] + slam["failed"] + depth["failed"] + settings["failed"]
              + loop["failed"] + vi["failed"] + asy["failed"] + io["failed"] + par["failed"]
              + scale["failed"])
    if failed:
        print(json.dumps(report, default=str))
        raise SmokeFailure(f"gates failed: {failed}")
    print(json.dumps(report, default=str))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
