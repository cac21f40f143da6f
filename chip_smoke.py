#!/usr/bin/env python3
"""Smoke test of the PyTorch port (orb_slam3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final `ok` line:
  1. the card's name and power limit (nvidia-smi); CUDA required; TF32 off;
  2. build both CUDA kernels from orb_slam3_tpu_torch/csrc (one nvcc each,
     started together) and print the build seconds and ptxas reports;
  3. K1 against its plain version at N=2048 landmarks x M=1000 keypoints,
     with planted matches, ties and empty windows: ok exact, idx/dist exact
     where ok;
  4. K2 against its plain version at N=2048 rows, mono and mixed stereo,
     B=1 and B=4: n and mask equal, R within 1e-5 and t within 1e-4;
  5. the tracking step at full width (752x480, 1000 features, 8 levels,
     L=2048) on a self-consistent scene: the launch counters are zeroed,
     the step runs once, both kernels must have launched, >= 90% of the
     frame landmarks are inliers and the true pose is recovered within
     1e-3; the same step on the CPU (plain versions) must recover it too;
     entry()'s own example arguments run and give finite results;
  6. timing with CUDA events (median of 50 runs after warm-up) of the full
     step, each kernel and each plain version at the main path's inputs,
     printed as one JSON line with each kernel's bound.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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


def device_kernel_ms(fn, names, runs=20):
    """Mean device time per call of the kernels whose name contains one of
    `names`, from torch.profiler; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for n in names:
        us = 0.0
        for ev in prof.key_averages():
            if n in ev.key:
                us += getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
        out[n] = us / 1000.0 / runs if us > 0 else None
    return out


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
    return err


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
    for B in (1, 4):
        for stereo in (False, True):
            args, kw = k2_case(dev, B, stereo, seed=10 * B + stereo)
            got = pk.pose_ba(*args, **kw)
            ref = pk.pose_ba_plain(*args, **kw)
            torch.cuda.synchronize()
            what = f"B={B} {'stereo' if stereo else 'mono'}"
            e = compare_k2(got, ref, what)
            err = max(err, e)
            print(f"[k2] {what} N=2048: n={got[3].tolist()} max |err| {e:.3g}")
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
    try:
        from torch.autograd import DeviceType
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
        busy_us, n_kernels = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                busy_us += ev.self_device_time_total
                n_kernels += ev.count
        out["device_busy_share"] = busy_us / 1000.0 / a.elapsed_time(b)
        out["kernels_per_step"] = n_kernels / runs
    except Exception as e:  # the profiler is optional: say why it is missing
        print(f"[timing] profiler breakdown unavailable: {e}")
    return out


# ---------------------------------------------------------------- phase 6
def k1_bound(a):
    from orb_slam3_tpu_torch.frontend import matching

    uv, po, pd, pv, kp, ko, kd, kv, radius = a
    N, M = uv.shape[0], kp.shape[0]
    nbytes = N * (8 + 4 + 32 + 1 + 4) + M * (8 + 4 + 32 + 1) + N * (4 + 4 + 1)
    gated = matching.window_mask(uv, kp, radius, pv, kv) & matching.octave_mask(po, ko, -1, 1)
    # per gate test of a valid landmark: 2 x (sub, abs, compare) + 2 octave
    # compares + valid = 9; per gated-in pair: 8 XOR + 8 popc + 8 adds + 3
    # for the best/second update = 27
    ops = int(pv.sum()) * M * 9 + int(gated.sum()) * 27
    return nbytes, ops


def k2_bound(a, kw, rounds=3, iters=6):
    K, R0, t0, uv, Xw, isig, valid = a
    B, N = uv.shape[0], uv.shape[1]
    stereo = "ur" in kw
    nbytes = B * N * (12 + 8 + 4 + 1 + (4 if stereo else 0)) + B * 17 * 4
    nbytes += B * (36 + 12 + 4) + B * N
    # per row: a cost pass ~36 ops (transform 18, projection 10, chi2 5,
    # gate 3); a Gauss-Newton pass ~200 (cost 31, weights 10, Jacobians 23,
    # 21 + 6 weighted products and sums ~135). Per round: initial cost,
    # iters x (GN + trial cost), reclassification.
    per_row = rounds * (36 + iters * (200 + 36) + 36)
    return nbytes, B * N * per_row


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
        plain_ms = time_ms(plain)
        b_ms, b_by = bound_ms(nbytes, ops)
        try:
            dev_ms = device_kernel_ms(fn, [kname])[kname]
        except Exception as e:  # the profiler is optional: say why it is missing
            print(f"[timing] profiler unavailable for {name}: {e}")
            dev_ms = None
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name], "max_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_ms": dev_ms, "bytes": nbytes, "ops": ops,
        })
        print(f"[timing] {name}: {ms:.4f} ms per call (device {dev_ms}), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    stages = stage_breakdown(step, args, *cfg_K)
    print(f"[timing] full step {step_ms:.3f} ms; stages {stages}")
    return {"kernels": rows, "step_ms": step_ms, "stages": stages, "gpu": gpu}


def main():
    import torch

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
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
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
