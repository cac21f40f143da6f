"""Reading a torch.profiler window: device busy time, idle gaps by the host
work in progress, kernels by name, and K1 / K2's device times.

The busy and idle arithmetic follows `chip_smoke.device_busy` at commit
356070c, taken over every stream's intervals on one timeline instead of a
sum of kernel times, so that overlapping streams are not counted twice.
"""

from __future__ import annotations

FRAME_MARK = "portbench.frame"
K1_NAME = "match_kernel"
K2_NAME = "pose_kernel"


def _kind(ev) -> str:
    """"CUDA" or "CPU" (a DeviceType printed as `DeviceType.CUDA`)."""
    return str(ev.device_type()).rsplit(".", 1)[-1].upper()


def _activity(ev) -> str:
    """The event's activity type in lower case, where this torch's events
    carry one (2.11's do not: its annotation mirrors are told by name)."""
    get = getattr(ev, "activity_type", None)
    return "" if get is None else str(get()).lower()


def split_events(events):
    """(device ops, host ops, frame marks) as (name, start_ns, end_ns, tid)
    tuples. Device ops are the kernels, copies and sets on any stream; the
    profiler's mirror of a host annotation on the device timeline is left
    out."""
    dev, host, marks = [], [], []
    for ev in events:
        name = ev.name()
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        kind = _kind(ev)
        if kind == "CUDA":
            if name.startswith("portbench.") or "annotation" in _activity(ev):
                continue
            dev.append((name, s, e, None))
        elif name == FRAME_MARK:
            marks.append((name, s, e, ev.start_thread_id()))
        else:
            host.append((name, s, e, ev.start_thread_id()))
    return dev, host, marks


def saw_kernels(events, names) -> bool:
    """Whether the window holds a device event of each named kernel (the
    profiler now and then misses some or all of a window's device events)."""
    seen = set()
    for ev in events:
        if _kind(ev) == "CUDA":
            seen.update(n for n in names if n in ev.name())
    return seen == set(names)


def merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def analyse(events, n_frames: int, top: int = 10) -> dict | None:
    """The profiled window's numbers, or None when it holds no device op:
    window_s (first frame's start to last frame's end), busy_s (time in
    which some device op runs, on any stream), kernels (count), the device
    ops with the most time and the longest idle gaps, each labelled by the
    innermost host op in progress at its middle and that op's thread, and
    K1 / K2's device seconds and event counts."""
    dev, host, marks = split_events(events)
    if not dev or not marks:
        return None
    w0 = min(m[1] for m in marks)
    w1 = max(m[2] for m in marks)
    busy = merge([(max(s, w0), min(e, w1)) for _, s, e, _ in dev if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top]
    host.sort(key=lambda h: h[1])
    labelled = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        inner = None
        for name, s, e, tid in host:
            if s > mid:
                break
            if e >= mid and (inner is None or s >= inner[1]):
                inner = (name, s, e, tid)
        label = "no host op" if inner is None else f"{inner[0]} (thread {inner[3]})"
        labelled.append([label, (g1 - g0) / 1e9])
    by_name: dict = {}
    n_kernels = 0
    k = {K1_NAME: [0.0, 0], K2_NAME: [0.0, 0]}
    for name, s, e, _ in dev:
        # K1 / K2 over the whole trace, as every captured call is counted
        for key in k:
            if key in name:
                k[key][0] += (e - s) / 1e9
                k[key][1] += 1
        if w0 <= s < w1:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            n_kernels += is_kernel(name)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9, "kernels": n_kernels,
        "frames": n_frames, "device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled,
        "k1_device_s": k[K1_NAME][0], "k1_events": k[K1_NAME][1],
        "k2_device_s": k[K2_NAME][0], "k2_events": k[K2_NAME][1],
    }
