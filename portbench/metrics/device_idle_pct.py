"""device_idle_pct: the share of the profiled frames' span (first frame's
start to last frame's end) in which no operation runs on any stream of the
card (torch.profiler). Layer: device (one H100, every stream)."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
