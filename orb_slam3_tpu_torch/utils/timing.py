"""Per-stage timing (the port's copy of orb_slam3_tpu/utils/timing.py).

The role of the reference's REGISTER_TIMES harness (`Settings.h:24`,
`Tracking.cc:263-410` PrintTimeStats -> ExecMean.txt): bracket each
pipeline stage, keep per-stage samples in milliseconds, report mean / std /
p50 / p95. The stage names are the JAX package's (`track.*`,
`orb_extraction`, `map.*`), so breakdowns of the two stay comparable.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import numpy as np
import torch


class StageTimer:
    """Samples from every thread (the tracker's and the background
    mapper's) land under their stage names; appending holds a lock."""

    def __init__(self):
        self.samples = defaultdict(list)
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            self.samples.clear()

    def _add(self, name: str, t0: float):
        ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self.samples[name].append(ms)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Bracket a stage in host time. CUDA work is queued and returns
        before the device finishes, so this attributes host time; a stage
        whose result the host reads before it ends includes its device
        time, others do not (use `stage_sync`)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, t0)

    @contextlib.contextmanager
    def stage_sync(self, name: str, device=None):
        """Like `stage`, but waits for the calling thread's current CUDA
        stream on `device` (nothing to wait for on the CPU) before closing
        the bracket, so the stage's device time is inside it. Only that
        stream: a tracking stage does not wait for the mapper's queued BA on
        the mapper's stream, nor a mapper stage for the tracker."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            self._add(name, t0)

    def summary(self) -> dict:
        """Mean / std plus p50 / p95 per stage."""
        with self._lock:
            samples = {k: list(v) for k, v in self.samples.items()}
        return {
            k: {
                "mean_ms": float(np.mean(v)),
                "std_ms": float(np.std(v)),
                "p50_ms": float(np.percentile(v, 50)),
                "p95_ms": float(np.percentile(v, 95)),
                "n": len(v),
            }
            for k, v in samples.items()
        }

    def print_stats(self, path: str | None = None):
        """ExecMean.txt-style dump (Tracking::PrintTimeStats)."""
        lines = ["stage, mean_ms, std_ms, p50_ms, p95_ms, samples"]
        for k, st in sorted(self.summary().items()):
            lines.append(
                f"{k}, {st['mean_ms']:.3f}, {st['std_ms']:.3f}, "
                f"{st['p50_ms']:.3f}, {st['p95_ms']:.3f}, {st['n']}"
            )
        text = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text


GLOBAL_TIMER = StageTimer()
