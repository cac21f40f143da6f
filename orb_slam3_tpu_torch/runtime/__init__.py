"""Concurrency runtime of the port: the background mapper.

The reference runs LocalMapping, LoopClosing and a transient global BA as
threads around a mutex-guarded pointer graph (`System.cc:197,214,233`).
The port keeps tracking on the caller's thread and runs the whole
per-keyframe mapping stack on one background mapper thread, on a CUDA
stream of its own, over immutable MapState snapshots published as commits
(`runtime/mapper.py`).
"""

from .mapper import AsyncMapper, MapCommit  # noqa: F401
