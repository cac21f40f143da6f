"""A prefetching frame loader for dataset playback (the port's counterpart
of orb_slam3_tpu/utils/frameloader.py).

The JAX package binds `native/libframeloader.so` (C++ worker threads with
libpng and libjpeg). A CUDA host need not have either library, so the port
decodes with its own PNG codec (`utils/png.py`; binary PGM too) on a pool
of worker threads, on every host alike: the same interface, the same
bounded in-order queue. zlib's inflate and numpy's row reconstruction
release the interpreter lock for most of a decode, so decodes overlap
with tracking. JPEG files are refused with an error naming the file.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import png

DECODER = "png codec (utils/png.py) on a thread pool"


def _decode(path: str) -> np.ndarray:
    return png.read_gray(path)


class FrameLoader:
    """Iterate decoded grayscale frames (float32 [H, W]) in order, at most
    `queue_depth` decoded or decoding ahead of the consumer on `n_threads`
    worker threads.

    >>> for img in FrameLoader([...paths...]):
    ...     system.track_monocular(img, ts)
    """

    decoder = DECODER

    def __init__(self, paths, n_threads: int = 3, queue_depth: int = 8):
        self._paths = list(paths)
        self._next = 0
        self._depth = max(1, int(queue_depth))
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(n_threads)),
                                        thread_name_prefix="frameloader")
        self._queue = collections.deque()
        self._fill()

    def _fill(self):
        while len(self._queue) < self._depth and self._next < len(self._paths):
            p = self._paths[self._next]
            self._queue.append((p, self._pool.submit(_decode, p)))
            self._next += 1

    def __len__(self):
        return len(self._paths)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._pool is None or not self._queue:
            raise StopIteration
        path, fut = self._queue.popleft()
        self._fill()
        try:
            img = fut.result()
        except (OSError, ValueError) as e:
            raise IOError(f"frame decode failed: {path}: {e}") from e
        return img.astype(np.float32)

    def close(self):
        if self._pool is not None:
            for _, fut in self._queue:
                fut.cancel()
            self._queue.clear()
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass
