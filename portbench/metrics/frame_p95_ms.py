"""frame_p95_ms: the 95th percentile of the host time of every `track_*`
call that returned in the window, outside the profiled frames (the
benchmark's own span around each call, as the reference's examples time
TrackRGBD). Layer: session API (`api/system.System.track_*`)."""

import numpy as np


def read(run):
    return float(np.percentile(run.frame_ms, 95)) if run.frame_ms else None
