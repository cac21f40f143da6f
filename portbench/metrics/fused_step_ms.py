"""fused_step_ms: the mean of stage `track.fused_step`'s samples over the
window (the program's `utils/timing.GLOBAL_TIMER`, reset at the window's
start). Layer: tracking (`tracking/tracker`, `tracking/track`)."""


def read(run):
    return run.stage_mean("track.fused_step")
