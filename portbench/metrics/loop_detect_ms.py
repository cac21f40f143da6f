"""loop_detect_ms: the mean of stage `map.loop_detect`'s samples over the
window (the program's `utils/timing.GLOBAL_TIMER`, reset at the window's
start). Layer: place recognition, loop closing (`place/*`,
`graphopt/loop_closer`)."""


def read(run):
    return run.stage_mean("map.loop_detect")
