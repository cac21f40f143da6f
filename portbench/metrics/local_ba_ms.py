"""local_ba_ms: the mean of stage `map.local_ba`'s samples over the window
(the program's `utils/timing.GLOBAL_TIMER`, reset at the window's
start). Layer: mapper (`runtime/mapper`, `mapping/local_mapper`,
`lm/schur`; after the IMU init `imu/vi_ba`)."""


def read(run):
    return run.stage_mean("map.local_ba")
