"""extract_ms: the mean of stage `orb_extraction`'s samples over the window
(the program's `utils/timing.GLOBAL_TIMER`, reset at the window's
start). Layer: ORB frontend (`frontend/orb`, `pyramid`, `fast`,
`select`)."""


def read(run):
    return run.stage_mean("orb_extraction")
