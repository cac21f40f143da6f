"""k1_roofline: K1's share of its roofline in the profiled frames: the mean
bound time per call (roofline.k1_bound on each call's inputs, against the
peaks of roofline.PEAKS) over the mean device time per K1 event. Layer:
kernels (`csrc/match_kernel.cu`)."""


def read(run):
    return run.roofline_pct("k1")
