"""k2_roofline: K2's share of its roofline in the profiled frames, as
k1_roofline with roofline.k2_bound (valid rows only). Layer: kernels
(`csrc/pose_kernel.cu`)."""


def read(run):
    return run.roofline_pct("k2")
