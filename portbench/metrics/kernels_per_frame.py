"""kernels_per_frame: the CUDA kernels that started in the profiled frames'
span over the number of those frames. Layer: device."""


def read(run):
    t = run.trace
    return None if t is None else t["kernels"] / t["frames"]
