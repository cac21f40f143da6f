"""The host half of the kernel wrappers, checked on the CPU.

- `check_args` rejects exactly what `check_tensor` rejects (device, dtype,
  shape, contiguity), and `check_aligned` a descriptor off a 16-byte
  boundary.
- The per-device scalars of tracking/track.py are made once and hold the
  bits that computing them each call gives, so the predicted octaves do not
  move.
- `pose_optimize_stereo` gives the same result for `bf` as a float and as a
  tensor already on the device.
"""

import numpy as np
import pytest
import torch

from orb_slam3_tpu_torch.frontend import camera as tcam
from orb_slam3_tpu_torch.kernels import build
from orb_slam3_tpu_torch.tracking import track as ttrack

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32 = torch.float32


def _spec(t, dtype=F32, shape=(4, 2)):
    return (("x", t, dtype, shape),)


def test_check_args_accepts_what_the_kernels_take():
    build.check_args(CPU, _spec(torch.zeros(4, 2)))
    build.check_args(CPU, (("a", torch.zeros(3), F32, (3,)),
                           ("b", torch.zeros(2, 5, dtype=torch.bool), torch.bool, (2, 5))))


@pytest.mark.parametrize("case,err", [
    ("dtype", TypeError), ("shape", ValueError), ("contiguity", ValueError),
])
def test_check_args_rejects_what_check_tensor_rejects(case, err):
    t = {
        "dtype": torch.zeros(4, 2, dtype=torch.float64),
        "shape": torch.zeros(4, 3),
        "contiguity": torch.zeros(2, 4).T,
    }[case]
    with pytest.raises(err):
        build.check_tensor("x", t, F32, (4, 2), CPU)
    with pytest.raises(err, match="x: "):
        build.check_args(CPU, _spec(t))


def test_check_aligned():
    buf = torch.zeros(64, dtype=torch.uint8)
    build.check_aligned("d", buf)
    with pytest.raises(ValueError, match="16-byte"):
        build.check_aligned("d", buf[1:])


def test_device_scalars_are_cached_and_bit_identical():
    a = ttrack._scalar(1.2, CPU)
    assert a is ttrack._scalar(1.2, CPU)
    assert a.dtype == F32 and a.ndim == 0
    log_s = ttrack._log_scale(CPU)
    assert log_s is ttrack._log_scale(CPU)
    fresh = torch.log(torch.tensor(1.2, dtype=F32))
    assert log_s.view(torch.int32).item() == fresh.view(torch.int32).item()


def test_stereo_pose_bf_as_float_or_device_tensor():
    rng = np.random.default_rng(2)
    n = 60
    Xw = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, (n, 1))], 1)
    uv = np.stack([450 * Xw[:, 0] / Xw[:, 2] + 376, 450 * Xw[:, 1] / Xw[:, 2] + 240], -1)
    ur = np.where(rng.uniform(size=n) < 0.5, uv[:, 0] - 45.0 / Xw[:, 2], -1.0)
    f = lambda a: torch.tensor(a, dtype=F32)
    K = tcam.make_pinhole(450.0, 450.0, 376.0, 240.0, device="cpu")
    common = (torch.eye(3), torch.zeros(3), f(uv), f(ur), f(Xw), torch.ones(n),
              torch.ones(n, dtype=torch.bool))
    as_float = ttrack.pose_optimize_stereo(tcam.PINHOLE, K, 45.0, *common)
    as_tensor = ttrack.pose_optimize_stereo(tcam.PINHOLE, K, torch.tensor(45.0), *common)
    for a, b in zip(as_float, as_tensor):
        assert torch.equal(a, b)
    assert int(as_float[3]) == n
