"""Robust loss weights and chi-square gates (port of orb_slam3_tpu/ops/robust.py).

The reference's g2o RobustKernelHuber with per-edge-type deltas (sqrt(5.991)
mono, sqrt(7.815) stereo) and the hard chi2 gates at the same thresholds
(`Optimizer.cc:871-872, 999-1046`). In IRLS form the Huber kernel is the
per-edge weight w = rho'(e2).
"""

import math

import torch

CHI2_2DOF = 5.991   # mono reprojection
CHI2_3DOF = 7.815   # stereo reprojection
CHI2_6DOF = 12.592
CHI2_9DOF = 16.919  # inertial residual gate

HUBER_MONO = math.sqrt(CHI2_2DOF)
HUBER_STEREO = math.sqrt(CHI2_3DOF)


def huber_weight(e2, delta):
    """IRLS weight of the Huber kernel for squared error e2 = r^T Omega r:
    1 where e <= delta, delta / e beyond."""
    e = torch.sqrt(torch.clamp(e2, min=1e-18))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def huber_rho(e2, delta):
    """Huber cost as g2o applies it: e2 where e <= delta, else
    2 delta e - delta^2."""
    e = torch.sqrt(torch.clamp(e2, min=1e-18))
    return torch.where(e <= delta, e2, 2.0 * delta * e - delta * delta)
