"""Device resolution for the port's entry points.

Entry points and the functions that make example inputs take
`device=None`, which means CUDA. Asking for CUDA on a host without it
raises: nothing drops to the CPU on its own. The CPU is used only when the
caller names it.
"""

from __future__ import annotations

import torch


def init_cuda() -> None:
    """Full-f32 matmuls and convolutions: the pyramid resize and the
    IC-angle moments are f32 matmuls, and TF32 would move keypoints."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device=None) -> torch.device:
    """`None` -> CUDA. Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested (the default) but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions on the CPU"
            )
        init_cuda()
    return dev
