"""PyTorch + CUDA port of orb_slam3_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (`ops/`, `frontend/`, `tracking/`) with
the same module and function names. Plain tensor work is PyTorch; each
Pallas kernel of the JAX package is a hand-written CUDA kernel under
`csrc/`, built at first use by `kernels/build.py`. Entry points run on CUDA
unless the caller passes `device="cpu"`; the kernel wrappers run their
plain PyTorch version only for tensors that lie on the CPU.
"""
