"""partner_tpu_torch — PARTNER in PyTorch with CUDA kernels.

A port of :mod:`partner_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference: the layout below mirrors it module for
module (``models/``, ``ops/``, ``core/``, ``losses/``, ``train/``,
``data/``, ``eval/``, ``tools/``, ``utils/``), and the public functions
keep its tensor layouts — points ``(B, P, C)``, BEV maps NHWC
``(B, H=azimuth, W=range, C)``, window tensors ``(nW, nh, T, hd)`` — so the
parity tests compare like with like.

This package imports ``torch``, numpy and scipy, and never ``jax``,
``flax``, ``optax`` or anything of ``partner_tpu``. The four Pallas kernels
of the repo are hand-written CUDA kernels for ``sm_90a`` (``csrc/``), built
with ``nvcc`` at first CUDA use; each has a plain PyTorch twin that runs for
CPU tensors. The evaluation entry point is ``python -m
partner_tpu_torch.tools.dist_test``.
"""

__version__ = "0.1.0"
