"""partner_tpu_torch — the PARTNER inference frame in PyTorch with CUDA kernels.

A port of :mod:`partner_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference: the layout below mirrors it module for
module (``models/``, ``ops/``, ``core/``, ``utils/``), and the public
functions keep its tensor layouts — points ``(B, P, C)``, BEV maps NHWC
``(B, H=azimuth, W=range, C)``, window tensors ``(nW, nh, T, hd)`` — so the
parity tests compare like with like.

This package imports ``torch`` and never ``jax`` or ``flax``. The two Pallas
kernels on the flagship inference path are hand-written CUDA kernels for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first CUDA use; each has a
plain PyTorch twin that runs for CPU tensors.
"""

__version__ = "0.1.0"
