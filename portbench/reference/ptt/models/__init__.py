"""The detectors of the benchmark's configurations, plain PyTorch."""

from .registry import DETECTORS, build_from_cfg
from . import (backbone, center_head, detectors,  # noqa: F401
               e2e_head, readers, rpn)


def build_detector(cfg, train_cfg=None, test_cfg=None, *, device,
                   generator=None):
    """A ``VoxelNetV3`` (PARTNER) or ``VoxelNet`` (CenterPoint) config ->
    its detector on ``device`` (``device="meta"`` draws no weights)."""
    return build_from_cfg(dict(cfg), DETECTORS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg,
                               device=device, generator=generator,
                               use_block_kernel=False))
