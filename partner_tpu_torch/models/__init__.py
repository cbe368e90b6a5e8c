from .registry import (  # noqa: F401
    BACKBONES, BBOX_HEADS, DETECTORS, NECKS, READERS, Registry,
    build_from_cfg,
)
from . import (backbone, backbone_dense, center_head, detectors,  # noqa: F401
               e2e_head, readers, rpn, two_stage)


def build_detector(cfg, train_cfg=None, test_cfg=None, *, device,
                   generator=None, use_block_kernel=False):
    """Counterpart of ``partner_tpu.models.build_detector``: a
    ``VoxelNetV3`` (PARTNER), ``VoxelNet`` (CenterPoint) or
    ``TwoStageDetector`` (two-stage CenterPoint) config.

    Builds the detector's module on ``device``; its weights are drawn from
    ``generator`` (a CPU ``torch.Generator``; seed 0 when None) and are
    usually replaced by converted flax weights or a checkpoint.
    ``use_block_kernel=True`` runs the E2E head's Swin blocks on the
    whole-block route (``ops/swin_block.py``); the CenterPoint detectors
    refuse it."""
    return build_from_cfg(dict(cfg), DETECTORS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg,
                               device=device, generator=generator,
                               use_block_kernel=use_block_kernel))
