from .registry import (  # noqa: F401
    BACKBONES, BBOX_HEADS, DETECTORS, NECKS, Registry, build_from_cfg,
)
from . import backbone_dense, detectors, e2e_head, rpn  # noqa: F401


def build_detector(cfg, train_cfg=None, test_cfg=None, *, device,
                   generator=None):
    """Counterpart of ``partner_tpu.models.build_detector`` (inference).

    Builds the detector's module on ``device``; its weights are drawn from
    ``generator`` (a CPU ``torch.Generator``; seed 0 when None) and are
    usually replaced by converted flax weights or a checkpoint."""
    return build_from_cfg(dict(cfg), DETECTORS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg,
                               device=device, generator=generator))
