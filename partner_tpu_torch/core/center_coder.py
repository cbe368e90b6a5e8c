"""CenterCoder (counterpart of ``partner_tpu/core/center_coder.py``).

Boxes ``[x, y, z, dx, dy, dz, yaw]`` are encoded as ``[x, y, z, log dx,
log dy, log dz, cos yaw, sin yaw]`` (sincos mode), dims clamped to >= 1e-5
before the log; ``rectify`` re-expresses yaw relative to the center
azimuth atan2(y, x), wrapped to (-pi, pi]. Predictions live in the same
space, so ``get_delta`` is a difference with the gt encoded on the fly and
``decode`` is the inverse of ``encode``.
"""

import numpy as np
import torch

from .geometry import wrap_angle_pi


class CenterCoder:
    def __init__(self, code_size=7, encode_angle_by_sincos=True,
                 period=2 * np.pi, rectify=False, **kwargs):
        self.base_code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        self.period = period
        self.rectify = rectify
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)

    @staticmethod
    def _prep(boxes):
        dims = torch.clamp(boxes[..., 3:6], min=1e-5)
        return torch.cat([boxes[..., :3], dims, boxes[..., 6:]], dim=-1)

    def _rectified_yaw(self, x, y, yaw):
        if not self.rectify:
            return yaw
        return wrap_angle_pi(yaw - torch.atan2(y, x))

    def encode(self, gt_boxes):
        """(..., 7+) gt boxes -> (..., code_size) encodings."""
        g = self._prep(gt_boxes)
        yaw = self._rectified_yaw(g[..., 0], g[..., 1], g[..., 6])
        if self.encode_angle_by_sincos:
            ang = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
        else:
            ang = yaw[..., None]
        return torch.cat([g[..., :3], torch.log(g[..., 3:6]), ang,
                          g[..., 7:]], dim=-1)

    def get_delta(self, gt_boxes, preds):
        """Regression residual ``encode(gt_boxes) - preds`` (preds already
        in encoded space); in plain-angle mode the yaw is regressed as
        yaw / period."""
        enc = self.encode(gt_boxes)
        if not self.encode_angle_by_sincos:
            enc = torch.cat([enc[..., :6], enc[..., 6:7] / self.period,
                             enc[..., 7:]], dim=-1)
        return enc - preds

    def decode(self, preds):
        """Encoded predictions -> raw boxes [x, y, z, dx, dy, dz, yaw, ...]
        (the true inverse of ``encode``, rectify included)."""
        xyz = preds[..., :3]
        dims = torch.exp(torch.clamp(preds[..., 3:6], -8.0, 8.0))
        if self.encode_angle_by_sincos:
            yaw = torch.atan2(preds[..., 7], preds[..., 6])
            extra = preds[..., 8:]
        else:
            yaw = preds[..., 6] * self.period
            extra = preds[..., 7:]
        if self.rectify:
            yaw = wrap_angle_pi(
                yaw + torch.atan2(preds[..., 1], preds[..., 0]))
        return torch.cat([xyz, dims, yaw[..., None], extra], dim=-1)


def build_coder(cfg):
    """The port has the plain CenterCoder only."""
    cfg = dict(cfg)
    kind = cfg.pop("type", "CenterCoder")
    if kind != "CenterCoder":
        raise ValueError(f"coder {kind!r} is not ported; only CenterCoder")
    return CenterCoder(**cfg)
