"""The box coders of the E2E set-prediction head (counterpart of
``partner_tpu/core/center_coder.py``), selected by ``CODER_CONFIG["type"]``
through :data:`CODERS` and :func:`build_coder`.

- ``CenterCoder``: boxes ``[x, y, z, dx, dy, dz, yaw]`` are encoded as
  ``[x, y, z, log dx, log dy, log dz, cos yaw, sin yaw]`` (sincos mode),
  dims clamped to >= 1e-5 before the log; ``rectify`` re-expresses yaw
  relative to the center azimuth atan2(y, x), wrapped to (-pi, pi].
  Predictions live in the same space, so ``get_delta`` is a difference
  with the gt encoded on the fly and ``decode`` is the inverse of
  ``encode``.

The benchmark's copy keeps ``CenterCoder``, the one its configurations
use.

Every raise of the JAX twin raises here too.
"""

import numpy as np
import torch

from .geometry import wrap_angle_pi


def _angle(yaw, sincos):
    """The yaw column(s) of an encoding: (cos, sin) or the yaw itself."""
    if sincos:
        return torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
    return yaw[..., None]


def _decoded_yaw(preds, sincos, period):
    """-> (yaw, the columns after the angle) of encoded predictions."""
    if sincos:
        return torch.atan2(preds[..., 7], preds[..., 6]), preds[..., 8:]
    return preds[..., 6] * period, preds[..., 7:]


def _yaw_over_period(enc, sincos, period):
    """Plain-angle mode regresses yaw / period (the decode's inverse)."""
    if sincos:
        return enc
    return torch.cat([enc[..., :6], enc[..., 6:7] / period, enc[..., 7:]],
                     dim=-1)


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
        return torch.cat([g[..., :3], torch.log(g[..., 3:6]),
                          _angle(yaw, self.encode_angle_by_sincos),
                          g[..., 7:]], dim=-1)

    def get_delta(self, gt_boxes, preds, **kwargs):
        """Regression residual ``encode(gt_boxes) - preds`` (preds already
        in encoded space); in plain-angle mode the yaw is regressed as
        yaw / period."""
        return _yaw_over_period(self.encode(gt_boxes),
                                self.encode_angle_by_sincos,
                                self.period) - preds

    def decode(self, preds):
        """Encoded predictions -> raw boxes [x, y, z, dx, dy, dz, yaw, ...]
        (the true inverse of ``encode``, rectify included)."""
        xyz = preds[..., :3]
        dims = torch.exp(torch.clamp(preds[..., 3:6], -8.0, 8.0))
        yaw, extra = _decoded_yaw(preds, self.encode_angle_by_sincos,
                                  self.period)
        if self.rectify:
            yaw = wrap_angle_pi(
                yaw + torch.atan2(preds[..., 1], preds[..., 0]))
        return torch.cat([xyz, dims, yaw[..., None], extra], dim=-1)


#: the coder types ``CODER_CONFIG["type"]`` selects
CODERS = {"CenterCoder": CenterCoder}


def build_coder(coder_cfg, period=2 * np.pi):
    """A box coder from a CODER_CONFIG dict: ``type`` (default
    ``CenterCoder``) and the constructor's keyword arguments."""
    cfg = dict(coder_cfg)
    cls = CODERS[cfg.pop("type", "CenterCoder")]
    cfg.setdefault("period", period)
    return cls(**cfg)
