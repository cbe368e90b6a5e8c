"""CenterCoder decode (counterpart of ``partner_tpu/core/center_coder.py``).

Only the inverse used at inference is ported: encoded predictions
``[x, y, z, log dx, log dy, log dz, cos yaw, sin yaw]`` back to boxes
``[x, y, z, dx, dy, dz, yaw]``.
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

    def decode(self, preds):
        """Encoded predictions -> raw boxes [x, y, z, dx, dy, dz, yaw, ...]
        (the true inverse of the JAX coder's encode, rectify included)."""
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
    """The port decodes with the plain CenterCoder only."""
    cfg = dict(cfg)
    kind = cfg.pop("type", "CenterCoder")
    if kind != "CenterCoder":
        raise ValueError(f"coder {kind!r} is not ported; only CenterCoder")
    return CenterCoder(**cfg)
