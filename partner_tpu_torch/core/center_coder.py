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
- ``CenterCoderV2``: the same encoding; its rectified ``get_delta`` reads
  the predicted yaw relative to the emitting cell's azimuth
  (``x_grid``, ``y_grid``), so its rectified ``decode`` raises; and
  ``encode_with_rois``, the RoI-relative encoding.
- ``CenterCoderPolar``: ``[rho, phi, z, log radius, log dz, dy / dx, cos,
  sin]`` with radius half the BEV diagonal; ``PolarTP`` regresses the
  ratio around ``template_ratio``, ``PolarSIG`` stores
  logit(dx / dy) (clamped below 1) and regresses the raw ratio against
  1 / sigmoid(prediction).
- ``CenterCoderTP``: dims as linear offsets from a template box, with no
  clamp in ``decode``; ``CenterCoderMTTP``: dims as log(d / anchor) with a
  per-task anchor row ``tmp_box[task_id]`` and no rectify.

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


class CenterCoderV2(CenterCoder):
    """CenterCoder's encoding with a grid-relative rectified delta and the
    RoI-relative ``encode_with_rois``."""

    def get_delta(self, gt_boxes, preds, x_grid=None, y_grid=None,
                  **kwargs):
        """Per-column residual; under ``rectify`` the predicted (cos, sin)
        is turned into the global frame by the emitting cell's azimuth
        atan2(y_grid, x_grid) first. Sincos mode only."""
        if not self.encode_angle_by_sincos:
            raise NotImplementedError(
                "CenterCoderV2.get_delta requires sincos mode")
        g = self._prep(gt_boxes)
        xyz_t = g[..., :3] - preds[..., :3]
        dims_t = torch.log(g[..., 3:6]) - preds[..., 3:6]
        cosp, sinp = preds[..., 6], preds[..., 7]
        if self.rectify:
            assert x_grid is not None and y_grid is not None
            theta = wrap_angle_pi(torch.atan2(sinp, cosp)
                                  + torch.atan2(y_grid, x_grid))
            cosp, sinp = torch.cos(theta), torch.sin(theta)
        rg = g[..., 6]
        ang_t = torch.stack([torch.cos(rg) - cosp, torch.sin(rg) - sinp],
                            dim=-1)
        return torch.cat([xyz_t, dims_t, ang_t, g[..., 7:] - preds[..., 8:]],
                         dim=-1)

    def decode(self, preds):
        if self.rectify:
            # the rectified yaw is relative to the emitting cell, which a
            # bare encoding row does not carry
            raise NotImplementedError(
                "CenterCoderV2 rectified decode needs the grid cell; "
                "decode at the head where x_grid/y_grid are in scope")
        return CenterCoder.decode(self, preds)

    def encode_with_rois(self, boxes, rois):
        """RoI-relative encoding: centers over the RoI's BEV diagonal, z
        over its height, dims as log ratios, yaw by difference (of cos and
        sin in sincos mode)."""
        b = self._prep(boxes)
        r = self._prep(rois)
        diag = torch.sqrt(r[..., 3] ** 2 + r[..., 4] ** 2)
        xt = (b[..., 0] - r[..., 0]) / diag
        yt = (b[..., 1] - r[..., 1]) / diag
        zt = (b[..., 2] - r[..., 2]) / r[..., 5]
        dims_t = torch.log(b[..., 3:6] / r[..., 3:6])
        if self.encode_angle_by_sincos:
            ang = torch.stack([torch.cos(b[..., 6]) - torch.cos(r[..., 6]),
                               torch.sin(b[..., 6]) - torch.sin(r[..., 6])],
                              dim=-1)
        else:
            ang = (b[..., 6] - r[..., 6])[..., None]
        return torch.cat([torch.stack([xt, yt, zt], dim=-1), dims_t, ang,
                          b[..., 7:] - r[..., 7:]], dim=-1)


class CenterCoderPolar(CenterCoder):
    """Polar encoding ``[rho, phi, z, log radius, log dz, ratio, cos, sin]``
    (radius = half the BEV diagonal, ratio = dy / dx); under ``rectify``
    the yaw is relative to phi. ``decode`` inverts radius and ratio back
    to (dx, dy) and (rho, phi) to (x, y)."""

    def encode(self, gt_boxes):
        g = self._prep(gt_boxes)
        x, y, z = g[..., 0], g[..., 1], g[..., 2]
        dx, dy, dz = g[..., 3], g[..., 4], g[..., 5]
        rho = torch.sqrt(x ** 2 + y ** 2)
        phi = torch.atan2(y, x)
        radius = torch.sqrt(dx ** 2 + dy ** 2) * 0.5
        ratio = dy / dx
        yaw = g[..., 6]
        if self.rectify:
            yaw = wrap_angle_pi(yaw - phi)
        return torch.cat(
            [torch.stack([rho, phi, z, torch.log(radius), torch.log(dz),
                          ratio], dim=-1),
             _angle(yaw, self.encode_angle_by_sincos), g[..., 7:]], dim=-1)

    def get_delta(self, gt_boxes, preds, **kwargs):
        """``encode(gt) - preds``, sincos mode only."""
        if not self.encode_angle_by_sincos:
            raise NotImplementedError(
                "polar coders regress yaw as (cos, sin) only")
        return self.encode(gt_boxes) - preds

    def decode(self, preds):
        rho, phi, z = preds[..., 0], preds[..., 1], preds[..., 2]
        radius = torch.exp(torch.clamp(preds[..., 3], -8.0, 8.0))
        dz = torch.exp(torch.clamp(preds[..., 4], -8.0, 8.0))
        ratio = self._decode_ratio(preds[..., 5])
        dx = 2.0 * radius / torch.sqrt(1.0 + ratio ** 2)
        dy = ratio * dx
        yaw, extra = _decoded_yaw(preds, self.encode_angle_by_sincos,
                                  self.period)
        if self.rectify:
            yaw = wrap_angle_pi(yaw + phi)
        x = rho * torch.cos(phi)
        y = rho * torch.sin(phi)
        return torch.cat(
            [torch.stack([x, y, z, dx, dy, dz, yaw], dim=-1), extra], dim=-1)

    @staticmethod
    def _decode_ratio(ratio_col):
        """Predicted ratio column -> the raw aspect dy / dx."""
        return ratio_col


class CenterCoderPolarTP(CenterCoderPolar):
    """CenterCoderPolar with the ratio column regressing
    ``dy / dx - template_ratio``."""

    def __init__(self, template_ratio=None, **kwargs):
        super().__init__(**kwargs)
        assert template_ratio is not None, "ratio = dy / dx"
        self.template_ratio = float(template_ratio)

    def encode(self, gt_boxes):
        enc = super().encode(gt_boxes)
        return torch.cat([enc[..., :5], enc[..., 5:6] - self.template_ratio,
                          enc[..., 6:]], dim=-1)

    def _decode_ratio(self, ratio_col):
        return ratio_col + self.template_ratio


class CenterCoderPolarSIG(CenterCoderPolar):
    """CenterCoderPolar with the ratio column storing logit(dx / dy) (dy >=
    dx, so the inverse ratio lies in (0, 1]; clamped to 1 - 1e-6 so that a
    square box's target stays finite); ``get_delta`` regresses the raw
    ratio against the decoded prediction 1 / sigmoid(column)."""

    def encode(self, gt_boxes):
        enc = super().encode(gt_boxes)
        inv = torch.clamp(1.0 / enc[..., 5], max=1.0 - 1e-6)
        logit = torch.log(inv) - torch.log1p(-inv)
        return torch.cat([enc[..., :5], logit[..., None], enc[..., 6:]],
                         dim=-1)

    def get_delta(self, gt_boxes, preds, **kwargs):
        if not self.encode_angle_by_sincos:
            raise NotImplementedError(
                "polar coders regress yaw as (cos, sin) only")
        # the polar targets with the ratio column in raw dy / dx units
        enc = CenterCoderPolar.encode(self, gt_boxes)
        delta = enc - preds
        ratio_t = enc[..., 5] - 1.0 / torch.sigmoid(preds[..., 5])
        return torch.cat([delta[..., :5], ratio_t[..., None],
                          delta[..., 6:]], dim=-1)

    def _decode_ratio(self, ratio_col):
        return 1.0 / torch.sigmoid(ratio_col)


class CenterCoderTP(CenterCoder):
    """CenterCoder with dims as linear offsets ``d - template`` from a
    template box [tx, ty, tz], given per call or as the ``templates_box``
    default; ``decode`` does not clamp the dims."""

    def __init__(self, templates_box=None, **kwargs):
        super().__init__(**kwargs)
        self.templates_box = (
            None if templates_box is None
            else torch.as_tensor(templates_box, dtype=torch.float32))

    def _template(self, template_box, like):
        t = self.templates_box if template_box is None else template_box
        assert t is not None, "CenterCoderTP needs a template box [tx,ty,tz]"
        return torch.as_tensor(t, dtype=torch.float32, device=like.device)

    def encode(self, gt_boxes, templates_box=None):
        g = self._prep(gt_boxes)
        dims = g[..., 3:6] - self._template(templates_box, g)
        yaw = self._rectified_yaw(g[..., 0], g[..., 1], g[..., 6])
        return torch.cat([g[..., :3], dims,
                          _angle(yaw, self.encode_angle_by_sincos),
                          g[..., 7:]], dim=-1)

    def get_delta(self, gt_boxes, preds, template_box=None, **kwargs):
        enc = self.encode(gt_boxes, self._template(template_box, preds))
        return _yaw_over_period(enc, self.encode_angle_by_sincos,
                                self.period) - preds

    def decode(self, preds, template_box=None):
        xyz = preds[..., :3]
        dims = preds[..., 3:6] + self._template(template_box, preds)
        yaw, extra = _decoded_yaw(preds, self.encode_angle_by_sincos,
                                  self.period)
        if self.rectify:
            yaw = wrap_angle_pi(
                yaw + torch.atan2(preds[..., 1], preds[..., 0]))
        return torch.cat([xyz, dims, yaw[..., None], extra], dim=-1)


class CenterCoderMTTP(CenterCoder):
    """Dims as log(d / anchor), the anchor the task's row of ``tmp_box``
    (num_tasks, 3); decoded as exp(column) x anchor. No rectify."""

    def __init__(self, tmp_box=None, **kwargs):
        kwargs.pop("rectify", None)
        super().__init__(rectify=False, **kwargs)
        assert tmp_box is not None, "per-task anchor sizes required"
        self.tmp_box = torch.as_tensor(tmp_box, dtype=torch.float32)

    def _anchor(self, task_id, like):
        return self.tmp_box[task_id].to(like.device)

    def encode(self, gt_boxes, task_id=0):
        g = self._prep(gt_boxes)
        dims = torch.log(g[..., 3:6] / self._anchor(task_id, g))
        return torch.cat([g[..., :3], dims,
                          _angle(g[..., 6], self.encode_angle_by_sincos),
                          g[..., 7:]], dim=-1)

    def get_delta(self, gt_boxes, preds, task_id=0, **kwargs):
        return _yaw_over_period(self.encode(gt_boxes, task_id),
                                self.encode_angle_by_sincos,
                                self.period) - preds

    def decode(self, preds, task_id=0):
        dims = (torch.exp(torch.clamp(preds[..., 3:6], -8.0, 8.0))
                * self._anchor(task_id, preds))
        yaw, extra = _decoded_yaw(preds, self.encode_angle_by_sincos,
                                  self.period)
        return torch.cat([preds[..., :3], dims, yaw[..., None], extra],
                         dim=-1)


#: the coder types ``CODER_CONFIG["type"]`` selects
CODERS = {
    "CenterCoder": CenterCoder,
    "CenterCoderV2": CenterCoderV2,
    "CenterCoderPolar": CenterCoderPolar,
    "CenterCoderPolarTP": CenterCoderPolarTP,
    "CenterCoderPolarSIG": CenterCoderPolarSIG,
    "CenterCoderTP": CenterCoderTP,
    "CenterCoderMTTP": CenterCoderMTTP,
}


def build_coder(coder_cfg, period=2 * np.pi):
    """A box coder from a CODER_CONFIG dict: ``type`` (default
    ``CenterCoder``) and the constructor's keyword arguments."""
    cfg = dict(coder_cfg)
    cls = CODERS[cfg.pop("type", "CenterCoder")]
    cfg.setdefault("period", period)
    return cls(**cfg)
