"""STROBE and HAN, the sweep- and sector-streaming pillar detectors
(counterpart of ``partner_tpu/models/strobe.py``).

- :class:`StrobeModule` (``STROBE``, ``STROBEV2``, ``STROBEV3`` at one
  sector): the sweeps of a (B, S, P, C) batch, oldest first, each
  pillarized on the whole grid with shared weights; ``RPNUber``
  concatenates each scale's input with the previous sweep's input of that
  scale. ``v1`` carries those contexts as they are; ``v2`` warps each
  carried scale into the current ego frame
  (:func:`~partner_tpu_torch.ops.warp.ego_motion_warp_polar`, by the
  batch's ``sweep_transforms`` (B, S, 3, 3) current -> previous); ``v3``
  warps the previous canvas and runs the neck on it, without a context,
  to get the contexts. The head runs on the last sweep, a seg head on its
  canvas.
- :class:`StrobeSectorModule` (STROBE at more than one sector): the
  sweeps outside, the sectors inside; each sector's neck gets the same
  sector's contexts from the previous sweep; the heads run on the last
  sweep's sectors.
- :class:`PolarStreamLSTMModule` (HAN 4-sector, ``PointPillarsLSTM`` /
  ``PointPillarsLSTMV1``): the PolarStream sector loop with an
  :class:`LSTMCell` memory of ``num_filters[-1]`` features over each
  sector's canvas mean (zero initial carry); its output is added to the
  next sector's canvas, channel by channel, before the neck (whose
  ``RPNWaymoLSTM`` carries its own ConvLSTM state from sector to sector).
  ``PointPillarsNoLSTM`` is the plain PolarStream module.

Every STROBE detector has ``input_kind`` "sweeps": no loader of either
package builds its (B, S, P, C) batch (ROADMAP.md §3), so ``dist_test``
and ``train`` refuse it; ``predict``, ``loss`` and ``make_train_step``
take the batch. No TPU kernel lies on this path: JAX wrote it in plain
XLA, the port in plain torch.
"""

import torch
import torch.nn as nn

from ..ops.warp import ego_motion_warp_polar
from .layers import Dense, constant
from .pillar import (PointPillarsModule, max_pillars_rule,
                     pillar_module_kwargs)
from .polarstream import (PolarStreamModule, check_stream_neck,
                          stream_detector)
from .registry import DETECTORS

GATES = "ifgo"


class RecurrentDense(Dense):
    """A flax ``OptimizedLSTMCell`` recurrent kernel: a Dense with bias,
    its kernel drawn orthogonal (flax's ``recurrent_kernel_init``)."""

    def init_extra(self, generator):
        w = torch.empty(tuple(self.weight.shape))
        nn.init.orthogonal_(w, generator=generator)
        self.weight.copy_(w)


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell(features)``: input kernels ``ii``,
    ``if``, ``ig``, ``io`` (no bias) and recurrent kernels ``hi``, ``hf``,
    ``hg``, ``ho`` (bias), gates i, f, g, o: c' = sigmoid(f) c + sigmoid(i)
    tanh(g), h' = sigmoid(o) tanh(c'). The carry is (c, h), as flax's."""

    def __init__(self, in_features, features):
        super().__init__()
        self.features = features
        for g in GATES:
            self.add_module(f"i{g}", Dense(in_features, features,
                                           use_bias=False))
            self.add_module(f"h{g}", RecurrentDense(features, features))

    def forward(self, carry, x):
        """carry (c, h) each (B, F), x (B, C_in) -> ((c', h'), h')."""
        c, h = carry
        z = {g: getattr(self, f"h{g}")(h) + getattr(self, f"i{g}")(x)
             for g in GATES}
        c = torch.sigmoid(z["f"]) * c + torch.sigmoid(z["i"]) * torch.tanh(
            z["g"])
        h = torch.sigmoid(z["o"]) * torch.tanh(c)
        return (c, h), h


class StrobeModule(PointPillarsModule):
    """Multi-sweep streaming pillars (``strobe.py:47-79``)."""

    def __init__(self, *args, variant="v1", **kwargs):
        super().__init__(*args, **kwargs)
        self.variant = variant

    def forward(self, example, generator=None):
        """example {"points": (B, S, P, C), "points_mask": (B, S, P)[,
        "sweep_transforms": (B, S, 3, 3)]} -> the last sweep's head maps
        (with a seg head its ``seg_preds`` too). Without transforms the
        warped variants carry their contexts as ``v1`` does.
        ``generator`` is unused (no dropout)."""
        points, mask = example["points"], example["points_mask"]
        tfs = example.get("sweep_transforms")
        pr = constant(self, "pc_range_f32", points.device,
                      lambda: torch.tensor(self.pc_range,
                                           dtype=torch.float32))
        prev_ctx = prev_canvas = None
        for si in range(points.shape[1]):
            canvas = self.encode_canvas(points[:, si], mask[:, si])
            if (self.variant == "v2" and prev_ctx is not None
                    and tfs is not None):
                prev_ctx = [ego_motion_warp_polar(c, tfs[:, si], pr)
                            for c in prev_ctx]
            elif (self.variant == "v3" and prev_canvas is not None
                    and tfs is not None):
                warped = ego_motion_warp_polar(prev_canvas, tfs[:, si], pr)
                _, prev_ctx = self.neck(warped, prev_sweep=None)
            x, prev_ctx = self.neck(canvas, prev_sweep=prev_ctx)
            prev_canvas = canvas
        return self.heads(canvas, x)


class StrobeSectorModule(PolarStreamModule):
    """STROBE over azimuth sectors (``strobe.py:82-118``)."""

    def forward(self, example, generator=None):
        """example {"points": (B, S, P, C), "points_mask": (B, S, P)} ->
        {"sector_preds": [the last sweep's head maps per sector]} (with a
        seg head its ``seg_preds`` too). ``generator`` is unused."""
        points, mask = example["points"], example["points_mask"]
        n_sweeps = points.shape[1]
        preds, segs = [], []
        prev = [None] * self.n_sectors
        for si in range(n_sweeps):
            last = si == n_sweeps - 1
            ctxs = []
            for s, (pts_s, sel) in enumerate(self.sector_inputs(
                    points[:, si], mask[:, si])):
                canvas = self.encode_sector(pts_s, sel)
                x, c = self.neck(canvas, prev_sweep=prev[s])
                ctxs.append(c)
                if last:
                    preds.append(self.bbox_head(x))
                    if self.seg_head is not None:
                        segs.append(self.seg_head(canvas, x)["seg_preds"])
            prev = ctxs
        out = {"sector_preds": preds}
        if segs:
            out["seg_preds"] = segs
        return out


class PolarStreamLSTMModule(PolarStreamModule):
    """The PolarStream sector loop with a recurrent channel memory between
    sectors (``strobe.py:121-159``)."""

    def __init__(self, reader_cfg, *args, **kwargs):
        super().__init__(reader_cfg, *args, **kwargs)
        feats = tuple(dict(reader_cfg).get("num_filters", (64,)))[-1]
        self.lstm = LSTMCell(feats, feats)

    def forward(self, example, generator=None):
        """As :meth:`PolarStreamModule.forward`; from sector 1 on, the
        canvas gets the LSTM's output of the previous sector's (updated)
        canvas mean added before the neck and the seg head."""
        preds, segs, ctx = [], [], None
        lstm_out = state = None
        for s, (pts_s, sel) in enumerate(self.sector_inputs(
                example["points"], example["points_mask"])):
            canvas = self.encode_sector(pts_s, sel)
            if lstm_out is not None:
                canvas = canvas + lstm_out[:, None, None, :]
            x, ctx = self.neck(canvas, ctx)
            preds.append(self.bbox_head(x))
            if self.seg_head is not None:
                segs.append(self.seg_head(canvas, x)["seg_preds"])
            if s < self.n_sectors - 1:
                pooled = canvas.mean(dim=(1, 2))
                if state is None:
                    zero = pooled.new_zeros(pooled.shape[:-1]
                                            + (self.lstm.features,))
                    state = (zero, zero)
                state, lstm_out = self.lstm(state, pooled)
        out = {"sector_preds": preds}
        if segs:
            out["seg_preds"] = segs
        return out


def no_sweep_loader(tool, name):
    """The message a CLI exits with on a STROBE config."""
    return (f"{tool}: {name} takes (B, S, P, C) batches of S sweeps (points "
            "(B, S, P, C), points_mask (B, S, P), sweep_transforms (B, S, 3, "
            "3)); no loader builds them, in this package or in the JAX one "
            "(a sweep-split loader is missing; ROADMAP.md §3). Drive it "
            "through build_detector(...).predict, loss and make_train_step")


def _refuse_block_kernel(use_block_kernel, name):
    if use_block_kernel:
        raise ValueError("use_block_kernel is an option of the E2E head's "
                         f"Swin blocks; {name}'s CenterHead has none")


def _build_strobe(variant):
    def build(reader, neck, bbox_head, backbone=None, seg_head=None,
              part_head=None, pretrained=None, train_cfg=None,
              test_cfg=None, max_pillars=None, nsectors=1, *, device,
              generator=None, use_block_kernel=False):
        """STROBE factory (``strobe.py:196-243``): ``max_pillars`` by
        ``max_pillars_rule`` over the model's ``nsectors`` (30,000 at
        one sector, 7,504 a sector at four); at one sector a
        :class:`StrobeModule` in a ``CenterPointDetector`` (seg weight
        1.0 by default), else a :class:`StrobeSectorModule` in a
        ``PolarStreamDetector`` (2.0). ``input_kind`` is "sweeps"."""
        from .detectors import CenterPointDetector, _materialize

        _refuse_block_kernel(use_block_kernel, "STROBE")
        if max_pillars is None:
            max_pillars = max_pillars_rule(bbox_head.get("voxel_generator"),
                                           nsectors)
        kw = pillar_module_kwargs(reader, neck, bbox_head, max_pillars)
        seg = dict(seg_head) if seg_head else None
        shape = bbox_head.get("voxel_shape", "cylinder")
        if nsectors > 1:
            check_stream_neck(neck)
            module = _materialize(device, generator, lambda: (
                StrobeSectorModule(n_sectors=nsectors, voxel_shape=shape,
                                   seg_head_cfg=seg, **kw)))
            det = stream_detector(module, bbox_head, seg_head, test_cfg)
        else:
            module = _materialize(device, generator, lambda: StrobeModule(
                variant=variant, seg_head_cfg=seg, **kw))
            det = CenterPointDetector(
                module, code_weights=bbox_head.get("code_weights",
                                                   [1.0] * 10),
                weight=bbox_head.get("weight", 0.25),
                voxel_size=kw["voxel_size"], test_cfg=test_cfg,
                voxel_shape=shape,
                seg_weight=(seg_head or {}).get("weight", 1.0))
        det.input_kind = "sweeps"
        return det
    return build


for _name, _variant in (("STROBE", "v1"), ("STROBEV2", "v2"),
                        ("STROBEV3", "v3")):
    DETECTORS.register_module(_build_strobe(_variant), name=_name)


def _build_pplstm(use_lstm):
    def build(reader, neck, bbox_head, backbone=None, seg_head=None,
              part_head=None, pretrained=None, train_cfg=None,
              test_cfg=None, max_pillars=None, *, device, generator=None,
              use_block_kernel=False):
        """HAN factory (``strobe.py:251-280``): the sector count from
        ``bbox_head["voxel_generator"]["nsectors"]``, ``max_pillars`` by
        ``max_pillars_rule``, the neck told ``nsectors``; a
        :class:`PolarStreamLSTMModule` (or, without the memory, a
        ``PolarStreamModule``) in a ``PolarStreamDetector``."""
        from .detectors import _materialize

        _refuse_block_kernel(use_block_kernel, "PointPillarsLSTM")
        check_stream_neck(neck)
        vg = bbox_head["voxel_generator"]
        n_sectors = vg.get("nsectors", 1)
        if max_pillars is None:
            max_pillars = max_pillars_rule(vg, n_sectors)
        kw = pillar_module_kwargs(reader, neck, bbox_head, max_pillars)
        kw["neck_cfg"].setdefault("nsectors", n_sectors)
        cls = PolarStreamLSTMModule if use_lstm else PolarStreamModule
        module = _materialize(device, generator, lambda: cls(
            n_sectors=n_sectors,
            voxel_shape=bbox_head.get("voxel_shape", "cylinder"),
            seg_head_cfg=dict(seg_head) if seg_head else None, **kw))
        return stream_detector(module, bbox_head, seg_head, test_cfg)
    return build


# PointPillarsLSTMV1 is the reference's han_method name of the same model
for _name, _lstm in (("PointPillarsLSTM", True), ("PointPillarsLSTMV1", True),
                     ("PointPillarsNoLSTM", False)):
    DETECTORS.register_module(_build_pplstm(_lstm), name=_name)
