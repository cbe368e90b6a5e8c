"""Detectors (counterpart of ``partner_tpu/models/detectors.py``).

The benchmark's copy keeps the VoxelNet paths of one process (no seg
head, no azimuth-sharded neck). ``build_voxelnet_v3`` turns the JAX
package's VoxelNetV3 config into an
:class:`E2EDetector` (PARTNER): the backbone (``PolarDenseFHD``: the point
fast path ``encode_points``, or the reader and the voxel path
``forward``; or the reader and the sparse ``SpMiddleResNetFHD``) ->
``SetBlockStack`` -> ``RPN`` ->
``E2ESWVoteHead``, then at inference decode through the box coder that
``CODER_CONFIG["type"]`` selects (``core.center_coder.build_coder``) and
rotated NMS, and in training the ``SetCriterion`` over the auction
matcher, in that coder's space. ``build_voxelnet`` turns a VoxelNet config into a
:class:`CenterPointDetector`: the same point path -> ``RPN`` ->
``CenterHead`` (``SepHead`` or ``DCNSepHead`` tasks), per-task decode
(after the double-flip average where ``test_cfg["double_flip"]`` is set)
and rotated NMS, and in training the FastFocal + L1 peak regression loss.
``models/pillar.py`` builds its ``PointPillars`` configs as the same
:class:`CenterPointDetector` over a ``PointPillarsModule``.

Both take either input contract of the JAX package: ``points`` +
``points_mask`` (the point fast path of ``PolarDenseFHD``), or voxels,
``features`` (B, N, C) dynamic means or ``voxels`` (B, N, K, C) +
``num_points`` hard voxels, with ``coords`` and ``voxel_mask``. With the
sparse backbone ``SpMiddleResNetFHD`` (the reference's spconv layout)
they take voxels only. ``input_kind`` names the contract the entry points
feed: ``"points"`` for ``PolarDenseFHD``, ``"voxels"`` for
``SpMiddleResNetFHD``, as in JAX.

    det = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg, device=dev)
    # or the E2E head's whole-block route: build_detector(...,
    # use_block_kernel=True)
    det.module.load_state_dict(convert.flax_to_torch(variables))  # optional
    preds = det.predict({"points": pts, "points_mask": mask})
    det.prepare_inference(example)   # E2E only: static-RPE cache
    losses = det.loss(example, generator)   # train mode, with targets
"""

import torch
import torch.nn as nn

from ..core.center_coder import build_coder
from ..core.geometry import bev_cell_centers
from ..losses.set_crit import SetCriterion
from ..utils.dtypes import resolve_compute_dtype
from . import e2e_head
from .center_head import (center_head_decode, center_head_loss,
                          center_head_post_process, double_flip_average)
from .layers import constant, init_weights
from .registry import (BACKBONES, BBOX_HEADS, DETECTORS, NECKS, READERS,
                       build_from_cfg)
from .set_transformer import SetBlockStack
from .swin_vote import WindowAttention


# the backbones the port builds -> the input contract the entry points feed
# them (``partner_tpu/models/detectors.py:487-489``, ``:548-550``)
_INPUT_KINDS = {"PolarDenseFHD": "points", "SpMiddleResNetFHD": "voxels"}
# a PointPillars config's backbone: the scatter that ``PointPillarsModule``
# does itself (``models/pillar.py``), no VoxelNet backbone
_PILLAR_SCATTERS = ("PointPillarsScatter", "DynamicPPScatter")
_PFN_READERS = ("PFNLayer", "DynamicPFNet", "PillarFeatureNet")


def backbone_input_kind(backbone):
    """A VoxelNet backbone cfg -> its detector's ``input_kind``; a pillar
    scatter or a backbone the port does not build raises."""
    name = dict(backbone).get("type")
    if name in _PILLAR_SCATTERS:
        raise NotImplementedError(
            f"backbone {name} is the pillar scatter of the PointPillars "
            "detector (type='PointPillars', models/pillar.py), not a "
            "VoxelNet backbone")
    kind = _INPUT_KINDS.get(name)
    if kind is None:
        raise NotImplementedError(
            f"backbone {name} is not ported; the port's VoxelNet builds "
            f"{sorted(_INPUT_KINDS)}")
    return kind


def _grid_spec(cfg):
    vg = cfg["voxel_generator"]
    pc_range = tuple(vg["range"])
    voxel_size = tuple(vg["voxel_size"])
    grid = tuple(int(round((pc_range[3 + i] - pc_range[i]) / voxel_size[i]))
                 for i in range(3))
    return grid, pc_range, voxel_size


class VoxelNetModule(nn.Module):
    """Reader + backbone + (optional SetBlock stack) + neck + head(s), NHWC.

    The reader (no parameters) serves the voxel inputs only. The SetBlock
    stack (``attns``) and its cell positions exist only with
    ``with_set_attention`` (VoxelNetV3). ``head_cfg`` is None for a
    segmentation-only model; ``seg_head_cfg`` adds a seg head over the
    backbone's BEV map (its canvas) and the neck's map. The neck takes the
    backbone's BEV width where the backbone knows it (flax infers it; the
    seg configs' ``num_input_features`` of 128 is not read in JAX)."""

    def __init__(self, reader_cfg, backbone_cfg, neck_cfg, head_cfg,
                 grid_size, pc_range, out_size_factor=8,
                 with_set_attention=False, set_cfg=None, seg_head_cfg=None):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.pc_range = tuple(pc_range)
        self.out_size_factor = out_size_factor
        self.with_set_attention = with_set_attention
        reader_cfg = dict(reader_cfg)
        if reader_cfg.get("type") in _PFN_READERS:
            raise NotImplementedError(
                f"reader {reader_cfg['type']} pools points into pillars; it "
                "runs in the PointPillars detector (type='PointPillars', "
                "models/pillar.py), not on VoxelNet's voxels")
        if READERS.get(reader_cfg.get("type")) is None:
            raise NotImplementedError(
                f"reader {reader_cfg.get('type')} is not ported")
        self.reader = build_from_cfg(reader_cfg, READERS)
        self.backbone = build_from_cfg(dict(backbone_cfg), BACKBONES,
                                       dict(input_shape=self.grid_size))
        neck_cfg = dict(neck_cfg)
        if getattr(self.backbone, "out_features", None):
            neck_cfg["num_input_features"] = self.backbone.out_features
        self.neck = build_from_cfg(neck_cfg, NECKS)
        self.bbox_head = (None if head_cfg is None
                          else build_from_cfg(dict(head_cfg), BBOX_HEADS))
        self.seg_head = None
        if seg_head_cfg:
            raise NotImplementedError("the reference copies no seg head")
        if not with_set_attention:
            return
        voxel_size = tuple((pc_range[3 + i] - pc_range[i]) / grid_size[i]
                           for i in range(3))
        n_r = grid_size[0] // out_size_factor
        n_az = grid_size[1] // out_size_factor
        self.bev_pos = bev_cell_centers(
            (n_r, n_az), voxel_size, pc_range, out_size_factor, "cylinder",
            center_offset=0.5)[..., :2].copy()       # (n_r, n_az, 2) numpy
        set_cfg = dict(set_cfg or {})
        self.attns = SetBlockStack(
            self.backbone.out_features,
            depth=set_cfg.get("set_depth", 2),
            num_heads=set_cfg.get("set_num_heads", 4),
            num_keypoints=set_cfg.get("set_h", 4),
            range_window=set_cfg.get("set_w", 8),
            drop=set_cfg.get("set_drop", 0.1),
            attn_drop=set_cfg.get("set_attn_drop", 0.1),
            drop_path=set_cfg.get("set_drop_path", 0.1),
            dtype=resolve_compute_dtype(
                set_cfg.get("set_compute_dtype", "float32")))

    def forward(self, example, generator=None, return_bev=False):
        """example: {"points": (B, P, C) f32, "points_mask": (B, P) bool},
        or voxels: {"features": (B, N, C) f32} or {"voxels": (B, N, K, C)
        f32, "num_points": (B, N)}, each with "coords" (B, N, 3) int32
        (z, az, r) and "voxel_mask" (B, N) bool -> the head's maps
        (B, n_az/8, n_r/8, .), and with ``return_bev`` also the neck's
        output map (B, n_az/8, n_r/8, C) beside them: ``(maps, bev)``.
        With a seg head the maps hold ``seg_preds`` (B, n_az/8, n_r/8,
        classes) too; a segmentation-only module gives that alone.
        Voxels win where both are given, as in JAX. ``generator`` feeds
        the SetBlock's dropout and DropPath in train mode."""
        if "features" in example or "voxels" in example:
            if "voxels" in example:   # hard voxels (B, N, K, C)
                features = self.reader(example["voxels"],
                                       example["num_points"])
            else:                     # dynamic means (B, N, C)
                features = self.reader(example["features"])
            bev = self.backbone(features, example["coords"],
                                example["voxel_mask"], self.grid_size)
        elif hasattr(self.backbone, "encode_points"):
            bev = self.backbone.encode_points(
                example["points"], example["points_mask"], self.grid_size,
                self.pc_range)                        # (B, n_az, n_r, C)
        else:
            raise ValueError(
                f"{type(self.backbone).__name__} takes voxel inputs "
                "(features or voxels, coords, voxel_mask); voxelize the "
                "points first (ops.voxelize.DeviceVoxelizer)")
        if self.with_set_attention:
            x = bev.transpose(1, 2)                   # (B, n_r, n_az, C)
            pos = constant(self, "bev_pos", x.device, lambda: self.bev_pos)
            x = self.attns(x, pos[None].expand(x.shape[0], -1, -1, -1),
                           generator)
            bev = x.transpose(1, 2)
        x = self.neck(bev)
        out = {} if self.bbox_head is None else self.bbox_head(x)
        return (out, x) if return_bev else out


class E2EDetector:
    """VoxelNetV3 + E2ESWVoteHead + SetCriterion: the train loss, and at
    inference forward, decode and NMS."""

    input_kind = "points"
    # the batch keys :meth:`loss` reads
    loss_keys = ("points", "points_mask", "global_box", "global_box_mask",
                 "votemap_flat")

    def __init__(self, module, criterion, test_cfg=None):
        self.module = module
        self.criterion = criterion
        self.coder = criterion.coder
        self.test_cfg = dict(test_cfg or {})

    def loss(self, example, generator=None):
        """The set losses of one forward in the module's current mode.

        example: "points", "points_mask" as for :meth:`predict`, plus
        "global_box" (B, M, 8) [x, y, z, dx, dy, dz, yaw, class] with the
        class 1-based (a 10-column box's velocity is dropped),
        "global_box_mask" (B, M) bool and "votemap_flat" (B, N, 4 + ncls).
        Returns the criterion's dict (loss terms, ``loss``,
        ``num_matched``)."""
        return self.set_losses(self.module(example, generator), example)

    def set_losses(self, preds, example):
        """Head maps + the example's targets -> the criterion's dict."""
        grid = self.module.bbox_head.offset_grid_on(preds["hm"].device)
        flat = e2e_head.flatten_head_preds(preds, grid)
        gt = example["global_box"]
        gt_boxes = torch.cat([gt[..., :6], gt[..., -2:-1]], dim=-1)
        gt_classes = torch.clamp((gt[..., -1] - 1).to(torch.int32), min=0)
        return self.criterion(flat, gt_boxes, gt_classes,
                              example["global_box_mask"],
                              example.get("votemap_flat"))

    @torch.no_grad()
    def prepare_inference(self, example):
        """Fill the static-RPE cache (``detectors.py:245-266``): one eval
        forward of ``example`` in which each per-block window attention
        stores its (nW, nh, T, T) RPE table, region mask folded in. Later
        eval forwards add the table in place of rebuilding the RPE;
        ``load_state_dict`` and train mode drop it. The whole-block route
        fills nothing, as in JAX.
        Returns {attention module name: table}."""
        self.module.eval()
        attns = self._window_attentions()
        for m in attns.values():
            m.rpe_table, m.rpe_fill = None, True
        try:
            self.module(example)
        finally:
            for m in attns.values():
                m.rpe_fill = False
        return {name: m.rpe_table for name, m in attns.items()
                if m.rpe_table is not None}

    def clear_inference_cache(self):
        """Back to the live path: drop every static-RPE table."""
        for m in self._window_attentions().values():
            m.rpe_table = None

    def _window_attentions(self):
        return {name: m for name, m in self.module.named_modules()
                if isinstance(m, WindowAttention)}

    @torch.no_grad()
    def predict(self, example):
        """-> dict of (B, nms_post, ...) detections + validity mask. Puts
        the module in eval mode first (running statistics, no dropout), as
        the JAX package's predict runs with ``train=False``."""
        self.module.eval()
        return self.decode(self.module(example))

    @torch.no_grad()
    def decode(self, preds):
        """Head maps -> decoded, score-masked, NMS'd detections."""
        grid = self.module.bbox_head.offset_grid_on(preds["hm"].device)
        flat = e2e_head.flatten_head_preds(preds, grid)
        boxes, scores = e2e_head.decode_flat_preds(
            flat, self.coder,
            iou_factor=self.test_cfg.get("iou_factor", 1.0),
            rectify=self.test_cfg.get("rectify", False))
        nms_cfg = self.test_cfg.get("nms", {})
        return e2e_head.E2ESWVoteHead.post_process(
            boxes, scores,
            self.test_cfg.get("score_threshold", 0.1),
            self.test_cfg.get("post_center_limit_range",
                              [-80, -80, -10, 80, 80, 10]),
            nms_cfg.get("nms_iou_threshold", 0.7),
            nms_cfg.get("nms_pre_max_size", 4096),
            nms_cfg.get("nms_post_max_size", 500))


class CenterPointDetector:
    """VoxelNet or PointPillars (``models/pillar.py``) + CenterHead: the
    FastFocal + L1 peak regression loss, and at inference forward, per-task
    decode and NMS; with a seg head (VoxelNet) its per-cell loss and
    per-point labels too. A segmentation-only VoxelNet has no CenterHead:
    its loss is the seg loss alone and ``predict`` gives the point labels
    alone."""

    input_kind = "points"

    def __init__(self, module, code_weights, weight, voxel_size=None,
                 test_cfg=None, voxel_shape="cylinder", seg_weight=1.0):
        self.module = module
        self.code_weights = tuple(code_weights)
        self.weight = weight
        self.voxel_size = voxel_size
        self.voxel_shape = voxel_shape
        self.seg_weight = seg_weight
        self.test_cfg = dict(test_cfg or {})

    @property
    def loss_keys(self):
        """The batch keys :meth:`loss` reads: the points, the per-task
        lists of the center targets with a CenterHead, and the points'
        labels with a seg head (its loss reads the points where the
        backbone reads voxels)."""
        keys = ("points", "points_mask")
        if getattr(self.module, "bbox_head", True) is not None:
            keys += ("hm", "anno_box", "ind", "mask", "cat")
        return keys

    def loss(self, example, generator=None):
        """The losses of one forward in the module's current mode.

        example: "points", "points_mask" as for :meth:`predict`, plus the
        per-task lists "hm", "anno_box", "ind", "mask", "cat" of the
        center target assigner, and with a seg head "points_label" (B, P)
        1-based. Returns :func:`center_head_loss`'s dict (``{"loss": 0}``
        without a CenterHead), with a seg head ``seg_loss`` beside it and
        ``loss`` through :func:`apply_seg_decay`."""
        preds = self.module(example, generator)
        if preds.get("det_preds"):
            ld = dict(center_head_loss(preds, example, self.code_weights,
                                       self.weight))
        else:
            ld = {"loss": 0.0}
        return ld

    @torch.no_grad()
    def predict(self, example):
        """-> dict of (B, tasks x nms_post, ...) detections + validity
        mask, the tasks concatenated in order with their labels offset by
        the classes before them; with a seg head ``point_seg_labels`` (B,
        P), each point's class (1-based) at its cell, 0 off the grid. Puts
        the module in eval mode first."""
        self.module.eval()
        preds = self.module(example)
        return self.decode(preds)

    @torch.no_grad()
    def decode(self, preds):
        """Head maps -> decoded, score-masked, NMS'd detections ({} without
        a CenterHead). With
        ``test_cfg["double_flip"]`` the maps are B x 4 rows, each sample's
        four flip copies in a row (``DoubleFlip`` and ``collate``); they
        are averaged back to B rows first (:func:`double_flip_average`)."""
        double_flip = bool(self.test_cfg.get("double_flip"))
        outs, offset = [], 0
        for task_preds in preds.get("det_preds") or []:
            if double_flip:
                task_preds = double_flip_average(task_preds)
            hm = task_preds["hm"]
            boxes, scores = center_head_decode(
                task_preds, (hm.shape[1], hm.shape[2]), self.voxel_size,
                self.module.pc_range, self.module.out_size_factor,
                voxel_shape=self.voxel_shape,
                rectify=self.test_cfg.get("rectify", False),
                pre_activated=double_flip)
            outs.append(center_head_post_process(boxes, scores,
                                                 self.test_cfg,
                                                 class_offset=offset))
            offset += hm.shape[-1]
        if len(outs) <= 1:
            return outs[0] if outs else {}
        return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}


def _neck_cfg(neck):
    return {k: v for k, v in dict(neck).items()
            if not k.startswith("set_") and k != "logger"}


def _materialize(device, generator, make):
    """The module ``make()`` builds, built on the meta device, then on
    ``device`` in eval mode with flax's default initializers drawn from
    ``generator`` (seed 0 when None); on the meta device, which holds no
    values, nothing is drawn."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device).eval()
    if torch.device(device).type != "meta":
        init_weights(module, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    return module


@DETECTORS.register_module(name="VoxelNetV3")
def build_voxelnet_v3(reader, backbone, neck, bbox_head, seg_head=None,
                      part_head=None, pretrained=None, train_cfg=None,
                      test_cfg=None, *, device, generator=None,
                      use_block_kernel=False):
    """PARTNER detector factory (detector cfg -> E2EDetector on ``device``).

    The module is built on the meta device and materialized on ``device``
    with flax's default initializers drawn from ``generator``, in eval
    mode. ``use_block_kernel`` puts the head's SwinVoteTransformer on its
    whole-block route at inference. The criterion comes from the head's
    ``SET_CRIT_CONFIG`` and ``MATCHER_CONFIG``, as in the JAX package."""
    kind = backbone_input_kind(backbone)
    grid, pc_range, _ = _grid_spec(bbox_head)
    osf = bbox_head.get("out_size_factor", 8)
    hc = bbox_head["HEAD_CONFIG"]
    sl_depth = hc.get("sl_depth", [2])
    head_cfg = {
        "type": "E2ESWVoteHead",
        "in_channels": bbox_head.get("in_channels", 512),
        "num_classes": hc.get("num_classes", 1),
        "kernel_size": hc.get("kernel_size", 3),
        "window_size": hc.get("window_size", 7),
        "sl_depth": (sl_depth[0] if isinstance(sl_depth, (list, tuple))
                     else sl_depth),
        "iou_head": hc.get("iou_loss", True),
        "init_bias": hc.get("init_bias", -2.19),
        "grid_size": grid,
        "pc_range": pc_range,
        "out_size_factor": osf,
        "voxel_shape": bbox_head.get("voxel_shape", "cylinder"),
        "compute_dtype": hc.get("compute_dtype", "float32"),
        "use_block_kernel": use_block_kernel,
    }
    coder_cfg = dict(bbox_head.get("CODER_CONFIG", {}))
    coder_cfg.setdefault("code_size", 7)
    coder_cfg.setdefault("encode_angle_by_sincos", True)
    coder_cfg.setdefault("rectify", False)
    coder = build_coder(coder_cfg)
    # the single-task criterion never passes a task_id: a multi-anchor
    # MTTP coder would train and decode every box against task 0's anchor
    tmp_box = getattr(coder, "tmp_box", None)
    if tmp_box is not None and tmp_box.shape[0] > 1:
        raise ValueError(
            "CenterCoderMTTP with multiple task anchors is unsupported by "
            "the single-task E2E head (task_id is never threaded); use one "
            "anchor row or a per-task head")
    neck = dict(neck)
    module = _materialize(device, generator, lambda: VoxelNetModule(
        reader_cfg=dict(reader), backbone_cfg=dict(backbone),
        neck_cfg=_neck_cfg(neck), head_cfg=head_cfg, grid_size=grid,
        pc_range=pc_range, out_size_factor=osf, with_set_attention=True,
        set_cfg={k: v for k, v in neck.items() if k.startswith("set_")}))
    sc = bbox_head.get("SET_CRIT_CONFIG", {})
    mc = bbox_head.get("MATCHER_CONFIG", {})
    criterion = SetCriterion(
        box_coder=coder,
        weight_dict=sc.get("weight_dict", {"loss_ce": 1, "loss_bbox": 2}),
        losses=sc.get("losses", ["loss_ce", "loss_bbox"]),
        sigma=sc.get("sigma", 3.0),
        code_weights=tuple(sc.get("code_weights", (1.0,) * 8)),
        gamma=sc.get("gamma", 2.0),
        alpha=sc.get("alpha", 0.25),
        matcher_weights=mc.get("weight_dict"))
    tc = dict(test_cfg or {})
    tc.setdefault("iou_factor", hc.get("iou_factor", 1))
    det = E2EDetector(module, criterion, tc)
    det.input_kind = kind
    return det


@DETECTORS.register_module(name="VoxelNet")
def build_voxelnet(reader, backbone, neck, bbox_head, seg_head=None,
                   part_head=None, pretrained=None, train_cfg=None,
                   test_cfg=None, *, device, generator=None,
                   use_block_kernel=False):
    """CenterPoint detector factory (VoxelNet config ->
    CenterPointDetector on ``device``), with the JAX package's rewrites of
    the head config: ``tasks`` as tuples of class names, ``common_heads``
    sorted, and ``voxel_shape``, ``code_weights``, ``weight`` and
    ``dataset`` taken out for the detector (``dataset`` names the data
    set only; the loss is the same for each).

    The module is built as :func:`build_voxelnet_v3` builds its own.
    ``use_block_kernel`` belongs to the E2E head and must stay False here.
    ``bbox_head`` may be None (segmentation only): the grid then comes
    from ``seg_head["voxel_generator"]``, as in JAX. A ``seg_head`` adds
    its head (``models/seg_head.py``) over the backbone's BEV map, its
    ``weight`` the seg loss's."""
    if use_block_kernel:
        raise ValueError("use_block_kernel is an option of the E2E head's "
                         "Swin blocks; VoxelNet's CenterHead has none")
    kind = backbone_input_kind(backbone)
    spec_src = bbox_head if bbox_head is not None else seg_head
    if not spec_src:
        raise ValueError("a VoxelNet config needs a bbox_head or a seg_head "
                         "(whose voxel_generator gives the grid)")
    grid, pc_range, voxel_size = _grid_spec(spec_src)
    osf = spec_src.get("out_size_factor", 8)
    head_cfg = None
    if bbox_head is not None:
        head_cfg = dict(bbox_head)
        for k in ("voxel_shape", "code_weights", "weight", "dataset"):
            head_cfg.pop(k, None)
        head_cfg["tasks"] = tuple({"class_names": tuple(t["class_names"])}
                                  for t in bbox_head["tasks"])
        if "common_heads" in head_cfg:
            head_cfg["common_heads"] = tuple(sorted(
                (k, tuple(v))
                for k, v in dict(bbox_head["common_heads"]).items()))
    module = _materialize(device, generator, lambda: VoxelNetModule(
        reader_cfg=dict(reader), backbone_cfg=dict(backbone),
        neck_cfg=_neck_cfg(neck), head_cfg=head_cfg, grid_size=grid,
        pc_range=pc_range, out_size_factor=osf,
        seg_head_cfg=dict(seg_head) if seg_head else None))
    src = bbox_head if bbox_head is not None else {}
    det = CenterPointDetector(
        module, code_weights=src.get("code_weights", [1.0] * 10),
        weight=src.get("weight", 0.25), voxel_size=voxel_size,
        test_cfg=test_cfg, voxel_shape=spec_src.get("voxel_shape",
                                                    "cylinder"),
        seg_weight=(seg_head or {}).get("weight", 1.0))
    det.input_kind = kind
    return det
