"""PARTNER detector (counterpart of ``partner_tpu/models/detectors.py``).

``build_voxelnet_v3`` turns the JAX package's VoxelNetV3 config into an
:class:`E2EDetector`: the point fast path (``PolarDenseFHD.encode_points``)
-> ``SetBlockStack`` -> ``RPN`` -> ``E2ESWVoteHead``, then at inference
decode through the configured CenterCoder and rotated NMS, and in training
the ``SetCriterion`` over the auction matcher.

    det = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg, device=dev)
    # or the head's whole-block route: build_detector(..., use_block_kernel=True)
    det.module.load_state_dict(convert.flax_to_torch(variables))  # optional
    preds = det.predict({"points": pts, "points_mask": mask})
    det.prepare_inference(example)   # optional: static-RPE cache, then predict
    losses = det.loss(example, generator)   # train mode, with targets
"""

import torch
import torch.nn as nn

from ..core.center_coder import build_coder
from ..core.geometry import bev_cell_centers
from ..losses.set_crit import SetCriterion
from ..utils.dtypes import resolve_compute_dtype
from . import e2e_head
from .layers import constant, init_weights
from .registry import BACKBONES, BBOX_HEADS, DETECTORS, NECKS, build_from_cfg
from .set_transformer import SetBlockStack
from .swin_vote import WindowAttention


def _grid_spec(cfg):
    vg = cfg["voxel_generator"]
    pc_range = tuple(vg["range"])
    voxel_size = tuple(vg["voxel_size"])
    grid = tuple(int(round((pc_range[3 + i] - pc_range[i]) / voxel_size[i]))
                 for i in range(3))
    return grid, pc_range, voxel_size


class VoxelNetModule(nn.Module):
    """Point-path backbone + SetBlock stack + neck + E2E head, NHWC."""

    def __init__(self, backbone_cfg, neck_cfg, head_cfg, grid_size, pc_range,
                 out_size_factor=8, set_cfg=None):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.pc_range = tuple(pc_range)
        self.backbone = build_from_cfg(dict(backbone_cfg), BACKBONES,
                                       dict(input_shape=self.grid_size))
        self.neck = build_from_cfg(dict(neck_cfg), NECKS)
        self.bbox_head = build_from_cfg(dict(head_cfg), BBOX_HEADS)
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

    def forward(self, example, generator=None):
        """example: {"points": (B, P, C) f32, "points_mask": (B, P) bool}
        -> dict of head maps (B, n_az/8, n_r/8, .). ``generator`` feeds
        the SetBlock's dropout and DropPath in train mode."""
        bev = self.backbone.encode_points(
            example["points"], example["points_mask"], self.grid_size,
            self.pc_range)                            # (B, n_az, n_r, C)
        x = bev.transpose(1, 2)                       # (B, n_r, n_az, C)
        pos = constant(self, "bev_pos", x.device, lambda: self.bev_pos)
        x = self.attns(x, pos[None].expand(x.shape[0], -1, -1, -1),
                       generator)
        return self.bbox_head(self.neck(x.transpose(1, 2)))


class E2EDetector:
    """VoxelNetV3 + E2ESWVoteHead + SetCriterion: the train loss, and at
    inference forward, decode and NMS."""

    input_kind = "points"

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
    if dict(backbone).get("type") != "PolarDenseFHD":
        raise ValueError("the port runs the PolarDenseFHD point path only")
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
    neck = dict(neck)
    with torch.device("meta"):
        module = VoxelNetModule(
            backbone_cfg=dict(backbone),
            neck_cfg={k: v for k, v in neck.items()
                      if not k.startswith("set_") and k != "logger"},
            head_cfg=head_cfg, grid_size=grid, pc_range=pc_range,
            out_size_factor=osf,
            set_cfg={k: v for k, v in neck.items() if k.startswith("set_")})
    module = module.to_empty(device=device).eval()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(module, generator)
    coder_cfg = dict(bbox_head.get("CODER_CONFIG", {}))
    coder_cfg.setdefault("code_size", 7)
    coder_cfg.setdefault("encode_angle_by_sincos", True)
    coder_cfg.setdefault("rectify", False)
    sc = bbox_head.get("SET_CRIT_CONFIG", {})
    mc = bbox_head.get("MATCHER_CONFIG", {})
    criterion = SetCriterion(
        box_coder=build_coder(coder_cfg),
        weight_dict=sc.get("weight_dict", {"loss_ce": 1, "loss_bbox": 2}),
        losses=sc.get("losses", ["loss_ce", "loss_bbox"]),
        sigma=sc.get("sigma", 3.0),
        code_weights=tuple(sc.get("code_weights", (1.0,) * 8)),
        gamma=sc.get("gamma", 2.0),
        alpha=sc.get("alpha", 0.25),
        matcher_weights=mc.get("weight_dict"))
    tc = dict(test_cfg or {})
    tc.setdefault("iou_factor", hc.get("iou_factor", 1))
    return E2EDetector(module, criterion, tc)
