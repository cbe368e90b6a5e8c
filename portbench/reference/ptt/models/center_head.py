"""CenterPoint's multi-task head (counterpart of the ``CenterHead`` half of
``partner_tpu/models/center_head.py``): ``CenterHead`` with one
``SepHead`` per task, or with ``dcn_head=True`` one ``DCNSepHead`` per
task (two deformable-conv ``FeatureAdaption`` branches, the nuScenes DCN
configs), and the pure functions over its maps: the loss (FastFocal
heatmap + L1 regression at the peaks), the double-flip average of the
test-time flips, the decode and the score / range mask with rotated NMS.

The single-group heads of the cylinder configs (counterpart of the
``CenterHeadSingle`` half): ``CenterHeadSingle`` (a shared conv with the
range-stratified ``RSNorm``, ``RangeStratified`` convs for ``reg``,
``ConvGNStack``s for the other heads, merged heads such as ``rot_vel``
as grouped convs split by channel) and ``CenterHeadSinglePos`` (its
heatmap input calibrated by the polar position encoding). With
``test_cfg["per_class_nms"]`` the post-process runs
``ops.nms.batched_rotated_nms`` over every candidate.

Maps are NHWC (B, H=azimuth, W=range, C), as in JAX. Submodules carry
flax's names (``Conv_0``, ``task{i}``, ``{head}_conv{j}``, ``{head}_out``,
``feature_adapt_cls``, ``conv_offset``, ``deform_kernel``, ``hm_out``,
``task_head``, ``shared_conv``, ``shared_norm``, ``{head}_rs``,
``{head}_stack``, ``GroupNorm_{k}``, ``hm_stack``, ``cal_*``), so
converted weights load by name. Not ported: the fused-branch ``SepHead``
option, a TPU knob that lost there.
"""

import functools

import numpy as np
import torch
import torch.nn as nn

from ..core.geometry import bev_cell_centers
from ..losses.centernet import fast_focal_loss, reg_loss
from ..ops.nms import batched_rotated_nms, rotate_nms_pcdet
from .layers import Conv2d, constant
from .registry import BBOX_HEADS

HEAD_CONV = 64  # SepHead's hidden width (``nn.Conv(64, ...)`` in JAX)


class SepHead(nn.Module):
    """Per-task separate conv heads: for each head, ``num_conv - 1`` 3x3
    convs with ReLU, then a 3x3 conv to its channels. Heads are built and
    returned in sorted name order; a head whose name holds ``hm`` starts
    its output bias at ``init_bias``, every other bias at zero."""

    def __init__(self, in_features, heads, init_bias=-2.19):
        super().__init__()
        self.heads = tuple(sorted(dict(heads).items()))
        for name, (classes, num_conv) in self.heads:
            cin = in_features
            for i in range(num_conv - 1):
                self.add_module(f"{name}_conv{i}",
                                Conv2d(cin, HEAD_CONV, 3, 1, 1))
                cin = HEAD_CONV
            self.add_module(f"{name}_out", Conv2d(
                cin, classes, 3, 1, 1,
                init_bias=init_bias if "hm" in name else None))

    def forward(self, x):
        out = {}
        for name, (_, num_conv) in self.heads:
            y = x
            for i in range(num_conv - 1):
                y = torch.relu(getattr(self, f"{name}_conv{i}")(y))
            out[name] = getattr(self, f"{name}_out")(y)
        return out


@BBOX_HEADS.register_module(name="CenterHead")
class CenterHead(nn.Module):
    """A shared 3x3 conv + ReLU, then one :class:`SepHead` per task. ``forward`` returns
    ``{"det_preds": [per-task dict of maps]}``."""

    def __init__(self, in_channels=512, tasks=(), common_heads=None,
                 share_conv_channel=64, num_hm_conv=2, init_bias=-2.19,
                 dcn_head=False, **kwargs):
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, share_conv_channel, 3, 1, 1)
        self.num_tasks = len(tasks)
        for i, task in enumerate(tasks):
            heads = dict(common_heads or {})
            ncls = len(task["class_names"])
            if dcn_head:
                raise NotImplementedError("the reference copies no DCN head")
            heads["hm"] = (ncls, num_hm_conv)
            head = SepHead(share_conv_channel, heads, init_bias)
            self.add_module(f"task{i}", head)

    def forward(self, x):
        """x: (B, n_az, n_r, in_channels) f32 -> {"det_preds": [...]}."""
        x = torch.relu(self.Conv_0(x))
        return {"det_preds": [getattr(self, f"task{i}")(x)
                              for i in range(self.num_tasks)]}


RS_EPS = 1e-5      # RSNorm's and RangeStratified's own norms (two-pass)
GN_EPS = 1e-6      # flax nn.GroupNorm's default (ConvGNStack)


class RSNorm(nn.Module):
    """Range-stratified GroupNorm over NHWC (B, az, r, C): the range axis
    cut into ``num_groups`` strata of ``r // num_groups`` cells, each
    normalized over (azimuth, its cells, the channels of each of
    ``num_heads`` channel groups) with a two-pass variance, then its own
    affine ``scale`` / ``bias`` (g, 1, C). A ragged tail of ``r %
    num_groups`` cells takes the last stratum's statistics and affine."""

    def __init__(self, num_heads, num_groups, features, eps=RS_EPS):
        super().__init__()
        self.num_heads = num_heads
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(num_groups, 1, features))
        self.bias = nn.Parameter(torch.empty(num_groups, 1, features))

    @torch.no_grad()
    def init_extra(self, generator):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        b, h, w, c = x.shape
        g, nh = self.num_groups, self.num_heads
        step = w // g
        xg = x[:, :, : step * g].reshape(b, h, g, step, nh, c // nh)
        mean = xg.mean(dim=(1, 3, 5), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 3, 5), keepdim=True)
        xs = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(
            b, h, g, step, c)
        out = (xs * self.scale + self.bias).reshape(b, h, step * g, c)
        if step * g == w:
            return out
        tail = x[:, :, step * g:].reshape(b, h, 1, w - step * g, nh, c // nh)
        tail = ((tail - mean[:, :, -1:]) * torch.rsqrt(var[:, :, -1:]
                                                       + self.eps))
        tail = tail.reshape(b, h, w - step * g, c)
        return torch.cat([out, tail * self.scale[-1] + self.bias[-1]], dim=2)


class RangeStratified(nn.Module):
    """Per-stratum 3x3 conv, per-stratum GroupNorm (one group over the
    features, two-pass, eps 1e-5) and ReLU. The range axis is cut into
    ``num_groups`` strata of ``r // num_groups`` cells; each stratum's
    conv sees one cell of its neighbours on either side in range (zeros
    beyond the map) and zero-padded azimuth. The strata run as one
    grouped conv with the strata on the channel axis. ``kernel`` (g, 3, 3,
    C, F) and ``bias`` (g, F) keep flax's raw layout, as do ``gn_scale``
    / ``gn_bias`` (g, 1, 1, F). The output is g x (r // g) cells wide, as
    JAX's is, where ``r % g`` leaves a tail."""

    def __init__(self, in_features, features, num_groups=8):
        super().__init__()
        g = num_groups
        self.num_groups = g
        self.kernel = nn.Parameter(torch.empty(g, 3, 3, in_features,
                                               features))
        self.bias = nn.Parameter(torch.empty(g, features))
        self.gn_scale = nn.Parameter(torch.empty(g, 1, 1, features))
        self.gn_bias = nn.Parameter(torch.empty(g, 1, 1, features))

    @torch.no_grad()
    def init_extra(self, generator):
        """flax's ``variance_scaling(1, "fan_in", "truncated_normal")`` of
        the raw (g, 3, 3, C, F) kernel: its fan in is g x 9 x C, the
        strata counted in (flax's receptive field is every axis but the
        last two)."""
        from .layers import _lecun_normal_

        g, kh, kw, c, _ = self.kernel.shape
        _lecun_normal_(self.kernel, g * kh * kw * c, generator)
        self.bias.zero_()
        self.gn_scale.fill_(1.0)
        self.gn_bias.zero_()

    def forward(self, x):
        b, h, w, c = x.shape
        g = self.num_groups
        f = self.kernel.shape[-1]
        step = w // g
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        strata = torch.stack([xp[:, :, i * step: i * step + step + 2]
                              for i in range(g)], dim=1)  # B,G,H+2,s+2,C
        strata = strata.permute(0, 1, 4, 2, 3).reshape(b, g * c, h + 2,
                                                       step + 2)
        weight = self.kernel.permute(0, 4, 3, 1, 2).reshape(g * f, c, 3, 3)
        y = torch.nn.functional.conv2d(strata, weight, self.bias.reshape(-1),
                                       groups=g)
        y = y.reshape(b, g, f, h, step)
        mean = y.mean(dim=(2, 3, 4), keepdim=True)
        var = ((y - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
        y = (y - mean) * torch.rsqrt(var + RS_EPS)
        y = y.permute(0, 3, 1, 4, 2)                      # B, H, G, s, F
        y = torch.relu(y * self.gn_scale.reshape(g, 1, f)
                       + self.gn_bias.reshape(g, 1, f))
        return y.reshape(b, h, g * step, f)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NHWC: statistics per sample and group of
    channels over (H, W, the group's channels) by flax's fast variance,
    max(0, E[x^2] - E[x]^2), eps 1e-6, then ``(x - mean) * (rsqrt(var +
    eps) * weight) + bias`` in flax's order."""

    def __init__(self, num_groups, features, eps=GN_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def init_extra(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        b, h, w, c = x.shape
        g = self.num_groups
        xg = x.reshape(b, h, w, g, c // g)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 2, 4), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(g, c // g)
        return ((xg - mean) * mul + self.bias.reshape(g, c // g)).reshape(
            b, h, w, c)


class ConvGNStack(nn.Module):
    """``num_conv - 1`` x (3x3 conv to ``hidden`` + ``GroupNorm`` with
    ``hidden`` groups + ReLU), then a 3x3 conv to ``out`` (bias at
    ``init_bias`` where given), every conv with ``groups`` groups."""

    def __init__(self, in_features, out, num_conv=2, hidden=64, groups=1,
                 init_bias=None):
        super().__init__()
        self.n_hidden = num_conv - 1
        cin = in_features
        for k in range(self.n_hidden):
            self.add_module(f"Conv_{k}", Conv2d(cin, hidden, 3, 1, 1,
                                                groups=groups))
            self.add_module(f"GroupNorm_{k}", GroupNorm(hidden, hidden))
            cin = hidden
        self.add_module(f"Conv_{self.n_hidden}", Conv2d(
            cin, out, 3, 1, 1, groups=groups, init_bias=init_bias))

    def forward(self, x):
        for k in range(self.n_hidden):
            x = torch.relu(getattr(self, f"GroupNorm_{k}")(
                getattr(self, f"Conv_{k}")(x)))
        return getattr(self, f"Conv_{self.n_hidden}")(x)


def _split_merged_heads(head_name, tensor):
    """'rot_vel' -> {'rot': the first half of the channels, 'vel': the
    second}."""
    names = head_name.split("_")
    dim = tensor.shape[-1] // len(names)
    return {nm: tensor[..., j * dim: (j + 1) * dim]
            for j, nm in enumerate(names)}


RS_FEATURES = 64   # RangeStratified's width (``RangeStratified(64, ...)``)
CAL_FEATURES = 64  # the position calibration's width


@BBOX_HEADS.register_module(name="CenterHeadSingle")
class CenterHeadSingle(nn.Module):
    """One group of heads over every class: ``shared_conv`` (3x3) +
    ``shared_norm`` (:class:`RSNorm` with 1 channel group and 4 range
    strata) + ReLU; a head named ``reg`` (or holding it) through
    ``{name}_rs`` (:class:`RangeStratified`) and a 1x1 ``{name}_out``; a
    merged head (``rot_vel``) through a :class:`ConvGNStack` with one
    conv group per sub-head, split by channel; every other head through a
    plain :class:`ConvGNStack`; ``hm_stack`` on the heatmap input.
    ``forward`` returns ``{"det_preds": [maps]}``, one task, the maps in
    sorted name order."""

    def __init__(self, in_channels=512, tasks=(), common_heads=None,
                 share_conv_channel=64, num_hm_conv=2, init_bias=-2.19,
                 rs_groups=8, **kwargs):
        super().__init__()
        self.heads = tuple(dict(
            common_heads or {"reg": (2, 2), "height": (1, 2),
                             "dim": (3, 2), "rot": (2, 2)}).items())
        num_classes = sum(len(t["class_names"]) for t in tasks)
        c = share_conv_channel
        self.shared_conv = Conv2d(in_channels, c, 3, 1, 1)
        self.shared_norm = RSNorm(1, 4, c)
        for name, (classes, num_conv) in self.heads:
            if "reg" in name:
                self.add_module(f"{name}_rs", RangeStratified(
                    c, RS_FEATURES, rs_groups))
                self.add_module(f"{name}_out", Conv2d(RS_FEATURES, classes,
                                                      1))
            else:
                n = len(name.split("_"))
                self.add_module(f"{name}_stack", ConvGNStack(
                    c, classes * n, num_conv, groups=n))
        self.hm_stack = ConvGNStack(c, num_classes, num_hm_conv,
                                    init_bias=init_bias)

    def forward(self, x):
        """x: (B, n_az, n_r, in_channels) f32 -> {"det_preds": [maps]}."""
        x = torch.relu(self.shared_norm(self.shared_conv(x)))
        ret = {}
        for name, _ in self.heads:
            if "reg" in name:
                y = getattr(self, f"{name}_out")(
                    getattr(self, f"{name}_rs")(x))
            else:
                y = getattr(self, f"{name}_stack")(x)
            ret.update(_split_merged_heads(name, y) if "_" in name
                       else {name: y})
        ret["hm"] = self.hm_stack(self.hm_input(x))
        return {"det_preds": [dict(sorted(ret.items()))]}

    def hm_input(self, x):
        return x


@BBOX_HEADS.register_module(name="CenterHeadSinglePos")
class CenterHeadSinglePos(CenterHeadSingle):
    """:class:`CenterHeadSingle` whose heatmap input is calibrated by the
    polar position of each cell: the encoding [x, y, r, cos phi, sin phi]
    of the cell corners (``bev_cell_centers`` with ``center_offset`` 0 on
    the first of ``nsectors`` sectors of ``voxel_generator``, float32 as
    JAX builds it) feeds ``cal_w0`` (3x3) -> tanh -> ``cal_w1`` (1x1) ->
    tanh and ``cal_b0`` (3x3) -> tanh -> ``cal_b1`` (1x1), and the input
    becomes ``x * w + b``. The encoding is a constant of the grid, so the
    calibration runs once a forward at batch 1 and is broadcast over the
    batch."""

    def __init__(self, in_channels=512, tasks=(), common_heads=None,
                 share_conv_channel=64, num_hm_conv=2, init_bias=-2.19,
                 rs_groups=8, voxel_generator=None, out_size_factor=8,
                 **kwargs):
        super().__init__(in_channels, tasks, common_heads,
                         share_conv_channel, num_hm_conv, init_bias,
                         rs_groups)
        self.voxel_generator = dict(voxel_generator or {})
        self.out_size_factor = out_size_factor
        f = CAL_FEATURES
        self.cal_w0 = Conv2d(5, f, 3, 1, 1)
        self.cal_w1 = Conv2d(f, f, 1)
        self.cal_b0 = Conv2d(5, f, 3, 1, 1)
        self.cal_b1 = Conv2d(f, f, 1)

    def pos_encoding(self, hw):
        """(n_az, n_r) -> the (n_az, n_r, 5) float32 numpy encoding."""
        vg = self.voxel_generator
        pc_range = vg["range"]
        interval = (pc_range[4] - pc_range[1]) / vg.get("nsectors", 1)
        ref = list(pc_range)
        ref[4] = ref[1] + interval
        cells = bev_cell_centers((hw[1], hw[0]), vg["voxel_size"], ref,
                                 self.out_size_factor, "cylinder",
                                 center_offset=0.0)   # (r, az, 4)
        x, y, r, phi = (cells[..., i] for i in range(4))
        enc = np.stack([x, y, r, np.cos(phi), np.sin(phi)], -1)
        return np.ascontiguousarray(enc.transpose(1, 0, 2), np.float32)

    def hm_input(self, x):
        hw = (x.shape[1], x.shape[2])
        pos = constant(self, f"pos{hw}", x.device,
                       lambda: self.pos_encoding(hw))[None]
        w = torch.tanh(self.cal_w1(torch.tanh(self.cal_w0(pos))))
        b = self.cal_b1(torch.tanh(self.cal_b0(pos)))
        return x * w + b


# ---------------------------------------------------------------------------
# loss / decode drivers (pure functions over head outputs)
# ---------------------------------------------------------------------------

# anno_box columns [x, y, z, dx, dy, dz, vx, vy, sin, cos] without velocity
_NO_VEL_COLUMNS = (0, 1, 2, 3, 4, 5, 8, 9)


def center_head_loss(preds_dicts, example, code_weights, weight):
    """FastFocal + weighted L1 regression per task.

    ``example`` carries per-task lists: ``hm`` (B, az, r, C) (or (B, C,
    az, r)), ``anno_box`` (B, M, 10), ``ind``/``mask``/``cat`` (B, M).
    Returns ``det_loss``, ``hm_loss``, ``loc_loss`` (lists of per-task
    scalars) and their total ``loss``."""
    rets = {"det_loss": [], "hm_loss": [], "loc_loss": []}
    total = 0.0
    for task_id, preds in enumerate(preds_dicts["det_preds"]):
        hm = torch.clamp(torch.sigmoid(preds["hm"]), 1e-4, 1 - 1e-4)
        target_hm = example["hm"][task_id]
        if target_hm.shape[1] != hm.shape[1]:   # (B, C, az, r) -> NHWC
            target_hm = target_hm.permute(0, 2, 3, 1)
        hm_l = fast_focal_loss(hm, target_hm, example["ind"][task_id],
                               example["mask"][task_id],
                               example["cat"][task_id])
        target_box = example["anno_box"][task_id]
        if "vel" in preds:
            anno = torch.cat([preds["reg"], preds["height"], preds["dim"],
                              preds["vel"], preds["rot"]], dim=-1)
        else:
            anno = torch.cat([preds["reg"], preds["height"], preds["dim"],
                              preds["rot"]], dim=-1)
            target_box = target_box[..., list(_NO_VEL_COLUMNS)]
        box_l = reg_loss(anno, example["mask"][task_id],
                         example["ind"][task_id], target_box)
        cw = torch.tensor(list(code_weights[: box_l.shape[0]]),
                          dtype=box_l.dtype).to(box_l.device)
        loc = (box_l * cw).sum()
        task_loss = hm_l + weight * loc
        total = total + task_loss
        rets["det_loss"].append(task_loss)
        rets["hm_loss"].append(hm_l)
        rets["loc_loss"].append(loc)
    rets["loss"] = total
    return rets


@functools.lru_cache(maxsize=32)
def _cell_corners(grid_hw, voxel_size, pc_range, out_size_factor,
                  voxel_shape, device):
    """(1, n, 2) float32 cartesian positions of the cells of an (h, w) map
    without the +0.5 offset (``bev_cell_centers(center_offset=0.0)``), and
    for cuboid grids the (1, n, 2) (row, column) index; built once per
    grid and device."""
    h, w = grid_hw
    cells = bev_cell_centers((w, h), voxel_size, pc_range, out_size_factor,
                             voxel_shape, center_offset=0.0)   # (r, az, 4)
    cart = np.ascontiguousarray(cells[..., :2].transpose(1, 0, 2))
    cart = torch.as_tensor(cart.reshape(1, h * w, 2), device=device)
    idx = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                   -1).reshape(1, h * w, 2)
    return cart, torch.as_tensor(idx, device=device)


def double_flip_average(preds):
    """One task's maps at batch B x 4, grouped per sample as [original, y
    flip (H reversed), x flip (W reversed), both], on a cartesian BEV ->
    the (B, ...) maps of the original frame: each copy flipped back, the
    flipped ``reg``, ``rot`` and ``vel`` components mirrored, and the four
    averaged. ``hm`` comes back sigmoided and ``dim`` exponentiated, so
    :func:`center_head_decode` must be told (``pre_activated``)."""
    def mean(v):
        # the copies summed in order, then divided, as XLA reduces them:
        # two cells whose copies hold the same values tie exactly
        return (((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]) / 4

    four = {}
    for k, v in preds.items():
        b4, h, w, c = v.shape
        v = v.reshape(b4 // 4, 4, h, w, c)
        four[k] = torch.stack([v[:, 0], v[:, 1].flip(1), v[:, 2].flip(2),
                               v[:, 3].flip(1, 2)], dim=1)
    out = {"hm": mean(torch.sigmoid(four["hm"])),
           "dim": mean(torch.exp(four["dim"])),
           "height": mean(four["height"])}
    reg = four["reg"].clone()
    for copy, col in ((1, 1), (2, 0), (3, 0), (3, 1)):
        reg[:, copy, ..., col] = 1 - reg[:, copy, ..., col]
    out["reg"] = mean(reg)
    rots = four["rot"][..., 0:1].clone()
    rotc = four["rot"][..., 1:2].clone()
    rotc[:, 1] *= -1   # y flip: theta -> pi - theta
    rots[:, 2] *= -1   # x flip: theta -> -theta
    rots[:, 3] *= -1
    rotc[:, 3] *= -1
    out["rot"] = torch.cat([mean(rots), mean(rotc)], dim=-1)
    if "vel" in four:
        vel = four["vel"].clone()
        vel[:, 1, ..., 1] *= -1
        vel[:, 2, ..., 0] *= -1
        vel[:, 3] *= -1
        out["vel"] = mean(vel)
    if "iou" in four:
        out["iou"] = mean(four["iou"])
    return out


def center_head_decode(preds, grid_hw, voxel_size, pc_range, out_size_factor,
                       voxel_shape="cylinder", rectify=False,
                       pre_activated=False):
    """One task's maps -> (boxes (B, N, 7 or 9), scores (B, N, C)).

    ``grid_hw`` = (n_az, n_r) of the feature map. Boxes are [x, y, z, dx,
    dy, dz, (vx, vy,) yaw]: dims ``exp(clip(dim, -8, 8))``, yaw
    ``atan2(sin, cos)``; on a cylinder grid the cartesian ``reg`` offset is
    added to the cell corner, and ``rectify`` turns yaw and velocity by the
    cell's azimuth. ``pre_activated`` maps (:func:`double_flip_average`'s)
    carry ``hm`` sigmoided and ``dim`` exponentiated already."""
    b, h, w, ncls = preds["hm"].shape
    n = h * w
    if pre_activated:
        hm = preds["hm"].reshape(b, n, ncls)
        dims = preds["dim"].reshape(b, n, 3)
    else:
        hm = torch.sigmoid(preds["hm"]).reshape(b, n, ncls)
        dims = torch.exp(torch.clamp(preds["dim"], -8.0, 8.0)).reshape(
            b, n, 3)
    rot = torch.atan2(preds["rot"][..., 0], preds["rot"][..., 1]).reshape(b, n)
    hei = preds["height"].reshape(b, n)
    reg = preds["reg"].reshape(b, n, 2)
    cart, idx = _cell_corners(
        (int(h), int(w)), tuple(float(v) for v in voxel_size),
        tuple(float(v) for v in pc_range), int(out_size_factor), voxel_shape,
        str(reg.device))
    if voxel_shape == "cylinder":
        xs = cart[..., 0] + reg[..., 0]
        ys = cart[..., 1] + reg[..., 1]
        azs = torch.atan2(ys, xs)
        if rectify:
            rot = rot + azs
    else:
        xs = ((idx[..., 1] + reg[..., 0]) * out_size_factor * voxel_size[0]
              + pc_range[0])
        ys = ((idx[..., 0] + reg[..., 1]) * out_size_factor * voxel_size[1]
              + pc_range[1])
    parts = [xs[..., None], ys[..., None], hei[..., None], dims]
    if "vel" in preds:
        vel = preds["vel"].reshape(b, n, 2)
        if voxel_shape == "cylinder" and rectify:
            vr = torch.linalg.norm(vel, dim=-1)
            va = torch.atan2(vel[..., 1], vel[..., 0]) + azs
            vel = torch.stack([vr * torch.cos(va), vr * torch.sin(va)], -1)
        parts.append(vel)
    parts.append(rot[..., None])
    return torch.cat(parts, dim=-1), hm


def center_head_post_process(boxes, scores, test_cfg, class_offset=0):
    """Score / range mask + rotated NMS -> fixed-size detections per
    sample: ``box3d_lidar``, ``scores``, ``label_preds`` (+
    ``class_offset``) and ``mask``, each (B, nms_post_max_size, ...).
    ``argmax`` ties go to the lower class. With ``per_class_nms`` every
    candidate goes to :func:`batched_rotated_nms` (IoU 0.2 and 83 kept by
    default; the config's ``nms_pre_max_size`` is not read, as in JAX),
    else the top ``nms_pre_max_size`` to :func:`rotate_nms_pcdet`."""
    per_class = test_cfg.get("per_class_nms", False)
    nms_cfg = dict(test_cfg.get("nms", {}))
    pcr = test_cfg.get("post_center_limit_range",
                       [-80, -80, -10, 80, 80, 10])
    thr = test_cfg.get("score_threshold", 0.1)
    outs = []
    for bx, sc in zip(boxes, scores):
        cls_score, label = sc.max(-1)
        m = cls_score > thr
        for i in range(3):
            m &= (bx[:, i] >= pcr[i]) & (bx[:, i] <= pcr[3 + i])
        masked = torch.where(m, cls_score,
                             torch.full_like(cls_score, -float("inf")))
        if per_class:
            keep, kmask = batched_rotated_nms(
                bx[:, [0, 1, 3, 4, -1]], masked, label,
                nms_cfg.get("nms_iou_threshold", 0.2),
                nms_cfg.get("nms_post_max_size", 83))
        else:
            keep, kmask = rotate_nms_pcdet(
                torch.cat([bx[:, :6], bx[:, -1:]], dim=-1), masked,
                nms_cfg.get("nms_iou_threshold", 0.7),
                nms_cfg.get("nms_pre_max_size", 4096),
                nms_cfg.get("nms_post_max_size", 500))
        outs.append({
            "box3d_lidar": bx[keep],
            "scores": cls_score[keep],
            "label_preds": (label[keep] + class_offset).to(torch.int32),
            "mask": kmask & (masked[keep] > -float("inf")),
        })
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
