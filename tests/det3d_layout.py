"""Synthetic state_dicts in the reference (det3d) layout, for the
checkpoint converters' tests and ``chip_smoke.py`` (numpy and torch only).

Every key and shape is the one ``partner_tpu/train/torch_convert.py``'s
functions read; every tensor is drawn from the ``np.random.RandomState``
given, norms included (weights and biases around 1 and 0, running means
around 0, running variances in [0.5, 1.5]).
"""

import numpy as np
import torch

HEAD_CONV = 64   # SepHead's and the E2E head's hidden conv width


class Layout:
    """Collects ``{key: float32 tensor}``; ``spconv`` is the sparse conv
    weights' layout, ``"kzyxio"`` (spconv 1.x) or ``"okzyxi"`` (2.x)."""

    def __init__(self, rng, spconv="kzyxio", sparse_bias=True):
        self.rng = rng
        self.spconv = spconv
        self.sparse_bias = sparse_bias
        self.sd = {}

    def put(self, key, shape, kind="weight"):
        r = self.rng
        if kind == "weight":
            a = r.randn(*shape) / np.sqrt(max(1, np.prod(shape[1:])))
        elif kind in ("scale", "var"):
            a = r.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            a = r.normal(0.0, 0.2, shape)
        self.sd[key] = torch.from_numpy(np.asarray(a, np.float32))

    def conv(self, key, o, i, *kernel, bias=True):
        self.put(f"{key}.weight", (o, i) + kernel)
        if bias:
            self.put(f"{key}.bias", (o,), "bias")

    def bn(self, key, c):
        self.put(f"{key}.weight", (c,), "scale")
        self.put(f"{key}.bias", (c,), "bias")
        self.put(f"{key}.running_mean", (c,), "mean")
        self.put(f"{key}.running_var", (c,), "var")

    def ln(self, key, c):
        self.put(f"{key}.weight", (c,), "scale")
        self.put(f"{key}.bias", (c,), "bias")

    def spconv_weight(self, key, i, o, kernel=(3, 3, 3), bias=False):
        shape = (tuple(kernel) + (i, o) if self.spconv == "kzyxio"
                 else (o,) + tuple(kernel) + (i,))
        a = self.rng.randn(*shape) / np.sqrt(np.prod(kernel) * i)
        self.sd[f"{key}.weight"] = torch.from_numpy(a.astype(np.float32))
        if bias:
            self.put(f"{key}.bias", (o,), "bias")


def rpn(lay, prefix, layer_nums, ds_num_filters, us_num_filters,
        us_layer_strides, num_input_features):
    """det3d ``RPN``: blocks.{i} = ZeroPad2d, (Conv, BN, ReLU) x (n + 1);
    deblocks.{j} = (ConvTranspose2d or Conv2d, BN, ReLU)."""
    cin = num_input_features
    start = len(layer_nums) - len(us_layer_strides)
    for i, n in enumerate(layer_nums):
        f = ds_num_filters[i]
        for li in range(n + 1):
            lay.conv(f"{prefix}blocks.{i}.{3 * li + 1}", f, cin, 3, 3,
                     bias=False)
            lay.bn(f"{prefix}blocks.{i}.{3 * li + 2}", f)
            cin = f
        j = i - start
        if j >= 0:
            s, uf = us_layer_strides[j], us_num_filters[j]
            if s > 1:    # ConvTranspose2d weight (I, O, kh, kw)
                lay.conv(f"{prefix}deblocks.{j}.0", f, uf, s, s, bias=False)
            else:
                lay.conv(f"{prefix}deblocks.{j}.0", uf, f, 1, 1, bias=False)
            lay.bn(f"{prefix}deblocks.{j}.1", uf)


def sep_head(lay, prefix, heads, cin):
    for name, (classes, num_conv) in dict(heads).items():
        c = cin
        for j in range(num_conv - 1):
            lay.conv(f"{prefix}{name}.{2 * j}", HEAD_CONV, c, 3, 3)
            c = HEAD_CONV
        lay.conv(f"{prefix}{name}.{2 * (num_conv - 1)}", classes, c, 3, 3)


def center_head(lay, prefix, in_channels, common_heads, classes_per_task,
                share=64):
    lay.conv(f"{prefix}shared_conv.0", share, in_channels, 3, 3)
    for t, n in enumerate(classes_per_task):
        heads = dict(common_heads)
        heads["hm"] = (n, 2)
        sep_head(lay, f"{prefix}tasks.{t}.", heads, share)


def pos_mlp(lay, prefix, nh):
    lay.conv(f"{prefix}.0", 16, 2, 1)
    lay.bn(f"{prefix}.1", 16)
    lay.conv(f"{prefix}.3", nh, 16, 1)


def mlp(lay, prefix, dim, hidden):
    lay.conv(f"{prefix}.fc1", hidden, dim)
    lay.conv(f"{prefix}.fc2", dim, hidden)


def set_attention(lay, prefix, dim, nh, mlp_ratio=4):
    """One SetAttention block with its two sector and its range
    attention."""
    hid = int(dim * mlp_ratio)
    lay.ln(f"{prefix}norm1", dim)
    lay.ln(f"{prefix}norm2", dim)
    lay.conv(f"{prefix}proj", dim, dim)
    mlp(lay, f"{prefix}mlp", dim, hid)
    for sub, full in (("sector_attn1", True), ("range_attn", True),
                      ("sector_attn2", False)):
        p = f"{prefix}{sub}."
        for n in ("proj_q", "proj_k", "proj_v"):
            lay.conv(f"{p}{n}", dim, dim)
        pos_mlp(lay, f"{p}pos_embedding_cart", nh)
        if full:
            lay.conv(f"{p}proj", dim, dim)
            lay.ln(f"{p}norm2", dim)
            mlp(lay, f"{p}mlp", dim, hid)
        if sub == "range_attn":
            lay.ln(f"{p}norm1", dim)


def window_attention(lay, prefix, dim, nh):
    lay.conv(f"{prefix}qkv", 3 * dim, dim)
    lay.conv(f"{prefix}proj", dim, dim)
    lay.put(f"{prefix}tau", (1, nh, 1, 1), "scale")
    lay.conv(f"{prefix}rpe.0", 16, 2, 1, 1)
    lay.conv(f"{prefix}rpe.2", nh, 16, 1, 1)
    lay.conv(f"{prefix}vote_mlp.0", 16, 3, 1)
    lay.conv(f"{prefix}vote_mlp.2", dim, 16, 1)


def e2e_head(lay, prefix, in_channels, num_classes=1, kernel=3, sl_depth=2,
             nh=4, iou_head=True, code=8):
    """The E2ESWVoteHead in the layout ``convert_e2e_head_state_dict``
    reads (embed width ``in_channels // 2``, Swin MLP ratio 1)."""
    half = in_channels // 2
    k = kernel
    lay.conv(f"{prefix}vote_head.0", HEAD_CONV, in_channels, k, k)
    lay.conv(f"{prefix}vote_head.2", 2, HEAD_CONV, k, k)
    lay.conv(f"{prefix}vote_cls_head.0", half, in_channels, 3, 3)
    lay.bn(f"{prefix}vote_cls_head.1", half)
    lay.conv(f"{prefix}vote_cls_head.3", 1, half, k, k)
    lay.conv(f"{prefix}cls_head.0.0", half, half, 3, 3)
    lay.bn(f"{prefix}cls_head.0.1", half)
    lay.conv(f"{prefix}cls_head.1", num_classes, half, k, k)
    lay.conv(f"{prefix}bbox_head.0", HEAD_CONV, half, k, k)
    lay.conv(f"{prefix}bbox_head.2", code, HEAD_CONV, k, k)
    if iou_head:
        lay.conv(f"{prefix}iou_head.0", HEAD_CONV, half, k, k)
        lay.conv(f"{prefix}iou_head.2", 1, HEAD_CONV, k, k)
    lay.conv(f"{prefix}layer.patch_embed.proj", half, in_channels, 1, 1)
    lay.ln(f"{prefix}layer.patch_embed.norm", half)
    lay.ln(f"{prefix}layer.norm0", half)
    for i in range(sl_depth):
        p = f"{prefix}layer.layers.0.blocks.{i}."
        lay.ln(f"{p}norm1", half)
        lay.ln(f"{p}norm2", half)
        window_attention(lay, f"{p}attn.", half, nh)
        mlp(lay, f"{p}mlp", half, half)


def sparse_backbone(lay, prefix, num_input_features):
    """SpMiddleResNetFHD: conv_input (SubM, BN), conv1.{0,1} basic blocks,
    conv2..conv4 (SparseConv, BN, ReLU, block, block), extra_conv."""

    def block(p, c):
        for j in (1, 2):
            lay.spconv_weight(f"{p}.conv{j}", c, c, bias=lay.sparse_bias)
            lay.bn(f"{p}.bn{j}", c)

    lay.spconv_weight(f"{prefix}conv_input.0", num_input_features, 16)
    lay.bn(f"{prefix}conv_input.1", 16)
    block(f"{prefix}conv1.0", 16)
    block(f"{prefix}conv1.1", 16)
    for name, ci, co in (("conv2", 16, 32), ("conv3", 32, 64),
                         ("conv4", 64, 128)):
        lay.spconv_weight(f"{prefix}{name}.0", ci, co)
        lay.bn(f"{prefix}{name}.1", co)
        block(f"{prefix}{name}.3", co)
        block(f"{prefix}{name}.4", co)
    lay.spconv_weight(f"{prefix}extra_conv.0", 128, 128, (3, 1, 1))
    lay.bn(f"{prefix}extra_conv.1", 128)


def partner_state_dict(rng, model_cfg, bev_features, spconv="kzyxio",
                       ddp=True):
    """A whole VoxelNetV3 (PARTNER) with the sparse backbone, from the
    model config the port builds (``bev_features``: the backbone's BEV
    width), keys under ``backbone.``, ``attns.{i}.``, ``neck.``,
    ``bbox_head.``, with DDP's ``module.`` prefix when ``ddp``."""
    lay = Layout(rng, spconv)
    neck = model_cfg["neck"]
    hc = model_cfg["bbox_head"]["HEAD_CONFIG"]
    sparse_backbone(lay, "backbone.",
                    model_cfg["backbone"]["num_input_features"])
    for i in range(neck.get("set_depth", 2)):
        set_attention(lay, f"attns.{i}.", bev_features,
                      neck.get("set_num_heads", 4))
    rpn(lay, "neck.", neck["layer_nums"], neck["ds_num_filters"],
        neck["us_num_filters"], neck["us_layer_strides"],
        neck["num_input_features"])
    sl = hc.get("sl_depth", [2])
    e2e_head(lay, "bbox_head.", model_cfg["bbox_head"]["in_channels"],
             hc.get("num_classes", 1), hc.get("kernel_size", 3),
             sl[0] if isinstance(sl, (list, tuple)) else sl,
             iou_head=hc.get("iou_loss", True))
    prefix = "module." if ddp else ""
    return {prefix + k: v for k, v in lay.sd.items()}
