"""Reference (det3d) ``state_dict`` -> the port's ``state_dict``
(counterpart of ``partner_tpu/train/torch_convert.py``).

Each function maps one reference module's keys straight to the names and
layouts of the port's module (flax's names: ``Conv_k``, ``BatchNorm_k``,
``block{i}``, ...), with no flax tree in between. Its output equals
``partner_tpu.train.torch_convert``'s followed by
:func:`partner_tpu_torch.convert.flax_to_torch`, tensor for tensor: float32
CPU tensors keyed as the port module's ``state_dict`` (relative to the
module converted).

Layouts: the port keeps torch's own layouts for Conv2d (O, I, kh, kw),
Linear (O, I) and ConvTranspose2d (I, O, kh, kw) (the spatial flip of
the JAX path and the one of ``flax_to_torch`` cancel), so those weights
pass as they are; a kernel-1 Conv1d or Conv2d becomes a Dense (O, I); an
spconv weight becomes the flat (K*I, O) kernel of ``models.sparse``
(:func:`.checkpoint.convert_torch_subm_conv`); a BatchNorm's ``weight``,
``bias``, ``running_mean``, ``running_var`` keep their names, but a
``MaskedBatchNorm``'s take flax's (``scale``, ``bias``, ``mean``, ``var``).

The sparse backbone's SparseBasicBlock convs have a bias in the port and in
flax; JAX's converter reads no ``conv{1,2}.bias`` key, the port maps it
where the checkpoint holds one (ROADMAP.md §3).
"""

import numpy as np
import torch

from .checkpoint import convert_torch_subm_conv


def _t(x):
    """A reference tensor (or array) -> a float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return torch.from_numpy(np.array(x, np.float32))


def _bn(sd, prefix, name):
    """A BatchNorm (``layers.BatchNorm``) -> {name.weight, .bias,
    .running_mean, .running_var}."""
    return {f"{name}.{k}": _t(sd[f"{prefix}.{k}"])
            for k in ("weight", "bias", "running_mean", "running_var")}


def _masked_bn(sd, prefix, name):
    """A BatchNorm1d over active voxels -> the ``MaskedBatchNorm``'s flax
    names."""
    return {f"{name}.scale": _t(sd[f"{prefix}.weight"]),
            f"{name}.bias": _t(sd[f"{prefix}.bias"]),
            f"{name}.mean": _t(sd[f"{prefix}.running_mean"]),
            f"{name}.var": _t(sd[f"{prefix}.running_var"])}


def _weight_bias(sd, prefix, name, weight):
    out = {f"{name}.weight": weight}
    if f"{prefix}.bias" in sd:
        out[f"{name}.bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _as_is(sd, prefix, name):
    """Conv2d (O, I, kh, kw) or Linear (O, I) [+ bias] -> ``layers.Conv2d``
    or ``layers.Dense``: the same layout."""
    return _weight_bias(sd, prefix, name, _t(sd[f"{prefix}.weight"]))


def _kernel1_as_dense(sd, prefix, name):
    """Conv1d (O, I, 1) or Conv2d (O, I, 1, 1) [+ bias] -> a Dense."""
    w = _t(sd[f"{prefix}.weight"])
    return _weight_bias(sd, prefix, name, w.reshape(w.shape[0], w.shape[1]))


def _ln(sd, prefix, name):
    return {f"{name}.weight": _t(sd[f"{prefix}.weight"]),
            f"{name}.bias": _t(sd[f"{prefix}.bias"])}


def prefixed(name, sd):
    """Prefix every key of a converted ``sd`` with ``name.``."""
    return {f"{name}.{k}": v for k, v in sd.items()}


def convert_rpn_state_dict(sd, layer_nums, us_layer_strides):
    """Reference RPN (``blocks.{i}.{idx}`` conv / BN Sequentials and
    ``deblocks.{j}``) -> the port's ``RPN``: per scale the entry conv and
    ``layer_nums[i]`` convs, each with its BN, then from the upsample start
    a deblock (a ConvTranspose for stride > 1, else a conv) with its BN,
    numbered in creation order."""
    out = {}
    conv_i = bn_i = tr_i = 0
    upsample_start = len(layer_nums) - len(us_layer_strides)
    for i, n in enumerate(layer_nums):
        # ZeroPad2d at index 0, then (Conv, BN, ReLU) at (1, 2, 3), ...
        for li in range(n + 1):
            out[f"Conv_{conv_i}.weight"] = _t(
                sd[f"blocks.{i}.{3 * li + 1}.weight"])
            conv_i += 1
            out.update(_bn(sd, f"blocks.{i}.{3 * li + 2}",
                           f"BatchNorm_{bn_i}"))
            bn_i += 1
        j = i - upsample_start
        if j >= 0:
            w = _t(sd[f"deblocks.{j}.0.weight"])
            if us_layer_strides[j] > 1:
                out[f"ConvTranspose_{tr_i}.weight"] = w
                tr_i += 1
            else:
                out[f"Conv_{conv_i}.weight"] = w
                conv_i += 1
            out.update(_bn(sd, f"deblocks.{j}.1", f"BatchNorm_{bn_i}"))
            bn_i += 1
    return out


def convert_sep_head_state_dict(sd, heads, prefix=""):
    """Reference SepHead (per head a Sequential, convs at even indices, the
    last at ``2 * (num_conv - 1)``, all with bias) -> the port's
    ``SepHead`` (``{head}_conv{j}``, ``{head}_out``)."""
    out = {}
    for name, (_, num_conv) in dict(heads).items():
        for j in range(num_conv - 1):
            out.update(_as_is(sd, f"{prefix}{name}.{2 * j}",
                               f"{name}_conv{j}"))
        out.update(_as_is(sd, f"{prefix}{name}.{2 * (num_conv - 1)}",
                           f"{name}_out"))
    return out


def convert_center_head_state_dict(sd, common_heads, num_tasks,
                                   num_classes_per_task):
    """Reference CenterHead (``shared_conv.0`` conv + ReLU, no norm, and
    ``tasks.{t}`` SepHeads) -> the port's ``CenterHead`` (``Conv_0``,
    ``task{t}``)."""
    out = _as_is(sd, "shared_conv.0", "Conv_0")
    for t in range(num_tasks):
        heads = dict(common_heads)
        heads["hm"] = (num_classes_per_task[t],
                       heads["hm"][1] if "hm" in heads else 2)
        out.update(prefixed(f"task{t}", convert_sep_head_state_dict(
            sd, heads, prefix=f"tasks.{t}.")))
    return out


def _pos_mlp(sd, prefix, name):
    """Reference pos_embedding_cart Sequential(Conv1d(2, 16, 1), BN1d,
    ReLU, Conv1d(16, nh, 1)) -> the port's ``PosEmbedMLP``."""
    out = _kernel1_as_dense(sd, f"{prefix}.0", "Dense_0")
    out.update(_bn(sd, f"{prefix}.1", "BatchNorm_0"))
    out.update(_kernel1_as_dense(sd, f"{prefix}.3", "Dense_1"))
    return prefixed(name, out)


def _mlp(sd, prefix, name):
    """Reference Mlp (fc1, fc2) -> the port's ``Mlp``."""
    out = _as_is(sd, f"{prefix}.fc1", "Dense_0")
    out.update(_as_is(sd, f"{prefix}.fc2", "Dense_1"))
    return prefixed(name, out)


def _projections(sd, prefix, names):
    out = {}
    for n in names:
        out.update(_as_is(sd, f"{prefix}{n}", n))
    return out


def convert_range_attention_state_dict(sd, prefix=""):
    """Reference RangeAttention -> the port's ``RangeAttention``."""
    out = _projections(sd, prefix, ("proj_q", "proj_k", "proj_v", "proj"))
    out.update(_ln(sd, f"{prefix}norm1", "norm1"))
    out.update(_ln(sd, f"{prefix}norm2", "norm2"))
    out.update(_mlp(sd, f"{prefix}mlp", "Mlp_0"))
    out.update(_pos_mlp(sd, f"{prefix}pos_embedding_cart", "pos_mlp"))
    return out


def convert_sector_attention_state_dict(sd, prefix=""):
    """Reference SectorAttention -> the port's ``SectorAttention`` (the
    weights map 1:1; the reference's activations do not, see the JAX
    function)."""
    out = _projections(sd, prefix, ("proj_q", "proj_k", "proj_v", "proj"))
    out.update(_ln(sd, f"{prefix}norm2", "norm2"))
    out.update(_mlp(sd, f"{prefix}mlp", "Mlp_0"))
    out.update(_pos_mlp(sd, f"{prefix}pos_embedding_cart", "pos_mlp"))
    return out


def convert_sector_broadcast_state_dict(sd, prefix=""):
    """Reference SectorAttentionV2 -> the port's ``SectorBroadcast`` (q, k,
    v and the position bias)."""
    out = _projections(sd, prefix, ("proj_q", "proj_k", "proj_v"))
    out.update(_pos_mlp(sd, f"{prefix}pos_embedding_cart", "pos_mlp"))
    return out


def convert_set_attention_state_dict(sd, prefix=""):
    """One reference SetAttention block -> the port's ``SetAttention``
    (its own unused ``pos_embedding_cart`` is skipped, as in JAX)."""
    out = _ln(sd, f"{prefix}norm1", "norm1")
    out.update(_ln(sd, f"{prefix}norm2", "norm2"))
    out.update(_as_is(sd, f"{prefix}proj", "proj"))
    out.update(_mlp(sd, f"{prefix}mlp", "Mlp_0"))
    for name, fn in (("sector_attn1", convert_sector_attention_state_dict),
                     ("range_attn", convert_range_attention_state_dict),
                     ("sector_attn2", convert_sector_broadcast_state_dict)):
        out.update(prefixed(name, fn(sd, prefix=f"{prefix}{name}.")))
    return out


def convert_window_attention_state_dict(sd, prefix=""):
    """The SwinVote WindowAttention (qkv, proj, tau, the rpe
    Conv2d(2, 16, 1) + ReLU + Conv2d(16, nh, 1) and the vote_mlp
    Conv1d(3, 16, 1) + ReLU + Conv1d(16, C, 1)) -> the port's
    ``WindowAttention``."""
    out = _as_is(sd, f"{prefix}qkv", "qkv")
    out.update(_as_is(sd, f"{prefix}proj", "proj"))
    out["tau"] = _t(sd[f"{prefix}tau"])
    for name, idx in (("rpe", (0, 2)), ("vote_mlp", (0, 2))):
        for k, i in enumerate(idx):
            out.update(prefixed(name, _kernel1_as_dense(
                sd, f"{prefix}{name}.{i}", f"Dense_{k}")))
    return out


def _conv_head(sd, prefix, name):
    """Reference Sequential(Conv, ReLU, Conv) -> the port's ``ConvHead``."""
    out = _as_is(sd, f"{prefix}.0", "Conv_0")
    out.update(_as_is(sd, f"{prefix}.2", "Conv_1"))
    return prefixed(name, out)


def _conv_bn_head(sd, conv0, bn, conv1, name):
    """Reference Conv + BN + ReLU + Conv -> the port's ``ConvBNHead``."""
    out = _as_is(sd, conv0, "Conv_0")
    out.update(_bn(sd, bn, "BatchNorm_0"))
    out.update(_as_is(sd, conv1, "Conv_1"))
    return prefixed(name, out)


def convert_e2e_head_state_dict(sd, sl_depth=2, iou_head=True):
    """The E2ESWVoteHead (with the SwinVote transformer ``layer``) -> the
    port's ``E2ESWVoteHead``: vote, vote-class, class, box and IoU heads;
    ``layer.patch_embed.{proj,norm}`` -> ``layer.patch_embed`` /
    ``layer.patch_norm``, ``layer.layers.0.blocks.{i}`` ->
    ``layer.block{i}``, ``layer.norm0`` -> ``layer.norm_out``."""
    out = _conv_head(sd, "vote_head", "vote_head")
    out.update(_conv_head(sd, "bbox_head", "bbox_head"))
    out.update(_conv_bn_head(sd, "vote_cls_head.0", "vote_cls_head.1",
                             "vote_cls_head.3", "vote_cls_head"))
    out.update(_conv_bn_head(sd, "cls_head.0.0", "cls_head.0.1",
                             "cls_head.1", "cls_head"))
    if iou_head:
        out.update(_conv_head(sd, "iou_head", "iou_head"))
    layer = _as_is(sd, "layer.patch_embed.proj", "patch_embed")
    layer.update(_ln(sd, "layer.patch_embed.norm", "patch_norm"))
    layer.update(_ln(sd, "layer.norm0", "norm_out"))
    for i in range(sl_depth):
        pre = f"layer.layers.0.blocks.{i}."
        block = _ln(sd, f"{pre}norm1", "norm1")
        block.update(_ln(sd, f"{pre}norm2", "norm2"))
        block.update(prefixed("attn", convert_window_attention_state_dict(
            sd, f"{pre}attn.")))
        block.update(_as_is(sd, f"{pre}mlp.fc1", "mlp_fc1"))
        block.update(_as_is(sd, f"{pre}mlp.fc2", "mlp_fc2"))
        layer.update(prefixed(f"block{i}", block))
    out.update(prefixed("layer", layer))
    return out


def convert_backbone_state_dict(sd):
    """SpMiddleResNetFHD's spconv weights -> the port's
    ``SpMiddleResNetFHD``: ``conv_input`` (SubM, BN), ``conv1.{k}``
    SparseBasicBlocks (conv1, bn1, conv2, bn2) -> ``conv1_{k}``;
    ``conv2``..``conv4`` (SparseConv, BN, ReLU, block, block) -> the
    down block's ``SparseConv_0``, ``MaskedBatchNorm_0`` and
    ``SparseBasicBlock_{0,1}``; ``extra_conv`` (SparseConv, BN)."""
    out = {}

    def conv(key, name):
        out[f"{name}.kernel"] = _t(convert_torch_subm_conv(_t(sd[key])
                                                           .numpy()))

    def basic_block(prefix, name):
        for j in (1, 2):
            conv(f"{prefix}.conv{j}.weight", f"{name}.SparseConv_{j - 1}")
            if f"{prefix}.conv{j}.bias" in sd:
                out[f"{name}.SparseConv_{j - 1}.bias"] = _t(
                    sd[f"{prefix}.conv{j}.bias"])
            out.update(_masked_bn(sd, f"{prefix}.bn{j}",
                                  f"{name}.MaskedBatchNorm_{j - 1}"))

    conv("conv_input.0.weight", "conv_input.SparseConv_0")
    out.update(_masked_bn(sd, "conv_input.1", "conv_input.MaskedBatchNorm_0"))
    for k in range(2):
        basic_block(f"conv1.{k}", f"conv1_{k}")
    for name in ("conv2", "conv3", "conv4"):
        conv(f"{name}.0.weight", f"{name}.SparseConv_0")
        out.update(_masked_bn(sd, f"{name}.1", f"{name}.MaskedBatchNorm_0"))
        for bi, ti in enumerate((3, 4)):
            basic_block(f"{name}.{ti}", f"{name}.SparseBasicBlock_{bi}")
    conv("extra_conv.0.weight", "extra_conv.SparseConv_0")
    out.update(_masked_bn(sd, "extra_conv.1", "extra_conv.MaskedBatchNorm_0"))
    return out


def strip_module_prefix(sd):
    """Drop DDP's ``module.`` prefix from every key that has it."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def sub_state_dict(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def convert_voxelnet_state_dict(sd, layer_nums, us_layer_strides,
                                common_heads, num_classes_per_task):
    """A whole reference VoxelNet (CenterPoint) state_dict (``backbone.``,
    ``neck.``, ``bbox_head.``; DDP ``module.`` prefixes stripped) -> the
    port's ``VoxelNetModule`` state_dict (the reader has no parameters)."""
    sd = strip_module_prefix(sd)
    out = prefixed("backbone", convert_backbone_state_dict(
        sub_state_dict(sd, "backbone.")))
    out.update(prefixed("neck", convert_rpn_state_dict(
        sub_state_dict(sd, "neck."), layer_nums, us_layer_strides)))
    out.update(prefixed("bbox_head", convert_center_head_state_dict(
        sub_state_dict(sd, "bbox_head."), common_heads,
        len(num_classes_per_task), num_classes_per_task)))
    return out


def convert_voxelnet_v3_state_dict(sd, layer_nums, us_layer_strides,
                                   set_depth=2, sl_depth=2, iou_head=True):
    """A whole reference VoxelNetV3 (PARTNER) state_dict with the sparse
    backbone (``backbone.``, the SetAttention stack ``attns.{i}.``,
    ``neck.``, ``bbox_head.``; DDP ``module.`` prefixes stripped) -> the
    port's ``VoxelNetModule`` state_dict (``attns.block{i}``). The JAX
    package has no whole-detector function for this model; this one is the
    composition of its per-module functions."""
    sd = strip_module_prefix(sd)
    out = prefixed("backbone", convert_backbone_state_dict(
        sub_state_dict(sd, "backbone.")))
    for i in range(set_depth):
        out.update(prefixed(f"attns.block{i}",
                            convert_set_attention_state_dict(
                                sd, prefix=f"attns.{i}.")))
    out.update(prefixed("neck", convert_rpn_state_dict(
        sub_state_dict(sd, "neck."), layer_nums, us_layer_strides)))
    out.update(prefixed("bbox_head", convert_e2e_head_state_dict(
        sub_state_dict(sd, "bbox_head."), sl_depth, iou_head)))
    return out
