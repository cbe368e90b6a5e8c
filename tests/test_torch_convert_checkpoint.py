"""The reference (det3d) checkpoint converters of partner_tpu_torch against
the JAX package's (CPU).

On synthetic state_dicts in the reference layout (``det3d_layout``: every
key and shape ``partner_tpu/train/torch_convert.py`` reads, norms
randomized), in both spconv weight layouts and with DDP ``module.``
prefixes:

- each converter function's output ``torch.equal`` to JAX's
  ``torch_convert`` followed by ``convert.flax_to_torch`` (the sparse
  blocks' conv biases, which JAX drops, aside: the port maps them);
- the converted sections' keys and shapes exactly the port module's;
- ``python -m partner_tpu_torch.tools.convert_checkpoint`` equal to the
  JAX tool's ``state.pkl`` as the port's JAX reader reads it, and its
  checkpoint loaded by ``tools.train.load_parameters`` into a
  SpMiddleResNetFHD detector bit-equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

import det3d_layout as d3
from torch_port_fixtures import (CENTERPOINT, SPARSE_BEV, tiny_centerpoint_cfg,
                                 tiny_frame_cfg, with_sparse_backbone)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("kzyxio", "okzyxi")
LAYER_NUMS, DS, US, US_STRIDES = [1, 1], [16, 32], [32, 32], [1, 2]
HEADS = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2)}


def flax(params, stats=None):
    """JAX torch_convert's trees -> the port's state_dict through
    ``flax_to_torch``."""
    from partner_tpu_torch.convert import flax_to_torch

    return flax_to_torch({"params": params, "batch_stats": stats or {}})


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def layout(seed, spconv="kzyxio", sparse_bias=False):
    return d3.Layout(np.random.RandomState(seed), spconv, sparse_bias)


def test_layout_helpers_match_jax():
    from partner_tpu.train import checkpoint as jc
    from partner_tpu_torch.train import checkpoint as tc

    rng = np.random.RandomState(0)
    w = rng.randn(8, 5, 3, 3).astype(np.float32)
    np.testing.assert_array_equal(tc.convert_torch_conv2d(w),
                                  jc.convert_torch_conv2d(w))
    w = rng.randn(8, 5).astype(np.float32)
    np.testing.assert_array_equal(tc.convert_torch_linear(w),
                                  jc.convert_torch_linear(w))
    for shape in ((3, 3, 3, 5, 16), (16, 3, 3, 3, 5), (3, 1, 1, 128, 128),
                  (128, 3, 1, 1, 128), (32, 3, 3, 3, 32)):
        w = rng.randn(*shape).astype(np.float32)
        np.testing.assert_array_equal(tc.convert_torch_subm_conv(w),
                                      jc.convert_torch_subm_conv(w))


def test_rpn_and_center_head_match_jax():
    from partner_tpu.train import torch_convert as jt
    from partner_tpu_torch.train import torch_convert as tt

    lay = layout(1)
    d3.rpn(lay, "", LAYER_NUMS, DS, US, US_STRIDES, 64)
    assert_same(tt.convert_rpn_state_dict(lay.sd, LAYER_NUMS, US_STRIDES),
                flax(*jt.convert_rpn_state_dict(lay.sd, LAYER_NUMS,
                                                US_STRIDES)))
    lay = layout(2)
    d3.sep_head(lay, "", dict(HEADS, hm=(3, 2)), 64)
    assert_same(tt.convert_sep_head_state_dict(lay.sd, dict(HEADS, hm=(3, 2))),
                flax(jt.convert_sep_head_state_dict(lay.sd,
                                                    dict(HEADS, hm=(3, 2)))))
    lay = layout(3)
    d3.center_head(lay, "", 64, HEADS, [1, 2])
    assert_same(tt.convert_center_head_state_dict(lay.sd, HEADS, 2, [1, 2]),
                flax(*jt.convert_center_head_state_dict(lay.sd, HEADS, 2,
                                                        [1, 2])))


@pytest.mark.parametrize("fn", ["range", "sector", "sector_broadcast",
                                "set", "window"])
def test_attention_converters_match_jax(fn):
    from partner_tpu.train import torch_convert as jt
    from partner_tpu_torch.train import torch_convert as tt

    lay = layout(4)
    d3.set_attention(lay, "blk.", 32, 4)
    d3.window_attention(lay, "win.", 32, 4)
    prefix = {"range": "blk.range_attn.", "sector": "blk.sector_attn1.",
              "sector_broadcast": "blk.sector_attn2.", "set": "blk.",
              "window": "win."}[fn]
    name = {"range": "range_attention", "sector": "sector_attention",
            "sector_broadcast": "sector_broadcast", "set": "set_attention",
            "window": "window_attention"}[fn] + "_state_dict"
    want = getattr(jt, "convert_" + name)(lay.sd, prefix=prefix)
    want = flax(*want) if isinstance(want, tuple) else flax(want)
    assert_same(getattr(tt, "convert_" + name)(lay.sd, prefix=prefix), want)


@pytest.mark.parametrize("iou_head", [True, False])
def test_e2e_head_matches_jax(iou_head):
    from partner_tpu.train import torch_convert as jt
    from partner_tpu_torch.train import torch_convert as tt

    lay = layout(5)
    d3.e2e_head(lay, "", 64, iou_head=iou_head)
    assert_same(tt.convert_e2e_head_state_dict(lay.sd, 2, iou_head),
                flax(*jt.convert_e2e_head_state_dict(lay.sd, 2, iou_head)))


@pytest.mark.parametrize("spconv", LAYOUTS)
@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
def test_backbone_matches_jax(spconv, bias):
    """Without the blocks' conv biases equal to JAX; with them, JAX drops
    them and the port maps them as they are."""
    from partner_tpu.train import torch_convert as jt
    from partner_tpu_torch.train import torch_convert as tt

    lay = layout(6, spconv, bias)
    d3.sparse_backbone(lay, "", 5)
    got = tt.convert_backbone_state_dict(lay.sd)
    want = flax(*jt.convert_backbone_state_dict(lay.sd))
    biases = {k for k in got if k not in want}
    assert_same({k: v for k, v in got.items() if k not in biases}, want)
    assert len(biases) == (16 if bias else 0)
    for k in biases:
        block, conv = k.split(".SparseConv_")
        j = int(conv[0]) + 1
        ref = (block.replace("conv1_", "conv1.")
               .replace("SparseBasicBlock_0", "3")
               .replace("SparseBasicBlock_1", "4"))
        assert torch.equal(got[k], lay.sd[f"{ref}.conv{j}.bias"]), k


def _tiny_sparse(config):
    m, tc = (tiny_frame_cfg() if config == "partner"
             else tiny_centerpoint_cfg(CENTERPOINT))
    return with_sparse_backbone(m), tc


def _centerpoint_reference(m, seed, spconv, bias):
    """A VoxelNet (CenterPoint) with the sparse backbone, reference layout,
    ``module.`` on the head's keys only."""
    lay = layout(seed, spconv, bias)
    d3.sparse_backbone(lay, "backbone.", m["backbone"]["num_input_features"])
    nk = m["neck"]
    d3.rpn(lay, "neck.", nk["layer_nums"], nk["ds_num_filters"],
           nk["us_num_filters"], nk["us_layer_strides"],
           nk["num_input_features"])
    classes = [len(t["class_names"]) for t in m["bbox_head"]["tasks"]]
    d3.center_head(lay, "bbox_head.", m["bbox_head"]["in_channels"],
                   m["bbox_head"]["common_heads"], classes,
                   m["bbox_head"].get("share_conv_channel", 64))
    return {("module." + k if k.startswith("bbox_head.") else k): v
            for k, v in lay.sd.items()}, classes


@pytest.mark.parametrize("spconv", LAYOUTS)
def test_voxelnet_detector_matches_jax_and_loads(spconv):
    from partner_tpu.train import torch_convert as jt
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train import torch_convert as tt

    m, tc = _tiny_sparse("centerpoint")
    sd, classes = _centerpoint_reference(m, 7, spconv, False)
    nk, heads = m["neck"], m["bbox_head"]["common_heads"]
    got = tt.convert_voxelnet_state_dict(sd, nk["layer_nums"],
                                         nk["us_layer_strides"], heads,
                                         classes)
    v = jt.convert_voxelnet_state_dict(sd, nk["layer_nums"],
                                       nk["us_layer_strides"], heads, classes)
    assert_same(got, flax(v["params"], v["batch_stats"]))
    det = build_detector(m, None, tc, device="cpu")
    want = det.module.state_dict()
    missing = sorted(set(want) - set(got))   # JAX drops the blocks' biases
    assert missing and all(".SparseConv_" in k and k.endswith(".bias")
                           for k in missing)
    assert not set(got) - set(want)
    sd, _ = _centerpoint_reference(m, 7, spconv, True)
    got = tt.convert_voxelnet_state_dict(sd, nk["layer_nums"],
                                         nk["us_layer_strides"], heads,
                                         classes)
    det.module.load_state_dict(got, strict=True)
    for k, v in det.module.state_dict().items():
        assert torch.equal(v, got[k]), k


@pytest.mark.parametrize("spconv", LAYOUTS)
def test_partner_detector_matches_jax_and_loads(spconv):
    """The whole SpMiddleResNetFHD PARTNER detector: the port's function
    equals JAX's per-module functions composed, and loads strictly."""
    from partner_tpu.train import torch_convert as jt
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train import torch_convert as tt

    m, tc = _tiny_sparse("partner")
    sd = d3.partner_state_dict(np.random.RandomState(8), m, SPARSE_BEV,
                               spconv)
    assert all(k.startswith("module.") for k in sd)
    nk = m["neck"]
    got = tt.convert_voxelnet_v3_state_dict(sd, nk["layer_nums"],
                                            nk["us_layer_strides"])
    plain = tt.strip_module_prefix(sd)
    want = {}
    for name, (p, s) in {
            "backbone": jt.convert_backbone_state_dict(
                tt.sub_state_dict(plain, "backbone.")),
            "attns.block0": jt.convert_set_attention_state_dict(
                plain, "attns.0."),
            "attns.block1": jt.convert_set_attention_state_dict(
                plain, "attns.1."),
            "neck": jt.convert_rpn_state_dict(
                tt.sub_state_dict(plain, "neck."), nk["layer_nums"],
                nk["us_layer_strides"]),
            "bbox_head": jt.convert_e2e_head_state_dict(
                tt.sub_state_dict(plain, "bbox_head."))}.items():
        want.update(tt.prefixed(name, flax(p, s)))
    biases = {k for k in got if k not in want}
    assert all(".SparseConv_" in k and k.endswith(".bias") for k in biases)
    assert_same({k: v for k, v in got.items() if k not in biases}, want)
    det = build_detector(m, None, tc, device="cpu")
    det.module.load_state_dict(got, strict=True)
    assert det.input_kind == "voxels"


def _write_pth(path, sd):
    torch.save({"state_dict": sd, "meta": {"epoch": 36}}, path)
    return str(path)


def _jax_cli(argv, monkeypatch):
    """The JAX tool in this process -> the port's reading of its
    ``latest`` checkpoint."""
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import convert_checkpoint as jcli
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py"] + argv)
    jcli.main()
    return load_checkpoint(os.path.join(argv[1], "latest"))


@pytest.mark.parametrize("spconv", LAYOUTS)
def test_cli_matches_jax_cli(tmp_path, monkeypatch, spconv):
    from partner_tpu_torch.tools import convert_checkpoint
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    m, _ = _tiny_sparse("centerpoint")
    sd, _ = _centerpoint_reference(m, 9, spconv, False)
    pth = _write_pth(tmp_path / "in.pth", sd)
    flags = ["--layer_nums", "1", "1", "--us_strides", "1", "2"]
    jpayload, jmeta = _jax_cli([pth, str(tmp_path / "jax")] + flags,
                               monkeypatch)
    path = convert_checkpoint.main([pth, str(tmp_path / "port")] + flags)
    payload, meta = load_checkpoint(path)
    assert meta == jmeta == {"converted_from": pth}
    assert payload["step"] == jpayload["step"] == 0
    assert_same(payload["state_dict"], jpayload["state_dict"])
    assert {k.split(".")[0] for k in payload["state_dict"]} == {"backbone",
                                                                "neck"}


def test_cli_checkpoint_loads_into_sparse_detector(tmp_path):
    """``--load_from`` (``tools.train.load_parameters``) of the converter's
    checkpoint of a reference checkpoint with the blocks' conv biases:
    every tensor it names lands in the detector bit-equal, the head keeps
    its initial weights, and a name the module lacks raises."""
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.tools import convert_checkpoint
    from partner_tpu_torch.tools.train import load_parameters
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    m, tc = _tiny_sparse("centerpoint")
    sd, _ = _centerpoint_reference(m, 10, "okzyxi", True)
    pth = _write_pth(tmp_path / "in.pth", sd)
    path = convert_checkpoint.main([pth, str(tmp_path / "out"),
                                    "--layer_nums", "1", "1"])
    payload, _ = load_checkpoint(os.path.join(tmp_path / "out", "latest"))
    assert payload["step"] == 0 and path.endswith("ckpt_00000000")
    det = build_detector(m, None, tc, device="cpu")
    head = {k: v.clone() for k, v in det.module.state_dict().items()
            if k.startswith("bbox_head.")}
    load_parameters(det, payload)
    now = det.module.state_dict()
    names = payload["state_dict"]
    assert len(names) == len([k for k in now
                              if k.split(".")[0] in ("backbone", "neck")])
    for k, v in names.items():
        assert torch.equal(now[k], v), k
    for k, v in head.items():
        assert torch.equal(now[k], v), k
    with pytest.raises(KeyError, match="no tensors"):
        load_parameters(det, {"state_dict": dict(names, extra=torch.ones(1))})
