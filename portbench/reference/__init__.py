"""The plain reference: a frozen float32 copy of the port's plain path
(``ptt/``), built from a cell's configuration file, and its lower
precision (the control that the comparison has to fail).

Nothing here imports ``partner_tpu_torch``, ``partner_tpu`` or JAX."""

import contextlib
import copy

import torch

from .ptt.models import build_detector
from .ptt.models.layers import Conv2d, Conv3d, ConvTranspose2d, Dense
from .ptt.models.sparse import SparseConv

CONVS = (Conv2d, Conv3d, ConvTranspose2d)      # cuDNN's convolutions
PRODUCTS = (Dense, SparseConv)                 # matrix products
FP8_MAX = 448.0      # float8_e4m3fn's largest finite value


def _compute_dtype_keys(model):
    """(dict, key) of every compute-dtype setting of a model config."""
    head = model["bbox_head"]
    yield model["neck"], "compute_dtype"
    yield model["neck"], "set_compute_dtype"
    if "HEAD_CONFIG" in head:
        yield head["HEAD_CONFIG"], "compute_dtype"


def build(cfg, device, dtype="float32"):
    """The reference detector of configuration ``cfg`` (a configuration
    file's dict) on ``device``, in eval mode, with every compute dtype set
    to ``dtype`` (None: as the configuration states). Built on the meta
    device: it holds no values until a state is loaded."""
    model = copy.deepcopy(cfg["model"])
    if dtype is not None:
        for d, k in _compute_dtype_keys(model):
            d[k] = dtype
    det = build_detector(model, copy.deepcopy(cfg["train_cfg"]),
                         copy.deepcopy(cfg["test_cfg"]), device="meta")
    if torch.device(device).type != "meta":
        det.module.to_empty(device=device)
    det.module.eval()
    return det


@contextlib.contextmanager
def exact_float32():
    """float32 products as float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x):
    """``x`` through float8 e4m3 with a per-tensor scale (amax to the
    format's largest value), back in its own dtype."""
    amax = x.detach().abs().amax().float()
    s = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((x.float() * s).to(torch.float8_e4m3fn).float() / s).to(x.dtype)


def bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def tf32(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest (what
    the tensor cores read of a float32 operand with TF32 on)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)


def _control_rounding(m, stated):
    """How the control rounds layer ``m``'s kernel and input, one step
    below ``stated``: bfloat16 -> float8 e4m3; float32 -> TF32 for a
    matrix product (float32 with TF32 off, PyTorch's default for
    matmuls) and bfloat16 for a convolution (which cuDNN already runs in
    TF32 by PyTorch's default)."""
    if stated in (torch.bfloat16, torch.float16):
        return fp8
    return tf32 if isinstance(m, PRODUCTS) else bf16


def lower_precision(det):
    """Turns a reference built with the configuration's own dtypes
    (``build(cfg, device, dtype=None)``) with its state loaded into the
    control: each conv, dense layer and sparse conv one step below the
    precision the configuration states for it (:func:`_control_rounding`),
    its kernel rounded once and its input at every call, the arithmetic in
    float32. Every other compute dtype is set to float32. The sparse
    backbone states none: it runs in float32."""
    for m in det.module.modules():
        if not isinstance(m, CONVS + PRODUCTS):
            stated = getattr(m, "dtype", None)
            if isinstance(stated, torch.dtype):
                m.dtype = torch.float32
            continue
        stated = getattr(m, "dtype", torch.float32)
        q = _control_rounding(m, stated)
        if isinstance(m, CONVS + (Dense,)):
            m.dtype = torch.float32
        weight = m.kernel if isinstance(m, SparseConv) else m.weight
        with torch.no_grad():
            weight.copy_(q(weight))
        m.register_forward_pre_hook(
            lambda mod, args, q=q: (q(args[0]),) + tuple(args[1:]))
    return det


def voxel_example(cfg, device, batch=1):
    """An all-padding voxel input of configuration ``cfg`` at its serving
    capacity, on ``device`` (the meta device for a count)."""
    vg = cfg["model"]["bbox_head"]["voxel_generator"]
    c = cfg["model"]["backbone"]["num_input_features"]
    n = serving_capacity(vg)
    return {"features": torch.zeros((batch, n, c), device=device),
            "coords": torch.zeros((batch, n, 3), dtype=torch.int32,
                                  device=device),
            "voxel_mask": torch.zeros((batch, n), dtype=torch.bool,
                                      device=device)}


def serving_capacity(voxel_generator):
    """The voxels a served sweep keeps: ``max_voxel_num``, or its second
    (test) entry where it gives train and test apart."""
    mv = voxel_generator["max_voxel_num"]
    return mv if isinstance(mv, int) else mv[1]


def frame_flops_dense(cfg):
    """FLOPs of one frame of configuration ``cfg`` at batch 1 after the
    sparse backbone (the SetBlock, neck and head, whose shapes no frame
    changes): the reference's forward counted on the meta device, less
    the backbone's part. Decode and NMS hold no product that the count
    sees."""
    from .. import yardstick

    det = build(cfg, "meta")
    with torch.no_grad():
        counts = yardstick.count_flops(det.module,
                                       voxel_example(cfg, "meta"))
    return counts["Global"] - counts.get("VoxelNetModule.backbone", 0)
