"""PolarDenseFHD point path (counterpart of ``partner_tpu/models/backbone_dense.py``).

Only what the flagship inference frame runs is ported: ``encode_points``
(decoration -> channel-major 2-layer stem -> one scatter-max into a
z-folded canvas) and the ``trunk2d`` conv trunk that turns the canvas into
the stride-8 BEV map. The 3D-conv trunk, the voxel input path and training
(BatchNorm batch statistics, the scatter-max backward) are not ported yet.

At inference the stem always runs through :func:`ops.stem.stem2_channel_major`:
the CUDA kernel for CUDA tensors, its plain twin for CPU tensors.
"""

import numpy as np
import torch
import torch.nn as nn

from ..ops import stem
from ..utils.dtypes import resolve_compute_dtype
from .layers import BN_EPS, BatchNorm, Conv2d, _lecun_normal_, constant
from .registry import BACKBONES


class Dense2DBlock(nn.Module):
    """2D 3x3 conv ("SAME") + BN + ReLU (trunk2d stage convs)."""

    def __init__(self, in_features, features, stride=1, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(in_features, features, 3, stride, "SAME",
                             use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x))).to(self.dtype)


class Dense2DResBlock(nn.Module):
    """Two 2D 3x3 convs with residual."""

    def __init__(self, features, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(features, features, 3, 1, "SAME", use_bias=False,
                            dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS)
        self.conv2 = Conv2d(features, features, 3, 1, "SAME", use_bias=False,
                            dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features, BN_EPS)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.conv1(x))).to(self.dtype)
        y = self.BatchNorm_1(self.conv2(y))
        return torch.relu(y.to(self.dtype) + x)


def scatter_canvas_fold2d(feats, coords, mask, canvas_shape, dtype):
    """Scatter-max point features into a z-folded dense canvas.

    Args:
      feats: (B, N, C) features, non-negative (post-ReLU stem outputs): the
        canvas starts at zero, so empty cells read 0.
      coords: (B, N, 3) integer (z, az, r) canvas coords.
      mask: (B, N) bool.
      canvas_shape: (cz, cy, cx).
    Returns (B, cy, cx, cz * C), channel order [z0c0..z0c(C-1), z1c0, ...]:
    the z-minor linear index makes the fold a free reshape. Masked rows go
    to a dump row past the canvas.
    """
    cz, cy, cx = canvas_shape
    cells = cz * cy * cx
    b, _, c = feats.shape
    lin = (coords[..., 1] * cx + coords[..., 2]) * cz + coords[..., 0]
    lin = torch.where(mask, lin, torch.full_like(lin, cells)).long()
    base = torch.zeros((b, cells + 1, c), dtype=dtype, device=feats.device)
    base.scatter_reduce_(1, lin[..., None].expand(-1, -1, c), feats.to(dtype),
                         "amax", include_self=True)
    return base[:, :cells].reshape(b, cy, cx, cz * c)


@BACKBONES.register_module(name="PolarDenseFHD")
class PolarDenseFHD(nn.Module):
    """Dense middle extractor, point path with ``trunk2d=True``.

    Raw parameters keep the flax names and layouts (``stem{i}_kernel`` is
    (C_in, F), ``stem{i}_scale/bias`` and the ``stem{i}_mean/var`` buffers
    are (F,)), so one set serves the channel-major stem."""

    def __init__(self, num_input_features=7, ds_factor=8, bev_pool=4,
                 z_pool=8, stem_features=(32, 64), stage_a_blocks=1,
                 stage_b_blocks=2, compute_dtype="bfloat16", trunk2d=False,
                 a2d_features=160, out_features=256, input_shape=None,
                 **kwargs):
        """``input_shape`` is the (n_r, n_az, n_z) grid: the first trunk
        conv's width, cz * F2, depends on it."""
        super().__init__()
        if not trunk2d:
            raise ValueError("only the trunk2d PolarDenseFHD is ported")
        if len(stem_features) != 2:
            raise ValueError("the fused stem takes exactly two layers")
        self.num_input_features = num_input_features
        self.bev_pool = bev_pool
        self.z_pool = z_pool
        self.stem_features = tuple(stem_features)
        self.dtype = resolve_compute_dtype(compute_dtype)
        dims = [num_input_features + 3] + list(stem_features)
        for i, f in enumerate(stem_features):
            setattr(self, f"stem{i}_kernel",
                    nn.Parameter(torch.empty(dims[i], f)))
            setattr(self, f"stem{i}_scale", nn.Parameter(torch.empty(f)))
            setattr(self, f"stem{i}_bias", nn.Parameter(torch.empty(f)))
            self.register_buffer(f"stem{i}_mean", torch.empty(f))
            self.register_buffer(f"stem{i}_var", torch.empty(f))
        self.out_features = out_features
        self.stage_a_blocks = stage_a_blocks
        self.stage_b_blocks = stage_b_blocks
        dt = self.dtype
        cin = self.canvas_shape(input_shape)[0] * self.stem_features[-1]
        self.conv_a2d = Dense2DBlock(cin, a2d_features, dtype=dt)
        for i in range(stage_a_blocks):
            setattr(self, f"block_a2d{i}",
                    Dense2DResBlock(a2d_features, dtype=dt))
        self.conv_b2d = Dense2DBlock(a2d_features, out_features, stride=2,
                                     dtype=dt)
        for i in range(stage_b_blocks):
            setattr(self, f"block_b2d{i}",
                    Dense2DResBlock(out_features, dtype=dt))

    def init_extra(self, generator):
        for i in range(len(self.stem_features)):
            k = getattr(self, f"stem{i}_kernel")
            _lecun_normal_(k, k.shape[0], generator)
            getattr(self, f"stem{i}_scale").data.fill_(1.0)
            getattr(self, f"stem{i}_bias").data.fill_(0.0)
            getattr(self, f"stem{i}_mean").fill_(0.0)
            getattr(self, f"stem{i}_var").fill_(1.0)

    def canvas_shape(self, input_shape):
        n_r, n_az, n_z = (int(s) for s in input_shape)
        if n_z % self.z_pool or n_az % self.bev_pool or n_r % self.bev_pool:
            raise ValueError(f"grid {input_shape} not divisible by pools "
                             f"({self.z_pool},{self.bev_pool})")
        return (n_z // self.z_pool, n_az // self.bev_pool,
                n_r // self.bev_pool)

    def _stem_t(self, x, mask):
        """Channel-major stem: x (B, C, P), mask (B, P) -> (B, F, P)."""
        dt = self.dtype
        ab = []
        for i in range(2):
            a = getattr(self, f"stem{i}_scale") * torch.rsqrt(
                getattr(self, f"stem{i}_var") + BN_EPS)
            ab.append((a.contiguous(), (getattr(self, f"stem{i}_bias")
                        - getattr(self, f"stem{i}_mean") * a).contiguous()))
        return stem.stem2_channel_major(
            x.to(dt).contiguous(), mask.contiguous(),
            self.stem0_kernel.t().to(dt).contiguous(), ab[0][0], ab[0][1],
            self.stem1_kernel.t().to(dt).contiguous(), ab[1][0], ab[1][1])

    def _trunk(self, canvas):
        a = self.conv_a2d(canvas)
        for i in range(self.stage_a_blocks):
            a = getattr(self, f"block_a2d{i}")(a)
        b = self.conv_b2d(a)
        for i in range(self.stage_b_blocks):
            b = getattr(self, f"block_b2d{i}")(b)
        return b.float()

    def encode_points(self, points, mask, input_shape, pc_range):
        """Point input -> BEV map (B, n_az/8, n_r/8, out_features) f32.

        points are cylinder layout (B, P, C) [rho, phi, z, ...]."""
        n_r, n_az, n_z = (int(s) for s in input_shape)
        cz, cy, cx = self.canvas_shape(input_shape)
        dev = points.device
        pr = constant(self, "pc_min", dev,
                      lambda: np.asarray(pc_range[:3], np.float32))
        cell = constant(self, "cell", dev, lambda: np.asarray([
            (pc_range[3] - pc_range[0]) / n_r * self.bev_pool,
            (pc_range[4] - pc_range[1]) / n_az * self.bev_pool,
            (pc_range[5] - pc_range[2]) / n_z * self.z_pool,
        ], np.float32))
        pts_t = points.transpose(1, 2)[:, : self.num_input_features].float()
        g = (pts_t[:, :3] - pr[None, :, None]) / cell[None, :, None]
        idx_t = torch.floor(g).to(torch.int32)
        frac_t = g - idx_t - 0.5
        lim = constant(self, "canvas_lim", dev,
                       lambda: np.asarray([cx, cy, cz], np.int32))
        inb = mask & torch.all((idx_t >= 0) & (idx_t < lim[None, :, None]),
                               dim=1)
        x_t = torch.cat([pts_t, frac_t], dim=1).to(self.dtype)
        x = self._stem_t(x_t, inb).transpose(1, 2)
        coords = torch.stack([idx_t[:, 2], idx_t[:, 1], idx_t[:, 0]], -1)
        canvas = scatter_canvas_fold2d(x, coords, inb, (cz, cy, cx),
                                       self.dtype)
        return self._trunk(canvas)
