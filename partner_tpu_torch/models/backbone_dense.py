"""PolarDenseFHD (counterpart of ``partner_tpu/models/backbone_dense.py``).

Two inputs, one stem and one scatter-max each: the point path
``encode_points`` (decoration by sub-cell offsets -> channel-major 2-layer
stem -> one scatter-max into a z-folded canvas) and the voxel path
``forward`` (full-resolution voxel features decorated by each voxel's
place in its pooled cell -> the same stem over the voxel rows -> the
scatter-max of the pooled coords). Then either trunk turns the canvas
into the stride-8 BEV map: the 2D ``trunk2d`` trunk of the PARTNER
configs, or the 3D-conv trunk of the CenterPoint configs (the canvas
unfolded to (B, cz, cy, cx, C); 3x3x3 stages at 1/4 and 1/8 resolution,
then the z-squeeze ``extra_conv`` and the channel fold). The 3D trunk's
``factorized`` option (no config sets it) is not ported.

In eval mode the stem runs through :func:`ops.stem.stem2_channel_major`
(the CUDA kernel for CUDA tensors, its plain twin for CPU tensors). In
train mode it runs the JAX package's train branch in plain torch, with
BatchNorm batch statistics, as JAX never calls its stem kernel in
training. The scatter-max reads the stem's channel-major output as it is,
through :class:`ops.scatter_max.ScatterMaxFold2d` (the kernel forward of
:func:`ops.scatter_max.scatter_max_fold2d`, the JAX tie-rule backward).
"""

import numpy as np
import torch
import torch.nn as nn

from ..ops import scatter_max, stem
from ..utils.dtypes import resolve_compute_dtype
from .layers import (BN_EPS, BN_MOMENTUM, BatchNorm, Conv2d, Conv3d,
                     _lecun_normal_, constant, update_running)
from .registry import BACKBONES


class Dense2DBlock(nn.Module):
    """2D 3x3 conv ("SAME") + BN + ReLU (trunk2d stage convs)."""

    def __init__(self, in_features, features, stride=1, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(in_features, features, 3, stride, "SAME",
                             use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x))).to(self.dtype)


class Dense2DResBlock(nn.Module):
    """Two 2D 3x3 convs with residual."""

    def __init__(self, features, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(features, features, 3, 1, "SAME", use_bias=False,
                            dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)
        self.conv2 = Conv2d(features, features, 3, 1, "SAME", use_bias=False,
                            dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.conv1(x))).to(self.dtype)
        y = self.BatchNorm_1(self.conv2(y))
        return torch.relu(y.to(self.dtype) + x)


class DenseConvBlock(nn.Module):
    """3D conv (no bias) + BN + ReLU (the 3D trunk's stage convs)."""

    def __init__(self, in_features, features, kernel=(3, 3, 3),
                 stride=(1, 1, 1), padding="SAME", dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv3d(in_features, features, kernel, stride, padding,
                             dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x))).to(self.dtype)


class DenseBasicBlock(nn.Module):
    """Two 3x3x3 convs with residual."""

    def __init__(self, features, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv3d(features, features, (3, 3, 3), dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)
        self.conv2 = Conv3d(features, features, (3, 3, 3), dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.conv1(x))).to(self.dtype)
        y = self.BatchNorm_1(self.conv2(y))
        return torch.relu(y.to(self.dtype) + x)


@BACKBONES.register_module(name="PolarDenseFHD")
class PolarDenseFHD(nn.Module):
    """Dense middle extractor, point path, with the 2D trunk
    (``trunk2d=True``) or the 3D one.

    Raw parameters keep the flax names and layouts (``stem{i}_kernel`` is
    (C_in, F), ``stem{i}_scale/bias`` and the ``stem{i}_mean/var`` buffers
    are (F,)), so one set serves the channel-major stem."""

    def __init__(self, num_input_features=7, ds_factor=8, bev_pool=4,
                 z_pool=8, stem_features=(32, 64), stage_a_blocks=1,
                 stage_b_blocks=2, compute_dtype="bfloat16", trunk2d=False,
                 a2d_features=160, out_features=256, factorized=False,
                 input_shape=None, **kwargs):
        """``input_shape`` is the (n_r, n_az, n_z) grid: the first 2D trunk
        conv's width, cz * F2, and the 3D trunk's BEV width depend on
        it."""
        super().__init__()
        if factorized:
            raise NotImplementedError(
                "PolarDenseFHD(factorized=True) is not ported: no config "
                "of the repo sets it")
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
        self.trunk2d = trunk2d
        self.stage_a_blocks = stage_a_blocks
        self.stage_b_blocks = stage_b_blocks
        dt = self.dtype
        cz = self.canvas_shape(input_shape)[0]
        f = self.stem_features[-1]
        if trunk2d:
            self.out_features = out_features
            self.conv_a2d = Dense2DBlock(cz * f, a2d_features, dtype=dt)
            for i in range(stage_a_blocks):
                setattr(self, f"block_a2d{i}",
                        Dense2DResBlock(a2d_features, dtype=dt))
            self.conv_b2d = Dense2DBlock(a2d_features, out_features,
                                         stride=2, dtype=dt)
            for i in range(stage_b_blocks):
                setattr(self, f"block_b2d{i}",
                        Dense2DResBlock(out_features, dtype=dt))
            return
        # the z-squeeze leaves (cz - 3) // 2 + 1 planes of 2F channels
        self.out_features = 2 * f * ((cz - 3) // 2 + 1)
        self.conv_a = DenseConvBlock(f, f, dtype=dt)
        for i in range(stage_a_blocks):
            setattr(self, f"block_a{i}", DenseBasicBlock(f, dtype=dt))
        self.conv_b = DenseConvBlock(f, 2 * f, stride=(1, 2, 2), dtype=dt)
        for i in range(stage_b_blocks):
            setattr(self, f"block_b{i}", DenseBasicBlock(2 * f, dtype=dt))
        self.extra_conv = DenseConvBlock(2 * f, 2 * f, kernel=(3, 1, 1),
                                         stride=(2, 1, 1), padding="VALID",
                                         dtype=dt)

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
        if self.training:
            return self._stem_t_train(x, mask)
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

    def _stem_t_train(self, x, mask):
        """The train branch of the JAX ``_stem_t`` (``backbone_dense.py:
        379-399``): per layer a product with f32 accumulation, cast, x
        mask, BatchNorm with the statistics of all (B, P) positions (masked
        zeros included, biased variance, as ``jnp.var``), momentum 0.99 on
        ``stem{i}_mean/var``, ReLU, cast."""
        dt = self.dtype
        m = mask[:, None, :].to(dt)
        for i in range(len(self.stem_features)):
            w = getattr(self, f"stem{i}_kernel").to(dt)
            x = torch.einsum("bcp,cf->bfp", x.float(), w.float()).to(dt)
            xf = (x * m).float()
            mean = xf.mean((0, 2))
            var = ((xf - mean[:, None]) ** 2).mean((0, 2))
            update_running(getattr(self, f"stem{i}_mean"), mean, BN_MOMENTUM)
            update_running(getattr(self, f"stem{i}_var"), var, BN_MOMENTUM)
            y = (xf - mean[:, None]) * torch.rsqrt(var[:, None] + BN_EPS)
            y = (y * getattr(self, f"stem{i}_scale")[:, None]
                 + getattr(self, f"stem{i}_bias")[:, None])
            x = torch.relu(y).to(dt)
        # einsum may hand back a permuted layout; the scatter reads (B, F, P)
        return x.contiguous()

    def _trunk(self, canvas):
        """z-folded canvas (B, cy, cx, cz * C) -> BEV map, float32."""
        if self.trunk2d:
            a = self.conv_a2d(canvas)
            for i in range(self.stage_a_blocks):
                a = getattr(self, f"block_a2d{i}")(a)
            b = self.conv_b2d(a)
            for i in range(self.stage_b_blocks):
                b = getattr(self, f"block_b2d{i}")(b)
            return b.float()
        bb, cy, cx, czc = canvas.shape
        c = self.stem_features[-1]
        # unfold z: the JAX package's (B, cz, cy, cx, C) canvas
        x = canvas.reshape(bb, cy, cx, czc // c, c).permute(0, 3, 1, 2, 4)
        a = self.conv_a(x)
        for i in range(self.stage_a_blocks):
            a = getattr(self, f"block_a{i}")(a)
        b = self.conv_b(a)
        for i in range(self.stage_b_blocks):
            b = getattr(self, f"block_b{i}")(b)
        e = self.extra_conv(b)
        # channel fold (B, nz', ny, nx, C) -> (B, ny, nx, C * nz'), C outer
        bb, nz2, ny, nx, cc = e.shape
        return e.permute(0, 2, 3, 4, 1).reshape(bb, ny, nx, cc * nz2).float()

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
        feats_t = self._stem_t(x_t, inb)                     # (B, F2, P)
        canvas = scatter_max.ScatterMaxFold2d.apply(
            feats_t, idx_t.flip(1).contiguous(), inb.contiguous(),
            (cz, cy, cx))
        return self._trunk(canvas)

    def forward(self, voxel_features, coords, mask, input_shape):
        """Voxel input -> BEV map (B, n_az/8, n_r/8, out_features) f32
        (JAX ``PolarDenseFHD.__call__``).

        Args:
          voxel_features: (B, N, C) per-voxel features (the reader's
            output), C = ``num_input_features``.
          coords: (B, N, 3) int32 full-resolution (z, azimuth, range).
          mask: (B, N) bool.
          input_shape: the (n_r, n_az, n_z) grid."""
        cz, cy, cx = self.canvas_shape(input_shape)
        pools = constant(self, "pools", coords.device, lambda: np.asarray(
            [self.z_pool, self.bev_pool, self.bev_pool], np.int32))
        # each voxel's place in its pooled cell, in (z, az, r) order
        frac = (torch.remainder(coords.float(), pools.float())
                / pools.float() - 0.5)
        x_t = torch.cat([voxel_features.float(), frac], dim=-1).to(
            self.dtype).transpose(1, 2).contiguous()          # (B, C_in, N)
        feats_t = self._stem_t(x_t, mask.contiguous())        # (B, F2, N)
        pooled_t = (coords // pools).to(torch.int32).transpose(1, 2)
        canvas = scatter_max.ScatterMaxFold2d.apply(
            feats_t, pooled_t.contiguous(), mask.contiguous(), (cz, cy, cx))
        return self._trunk(canvas)
