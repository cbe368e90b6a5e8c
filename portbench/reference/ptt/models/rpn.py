"""RPN 2D BEV neck, NHWC (counterpart of ``partner_tpu/models/rpn.py``).

Per scale: a 3x3 conv with stride s (explicit padding 1) + BN + ReLU, then
``layer_num`` 3x3 conv units, then an upsampling deblock (a transpose conv
for stride > 1, a 1x1 conv for stride 1) whose outputs are concatenated.
Submodules carry flax's creation-order names (``Conv_k``, ``BatchNorm_k``,
``ConvTranspose_k``) so converted weights load by name.

On the mesh's azimuth axis (``parallel.halo.AzimuthShard``) the neck runs
on a rank's contiguous run of azimuth rows: each 3x3 conv takes one row
from each neighbour (``parallel.halo.edge_halo``; zeros past the sweep's
two ends, the unsharded conv's zero padding), a stride-2 conv the previous
row alone, and a deblock (a transpose conv whose kernel is its stride, or
a 1x1 conv) none.
"""

import torch
import torch.nn as nn

from ..utils.dtypes import resolve_compute_dtype
from .layers import BN_EPS, BN_MOMENTUM, BatchNorm, Conv2d, ConvTranspose2d
from .registry import NECKS


@NECKS.register_module(name="RPN")
class RPN(nn.Module):
    def __init__(self, layer_nums=(5, 5), ds_layer_strides=(1, 2),
                 ds_num_filters=(128, 256), us_layer_strides=(1, 2),
                 us_num_filters=(256, 256), num_input_features=256,
                 compute_dtype="float32"):
        super().__init__()
        dt = self.dtype = resolve_compute_dtype(compute_dtype)
        self.upsample_start = len(layer_nums) - len(us_layer_strides)
        n = {"Conv": 0, "BatchNorm": 0, "ConvTranspose": 0}

        def add(kind, mod):
            name = f"{kind}_{n[kind]}"
            n[kind] += 1
            self.add_module(name, mod)
            return name

        # per scale: ([(conv, bn) names, ...], (deblock, bn) names or None)
        self.stages = []
        cin = num_input_features
        for i, n_layers in enumerate(layer_nums):
            f = ds_num_filters[i]
            units = []
            for li in range(n_layers + 1):
                stride = ds_layer_strides[i] if li == 0 else 1
                units.append((add("Conv", Conv2d(cin, f, 3, stride, 1,
                                                 use_bias=False, dtype=dt)),
                              add("BatchNorm", BatchNorm(f, BN_EPS, BN_MOMENTUM))))
                cin = f
            up = None
            j = i - self.upsample_start
            if j >= 0:
                s, uf = us_layer_strides[j], us_num_filters[j]
                if s > 1:
                    deb = add("ConvTranspose", ConvTranspose2d(f, uf, s, dt))
                else:
                    k = int(round(1 / s))
                    deb = add("Conv", Conv2d(f, uf, k, k, "SAME",
                                             use_bias=False, dtype=dt))
                up = (deb, add("BatchNorm", BatchNorm(uf, BN_EPS, BN_MOMENTUM)))
            self.stages.append((units, up))

    def forward(self, x):
        """x (B, H, W, C) -> (B, H', W', sum(us_num_filters)) float32."""
        dt = self.dtype
        x = x.to(dt)
        ups = []
        for units, up in self.stages:
            for conv, bn in units:
                y = getattr(self, conv)(x)
                x = torch.relu(getattr(self, bn)(y)).to(dt)
            if up is not None:
                deb, bn = up
                ups.append(torch.relu(getattr(self, bn)(getattr(self, deb)(x))))
        if ups:
            x = torch.cat(ups, dim=-1)
        return x.float()
