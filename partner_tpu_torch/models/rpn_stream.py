"""Streaming RPN necks with sector context padding, NHWC (counterpart of
``RPNTECP`` and ``RPNBDCP`` in ``partner_tpu/models/rpn_stream.py``).

A sweep is cut into azimuth sectors that arrive one after another. Each
3x3 conv of the neck pads its input's azimuth axis (axis 1 of the
(B, az, r, C) map) with context instead of zeros where it has some:

- :class:`ConvContextTE` (``RPNTECP``, trailing edge): sector 0 pads one
  zero row at both azimuth ends; a later sector puts the previous sector's
  last row in front and one zero row after. It returns its input's last
  row as the context of the next sector.
- :class:`ConvBDCPSeq` (``RPNBDCP``, bidirectional): the previous
  sector's last row in front (zeros at sector 0), and after the sector
  the leading-edge row of the previous sweep's map where one is given
  (zeros otherwise). It returns its whole input as the next context.

The range axis is zero-padded on both sides, then the conv runs VALID.
Contexts are plain lists, one entry per conv, threaded by the caller.
Submodules keep flax's names (``block{i}_conv{li}`` holding ``Conv_0`` and
``BatchNorm_0``; ``deblock{j}_conv``, ``deblock{j}_bn``), so
``convert.flax_to_torch`` maps them.

``RPNHalo``, ``RPNUber`` and ``RPNWaymo`` / ``RPNWaymoLSTM`` are not
ported; a config that names them raises (ROADMAP.md queue 1 item 7, and
items 9/11 for the halo's mesh form).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BN_EPS, BN_MOMENTUM, BatchNorm, Conv2d,
                     ConvTranspose2d)
from .registry import NECKS


class ConvContextTE(nn.Module):
    """3x3 conv (stride ``stride``, no bias) + BatchNorm + ReLU with
    trailing-edge azimuth padding (``rpn_stream.py:30-50``)."""

    def __init__(self, in_features, features, stride=1, padding=1):
        super().__init__()
        self.padding = padding
        self.Conv_0 = Conv2d(in_features, features, 3, stride, 0,
                             use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x, prev_ctx):
        """x (B, az, r, C), prev_ctx (B, p, r, C) or None -> (y, x's last
        ``padding`` azimuth rows)."""
        p = self.padding
        cur_ctx = x[:, -p:]
        if prev_ctx is None:
            xp = F.pad(x, (0, 0, p, p, p, p))
        else:
            xp = F.pad(torch.cat([prev_ctx, x], dim=1), (0, 0, p, p, 0, p))
        y = self.BatchNorm_0(self.Conv_0(xp))
        return torch.relu(y), cur_ctx


class ConvBDCPSeq(nn.Module):
    """3x3 conv + BatchNorm + ReLU with bidirectional azimuth padding
    (``rpn_stream.py:53-78``): the previous sector's last ``padding`` rows
    in front, ``next_rows`` (the previous sweep's leading edge) after."""

    def __init__(self, in_features, features, stride=1, padding=1):
        super().__init__()
        self.padding = padding
        self.Conv_0 = Conv2d(in_features, features, 3, stride, 0,
                             use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, BN_EPS, BN_MOMENTUM)

    def forward(self, x, prev_ctx, next_rows):
        """x (B, az, r, C); prev_ctx the previous sector's whole input
        (B, az', r, C) or None; next_rows (B, rows, r, C) or None -> (y,
        x)."""
        p = self.padding
        zeros = torch.zeros_like(x[:, :p])
        lead = prev_ctx[:, -p:] if prev_ctx is not None else zeros
        tail = next_rows if next_rows is not None else zeros
        xp = F.pad(torch.cat([lead, x, tail], dim=1), (0, 0, p, p))
        y = self.BatchNorm_0(self.Conv_0(xp))
        return torch.relu(y), x


class DeblockTranspose(ConvTranspose2d):
    """flax ``nn.ConvTranspose`` with kernel == stride, no bias, whose
    weight is kept as (O, I, kh, kw), the layout ``convert.flax_to_torch``
    gives a flax conv kernel: a stream neck names every deblock
    ``deblock{j}_conv``, a conv or a transposed one by its stride, so the
    converter cannot tell them apart by name. The forward turns it into
    torch's transposed layout, (I, O, kh, kw) flipped spatially."""

    def __init__(self, in_features, out_features, stride,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, stride, dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               stride, stride))

    def fan_in(self):
        w = self.weight
        return w.shape[1] * w.shape[2] * w.shape[3]

    def forward(self, x):
        dt = self.dtype
        w = self.weight.transpose(0, 1).flip(2, 3).to(dt)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), w, None,
                               self.stride)
        return y.permute(0, 2, 3, 1)


class _StreamRPNBase(nn.Module):
    """The blocks and deblocks of a stream neck (``rpn_stream.py:81-103``):
    per scale ``layer_nums[i] + 1`` context convs, the first at
    ``ds_layer_strides[i]``; the last ``len(us_layer_strides)`` scales each
    end in a deblock: a transposed conv (kernel = stride) above stride 1,
    else a conv of kernel and stride ``round(1 / stride)`` (1x1 at stride
    1, 2x2 stride 2 at 0.5), + BatchNorm + ReLU."""

    unit = None   # the context conv class

    def __init__(self, layer_nums=(2, 2), ds_layer_strides=(1, 2),
                 ds_num_filters=(64, 128), us_layer_strides=(1, 2),
                 us_num_filters=(64, 64), num_input_features=64,
                 nsectors=1):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.ds_layer_strides = tuple(ds_layer_strides)
        self.us_layer_strides = tuple(us_layer_strides)
        self.nsectors = nsectors
        self.upsample_start = len(layer_nums) - len(us_layer_strides)
        cin = num_input_features
        for i, n_layers in enumerate(self.layer_nums):
            f = ds_num_filters[i]
            for li in range(n_layers + 1):
                stride = ds_layer_strides[i] if li == 0 else 1
                self.add_module(f"block{i}_conv{li}",
                                self.unit(cin, f, stride))
                cin = f
            j = i - self.upsample_start
            if j >= 0:
                s, uf = us_layer_strides[j], us_num_filters[j]
                if s > 1:
                    deb = DeblockTranspose(f, uf, int(s))
                else:
                    k = int(round(1 / s))
                    deb = Conv2d(f, uf, k, k, "SAME", use_bias=False)
                self.add_module(f"deblock{j}_conv", deb)
                self.add_module(f"deblock{j}_bn",
                                BatchNorm(uf, BN_EPS, BN_MOMENTUM))

    def _deblock(self, x, j):
        u = getattr(self, f"deblock{j}_conv")(x)
        return torch.relu(getattr(self, f"deblock{j}_bn")(u))

    def _run(self, x, conv):
        """The blocks over x with ``conv(module, x, ctx_i) -> (y, ctx)``
        -> (the deblocks' outputs concatenated, the new contexts)."""
        ups, new_context = [], []
        ctx_i = 0
        for i, n_layers in enumerate(self.layer_nums):
            for li in range(n_layers + 1):
                x, ctx = conv(getattr(self, f"block{i}_conv{li}"), x, ctx_i)
                new_context.append(ctx)
                ctx_i += 1
            j = i - self.upsample_start
            if j >= 0:
                ups.append(self._deblock(x, j))
        return (torch.cat(ups, dim=-1) if ups else x), new_context


@NECKS.register_module(name="RPNTECP")
class RPNTECP(_StreamRPNBase):
    """Trailing-edge context-padding RPN (``rpn_stream.py:106-130``)."""

    unit = ConvContextTE

    def forward(self, x, prev_context=None):
        """x (B, az, r, C) one sector's canvas, prev_context the previous
        sector's contexts or None -> ((B, az', r', sum(us_num_filters)),
        this sector's contexts: each conv input's last row)."""
        return self._run(x, lambda m, x, i: m(
            x, None if prev_context is None else prev_context[i]))


@NECKS.register_module(name="RPNBDCP")
class RPNBDCP(_StreamRPNBase):
    """Bidirectional context-padding RPN (``rpn_stream.py:133-170``)."""

    unit = ConvBDCPSeq

    def forward(self, x, prev_context=None, prev_sweep=None, sec_id=0):
        """As :meth:`RPNTECP.forward`; the contexts are each conv's whole
        input. ``prev_sweep``: per conv the previous sweep's full-sweep
        map at that conv's input resolution; the next sector's first
        azimuth row of it (cyclic, from row ``(sec_id + 1) x`` this
        sector's rows) pads the leading edge. No caller passes it (the
        module's sector loop does not, as in JAX), so the leading edge
        pads zeros and the neck computes what ``RPNTECP`` computes on the
        same weights."""
        def conv(m, x, i):
            prev = None if prev_context is None else prev_context[i]
            nxt = None
            if prev_sweep is not None:
                full = prev_sweep[i]
                start = ((sec_id + 1) * x.shape[1]) % full.shape[1]
                nxt = torch.roll(full, -start, dims=1)[:, :1]
            return m(x, prev, nxt)

        return self._run(x, conv)


def _not_ported(name, item):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"neck {name} is not ported (ROADMAP.md queue 1 item {item})")
    return build


for _name, _item in (("RPNHalo", "7 (and items 9/11: the azimuth mesh)"),
                     ("RPNUber", "7: STROBE and HAN"),
                     ("RPNWaymo", "7: STROBE and HAN"),
                     ("RPNWaymoLSTM", "7: STROBE and HAN")):
    NECKS.register_module(_not_ported(_name, _item), name=_name)
