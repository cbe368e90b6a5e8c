"""Streaming RPN necks, NHWC (counterpart of
``partner_tpu/models/rpn_stream.py``).

A sweep is cut into azimuth sectors that arrive one after another, or a
sweep follows the previous one. The necks carry context between calls
(axis 1 of the (B, az, r, C) map is the azimuth):

- :class:`ConvContextTE` (``RPNTECP``, trailing edge): sector 0 pads one
  zero row at both azimuth ends; a later sector puts the previous sector's
  last row in front and one zero row after. It returns its input's last
  row as the context of the next sector.
- :class:`ConvBDCPSeq` (``RPNBDCP``, bidirectional): the previous
  sector's last row in front (zeros at sector 0), and after the sector
  the leading-edge row of the previous sweep's map where one is given
  (zeros otherwise). It returns its whole input as the next context.
- ``RPNHalo``: a whole sweep, each conv's azimuth axis padded circularly;
  with ``axis_name``, a rank's azimuth shard padded by its neighbours'
  rows (``parallel.halo.ring_halo``, the JAX neck's ring halo).
- ``RPNUber`` (STROBE): each scale's input concatenated with the previous
  sweep's input of that scale (zeros without one); it returns this
  sweep's per-scale inputs as the next context.
- ``RPNWaymoLSTM``, also registered as ``RPNWaymo`` (HAN): a
  :class:`ConvLSTMCell` memory over the canvas, its hidden map
  concatenated to the canvas; it returns the new ``(h, c)`` state.

``RPNTECP`` / ``RPNBDCP`` / ``RPNHalo`` zero-pad the range axis on both
sides and run each conv VALID. ``RPNUber`` and ``RPNWaymoLSTM`` pass
``padding=1`` to their convs as JAX does: 1 on both sides of both axes,
also at stride 2, where flax's "SAME" would pad (0, 1). Contexts are
plain lists or tuples threaded by the caller. Submodules keep flax's
names (a context conv's ``block{i}_conv{li}`` holding ``Conv_0`` and
``BatchNorm_0``; a plain conv's ``block{i}_conv{li}`` and
``block{i}_bn{li}``; ``deblock{j}_conv``, ``deblock{j}_bn``;
``memory.gates``), so ``convert.flax_to_torch`` maps them. No TPU kernel
lies here: the JAX package wrote these necks in plain XLA, the port in
plain torch.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.halo import ring_halo
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
    per scale ``layer_nums[i] + 1`` 3x3 convs, the first at
    ``ds_layer_strides[i]``; the last ``len(us_layer_strides)`` scales each
    end in a deblock: a transposed conv (kernel = stride) above stride 1,
    else a conv of kernel and stride ``round(1 / stride)`` (1x1 at stride
    1, 2x2 stride 2 at 0.5), + BatchNorm + ReLU.

    A context neck names its conv class ``unit`` (``block{i}_conv{li}``);
    without one each conv is a plain ``Conv2d`` (no bias, padding
    ``conv_padding``) named ``block{i}_conv{li}`` beside its
    ``block{i}_bn{li}``. :meth:`_in_width` gives a scale's input width
    from the width that reaches it."""

    unit = None          # the context conv class, or None: plain convs
    conv_padding = 1     # a plain conv's padding on every side

    def __init__(self, layer_nums=(2, 2), ds_layer_strides=(1, 2),
                 ds_num_filters=(64, 128), us_layer_strides=(1, 2),
                 us_num_filters=(64, 64), num_input_features=64,
                 nsectors=1):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.ds_layer_strides = tuple(ds_layer_strides)
        self.us_layer_strides = tuple(us_layer_strides)
        self.num_input_features = num_input_features
        self.nsectors = nsectors
        self.upsample_start = len(layer_nums) - len(us_layer_strides)
        self._init_extra()
        cin = num_input_features
        for i, n_layers in enumerate(self.layer_nums):
            f = ds_num_filters[i]
            cin = self._in_width(i, cin)
            for li in range(n_layers + 1):
                stride = ds_layer_strides[i] if li == 0 else 1
                if self.unit is not None:
                    self.add_module(f"block{i}_conv{li}",
                                    self.unit(cin, f, stride))
                else:
                    self.add_module(f"block{i}_conv{li}", Conv2d(
                        cin, f, 3, stride, self.conv_padding,
                        use_bias=False))
                    self.add_module(f"block{i}_bn{li}",
                                    BatchNorm(f, BN_EPS, BN_MOMENTUM))
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

    def _init_extra(self):
        """Submodules built before the blocks (none here)."""

    def _in_width(self, i, cin):
        """Scale i's input width from the ``cin`` that reaches it."""
        return cin

    def _deblock(self, x, j):
        u = getattr(self, f"deblock{j}_conv")(x)
        return torch.relu(getattr(self, f"deblock{j}_bn")(u))

    def _plain(self, i, li, x):
        """Plain conv ``block{i}_conv{li}`` + its BatchNorm + ReLU."""
        y = getattr(self, f"block{i}_conv{li}")(x)
        return torch.relu(getattr(self, f"block{i}_bn{li}")(y))

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

    def _run_plain(self, x, scale_input=None, pad=None):
        """The blocks of plain convs over x -> (the deblocks' outputs
        concatenated, each scale's input before ``scale_input``).
        ``scale_input(i, x)`` rewrites scale i's input (``RPNUber``'s
        concat), ``pad(x)`` each conv's input (``RPNHalo``'s halo)."""
        ups, inputs = [], []
        for i, n_layers in enumerate(self.layer_nums):
            inputs.append(x)
            if scale_input is not None:
                x = scale_input(i, x)
            for li in range(n_layers + 1):
                x = self._plain(i, li, x if pad is None else pad(x))
            j = i - self.upsample_start
            if j >= 0:
                ups.append(self._deblock(x, j))
        return (torch.cat(ups, dim=-1) if ups else x), inputs


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


@NECKS.register_module(name="RPNHalo")
class RPNHalo(_StreamRPNBase):
    """A whole sweep's RPN with cyclic azimuth halos
    (``rpn_stream.py:173-207``): each conv's input gets the previous
    azimuth row in front and the next after, then a zero column at both
    range ends, and the conv runs VALID. With ``axis_name`` None the
    sweep is whole and the halo is circular padding. With an
    ``axis_name``, the rank holds one shard of the azimuth rows and the
    rows come from its neighbours through ``parallel.halo.ring_halo`` over
    the process group registered under that name (as JAX's form runs under
    ``shard_map``); the BatchNorm statistics are the shard's own there, as
    in JAX."""

    conv_padding = 0

    def __init__(self, *args, axis_name=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.axis_name = axis_name

    def forward(self, x):
        """x (B, az, r, C) a whole sweep, or this rank's azimuth shard ->
        (B, az', r', sum(us_num_filters))."""
        def halo(x):
            return F.pad(ring_halo(x, 1, self.axis_name), (0, 0, 1, 1))

        return self._run_plain(x, pad=halo)[0]


@NECKS.register_module(name="RPNUber")
class RPNUber(_StreamRPNBase):
    """STROBE's previous-sweep concat neck (``rpn_stream.py:210-237``):
    scale i's input is concatenated (after it, on the channels) with
    ``prev_sweep[i]``, zeros without a previous sweep; the convs pad 1 on
    every side."""

    def _in_width(self, i, cin):
        return 2 * cin

    def forward(self, x, prev_sweep=None):
        """x (B, az, r, C), prev_sweep the previous sweep's contexts or
        None -> ((B, az', r', sum(us_num_filters)), this sweep's contexts:
        each scale's input before the concat; scale i > 0's is scale i -
        1's last conv output, not a deblocked map)."""
        def concat(i, x):
            prev = (prev_sweep[i] if prev_sweep is not None
                    else torch.zeros_like(x))
            return torch.cat([x, prev], dim=-1)

        return self._run_plain(x, scale_input=concat)


class ConvLSTMCell(nn.Module):
    """A convolutional LSTM over BEV maps (``rpn_stream.py:240-261``): one
    k x k conv ``gates`` (bias, "SAME") of [x, h] to 4F channels split
    (i, f, g, o); c' = sigmoid(f + 1) c + sigmoid(i) tanh(g), h' =
    sigmoid(o) tanh(c'). A missing state is zeros."""

    def __init__(self, in_features, features, kernel=3):
        super().__init__()
        self.features = features
        self.gates = Conv2d(in_features + features, 4 * features, kernel, 1,
                            "SAME")

    def forward(self, x, state):
        """x (B, H, W, C), state (h, c) each (B, H, W, F) or None -> (h',
        (h', c'))."""
        if state is None:
            h = x.new_zeros(x.shape[:-1] + (self.features,))
            c = torch.zeros_like(h)
        else:
            h, c = state
        i, f, g, o = torch.chunk(self.gates(torch.cat([x, h], dim=-1)), 4,
                                 dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


@NECKS.register_module(name="RPNWaymo")
@NECKS.register_module(name="RPNWaymoLSTM")
class RPNWaymoLSTM(_StreamRPNBase):
    """HAN's memory neck (``rpn_stream.py:264-292``): a ``memory``
    ConvLSTM of ``num_input_features`` on the canvas, its hidden map
    concatenated after the canvas, then plain convs padding 1 on every
    side."""

    def _init_extra(self):
        self.memory = ConvLSTMCell(self.num_input_features,
                                   self.num_input_features)

    def _in_width(self, i, cin):
        return 2 * cin if i == 0 else cin

    def forward(self, x, prev_state=None):
        """x (B, az, r, C), prev_state the previous call's (h, c) or None
        -> ((B, az', r', sum(us_num_filters)), the new (h, c))."""
        h, state = self.memory(x, prev_state)
        return self._run_plain(torch.cat([x, h], dim=-1))[0], state
