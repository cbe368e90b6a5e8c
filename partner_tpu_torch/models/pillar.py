"""The pillar encoder, the pillar scatter and the PointPillars detector
(counterpart of ``partner_tpu/models/pillar.py``).

- :class:`DynamicPFNet`: per-point decorated features (the raw point
  channels, offsets from the pillar's cluster means of xyz and / or
  (rho, phi[, z]), offsets from the pillar centre in cartesian and / or
  polar terms, the distance) through Dense (no bias) + ``MaskedBatchNorm``
  + ReLU layers, each followed by a max over the pillar's points;
  :class:`PillarFeatureNet` is its cuboid configuration.
- :func:`pp_scatter`: (B, V, F) pillar features -> the (B, n_az, n_r, F)
  canvas, NHWC.
- :class:`PointPillarsModule`: the points pillarized on their device by
  ``ops.voxelize.dynamic_voxelize`` on the (nx, ny, 1) grid, the PFN over
  the whole batch's pillars in one segment space, the scatter, then the
  ``RPN`` neck and the ``CenterHead``; with a ``seg_head`` (HAN's
  ``SingleConvHead``) a seg map over the canvas and the neck's map.
- ``build_point_pillars``, registered as ``PointPillars``: the module in a
  :class:`~.detectors.CenterPointDetector`.
- :func:`pillar_module_kwargs` and :func:`max_pillars_rule`: the config
  reading that every pillar module's factory shares.

JAX wrote this stack in plain XLA (``segment_sum``, ``segment_max``,
``.at[].set``; no Pallas kernel), and the port writes it in plain torch.
The segment sums add each pillar's rows in their stream order
(``segment_reduce`` over a stable sort, no atomic adds), and the pooled
max is ``scatter_reduce`` ``amax``, exact in any order, so a frame gives
the same canvas on every run. Its gradient splits among tied rows evenly,
as JAX's does. In training the gradient of the pooled rows gathered back
onto the points is summed by ``index_add`` (atomic on the card).
"""

import torch
import torch.nn as nn

from ..ops.voxelize import dynamic_voxelize
from .layers import Dense, MaskedBatchNorm, constant
from .registry import BBOX_HEADS, DETECTORS, NECKS, READERS, build_from_cfg
from .seg_head import build_seg_head, neck_out_features


def _segment_max(x, seg, num_segments):
    """Per-segment max of the rows of ``x`` (-inf where a segment has
    none)."""
    out = x.new_full((num_segments, x.shape[1]), float("-inf"))
    return out.scatter_reduce(0, seg[:, None].expand_as(x), x, "amax",
                              include_self=False)


@READERS.register_module(name="DynamicPFNet")
class DynamicPFNet(nn.Module):
    """Decorated pillar features, pooled per pillar
    (``partner_tpu/models/pillar.py:38-132``).

    Point layouts: ``cylinder`` [rho, phi, z, x, y, ...] or ``cuboid``
    [x, y, z, ..., rho, phi]. Submodules keep flax's names
    (``pfn{i}_dense``, ``pfn{i}_bn``)."""

    def __init__(self, num_input_features=4, num_filters=(64,),
                 voxel_shape="cylinder", xyz_cluster=True, raz_cluster=True,
                 xy_center=True, ra_center=True, with_distance=False,
                 voxel_size=(0.2, 0.2, 8), pc_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.num_input_features = num_input_features
        self.num_filters = tuple(num_filters)
        self.voxel_shape = voxel_shape
        self.xyz_cluster = xyz_cluster
        self.raz_cluster = raz_cluster
        self.xy_center = xy_center
        self.ra_center = ra_center
        self.with_distance = with_distance
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        cin = (num_input_features + 3 * xyz_cluster + 2 * xy_center
               + (2 if xyz_cluster else 3) * raz_cluster + 2 * ra_center
               + int(with_distance))
        for i, f in enumerate(self.num_filters):
            self.add_module(f"pfn{i}_dense", Dense(cin, f, use_bias=False))
            self.add_module(f"pfn{i}_bn", MaskedBatchNorm(f))
            cin = 2 * f

    def forward(self, points, points_mask, point_pillar, pillar_coords,
                num_pillars):
        """points (P, C) in the layout above, points_mask (P,) bool,
        point_pillar (P,) each row's pillar slot (``num_pillars`` or more
        for none), pillar_coords (V, 3) int (z, az, r) -> (V, F) pillar
        features, 0 for an empty slot. Train mode takes the BatchNorm
        statistics over the valid rows."""
        v = int(num_pillars)
        dt, dev = points.dtype, points.device
        valid = points_mask & (point_pillar < v)
        seg = torch.where(valid, point_pillar, v).long()
        if self.voxel_shape == "cuboid":
            xyz, ra = points[:, :3], points[:, -2:]
        else:
            xyz, ra = points[:, [3, 4, 2]], points[:, :2]

        # pillar centres (r = coords[:, 2], az = coords[:, 1]) + half a
        # cell, gathered through slot v, which holds 0
        vs, pr = self.voxel_size, self.pc_range
        zero = torch.zeros(1, dtype=dt, device=dev)
        c1p = torch.cat([pillar_coords[:, 2].to(dt) * vs[0] + vs[0] / 2
                         + pr[0], zero])[seg]
        c2p = torch.cat([pillar_coords[:, 1].to(dt) * vs[1] + vs[1] / 2
                         + pr[1], zero])[seg]

        # cluster means: each pillar's valid rows summed in stream order
        cols = []
        if self.xyz_cluster:
            cols.append(xyz)
        if self.raz_cluster:
            cols.append(ra if self.xyz_cluster
                        else torch.cat([ra, points[:, 2:3]], dim=1))
        if cols:
            vals = torch.where(valid[:, None], torch.cat(cols, dim=1), 0.0)
            order = torch.argsort(seg, stable=True)
            bounds = torch.searchsorted(seg[order],
                                        torch.arange(v + 2, device=dev))
            lengths = bounds[1:] - bounds[:-1]
            sums = torch.segment_reduce(vals[order], "sum", lengths=lengths,
                                        unsafe=True)
            offsets = vals - (sums / torch.clamp(lengths, min=1)[:, None]
                              .to(dt))[seg]

        feats = [points[:, : self.num_input_features]]
        if self.xyz_cluster:
            feats.append(offsets[:, :3])
        if self.xy_center:
            if self.voxel_shape == "cuboid":
                xc, yc = c1p, c2p
            else:
                xc, yc = c1p * torch.cos(c2p), c1p * torch.sin(c2p)
            feats.append((xyz[:, 0] - xc)[:, None])
            feats.append((xyz[:, 1] - yc)[:, None])
        if self.raz_cluster:
            feats.append(offsets[:, 3:] if self.xyz_cluster else offsets)
        if self.ra_center:
            if self.voxel_shape == "cuboid":
                rc, ac = torch.hypot(c1p, c2p), torch.atan2(c2p, c1p)
            else:
                rc, ac = c1p, c2p
            feats.append((ra[:, 0] - rc)[:, None])
            feats.append((ra[:, 1] - ac)[:, None])
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))

        x = torch.cat(feats, dim=-1) * valid[:, None]
        n = len(self.num_filters)
        for i in range(n):
            x = getattr(self, f"pfn{i}_dense")(x)
            x = torch.relu(getattr(self, f"pfn{i}_bn")(x, valid))
            pooled = _segment_max(
                torch.where(valid[:, None], x, float("-inf")), seg, v + 1)
            pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
            if i < n - 1:
                x = torch.cat([x, pooled[seg]], dim=-1)
        return pooled[:v]


@READERS.register_module(name="PillarFeatureNet")
class PillarFeatureNet(DynamicPFNet):
    """The reference's cartesian pillar encoder
    (``partner_tpu/models/pillar.py:242-256``): raw features, the xyz
    cluster-mean offsets and the xy pillar-centre offsets (and the
    distance where asked), on cuboid points."""

    def __init__(self, num_input_features=4, num_filters=(64,),
                 voxel_shape="cuboid", xyz_cluster=True, raz_cluster=False,
                 xy_center=True, ra_center=False, **kwargs):
        super().__init__(num_input_features, num_filters, voxel_shape,
                         xyz_cluster, raz_cluster, xy_center, ra_center,
                         **kwargs)


def pp_scatter(pillar_features, pillar_coords, pillar_mask, grid_size):
    """(B, V, F) pillar features, (B, V, 3) coords (z, az, r) and (B, V)
    mask -> the (B, n_az, n_r, F) canvas (``pillar.py:135-146``, per
    sample there): each valid pillar's row at its cell, 0 elsewhere; a
    masked pillar's row goes to a sentinel cell that is cut off."""
    n_r, n_az = int(grid_size[0]), int(grid_size[1])
    b, _, f = pillar_features.shape
    lin = pillar_coords[..., 1].long() * n_r + pillar_coords[..., 2].long()
    lin = torch.where(pillar_mask, lin, n_az * n_r)
    src = torch.where(pillar_mask[..., None], pillar_features, 0.0)
    canvas = src.new_zeros((b, n_az * n_r + 1, f)).scatter(
        1, lin[..., None].expand(-1, -1, f), src)
    return canvas[:, :-1].reshape(b, n_az, n_r, f)


class PointPillarsModule(nn.Module):
    """points -> pillars -> PFN -> scatter -> ``RPN`` -> ``CenterHead``,
    NHWC (``pillar.py:149-240``). ``max_pillars`` is the pillar capacity
    of each sample: the lowest linear cell ids are kept, as in JAX (the
    config's ``max_voxel_num`` is not read). ``seg_head_cfg`` adds a seg
    head over (canvas, neck map), its config cut to JAX's keys."""

    SEG_KEYS = ("type", "num_classes", "kernel", "in_channels", "up_scale",
                "height", "weight")

    def __init__(self, reader_cfg, neck_cfg, head_cfg, grid_size, pc_range,
                 voxel_size, max_pillars=32768, out_size_factor=8,
                 seg_head_cfg=None):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.max_pillars = int(max_pillars)
        self.out_size_factor = out_size_factor
        rc = dict(reader_cfg)
        rc.setdefault("voxel_size", self.voxel_size)
        rc.setdefault("pc_range", self.pc_range)
        self.reader = build_from_cfg(rc, READERS)
        self.neck = build_from_cfg(dict(neck_cfg), NECKS)
        self.bbox_head = build_from_cfg(dict(head_cfg), BBOX_HEADS)
        self.seg_head = None
        if seg_head_cfg:
            self.seg_head = build_seg_head(
                seg_head_cfg, self.SEG_KEYS,
                tuple(rc.get("num_filters", (64,)))[-1],
                neck_out_features(self.neck))

    def pillarize(self, points, points_mask):
        """``dynamic_voxelize`` on the pillar grid (nx, ny, 1), the z extent
        one cell: coords (B, V, 3), mask (B, V), num_points (B, V) and
        point_voxel (B, P)."""
        dev = points.device
        size = constant(self, "pillar_size", dev, lambda: torch.tensor(
            [self.voxel_size[0], self.voxel_size[1],
             self.pc_range[5] - self.pc_range[2]], dtype=torch.float32))
        pr = constant(self, "pc_range", dev, lambda: torch.tensor(
            self.pc_range, dtype=torch.float32))
        return dynamic_voxelize(
            points, points_mask, size, pr,
            (self.grid_size[0], self.grid_size[1], 1), self.max_pillars,
            return_point_voxel=True, features=False)

    def encode_canvas(self, points, points_mask):
        """points (B, P, C), points_mask (B, P) -> the canvas (B, n_az,
        n_r, F). The batch's pillars share one segment space (slot
        ``b * max_pillars + pillar``), so the PFN's BatchNorm takes its
        statistics over the whole batch's valid points."""
        b, p, c = points.shape
        v = self.max_pillars
        vox = self.pillarize(points, points_mask)
        pv = vox["point_voxel"].long()
        offsets = torch.arange(b, device=points.device)[:, None] * v
        flat_seg = torch.where(pv < v, pv + offsets, b * v).reshape(b * p)
        feats = self.reader(points.reshape(b * p, c),
                            points_mask.reshape(b * p), flat_seg,
                            vox["coords"].reshape(b * v, 3), b * v)
        return pp_scatter(feats.reshape(b, v, -1), vox["coords"],
                          vox["mask"], self.grid_size)

    def heads(self, canvas, x):
        """The head's maps of the neck's map x, with a seg head also
        ``seg_preds`` (B, n_az, n_r, classes) over the canvas and x."""
        out = self.bbox_head(x)
        if self.seg_head is not None:
            out = dict(out, seg_preds=self.seg_head(canvas, x)["seg_preds"])
        return out

    def forward(self, example, generator=None, return_bev=False):
        """example {"points": (B, P, C), "points_mask": (B, P)} -> the
        head's maps (:meth:`heads`), and with ``return_bev`` the neck's map
        beside them: ``(maps, bev)``. ``generator`` is unused (no
        dropout)."""
        canvas = self.encode_canvas(example["points"], example["points_mask"])
        x = self.neck(canvas)
        out = self.heads(canvas, x)
        return (out, x) if return_bev else out


def max_pillars_rule(vg, n_sectors):
    """A sector's pillar capacity where the config sets none: the first
    ``max_voxel_num`` (32,768 without one) shared among the sectors,
    ``max(1024, ceil(mv / S))`` rounded up to 8 (30,000 at one sector,
    7,504 a sector at four)."""
    mv = dict(vg or {}).get("max_voxel_num", 32768)
    mv = mv[0] if isinstance(mv, (list, tuple)) else mv
    return max(1024, (-(-mv // max(n_sectors, 1)) + 7) // 8 * 8)


def pillar_module_kwargs(reader, neck, bbox_head, max_pillars):
    """The keyword arguments a pillar module (PointPillars, PolarStream,
    STROBE, HAN) takes from a config (``partner_tpu/models/strobe.py:
    162-193``): the grid, range and cell size of
    ``bbox_head["voxel_generator"]``, the reader and neck configs, and the
    head config rewritten as ``build_voxelnet`` rewrites it."""
    from .detectors import _grid_spec

    grid, pc_range, voxel_size = _grid_spec(bbox_head)
    head_cfg = dict(bbox_head)
    for k in ("voxel_shape", "code_weights", "weight", "dataset"):
        head_cfg.pop(k, None)
    head_cfg["tasks"] = tuple({"class_names": tuple(t["class_names"])}
                              for t in bbox_head["tasks"])
    if "common_heads" in head_cfg:
        head_cfg["common_heads"] = tuple(sorted(
            (k, tuple(v)) for k, v in dict(bbox_head["common_heads"]).items()))
    return dict(reader_cfg=dict(reader),
                neck_cfg={k: v for k, v in dict(neck).items()
                          if k != "logger"},
                head_cfg=head_cfg, grid_size=grid, pc_range=pc_range,
                voxel_size=voxel_size, max_pillars=max_pillars,
                out_size_factor=bbox_head.get("out_size_factor", 8))


@DETECTORS.register_module(name="PointPillars")
def build_point_pillars(reader, neck, bbox_head, backbone=None,
                        seg_head=None, pretrained=None, train_cfg=None,
                        test_cfg=None, max_pillars=32768, *, device,
                        generator=None, use_block_kernel=False):
    """PointPillars factory (``pillar.py:258-303``): a
    :class:`PointPillarsModule` in a ``CenterPointDetector`` that takes
    points, with the head config rewritten as ``build_voxelnet`` rewrites
    it; a ``seg_head`` (HAN 1-sector) adds its head, its ``weight`` the seg
    loss's (1.0 by default). ``max_pillars`` is 32,768 where the config
    sets none: the factory does not read ``max_voxel_num``, as in JAX.
    ``backbone`` (``PointPillarsScatter``) is read by neither package: the
    module scatters its own canvas. The module is built on the meta device
    and materialized on ``device`` with flax's default initializers drawn
    from ``generator`` (seed 0 when None)."""
    from .detectors import CenterPointDetector, _materialize

    if use_block_kernel:
        raise ValueError("use_block_kernel is an option of the E2E head's "
                         "Swin blocks; PointPillars' CenterHead has none")
    kw = pillar_module_kwargs(reader, neck, bbox_head, max_pillars)
    module = _materialize(device, generator, lambda: PointPillarsModule(
        seg_head_cfg=dict(seg_head) if seg_head else None, **kw))
    return CenterPointDetector(
        module, code_weights=bbox_head.get("code_weights", [1.0] * 10),
        weight=bbox_head.get("weight", 0.25), voxel_size=kw["voxel_size"],
        test_cfg=test_cfg, voxel_shape=bbox_head.get("voxel_shape",
                                                     "cylinder"),
        seg_weight=(seg_head or {}).get("weight", 1.0))
