"""partner_tpu_torch CUDA kernels against their plain twins, on the card.

These need an NVIDIA CUDA card (sm_90a) and nvcc; without one they skip.
On the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# Both sides bf16 with f32 accumulation in another order: two bf16 ulps
# relative, |kernel - plain| <= TOL * (1 + |plain|). The scatter-max is
# exact.
TOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= TOL * (1 + ref.abs())).all())


def _stem_args(dev, b=2, p=5037, seed=0, cin=10):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    args = [torch.randn(b, cin, p, generator=g).to(bf),
            torch.rand(b, p, generator=g) < 0.8,
            (torch.randn(32, cin, generator=g) * 0.3).to(bf),
            0.5 + torch.rand(32, generator=g), 0.2 * torch.randn(32, generator=g),
            (torch.randn(64, 32, generator=g) * 0.2).to(bf),
            0.5 + torch.rand(64, generator=g), 0.2 * torch.randn(64, generator=g)]
    return [a.to(dev) for a in args]


def test_stem_kernel_matches_plain(cuda):
    from partner_tpu_torch.ops import stem

    args = _stem_args(cuda)  # P not a multiple of the block: ragged tail
    before = stem.stem2_channel_major.launches
    out = stem.stem2_channel_major(*args)
    torch.cuda.synchronize()
    assert stem.stem2_channel_major.launches == before + 1
    _close(out, stem.stem2_channel_major_plain(*args))


# (points, batch, x 2 bytes past a 16-byte boundary), each at C_in 10 (the
# one-sweep configs' width) and 11 (the two-sweep configs')
STEM_POINTS = {"p1": (1, 2, False), "p15": (15, 2, False),
               "p16": (16, 2, False), "p17": (17, 2, False),
               "p5037": (5037, 2, False), "p216000": (216_000, 1, False),
               "p432000": (432_000, 1, False),
               "p4096-unaligned-x": (4096, 1, True)}
# C_in 8: the cuboid nuScenes configs (5 point features + 3 decorations)
STEM_CASES = [(cin, case) for cin in (8, 10, 11) for case in STEM_POINTS]


def _stem_f32(x, mask, w1, a1, b1, w2, a2, b2):
    """The stem in float32 throughout: no bf16 rounding of the hidden
    layer or the output."""
    m = mask[:, None, :].float()
    h = torch.relu((w1.float() @ x.float()) * m * a1[:, None] + b1[:, None])
    return torch.relu((w2.float() @ h) * m * a2[:, None] + b2[:, None])


@pytest.mark.parametrize(
    "cin,case", STEM_CASES,
    ids=[case if cin == 10 else f"cin{cin}-{case}" for cin, case in STEM_CASES])
def test_stem_kernel_point_counts(cuda, cin, case):
    """Point counts below, at and past one 16-point m-tile, a ragged tail,
    the flagship buffer (216,000 rows), the two-sweep buffer (432,000), and
    an x off a 16-byte boundary (the scalar copies of the kernel), at each
    width (C_in 8, 10, 11), against the twin within TOL. The tensor cores sum the products
    in another order than the twin's f32 matmul, so a bf16 rounding can
    flip: fewer than 0.1% of the outputs may differ, and an output beyond
    TOL of the twin passes only within TOL of the stem in float32
    throughout (the escape of the block kernel's 300-window test,
    ROADMAP.md §3). There kernel and twin round a hidden value or an output
    to the two sides of a bf16 step: 1 of 27,648,000 outputs at C_in 11
    and 432,000 rows (0.168 against the twin's 0.155; float32 0.163)."""
    from partner_tpu_torch.ops import stem

    p, b, offset = STEM_POINTS[case]
    args = _stem_args(cuda, b=b, p=p, seed=3, cin=cin)
    if offset:
        x = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                        device=cuda)[1:].view(args[0].shape)
        x.copy_(args[0])
        args[0] = x
    before = stem.stem2_channel_major.launches
    out = stem.stem2_channel_major(*args).float()
    ref = stem.stem2_channel_major_plain(*args).float()
    exact = _stem_f32(*args)
    torch.cuda.synchronize()
    assert stem.stem2_channel_major.launches == before + 1
    assert torch.isfinite(out).all()
    beyond = (out - ref).abs() > TOL * (1 + ref.abs())
    escaped = (out - exact).abs() <= TOL * (1 + exact.abs())
    n_diff = int((out != ref).sum())
    print(f"stem C_in {cin} {case}: {n_diff} of {out.numel()} outputs not "
          f"equal to the twin, {int(beyond.sum())} beyond TOL of it")
    assert not bool((beyond & ~escaped).any())
    assert n_diff <= 1e-3 * out.numel()


def _attn_args(dev, nw, mask_map=None, seed=0):
    """Window attention inputs: nw windows of 4 heads, T 64, hd 64 in
    bf16; with mask_map (h, w), the shifted-window region mask (shift 4)
    of that map's windows, which window w takes as mask[w % nWm]."""
    from partner_tpu_torch.models.swin_vote import swin_attn_mask

    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q, k, v = (rnd(nw, 4, 64, 64).to(torch.bfloat16) for _ in range(3))
    pos = rnd(nw, 64, 2) * 20
    mask = None
    if mask_map is not None:
        mask = torch.from_numpy(swin_attn_mask(*mask_map, 8, 4))
    args = [q, k, v, pos, mask, 0.3 * rnd(2, 16), 0.1 * rnd(16),
            0.3 * rnd(16, 4), 0.1 * rnd(4), 0.5 + torch.rand(4, generator=g)]
    return [None if a is None else a.to(dev) for a in args]


@pytest.mark.parametrize("mask_windows", [0, 4], ids=["no-mask", "mask"])
def test_attention_kernel_matches_plain(cuda, mask_windows):
    from partner_tpu_torch.ops import swin_attn

    # 4 mask windows tiled 3x
    args = _attn_args(cuda, 12, (16, 16) if mask_windows else None)
    before = swin_attn.swin_vote_attention.launches
    out = swin_attn.swin_vote_attention(*args)
    torch.cuda.synchronize()
    assert swin_attn.swin_vote_attention.launches == before + 1
    _close(out, swin_attn.swin_vote_attention_plain(*args))


# (windows, the map whose shifted-window mask they take, or None)
ATTN_GRID_CASES = {
    "1-no-mask": (1, None), "1-mask": (1, (8, 8)),
    "13-no-mask": (13, None), "13-mask": (13, (8, 104)),
    "133-no-mask": (133, None), "133-mask": (133, (56, 152)),
    "26-mask-tiled": (26, (8, 104)),
}


@pytest.mark.parametrize("case", list(ATTN_GRID_CASES))
def test_attention_kernel_grid_edges(cuda, case):
    """Window counts that stress the grid of one block per window, one
    resident per SM: one window, fewer windows than SMs, one more than 132
    (a second wave), without the mask, with a mask per window, and with a
    mask tiled across a batch of 2 (nW = 2 nWm)."""
    from partner_tpu_torch.ops import swin_attn

    nw, mask_map = ATTN_GRID_CASES[case]
    args = _attn_args(cuda, nw, mask_map, seed=2)
    out = swin_attn.swin_vote_attention(*args)
    torch.cuda.synchronize()
    _close(out, swin_attn.swin_vote_attention_plain(*args))


ATTN_300_MASKS = {"no-mask": None, "mask": (96, 200),
                   "mask-tiled": (80, 120)}


@pytest.mark.parametrize("mask", list(ATTN_300_MASKS))
def test_attention_kernel_300_windows_against_plain(cuda, mask):
    """300 windows (a 96 x 200 map; tiled: 150 mask windows, a batch of 2),
    2-3 waves of blocks. Held against the plain twin within TOL, element by
    element. Kernel and twin round P and the output
    to bf16 from f32 sums taken in another order, so a rounding can flip;
    an element beyond TOL of the twin passes only where the kernel lies
    within TOL of the same attention in float32 with no rounding (the twin
    on float32 q, k, v: P is not rounded)."""
    from partner_tpu_torch.ops import swin_attn

    args = _attn_args(cuda, 300, ATTN_300_MASKS[mask], seed=1)
    out = swin_attn.swin_vote_attention(*args).float()
    plain = swin_attn.swin_vote_attention_plain(*args).float()
    exact = swin_attn.swin_vote_attention_plain(
        *(a.float() for a in args[:3]), *args[3:])
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    off_plain = (out - plain).abs() > TOL * (1 + plain.abs())
    off_exact = (out - exact).abs() > TOL * (1 + exact.abs())
    print(f"300 windows, {mask}: {int(off_plain.sum())} of {out.numel()} "
          f"elements beyond TOL of the twin, "
          f"{int((off_plain & off_exact).sum())} of them beyond TOL of "
          f"float32; max |kernel - twin| {float((out - plain).abs().max())}"
          f", max |kernel - float32| {float((out - exact).abs().max())}, "
          f"max |twin - float32| {float((plain - exact).abs().max())}")
    assert not bool((off_plain & off_exact).any())


@pytest.mark.parametrize("mask", ["no-mask", "mask"])
def test_attention_kernel_300_windows_exactly(cuda, mask):
    """300 windows: a window is computed the same wherever and whenever it
    runs, so the launch is bit-equal to launching each row of 25 windows
    alone (fewer windows than SMs: one wave)."""
    from partner_tpu_torch.ops import swin_attn

    args = _attn_args(cuda, 300, ATTN_300_MASKS[mask], seed=1)
    out = swin_attn.swin_vote_attention(*args)
    rows = []
    for r in range(12):
        part = [a[25 * r:25 * r + 25].contiguous() for a in args[:4]]
        m = None if args[4] is None else args[4][25 * r:25 * r + 25]
        rows.append(swin_attn.swin_vote_attention(*part, m, *args[5:]))
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, torch.cat(rows))


def _block_args(dev, shift, seed=0, h=16, w=24, b=2):
    """Whole-block op inputs, batch b of an h x w map (default 2 of 16 x
    24), at the kernel's widths: a SwinVoteBlock with random weights and
    norms, cell positions 0-75 m, the real region mask for a shifted
    block."""
    from partner_tpu_torch.models.layers import init_weights
    from partner_tpu_torch.models.swin_vote import SwinVoteBlock, swin_attn_mask
    from partner_tpu_torch.ops import swin_block

    g = torch.Generator().manual_seed(seed)
    block = SwinVoteBlock(256, 4, 8, shift_size=shift, dtype=torch.bfloat16)
    init_weights(block, g)
    with torch.no_grad():
        for name, t in block.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.2 * torch.randn(t.shape, generator=g))
            elif "norm" in name or name.endswith("tau"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
    block = block.to(dev)
    x = torch.randn(b, h, w, 256, generator=g).to(torch.bfloat16)
    pos = torch.rand(b, h, w, 2, generator=g) * 75
    vote = torch.randn(b, h, w, 3, generator=g)
    mask = (torch.from_numpy(swin_attn_mask(h, w, 8, shift)) if shift
            else None)
    x, pos, vote = (a.to(dev) for a in (x, pos, vote))
    params = swin_block.swin_vote_block_params(block, torch.bfloat16)
    bias = swin_block.block_bias_table(
        pos, None if mask is None else mask.to(dev), params["rpe"],
        torch.bfloat16, 8)
    return x, vote, bias, params


@pytest.mark.parametrize("shift", [0, 4], ids=["unshifted", "shifted"])
def test_block_kernel_matches_plain(cuda, shift):
    from partner_tpu_torch.ops import swin_block

    x, vote, bias, params = _block_args(cuda, shift)
    before = swin_block.swin_vote_block.launches
    out = swin_block.swin_vote_block(x, vote, bias, params, 4, 8)
    torch.cuda.synchronize()
    assert swin_block.swin_vote_block.launches == before + 1
    _close(out, swin_block.swin_vote_block_plain(x, vote, bias, params, 4, 8))


@pytest.mark.parametrize("shift", [0, 4], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("b", [1, 2], ids=["15-windows", "batch-2"])
def test_block_kernel_tiling_edges(cuda, shift, b):
    """A 24 x 40 map: 15 windows a sample, a count that divides neither by
    the SM count nor by the windows a persistent block takes."""
    from partner_tpu_torch.ops import swin_block

    x, vote, bias, params = _block_args(cuda, shift, seed=1, h=24, w=40, b=b)
    out = swin_block.swin_vote_block(x, vote, bias, params, 4, 8)
    torch.cuda.synchronize()
    _close(out, swin_block.swin_vote_block_plain(x, vote, bias, params, 4, 8))


@pytest.mark.parametrize("shift", [0, 4], ids=["unshifted", "shifted"])
def test_block_kernel_walks_windows_against_plain(cuda, shift):
    """300 windows (a 96 x 200 map): each persistent block walks 2 or 3
    windows. Held against the plain twin within TOL, element by element.
    Kernel and twin round the same intermediates to bf16 (LN outputs, q,
    k, P, v, head outputs, the GELU) from sums taken in another order; a
    bf16 flip early in a window can carry a few outputs beyond TOL of the
    twin. Such an element passes only where the kernel lies within TOL of
    the same block computed in float32 with no rounding (the twin on a
    float32 x): there the twin, not the kernel, is the one that strayed."""
    from partner_tpu_torch.ops import swin_block

    x, vote, bias, params = _block_args(cuda, shift, seed=1, h=96, w=200,
                                        b=1)
    out = swin_block.swin_vote_block(x, vote, bias, params, 4, 8).float()
    plain = swin_block.swin_vote_block_plain(x, vote, bias, params, 4,
                                             8).float()
    exact = swin_block.swin_vote_block_plain(x.float(), vote, bias, params,
                                             4, 8)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    off_plain = (out - plain).abs() > TOL * (1 + plain.abs())
    off_exact = (out - exact).abs() > TOL * (1 + exact.abs())
    print(f"300 windows, shift {shift}: {int(off_plain.sum())} of "
          f"{out.numel()} elements beyond TOL of the twin, "
          f"{int((off_plain & off_exact).sum())} of them beyond TOL of "
          f"float32; max |kernel - twin| {float((out - plain).abs().max())}"
          f", max |kernel - float32| {float((out - exact).abs().max())}, "
          f"max |twin - float32| {float((plain - exact).abs().max())}")
    assert not bool((off_plain & off_exact).any())


@pytest.mark.parametrize("shift", [0, 4], ids=["unshifted", "shifted"])
def test_block_kernel_walks_windows_exactly(cuda, shift):
    """300 windows (a 96 x 200 map): each persistent block walks 2 or 3
    windows, its weight stream running on from one into the next. A window
    is computed the same wherever it runs, so the result is bit-equal to
    launching each row of 25 windows alone (fewer windows than SMs: one
    window a block)."""
    from partner_tpu_torch.ops import swin_block

    x, vote, bias, params = _block_args(cuda, shift, seed=1, h=96, w=200,
                                        b=1)
    out = swin_block.swin_vote_block(x, vote, bias, params, 4, 8)
    rows = [swin_block.swin_vote_block(
        x[:, 8 * r:8 * r + 8].contiguous(), vote[:, 8 * r:8 * r + 8]
        .contiguous(), bias[:, r:r + 1].contiguous(), params, 4, 8)
        for r in range(12)]
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, torch.cat(rows, 1))


def _scatter_args(dev, b=2, p=7013, seed=0, shape=(5, 12, 9),
                  dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(b, 64, p, generator=g))
    x = torch.where(torch.rand(b, 64, p, generator=g) < 0.1, -0.0, x)
    coords = torch.stack([torch.randint(0, s, (b, p), generator=g)
                          for s in shape], 1).to(torch.int32)
    mask = torch.rand(b, p, generator=g) < 0.8
    return [a.to(dev) for a in (x.to(dtype), coords, mask)], shape


def _scatter_case(dev, case, dtype):
    """(args, shape, the mask the twin takes) of a scatter edge case."""
    if case in ("c8", "c128"):
        args, shape = _scatter_args(dev, b=2, p=3000, seed=4, dtype=dtype)
        x = (args[0][:, :8] if case == "c8"
             else torch.cat([args[0], args[0].flip(2)], 1))
        return [x.contiguous(), *args[1:]], shape, args[2]
    kw = {"p-not-8": dict(b=1, p=1001), "batch-2": dict(b=2, p=4096),
          "all-masked": dict(b=2, p=4096), "3-cells": dict(b=2, p=20_000),
          "zeros-only": dict(b=1, p=4096), "outside": dict(b=2, p=4096),
          "unaligned-x": dict(b=1, p=4096),
          # the two-sweep CenterPoint rows on the full-width canvas
          "p432000": dict(b=1, p=432_000, shape=(5, 512, 288))}[case]
    args, shape = _scatter_args(dev, seed=4, dtype=dtype, **kw)
    x, coords, mask = args
    if case == "all-masked":
        mask = torch.zeros_like(mask)
    elif case == "3-cells":
        coords = coords[:, :, :3][:, :, torch.randint(
            0, 3, (x.shape[2],), generator=torch.Generator().manual_seed(5))
            .to(dev)].contiguous()
    elif case == "zeros-only":
        x = torch.where(x > 0, 0.0, x)         # +0.0 and -0.0 rows
        assert bool((torch.signbit(x) & (x == 0)).any())
    elif case == "unaligned-x":
        xo = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
        x = xo.view(x.shape)
        x.copy_(args[0])
    twin_mask = mask
    if case == "outside":
        # a fifth of the kept rows off the canvas on one axis: dropped
        g = torch.Generator().manual_seed(6)
        off = (torch.rand(mask.shape, generator=g) < 0.2).to(dev) & mask
        axis = torch.randint(0, 3, mask.shape, generator=g).to(dev)
        for a, s in enumerate(shape):
            sel = off & (axis == a)
            coords[:, a] = torch.where(sel & (coords[:, a] % 2 == 0), -1,
                                       torch.where(sel, s, coords[:, a]))
        twin_mask = mask & ~off
    return [x, coords.contiguous(), mask], shape, twin_mask


SCATTER_CASES = ["p-not-8", "batch-2", "all-masked", "3-cells",
                 "zeros-only", "outside", "unaligned-x", "c8", "c128",
                 "p432000"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_kernel_edge_cases(cuda, case, dtype):
    """Exact equality with the twin: P not a multiple of 8 with a ragged
    tail tile, a batch of 2, every row masked, all rows into 3 cells
    (~6,700 rows a cell), rows of only +0.0 and -0.0, rows whose coords
    fall outside the canvas (dropped by the kernel; masked for the twin),
    x off a 16-byte boundary (the scalar loads), C = 8 and C = 128 (two
    slices of the slab), and the two-sweep frame's 432,000 rows (3,375
    tiles) into the full-width (5, 512, 288) canvas. No -0.0 bits reach the
    canvas."""
    from partner_tpu_torch.ops import scatter_max

    args, shape, twin_mask = _scatter_case(cuda, case, dtype)
    out = scatter_max.scatter_max_fold2d(*args, shape)
    ref = scatter_max.scatter_max_fold2d_plain(args[0], args[1], twin_mask,
                                               shape)
    torch.cuda.synchronize()
    assert torch.equal(out.float(), ref.float())  # a max is exact
    bits = out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    assert not bool((bits == torch.iinfo(bits.dtype).min).any())  # -0.0
    if case in ("all-masked", "zeros-only"):
        assert not bool(out.any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scatter_kernel_matches_plain(cuda, dtype):
    from partner_tpu_torch.ops import scatter_max

    # ~50 rows a cell: contended atomics
    args, shape = _scatter_args(cuda, dtype=dtype)
    before = scatter_max.scatter_max_fold2d.launches
    out = scatter_max.scatter_max_fold2d(*args, shape)
    torch.cuda.synchronize()
    assert scatter_max.scatter_max_fold2d.launches == before + 1
    ref = scatter_max.scatter_max_fold2d_plain(*args, shape)
    assert torch.equal(out.float(), ref.float())  # a max is exact


def test_wrappers_raise_instead_of_falling_back(cuda):
    from partner_tpu_torch.ops import scatter_max, stem, swin_attn, swin_block

    args = _stem_args(cuda, b=1, p=64)
    with pytest.raises(ValueError):  # f32 features: the kernel takes bf16
        stem.stem2_channel_major(args[0].float(), *args[1:])
    args = _stem_args(cuda, b=1, p=64, cin=12)
    with pytest.raises(ValueError):  # C_in 12: no instantiation
        stem.stem2_channel_major(*args)
    args = _attn_args(cuda, 2)
    with pytest.raises(ValueError):  # non-contiguous q
        swin_attn.swin_vote_attention(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError):  # T = 32: the kernel takes 64
        swin_attn.swin_vote_attention(
            *(a[:, :, :32].contiguous() for a in args[:3]), args[3][:, :32],
            *args[4:])
    with pytest.raises(ValueError):  # 2 heads: the kernel takes 4
        swin_attn.swin_vote_attention(
            *(a[:, :2].contiguous() for a in args[:3]), *args[3:7],
            args[7][:, :2].contiguous(), args[8][:2].contiguous(),
            args[9][:2].contiguous())
    q_off = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                        device=cuda)[1:].view(args[0].shape)
    q_off.copy_(args[0])
    with pytest.raises(ValueError):  # q 2 bytes off a 16-byte boundary
        swin_attn.swin_vote_attention(q_off, *args[1:])
    x, vote, bias, params = _block_args(cuda, 0)
    with pytest.raises(ValueError):  # f32 x: the kernel takes bf16
        swin_block.swin_vote_block(x.float(), vote, bias, params, 4, 8)
    with pytest.raises(ValueError):  # 2 heads: the kernel takes 4
        swin_block.swin_vote_block(x, vote, bias, params, 2, 8)
    with pytest.raises(ValueError):  # a map that does not tile
        swin_block.swin_vote_block(x[:, :12].contiguous(), vote[:, :12],
                                   bias, params, 4, 8)
    args, shape = _scatter_args(cuda, b=1, p=100)
    with pytest.raises(ValueError):  # f16: the kernel takes bf16 or f32
        scatter_max.scatter_max_fold2d(args[0].half(), *args[1:], shape)
    with pytest.raises(ValueError):  # non-contiguous coords
        scatter_max.scatter_max_fold2d(
            args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2),
            args[2], shape)
    for dt in (torch.bfloat16, torch.float32):  # C = 12: not a multiple of 8
        with pytest.raises(ValueError):
            scatter_max.scatter_max_fold2d(
                args[0][:, :12].to(dt).contiguous(), *args[1:], shape)


def test_scatter_backward_kernel_route_matches_plain(cuda):
    """``ScatterMaxFold2d`` on the kernel's forward against the same
    backward on the twin's forward: the tie rule picks rows by an exact
    compare, so the gradients are bit-equal."""
    from partner_tpu_torch.ops import scatter_max

    args, shape = _scatter_args(cuda)
    x = args[0].requires_grad_()
    g = torch.randn((2, *shape[1:], shape[0] * 64),
                    generator=torch.Generator().manual_seed(1)).to(x)
    before = scatter_max.scatter_max_fold2d.launches
    scatter_max.ScatterMaxFold2d.apply(x, *args[1:], shape).backward(g)
    assert scatter_max.scatter_max_fold2d.launches == before + 1
    with torch.no_grad():
        canvas = scatter_max.scatter_max_fold2d_plain(x, *args[1:], shape)
        want = scatter_max.scatter_max_fold2d_backward(x, *args[1:], canvas,
                                                       g, shape)
    torch.cuda.synchronize()
    assert torch.equal(x.grad, want)
    assert (want != 0).sum() > (canvas > 0).sum()  # tied winners exist


def test_flagship_train_step_on_the_card(cuda):
    """One train step of the flagship config at full width and grid, batch
    1, on a 20,000-point synthetic sweep: finite loss and gradients, the
    scatter-max kernel once, the stem, attention and block kernels never."""
    import os
    import sys

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from partner_tpu_torch.models import build_detector
    from partner_tpu_torch.train.optim import build_one_cycle_optimizer
    from partner_tpu_torch.train.train_state import make_train_step

    m, tc, _, lr_max = chip_smoke.train_cfgs()
    gen = torch.Generator().manual_seed(0)
    det = build_detector(m, None, tc, device=cuda, generator=gen)
    chip_smoke.randomize_norms(det.module, gen)
    ex = chip_smoke.to_device(chip_smoke.train_example(
        np.random.RandomState(0), m["bbox_head"]["voxel_generator"]["range"],
        det.module.grid_size, 1, 20_000, 24_000, 16), cuda)
    wrappers = chip_smoke.kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    met = make_train_step(det, build_one_cycle_optimizer(
        det.module, lr_max, 1000))(ex, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    assert {k: fn.launches for k, fn in wrappers.items()} == {
        "stem": 0, "scatter_max": 1, "swin_attn": 0, "swin_block": 0}
    assert all(torch.isfinite(v).all() for v in met.values())
    assert float(met["grad_norm"]) > 0
    for name, p in det.module.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("case", ["below-capacity", "over-capacity",
                                  "dense", "empty"])
def test_dynamic_voxelize_on_card_matches_cpu_and_repeats(cuda, case):
    """``dynamic_voxelize`` on the card: coords, mask, counts and point
    slots equal to the CPU's, means within 1e-6 (1 + |cpu|), and a second
    run bit-equal (no atomic sums), below and over capacity, with many
    rows a voxel, and with no valid row."""
    import numpy as np

    from partner_tpu_torch.ops.voxelize import dynamic_voxelize

    rng = np.random.RandomState(0)
    pr = np.array([0.3, -np.pi, -2.0, 75.18, np.pi, 4.0], np.float32)
    vs, cap, n = {
        "below-capacity": ((0.065, 0.0030679616, 0.15), 200_000, 180_000),
        "over-capacity": ((0.065, 0.0030679616, 0.15), 50_000, 180_000),
        "dense": ((15.0, 2.0, 3.0), 400, 60_000),
        "empty": ((0.065, 0.0030679616, 0.15), 1_000, 0)}[case]
    grid = tuple(int(round((pr[3 + i] - pr[i]) / vs[i])) for i in range(3))
    pts = np.zeros((2, 216_000, 7), np.float32)
    pts[:, :, 0] = rng.uniform(0.3, 75.0, (2, 216_000))
    pts[:, :, 1] = rng.uniform(-np.pi, np.pi, (2, 216_000))
    pts[:, :, 2] = rng.uniform(-2.0, 4.0, (2, 216_000))
    pts[:, :, 3:] = rng.rand(2, 216_000, 4)
    mask = np.zeros((2, 216_000), bool)
    mask[:, :n] = True
    args = (np.asarray(vs, np.float32), pr, grid, cap)
    want = dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                            *args, return_point_voxel=True)
    got = [dynamic_voxelize(torch.from_numpy(pts).to(cuda),
                            torch.from_numpy(mask).to(cuda), *args,
                            return_point_voxel=True) for _ in range(2)]
    for k in ("coords", "mask", "num_points", "point_voxel"):
        assert torch.equal(got[0][k].cpu(), want[k]), k
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k
    err = (got[0]["features"].cpu() - want["features"]).abs()
    assert bool((err <= 1e-6 * (1 + want["features"].abs())).all())
    if case == "over-capacity":
        assert bool(want["mask"].all())
