"""The work ``chip_smoke.py`` counts for each hand-written kernel (CPU).

``chip_smoke.kernel_work`` reckons each kernel's FLOPs and bytes from the
shapes of its arguments (every input byte read once, every output byte
written once, 2 FLOPs a multiply-add of the products), and
``chip_smoke.bound`` turns them into the least time an H100 could take.
These pin both at the flagship frame's shapes, within 2%. Shapes only:
the tensors live on the ``meta`` device, except the scatter's mask, whose
kept rows are data.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

META = torch.device("meta")
BF, F32 = torch.bfloat16, torch.float32
P = 216_000                      # the flagship sweep's 216,000-row buffer
NW, NH, T, HD = 576, 4, 64, 64   # 256 x 144 BEV in 8 x 8 windows


def _t(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


def _stem():
    return (_t(1, 10, P, dtype=BF), _t(1, P, dtype=torch.bool),
            _t(32, 10, dtype=BF), _t(32), _t(32), _t(64, 32, dtype=BF),
            _t(64), _t(64))


def _attn(with_mask=True):
    return (_t(NW, NH, T, HD, dtype=BF), _t(NW, NH, T, HD, dtype=BF),
            _t(NW, NH, T, HD, dtype=BF), _t(NW, T, 2),
            _t(NW, T, T) if with_mask else None, _t(2, 16), _t(16),
            _t(16, NH), _t(NH), _t(NH))


def _block():
    from partner_tpu_torch.ops import swin_block

    params = {k: _t(*shape, dtype=BF if operand else F32)
              for k, (shape, operand) in swin_block._packed_shapes(
                  256, NH, 256, 16).items()}
    return (_t(1, 256, 144, 256, dtype=BF), _t(1, 256, 144, 3),
            _t(1, 32, 18, NH, T, T), params, NH, 8)


def _scatter(kept=P):
    mask = torch.zeros(1, P, dtype=torch.bool)
    mask[0, :kept] = True
    return (_t(1, 64, P, dtype=BF), _t(1, 3, P, dtype=torch.int32), mask,
            (5, 512, 288))


def _close(got, want):
    assert got == pytest.approx(want, rel=0.02), (got, want)


def test_block_work_and_bound():
    w = chip_smoke.kernel_work("swin_block", *_block())
    _close(w["flops"]["bf16"], 31.4e9)
    _close(w["bytes"], 76.7e6)
    # the vote MLP and embed in float32: 0.30 GFLOP, 4.5 us on the FMA units
    _close(w["flops"]["f32"], 0.302e9)
    ms, by = chip_smoke.bound(w)
    assert by == "operations"
    _close(ms, 31.4e9 / 989e12 * 1e3)


def test_attention_work_and_bound():
    """q, k, v and the output are (576, 4, 64, 64) bf16, 18.9 MB each, and
    the mask (576, 64, 64) f32 9.4 MB: 85.2 MB with the mask, not 47.5 MB
    (that figure takes a bf16 value as one byte); q.k and P.v are 2.42
    GFLOP at 2 FLOPs a multiply-add, not 1.21 (that figure counts
    multiply-adds, where the block's 31.4 GFLOP counts FLOPs)."""
    w = chip_smoke.kernel_work("swin_attn", *_attn())
    _close(w["flops"]["bf16"], 2.416e9)
    _close(w["bytes"], 85.2e6)
    _close(w["flops"]["f32"], 0.453e9)   # the RPE MLP over 64 x 64 pairs
    ms, by = chip_smoke.bound(w)
    assert by == "bytes"
    _close(ms, 85.2e6 / 3.35e12 * 1e3)
    _close(chip_smoke.kernel_work("swin_attn", *_attn(False))["bytes"],
           75.8e6)


def test_stem_work_and_bound():
    w = chip_smoke.kernel_work("stem", *_stem())
    _close(w["flops"]["bf16"], 1.02e9)
    _close(w["bytes"], 32.2e6)
    assert chip_smoke.bound(w)[1] == "bytes"


def test_scatter_work_counts_the_kept_rows():
    w = chip_smoke.kernel_work("scatter_max", *_scatter())
    _close(w["bytes"], 125e6)
    assert w["flops"] == {}
    ms, by = chip_smoke.bound(w)
    assert by == "bytes"
    _close(ms, 125e6 / 3.35e12 * 1e3)
    # half the rows kept: their features and coords are not read
    half = chip_smoke.kernel_work("scatter_max", *_scatter(P // 2))
    _close(w["bytes"] - half["bytes"], P // 2 * (64 * 2 + 3 * 4))
    # the backward: rows, the canvas and cotangent at the kept rows' cells,
    # the gradient of every row
    b = chip_smoke.kernel_work("scatter_max_backward", *_scatter())
    _close(b["bytes"], 30.24e6 + 0.216e6 + 2 * 27.65e6 + 27.65e6)


def test_bound_takes_the_larger_time():
    assert chip_smoke.bound({"flops": {"bf16": 989e9}, "bytes": 3.35e6}) == (
        pytest.approx(1.0), "operations")
    assert chip_smoke.bound({"flops": {"f32": 67e9}, "bytes": 6.7e9}) == (
        pytest.approx(2.0), "bytes")
