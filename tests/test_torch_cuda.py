"""partner_tpu_torch CUDA kernels against their plain twins, on the card.

These need an NVIDIA CUDA card (sm_90a) and nvcc; without one they skip.
On the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# Both sides bf16 with f32 accumulation in another order: two bf16 ulps
# relative, |kernel - plain| <= TOL * (1 + |plain|).
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


def _stem_args(dev, b=2, p=5037, seed=0):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    args = [torch.randn(b, 10, p, generator=g).to(bf),
            torch.rand(b, p, generator=g) < 0.8,
            (torch.randn(32, 10, generator=g) * 0.3).to(bf),
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


def _attn_args(dev, nw, mask_windows, seed=0):
    from partner_tpu_torch.models.swin_vote import swin_attn_mask

    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    q, k, v = (rnd(nw, 4, 64, 64).to(torch.bfloat16) for _ in range(3))
    pos = rnd(nw, 64, 2) * 20
    mask = None
    if mask_windows:
        m = torch.from_numpy(swin_attn_mask(16, 8 * mask_windows // 2, 8, 4))
        mask = m[:mask_windows].contiguous()
    args = [q, k, v, pos, mask, 0.3 * rnd(2, 16), 0.1 * rnd(16),
            0.3 * rnd(16, 4), 0.1 * rnd(4), 0.5 + torch.rand(4, generator=g)]
    return [None if a is None else a.to(dev) for a in args]


@pytest.mark.parametrize("mask_windows", [0, 4], ids=["no-mask", "mask"])
def test_attention_kernel_matches_plain(cuda, mask_windows):
    from partner_tpu_torch.ops import swin_attn

    args = _attn_args(cuda, 12, mask_windows)  # mask tiled 3x
    before = swin_attn.swin_vote_attention.launches
    out = swin_attn.swin_vote_attention(*args)
    torch.cuda.synchronize()
    assert swin_attn.swin_vote_attention.launches == before + 1
    _close(out, swin_attn.swin_vote_attention_plain(*args))


def test_wrappers_raise_instead_of_falling_back(cuda):
    from partner_tpu_torch.ops import stem, swin_attn

    args = _stem_args(cuda, b=1, p=64)
    with pytest.raises(ValueError):  # f32 features: the kernel takes bf16
        stem.stem2_channel_major(args[0].float(), *args[1:])
    args = _attn_args(cuda, 2, 0)
    with pytest.raises(ValueError):  # non-contiguous q
        swin_attn.swin_vote_attention(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError):  # T = 32: the kernel takes 64
        swin_attn.swin_vote_attention(
            *(a[:, :, :32].contiguous() for a in args[:3]), args[3][:, :32],
            *args[4:])
