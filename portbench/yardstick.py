"""The benchmark's fixed arithmetic: the card's data-sheet peaks and the
FLOPs of a frame, counted over the plain reference (``reference/``) so
that they are the same work whatever implements it. The peaks are
NVIDIA's data sheet for the H100 SXM5 at 700 W, dense rates without
sparsity. A later change to the program does not move them.

A frame's FLOPs are two parts. The dense layers after the backbone (the
SetBlock, the neck and the head) have the same shapes in every frame:
they are counted once on the meta device and frozen in the
configuration file (``flops.frame_dense``). The sparse backbone's convs
do the work of the frame's active sites: a conv's FLOPs are 2 Cin Cout a
pair of an output site and an active input site in its kernel's reach,
counted from the reference's own neighbour maps of each sweep
(:func:`sparse_flops`). The program's gather-matmul also multiplies the
empty neighbours and capacity rows as zeros; that is not counted."""

import contextlib

PEAK_FLOPS = {"bf16": 989e12}            # dense tensor-core rate, FLOP/s


def mfu(flops, seconds_per_item):
    """Percent of the card's bf16 dense peak that ``flops`` a frame at
    ``seconds_per_item`` reach."""
    return 100.0 * flops / seconds_per_item / PEAK_FLOPS["bf16"]


def count_flops(fn, *args, **kwargs):
    """Matmul-class FLOPs of ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (2 a
    multiply-add; convolutions, matrix products and attention), as
    {module path: FLOPs} and their total under ``"Global"``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    return {k: int(sum(v.values())) for k, v in
            mode.get_flop_counts().items()}


@contextlib.contextmanager
def pair_counting():
    """While open, the reference's sparse convs count their work instead
    of doing it: each call adds 2 Cin Cout for every (output row,
    neighbour) pair whose neighbour is an active row to the list this
    yields, and returns zeros of the output's shape."""
    import torch

    from .reference.ptt.models.sparse import SparseConv

    counts = []
    forward = SparseConv.forward

    def count(self, feats, nmap):
        k = nmap.shape[-1]
        cin, cout = self.kernel.shape[0] // k, self.kernel.shape[1]
        pairs = (nmap < feats.shape[1]).sum()
        counts.append(pairs * (2 * cin * cout))
        return feats.new_zeros(feats.shape[0], nmap.shape[1], cout)
    SparseConv.forward = count
    try:
        yield counts
    finally:
        SparseConv.forward = forward


def sparse_flops(backbone, voxels, grid):
    """FLOPs of the reference sparse backbone ``backbone`` on one batch of
    voxels ({"features", "coords", "voxel_mask"}) of grid ``grid``: its
    convs' active pairs (:func:`pair_counting`); the maps are built, no
    product is taken."""
    import torch

    with torch.no_grad(), pair_counting() as counts:
        backbone(voxels["features"], voxels["coords"], voxels["voxel_mask"],
                 grid)
    return int(sum(int(c) for c in counts))
