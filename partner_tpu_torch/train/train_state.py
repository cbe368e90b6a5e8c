"""The train step (counterpart of ``make_train_step`` in
``partner_tpu/train/train_state.py:35-61``).

JAX threads an immutable state through a jitted function; here the module
holds the parameters and BatchNorm statistics and the optimizer holds its
moments and step count, and one step updates both in place:

    step = make_train_step(det, build_one_cycle_optimizer(det.module, ...))
    metrics = step(example, generator)

With a process group (``parallel.dist.initialize``: torchrun's ranks, one
a card) the step is data-parallel. Each rank holds its part of a global
batch, and the step computes what one process computes on the whole
global batch, as JAX's ``data`` mesh axis does:

- the forward and the loss run inside ``parallel.dist.reducing``, so
  every BatchNorm takes the global batch's statistics and every loss its
  global normalizers; each rank's loss is then its part of the global
  loss;
- ``DistributedDataParallel`` sums the parts' gradients over the ranks
  (``parallel.dist.sum_gradients_hook``: DDP's own hook averages), which
  gives the global loss's gradient; the clip reads the summed gradients,
  so every rank clips and updates alike;
- the logged terms are the global values, the parts summed in one
  all-reduce.
"""

import torch

from ..parallel import dist


class _LossModule(torch.nn.Module):
    """``det.loss`` as a module's forward over ``det.module``'s parameters,
    for ``DistributedDataParallel`` to wrap (a detector's loss calls more of
    its module than ``forward``)."""

    def __init__(self, det):
        super().__init__()
        self.module = det.module
        self._loss = det.loss

    def forward(self, example, generator):
        return self._loss(example, generator)


def make_train_step(det, opt):
    """``step(example, generator) -> metrics`` for a detector
    (``E2EDetector``, ``CenterPointDetector`` or ``TwoStageDetector``) and
    a ``train.optim.ChainOptimizer`` on its module's trainable parameters
    (one-cycle Adam or the config-built family; a frozen first stage stays
    in eval mode through ``module.train()`` and takes no gradient).

    A step puts the module in train mode, runs the forward (BatchNorm
    batch statistics, dropout and DropPath drawing from ``generator``) and
    the loss, backpropagates, reads the global gradient norm before
    clipping, clips, updates the parameters and counts the step. Each
    parameter's ``.grad`` holds that step's gradient afterwards. ``metrics``
    holds the detector's loss dict (every term and ``loss``; the E2E
    detector's ``num_matched``; the CenterPoint detector's per-task lists
    ``det_loss``, ``hm_loss``, ``loc_loss``; the two-stage detector's
    ``roi_cls_loss``, ``roi_reg_loss``; a seg head's ``seg_loss``) and
    ``grad_norm``, as tensors on the module's device (nothing is copied
    to the host).

    ``example`` is whatever the detector's loss reads, as in JAX: a
    detector that takes voxel inputs (the sparse backbone) takes the
    ``features``, ``coords`` and ``voxel_mask`` of
    ``ops.voxelize.DeviceVoxelizer`` beside its targets (and, with a seg
    head, the points and their labels).

    With a process group the step is data-parallel as the module docstring
    says: ``example`` is this rank's part of the global batch,
    ``generator`` this rank's own (JAX draws one dropout mask for the
    global batch, so the ranks must not repeat each other's), and every
    metric is the global batch's. Building the step wraps the module once,
    on every rank together. The parameters a loss leaves unused (a head
    the config's losses do not read) are found each step
    (``find_unused_parameters``)."""
    ddp = None
    if torch.distributed.is_initialized():
        dev = next(det.module.parameters()).device
        ddp = torch.nn.parallel.DistributedDataParallel(
            _LossModule(det),
            device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=True)
        ddp.register_comm_hook(None, dist.sum_gradients_hook)

    def step(example, generator):
        det.module.train()
        for p in opt.params:
            p.grad = None
        if ddp is None:
            losses = det.loss(example, generator)
            losses["loss"].backward()
        else:
            with dist.reducing() as group:
                losses = ddp(example, generator)
                losses["loss"].backward()
            losses = dist.sum_terms(losses, group)
        metrics = {k: [t.detach() for t in v] if isinstance(v, list)
                   else v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = opt.step()
        return metrics

    return step
