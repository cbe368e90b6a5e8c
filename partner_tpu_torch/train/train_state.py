"""The train step (counterpart of ``make_train_step`` in
``partner_tpu/train/train_state.py:35-61``).

JAX threads an immutable state through a jitted function; here the module
holds the parameters and BatchNorm statistics and the optimizer holds its
moments and step count, and one step updates both in place:

    step = make_train_step(det, build_one_cycle_optimizer(det.module, ...))
    metrics = step(example, generator)

With a process group (``parallel.dist.initialize``: torchrun's ranks) the
step runs on the current mesh (``parallel.mesh``; a data-only mesh of the
world unless one was built). Each rank holds its data coordinate's part
of a global batch, and the step computes what one process computes on
the whole global batch, as JAX's mesh does:

- the forward and the loss run inside ``parallel.dist.reducing`` on the
  ``data`` group, so every BatchNorm takes the global batch's statistics
  and every loss its global normalizers (an azimuth-sharded neck's
  BatchNorm reduces over data x azimuth); each rank's loss is then its
  part of the global loss. The model ranks of one data coordinate hold
  the same batch and are never summed over;
- on an azimuth axis of K every azimuth rank computes the whole loss of
  its part, so the loss's cotangent is scaled by 1/K in the backward;
- ``DistributedDataParallel`` on the ``grad`` group (data x azimuth) sums
  the gradients (``parallel.dist.sum_gradients_hook``: DDP's own hook
  averages), which gives the global loss's gradient for every parameter;
  the clip reads the summed gradients (a model-sliced one's slices summed
  over the ``model`` group), so every rank clips and updates alike;
- the logged terms are the global values, the parts summed over the
  ``data`` group in one all-reduce.
"""

import torch

from ..parallel import dist, mesh


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

    With a process group the step runs on the mesh as the module
    docstring says: ``example`` is this rank's data coordinate's part of
    the global batch, ``generator`` that coordinate's own (JAX draws one
    dropout mask for the global batch, so the data coordinates must not
    repeat each other's; the model and azimuth ranks of one coordinate
    draw alike), and every metric is the global batch's. Building the step
    wraps the module once, on every rank together, after the detector is
    placed on the mesh (``parallel.mesh.place``) and the optimizer built
    on its (sliced) parameters. The parameters a loss leaves unused (a head
    the config's losses do not read) are found each step
    (``find_unused_parameters``)."""
    ddp = grid = None
    if torch.distributed.is_initialized():
        grid = mesh.current()
        dev = next(det.module.parameters()).device
        ddp = torch.nn.parallel.DistributedDataParallel(
            _LossModule(det),
            device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=True,
            process_group=grid.grad)
        ddp.register_comm_hook(grid.grad, dist.sum_gradients_hook)

    def step(example, generator):
        det.module.train()
        for p in opt.params:
            p.grad = None
        if ddp is None:
            losses = det.loss(example, generator)
            losses["loss"].backward()
        else:
            with dist.reducing(grid.data) as group:
                losses = ddp(example, generator)
                loss = losses["loss"]
                if grid.n_az > 1:
                    loss = dist.scale_grad(loss, 1.0 / grid.n_az)
                loss.backward()
            losses = dist.sum_terms(losses, group)
        metrics = {k: [t.detach() for t in v] if isinstance(v, list)
                   else v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = opt.step()
        return metrics

    return step
