"""The train step (counterpart of ``make_train_step`` in
``partner_tpu/train/train_state.py:35-61``).

JAX threads an immutable state through a jitted function; here the module
holds the parameters and BatchNorm statistics and the optimizer holds its
moments and step count, and one step updates both in place:

    step = make_train_step(det, build_one_cycle_optimizer(det.module, ...))
    metrics = step(example, generator)
"""


def make_train_step(det, opt):
    """``step(example, generator) -> metrics`` for a detector
    (``E2EDetector``, ``CenterPointDetector`` or ``TwoStageDetector``) and
    a :class:`~partner_tpu_torch.train.optim.OneCycleAdam` on its module's
    trainable parameters (a frozen first stage stays in eval mode through
    ``module.train()`` and takes no gradient).

    A step puts the module in train mode, runs the forward (BatchNorm
    batch statistics, dropout and DropPath drawing from ``generator``) and
    the loss, backpropagates, reads the global gradient norm before
    clipping, clips, updates the parameters and counts the step. Each
    parameter's ``.grad`` holds that step's gradient afterwards. ``metrics``
    holds the detector's loss dict (every term and ``loss``; the E2E
    detector's ``num_matched``; the CenterPoint detector's per-task lists
    ``det_loss``, ``hm_loss``, ``loc_loss``; the two-stage detector's
    ``roi_cls_loss``, ``roi_reg_loss``) and ``grad_norm``, as tensors
    on the module's device (nothing is copied to the host).

    A detector that takes voxel inputs (the sparse backbone) raises here:
    the loss path takes points only (ROADMAP.md queue 1, off the main
    path: training through voxel inputs)."""
    if det.input_kind != "points":
        raise NotImplementedError(
            f"a train step of a detector with {det.input_kind} inputs is not "
            "ported (ROADMAP.md queue 1, off the main path: training through "
            "voxel inputs)")

    def step(example, generator):
        det.module.train()
        for p in opt.params:
            p.grad = None
        losses = det.loss(example, generator)
        losses["loss"].backward()
        metrics = {k: [t.detach() for t in v] if isinstance(v, list)
                   else v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = opt.step()
        return metrics

    return step
