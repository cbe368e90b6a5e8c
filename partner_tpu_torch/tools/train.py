"""Training CLI of the port (counterpart of ``tools/train.py``).

    python -m partner_tpu_torch.tools.train CONFIG [--work_dir D]
        [--resume_from CKPT] [--load_from CKPT] [--seed S]
        [--total_steps N] [--max_steps_per_epoch N] [--max_points P]
        [--batch_size B] [--validate] [--eval_interval E]
        [--eval_max_frames F] [--tensorboard] [--debug_nans]
        [--profile_dir D] [--device cuda|cpu]

Reads the config with ``utils.config.load_config``, builds the detector on
``--device`` (the card unless ``--device cpu``; with no card it stops with
an error rather than run on the CPU), the ``data.train`` dataset in train
mode and its loader (``samples_per_gpu`` a batch by default), and runs the
one-cycle Adam loop of ``make_train_step`` as the JAX CLI does:

- resume from ``--resume_from`` or, without it, from ``work_dir/latest``:
  weights, BatchNorm statistics, the Adam count and moments and the step,
  from a port or a JAX checkpoint; else ``--load_from`` loads the
  parameters only (BatchNorm statistics keep their initial values); else,
  for a two-stage config, the first stage's weights and statistics from
  the one-stage checkpoint ``first_stage_cfg["pretrained"]`` names (the
  run stops if it does not exist);
- any ported detector: PARTNER (``VoxelNetV3``), CenterPoint
  (``VoxelNet``), whose per-task loss terms are logged as lists, or the
  two-stage CenterPoint (``TwoStageDetector``; with ``freeze`` the
  optimizer holds the RoI head alone, and checkpoints its moments alone);
- metrics stay on the device between log flushes (one copy to the host
  per ``log_config.interval`` steps); the text log carries ``data_time``,
  ``transfer_time``, ``forward_time``, ``time`` and ``sync_time``; a
  ``PaviLoggerHook`` or ``MetricsSinkHook`` in ``log_config.hooks`` writes
  ``metrics.jsonl`` (each step's loss terms, ``num_matched``,
  ``grad_norm`` and phase times), ``--tensorboard`` a TensorBoard log;
- a checkpoint (weights, statistics, Adam state) after every epoch, the
  newest ``checkpoint_config.keep`` kept;
- with ``--validate`` (or a ``("val", n)`` entry in ``workflow``) the
  ported evaluator over ``data.val`` after the epoch's checkpoint.
  ``predict`` leaves the module in eval mode; the next step puts it back in
  train mode.

Random draws: the data pipeline draws from one ``np.random.RandomState``
seeded from ``--seed`` and the step the run starts at; dropout and DropPath
from a ``torch.Generator`` seeded from ``--seed`` and the step, so a run
resumed at a step takes the same dropout draws as an unbroken one. The
initial weights come from ``--seed``.

``--debug_nans`` turns on ``torch.autograd.set_detect_anomaly``;
``--profile_dir`` writes a ``torch.profiler`` trace of steps 10-15 after
the start. Not ported: the JAX CLI's ``--mesh`` (ROADMAP.md queue 1: DDP
and mesh eval), the ``lr_config`` types other than ``one_cycle`` with the
config-built optimizer (ROADMAP.md queue 1: the lr schedule family), and
``curriculum_weights`` (ROADMAP.md queue 1, off the main path:
``seg_head``); each stops the run with a message naming its item.
"""

import argparse
import os
import sys

import numpy as np

def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--load_from", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--total_steps", type=int, default=None)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--max_points", type=int, default=200000)
    p.add_argument("--batch_size", type=int, default=None,
                   help="override samples_per_gpu")
    p.add_argument("--mesh", default=None,
                   help="not ported: the port trains on one device")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--eval_interval", type=int, default=None)
    p.add_argument("--eval_max_frames", type=int, default=None)
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 10-15 here")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def example_to_device(batch, device, keys):
    """Collated numpy batch -> the tensors of ``keys`` (the detector's
    ``loss_keys``) on ``device``, per-task lists as lists of tensors."""
    import torch

    def move(a):
        return torch.from_numpy(a).to(device)

    return {k: [move(a) for a in batch[k]] if isinstance(batch[k], list)
            else move(batch[k]) for k in keys}


def dropout_generator(seed, step):
    """The dropout and DropPath generator of one step (on the CPU, which
    gives the same masks on the CPU and the card)."""
    import torch

    return torch.Generator().manual_seed(seed * 2 ** 32 + step)


def load_parameters(det, payload):
    """``--load_from``: the payload's parameters only, as the JAX CLI
    loads ``params`` and leaves ``batch_stats`` at their initial values."""
    names = [n for n, _ in det.module.named_parameters()]
    sd = payload["state_dict"]
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks parameters {missing[:5]}")
    det.module.load_state_dict({n: sd[n] for n in names}, strict=False)


def load_pretrained_first_stage(det, path):
    """A fresh run of a two-stage config: the one-stage checkpoint its
    ``first_stage_cfg["pretrained"]`` names (a port checkpoint or a JAX
    ``state.pkl``) -> the first stage's weights and BatchNorm statistics.
    A missing path stops the run with a message."""
    from ..train.checkpoint import load_checkpoint

    if not os.path.exists(path):
        sys.exit(f"train: the first stage's pretrained checkpoint {path} "
                 "does not exist; train the one-stage config first, or pass "
                 "--load_from")
    det.module.first.load_state_dict(load_checkpoint(path)[0]["state_dict"],
                                     strict=True)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..data import build_dataloader, build_dataset
    from ..eval.evaluator import evaluate
    from ..models import build_detector
    from ..train.checkpoint import (latest_checkpoint, load_checkpoint,
                                    optimizer_state, restore_train_state,
                                    save_checkpoint)
    from ..train.hooks import (IterTimer, LogBuffer, MetricsSinkHook,
                               TensorBoardLoggerHook, TextLoggerHook,
                               get_logger)
    from ..train.optim import build_one_cycle_optimizer, one_cycle_lr
    from ..train.train_state import make_train_step
    from ..utils.config import load_config

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("train: no CUDA device; pass --device cpu to run on the CPU")
    if args.mesh:
        sys.exit("train: --mesh is not ported; the port trains on one "
                 "device (ROADMAP.md queue 1: DDP and mesh eval)")
    cfg = load_config(args.config)
    lr_cfg = dict(cfg["lr_config"])
    if lr_cfg.get("type", "one_cycle") != "one_cycle":
        sys.exit(f"train: lr_config type {lr_cfg['type']!r} is not ported; "
                 "only one_cycle is (ROADMAP.md queue 1: the lr schedule "
                 "family)")
    if cfg.get("curriculum_weights") is not None:
        sys.exit("train: curriculum_weights (the seg loss) is not ported "
                 "(ROADMAP.md queue 1, off the main path: seg_head)")
    device = torch.device(args.device)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dir")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(work_dir, exist_ok=True)
    logger = get_logger(work_dir)
    logger.info(f"device: {device}")

    resume = args.resume_from or latest_checkpoint(work_dir)
    payload = load_checkpoint(resume)[0] if resume else None
    start_step = int(payload["step"]) if payload else 0

    det = build_detector(cfg["model"], cfg.get("train_cfg"),
                         cfg.get("test_cfg"), device=device,
                         generator=torch.Generator().manual_seed(args.seed))
    dataset = build_dataset(dict(cfg["data"]["train"]), dict(
        rng=np.random.RandomState([args.seed, start_step])))
    batch_size = args.batch_size or cfg["data"]["samples_per_gpu"]
    vg_mv = dict(cfg["voxel_generator"]).get("max_voxel_num", 150000)
    loader = build_dataloader(
        dataset, batch_size,
        workers_per_gpu=cfg["data"].get("workers_per_gpu", 4),
        max_points=args.max_points,
        max_voxels=vg_mv if isinstance(vg_mv, int) else vg_mv[0])

    if len(loader) == 0:
        sys.exit(f"train: the train set's {len(dataset)} samples make no "
                 f"whole batch of {batch_size}")
    steps_per_epoch = args.max_steps_per_epoch or len(loader)
    total_steps = args.total_steps or (steps_per_epoch
                                       * cfg.get("total_epochs", 1))
    grad_clip = dict(cfg.get("optimizer_config", {})).get(
        "grad_clip", {}).get("max_norm", 35.0)
    lr_max = lr_cfg.get("lr_max", 3e-3)
    div_factor = lr_cfg.get("div_factor", 10.0)
    pct_start = lr_cfg.get("pct_start", 0.4)
    opt = build_one_cycle_optimizer(
        det.module, lr_max=lr_max, total_steps=total_steps,
        wd=dict(cfg["optimizer"]).get("wd", 0.01),
        moms=lr_cfg.get("moms", (0.95, 0.85)), div_factor=div_factor,
        pct_start=pct_start, grad_clip=grad_clip)
    lr_sched = one_cycle_lr(lr_max, total_steps, div_factor, pct_start)

    if payload is not None:
        restore_train_state(det, opt, payload)
        logger.info(f"resumed from {resume} at step {start_step}")
    elif args.load_from:
        load_parameters(det, load_checkpoint(args.load_from)[0])
        logger.info(f"loaded weights from {args.load_from}")
    elif getattr(det, "pretrained", None):
        load_pretrained_first_stage(det, det.pretrained)
        logger.info(f"loaded the first stage from {det.pretrained}")

    log_cfg = dict(cfg.get("log_config", {}))
    log_interval = log_cfg.get("interval", 5)
    buffer = LogBuffer()
    text_hook = TextLoggerHook(logger, interval=log_interval)
    tb_hook = (TensorBoardLoggerHook(os.path.join(work_dir, "tb"))
               if args.tensorboard else None)
    sink_hook = None
    sinks = [dict(h) for h in log_cfg.get("hooks", [])
             if dict(h).get("type") in ("PaviLoggerHook", "MetricsSinkHook")]
    if sinks:
        sink_hook = MetricsSinkHook(
            path=sinks[0].get("path", os.path.join(work_dir, "metrics.jsonl")),
            interval=sinks[0].get("interval", log_interval))
    timer = IterTimer()

    # the step's metrics stay device tensors until a flush, which copies
    # the whole window to the host at once (the JAX CLI's flush_pending)
    pending = []

    def flush_pending():
        if not pending:
            return
        keys = [k for k in pending[0][2] if k in ("loss", "grad_norm",
                                                  "num_matched")
                or k.startswith("loss_") or k.endswith("_loss")]
        # a per-task list (the CenterPoint terms) is logged as a list
        sizes = [len(pending[0][2][k]) if isinstance(pending[0][2][k], list)
                 else 0 for k in keys]
        fetched = torch.stack([
            torch.cat([torch.stack(m[k]).float().reshape(-1) if n
                       else m[k].float().reshape(1)
                       for k, n in zip(keys, sizes)])
            for _, _, m, _ in pending]).cpu().tolist()
        sync_time = timer.lap()  # the host's wait for the window's work
        for (si, ep, _, tim), flat in zip(pending, fetched):
            scal, i = {}, 0
            for k, n in zip(keys, sizes):
                scal[k] = flat[i: i + n] if n else flat[i]
                i += max(n, 1)
            buffer.update({**tim, **scal})
            lr = float(lr_sched(si))
            if tb_hook is not None:
                tb_hook.log(si, scal, lr=lr)
            if sink_hook is not None:   # with the step's phase times
                sink_hook.log(si, {**tim, **scal}, lr=lr, epoch=ep)
        buffer.update({"sync_time": sync_time})
        si, ep = pending[-1][0], pending[-1][1]
        text_hook.after_iter(buffer, si, ep, float(lr_sched(si)),
                             steps_per_epoch)
        pending.clear()

    eval_interval = args.eval_interval or cfg.get("eval_interval", 1)
    # a ("val", n) entry in workflow turns validation on, every n train
    # epochs unless an interval was given (the reference's Trainer.run)
    wf = [tuple(w) for w in cfg.get("workflow", [])]
    if any(m == "val" for m, *_ in wf) and "val" in cfg.get("data", {}):
        args.validate = True
        train_epochs = sum(n for m, n in wf if m == "train")
        if (args.eval_interval is None and train_epochs
                and cfg.get("eval_interval") is None):
            eval_interval = train_epochs
    val_dataset = None
    with open(args.config) as f:
        config_text = f.read()

    step = make_train_step(det, opt)
    profiler = None
    step_i = start_step
    epoch = step_i // max(steps_per_epoch, 1)
    while step_i < total_steps:
        loader.set_epoch(epoch)
        for batch in loader:
            if step_i >= total_steps:
                break
            if args.profile_dir and step_i == start_step + 10:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                profiler.start()
            if profiler is not None and step_i == start_step + 15:
                profiler.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                path = os.path.join(args.profile_dir, "train_trace.json")
                profiler.export_chrome_trace(path)
                profiler = None
                logger.info(f"profiler trace written to {path}")
            data_time = timer.lap()
            ex = example_to_device(batch, device, det.loss_keys)
            transfer_time = timer.lap()
            metrics = step(ex, dropout_generator(args.seed, step_i))
            # no host read here: the next step's data work overlaps the
            # card's; the window is read at the flush
            forward_time = timer.lap()
            pending.append((step_i, epoch, metrics, {
                "data_time": data_time, "transfer_time": transfer_time,
                "forward_time": forward_time,
                "time": data_time + transfer_time + forward_time}))
            if (step_i + 1) % log_interval == 0:
                flush_pending()
            step_i += 1
            if args.max_steps_per_epoch and step_i % steps_per_epoch == 0:
                break
        epoch += 1
        flush_pending()
        save_checkpoint(
            work_dir, step_i, det.module.state_dict(),
            meta=dict(epoch=epoch, step=step_i, config=config_text),
            keep=dict(cfg.get("checkpoint_config", {})).get("keep", 5),
            opt_state=optimizer_state(det.module, opt))
        logger.info(f"epoch {epoch} done @ step {step_i}; checkpoint saved")

        if args.validate and epoch % eval_interval == 0:
            if val_dataset is None:
                val_dataset = build_dataset(dict(cfg["data"]["val"]))
            result, _ = evaluate(det, val_dataset, work_dir, logger, device,
                                 max_points=args.max_points,
                                 max_frames=args.eval_max_frames)
            if result is not None:
                det_metrics = (result[0] if isinstance(result, tuple)
                               else result)
                logger.info(f"[val] epoch {epoch}: {det_metrics}")
                if tb_hook is not None and det_metrics:
                    tb_hook.log(step_i, {
                        f"val/{k}": v for k, v in det_metrics.items()
                        if isinstance(v, (int, float)) and np.isfinite(v)})
        timer.lap()  # the next step's data_time leaves this epoch's end out

    if profiler is not None:
        profiler.stop()
    if sink_hook is not None:
        sink_hook.close()
    if tb_hook is not None:
        tb_hook.close()
    logger.info("training complete")
    return step_i


if __name__ == "__main__":
    main()
