"""Training CLI of the port (counterpart of ``tools/train.py``).

    python -m partner_tpu_torch.tools.train CONFIG [--work_dir D]
        [--resume_from CKPT] [--load_from CKPT] [--seed S]
        [--total_steps N] [--max_steps_per_epoch N] [--max_points P]
        [--batch_size B] [--validate] [--eval_interval E]
        [--eval_max_frames F] [--tensorboard] [--debug_nans]
        [--profile_dir D] [--device cuda|cpu]
        [--mesh auto|data=D,model=M,azimuth=K]
    python -m torch.distributed.run --nproc_per_node D*M*K \
        -m partner_tpu_torch.tools.train CONFIG ... \
        --mesh data=D,model=M,azimuth=K

Reads the config with ``utils.config.load_config``, builds the detector on
``--device`` (the card unless ``--device cpu``; with no card it stops with
an error rather than run on the CPU), the ``data.train`` dataset in train
mode and its loader, and runs the loop of ``make_train_step`` as the JAX
CLI does:

- resume from ``--resume_from`` or, without it, from ``work_dir/latest``:
  weights, BatchNorm statistics, the Adam count and moments and the step,
  from a port or a JAX checkpoint; else ``--load_from`` loads the
  parameters only (BatchNorm statistics keep their initial values); else,
  for a two-stage config, the first stage's weights and statistics from
  the one-stage checkpoint ``first_stage_cfg["pretrained"]`` names (the
  run stops if it does not exist);
- the optimizer as the JAX CLI chooses it: one-cycle Adam
  (``build_one_cycle_optimizer``) for ``lr_config`` type ``one_cycle``,
  else ``build_lr_schedule`` (fixed, step, exp, poly, inv, cosine, with
  a constant, linear or exp warmup; ``by_epoch`` over the run's steps an
  epoch) with the config-built ``build_optimizer`` (adam / adamw,
  amsgrad, sgd); the logged ``lr`` is the schedule's at the step;
- the JAX CLI's mesh over torchrun's processes, one a card
  (``parallel.dist.initialize`` first: NCCL on the cards, gloo with
  ``--device cpu``): ``--mesh`` lays the ranks out as ``data=D,model=M,
  azimuth=K`` in JAX's device order (``parallel.mesh``; ``auto`` puts
  every rank on ``data``) and stops the run, naming the cause, where the
  spec is not the world's, the global batch does not split over D, or
  the azimuth axis is asked of a detector other than VoxelNetV3 and
  VoxelNet or of a map whose rows do not split into K runs of whole neck
  strides. ``--batch_size`` is the global batch (default
  ``samples_per_gpu`` x the world size); data coordinate d's rank at
  model 0, azimuth 0 loads the d-th positional part of every global batch
  (``data.loader``) with d's random draws and broadcasts it to d's other
  ranks (``parallel.mesh.batches``). The detector is placed on the mesh
  (``parallel.mesh.place``: its large kernels sliced over ``model``,
  its neck on an azimuth axis sharded over ``azimuth``) and the step
  runs on it (``train.train_state``), so the ranks train as one process
  on the global batch. Rank 0 alone logs and writes checkpoints, in the
  data-only layout (the model slices and their Adam slots gathered; no
  ``module.`` prefix: interchangeable with a one-process run's); every
  rank resumes its own slice of the same checkpoint;
- any ported detector: PARTNER (``VoxelNetV3``), CenterPoint
  (``VoxelNet``), whose per-task loss terms are logged as lists, or the
  two-stage CenterPoint (``TwoStageDetector``; with ``freeze`` the
  optimizer holds the RoI head alone, and checkpoints its moments alone);
  a detector that takes voxel inputs (the sparse backbone, the
  segmentation-only VoxelNet) trains through them: each batch's points are
  voxelized on the device by ``ops.voxelize.DeviceVoxelizer`` at the
  config's ``voxel_generator``, up to its first ``max_voxel_num``, and
  stay in the example beside the voxels (the seg loss reads them), as in
  JAX (``tools/train.py:194-220``);
- ``curriculum_weights``: the epoch's entry (1.0 past the list's end) is
  each batch's ``seg_loss_decay``, the seg loss's weight in ``loss``
  (a negative entry balances it against the det loss;
  ``models.detectors.apply_seg_decay``);
- metrics stay on the device between log flushes (one copy to the host
  per ``log_config.interval`` steps); the text log carries ``data_time``,
  ``transfer_time``, ``forward_time``, ``time`` and ``sync_time``; a
  ``PaviLoggerHook`` or ``MetricsSinkHook`` in ``log_config.hooks`` writes
  ``metrics.jsonl`` (each step's loss terms, ``num_matched``,
  ``grad_norm`` and phase times), ``--tensorboard`` a TensorBoard log;
  a ``ClosureHook`` there (an instance, or ``dict(type="ClosureHook",
  fn_name=stage, fn=callable)``) is called at its stage (``before_run``,
  ``before_epoch``, ``before_iter``, ``after_iter``, ``after_epoch`` or
  ``after_run``) on every rank with the loop's state: ``model`` (the
  detector), ``optimizer``, ``work_dir``, ``rank``, ``epoch``, ``iter``
  (the step) and, after a step, its device metrics ``outputs``;
- a checkpoint (weights, statistics, the optimizer's state: the Adam
  moments, AMSGrad's max or SGD's trace) after every epoch, the newest
  ``checkpoint_config.keep`` kept;
- with ``--validate`` (or a ``("val", n)`` entry in ``workflow``) the
  ported evaluator over ``data.val`` after the epoch's checkpoint,
  sharded over the ranks as ``dist_test`` shards it.
  ``predict`` leaves the module in eval mode; the next step puts it back in
  train mode.

Random draws: the data pipeline draws from one ``np.random.RandomState``
seeded from ``--seed`` and the step the run starts at; dropout and DropPath
from a ``torch.Generator`` seeded from ``--seed`` and the step, so a run
resumed at a step takes the same dropout draws as an unbroken one. With
more than one data coordinate each coordinate's two seeds take it too, so
no two parts of a global batch draw alike, while the model and azimuth
ranks of one coordinate draw alike. The initial weights come from
``--seed``.

``--debug_nans`` turns on ``torch.autograd.set_detect_anomaly``;
``--profile_dir`` writes a ``torch.profiler`` trace of steps 10-15 after
the start. ``--resume_from`` and ``--load_from`` take what
``train.checkpoint.load_checkpoint`` takes (``modelzoo://``, ``file://``
and remote-store paths too).
"""

import argparse
import logging
import os
import sys
import types

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
                   help="the global batch (default samples_per_gpu x the "
                        "world size)")
    p.add_argument("--mesh", default=None,
                   help="'auto' or 'data=D,model=M,azimuth=K' over the "
                        "D*M*K torchrun ranks")
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


def dropout_generator(seed, step, d=0, n_data=1):
    """The dropout and DropPath generator of one step (on the CPU, which
    gives the same masks on the CPU and the card); with more than one data
    coordinate, coordinate ``d``'s own."""
    import torch

    if n_data == 1:
        return torch.Generator().manual_seed(seed * 2 ** 32 + step)
    return torch.Generator().manual_seed(int(np.random.SeedSequence(
        [seed, step, d]).generate_state(1, np.uint64)[0] >> 1))


def closure_hooks(entries):
    """The ``ClosureHook``s of ``log_config.hooks``: instances as they are,
    ``dict(type="ClosureHook", fn_name=..., fn=...)`` entries built."""
    from ..train.hooks import ClosureHook

    return [ClosureHook(h["fn_name"], h["fn"]) if isinstance(h, dict)
            else h for h in entries
            if isinstance(h, ClosureHook)
            or (isinstance(h, dict) and h.get("type") == "ClosureHook")]


def load_parameters(det, payload):
    """``--load_from``. A checkpoint of the whole model loads its
    parameters only, as the JAX CLI loads ``params`` and leaves
    ``batch_stats`` at their initial values. A checkpoint of some sections
    (``tools.convert_checkpoint`` writes the neck and the backbone of a
    reference checkpoint) loads every tensor it names, statistics too, as
    the reference's ``load_from`` does; the other sections keep their
    initial values. A name the module lacks raises."""
    from ..parallel import tp

    names = [n for n, _ in det.module.named_parameters()]
    sd = payload["state_dict"]
    unknown = sorted(set(sd) - set(det.module.state_dict()))
    if unknown:
        raise KeyError(f"the module has no tensors {unknown[:5]}")
    if all(n in sd for n in names):
        sd = {n: sd[n] for n in names}
    tp.load_state_dict(det.module, sd, strict=False)


def load_pretrained_first_stage(det, path):
    """A fresh run of a two-stage config: the one-stage checkpoint its
    ``first_stage_cfg["pretrained"]`` names (a port checkpoint or a JAX
    ``state.pkl``) -> the first stage's weights and BatchNorm statistics.
    A missing path stops the run with a message."""
    from ..parallel import tp
    from ..train.checkpoint import load_checkpoint

    try:
        payload = load_checkpoint(path)[0]
    except FileNotFoundError:
        sys.exit(f"train: the first stage's pretrained checkpoint {path} "
                 "does not exist; train the one-stage config first, or pass "
                 "--load_from")
    tp.load_state_dict(det.module.first, payload["state_dict"], strict=True)


def sector_targets(data_cfg, n_sectors, logger, config_path):
    """The train set's config with each ``AssignLabel`` assigning the
    model's ``n_sectors``. ``han_4_sectors.py`` builds its pipeline from
    ``han_1_sector.py`` and rebinds ``assigner`` only after, so its
    ``AssignLabel`` keeps one sector while the model has four; the JAX
    train CLI then fails at its first loss (ROADMAP.md §3). Each rewrite
    is logged as a warning naming ``config_path`` and the old count."""
    pipeline = []
    for stage in data_cfg.get("pipeline", []):
        stage = dict(stage)
        old = (dict(stage.get("cfg") or {}).get("nsectors", 1)
               if stage.get("type") == "AssignLabel" else n_sectors)
        if old != n_sectors:
            stage["cfg"] = dict(stage.get("cfg") or {}, nsectors=n_sectors)
            logger.warning(f"{config_path}: the train pipeline's AssignLabel "
                           f"assigns {old} sector(s) and the model has "
                           f"{n_sectors}; assigning {n_sectors}")
        pipeline.append(stage)
    return dict(data_cfg, pipeline=pipeline)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..data import build_dataloader, build_dataset
    from ..eval.evaluator import evaluate
    from ..models import build_detector
    from ..models.strobe import no_sweep_loader
    from ..parallel import dist, mesh, tp
    from ..train.checkpoint import (latest_checkpoint, load_checkpoint,
                                    optimizer_state, restore_train_state,
                                    save_checkpoint)
    from ..train.hooks import (IterTimer, LogBuffer, MetricsSinkHook,
                               TensorBoardLoggerHook, TextLoggerHook,
                               get_logger)
    from ..train.optim import (build_lr_schedule, build_one_cycle_optimizer,
                               build_optimizer, one_cycle_lr)
    from ..train.train_state import make_train_step
    from ..utils.config import load_config

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("train: no CUDA device; pass --device cpu to run on the CPU")
    owned = dist.initialize(args.device)
    rank, world = dist.process_info()
    cfg = load_config(args.config)
    batch_size = args.batch_size or cfg["data"]["samples_per_gpu"] * world
    n_data, n_model, n_az = mesh.check(args.mesh, world, "train", batch_size,
                                       cfg["model"])
    grid = mesh.build(n_data, n_model, n_az)
    d = grid.coords[0]
    main_rank = rank == 0
    lr_cfg = dict(cfg["lr_config"])
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dir")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(work_dir, exist_ok=True)
    logger = (get_logger(work_dir) if main_rank
              else get_logger(level=logging.WARNING))
    logger.info(f"device: {device}, rank {rank} of {world}, {grid}")

    resume = args.resume_from or latest_checkpoint(work_dir)
    payload = load_checkpoint(resume)[0] if resume else None
    start_step = int(payload["step"]) if payload else 0

    det = build_detector(cfg["model"], cfg.get("train_cfg"),
                         cfg.get("test_cfg"), device=device,
                         generator=torch.Generator().manual_seed(args.seed))
    if det.input_kind == "sweeps":
        sys.exit(no_sweep_loader("train", cfg["model"]["type"]))
    sliced = mesh.place(det, grid)
    if sliced:
        logger.info(f"{len(sliced)} parameters sliced over model={n_model}")
    train_data = sector_targets(dict(cfg["data"]["train"]),
                                getattr(det.module, "n_sectors", 1), logger,
                                args.config)
    dataset = build_dataset(train_data, dict(rng=np.random.RandomState(
        [args.seed, start_step] + ([d] if n_data > 1 else []))))
    vg_mv = dict(cfg["voxel_generator"]).get("max_voxel_num", 150000)
    loader = build_dataloader(
        dataset, batch_size,
        workers_per_gpu=cfg["data"].get("workers_per_gpu", 4),
        max_points=args.max_points,
        max_voxels=vg_mv if isinstance(vg_mv, int) else vg_mv[0],
        rank=d, world_size=n_data)

    if len(loader) == 0:
        sys.exit(f"train: the train set's {len(dataset)} samples make no "
                 f"whole batch of {batch_size}")
    steps_per_epoch = args.max_steps_per_epoch or len(loader)
    total_steps = args.total_steps or (steps_per_epoch
                                       * cfg.get("total_epochs", 1))
    grad_clip = dict(cfg.get("optimizer_config", {})).get(
        "grad_clip", {}).get("max_norm", 35.0)
    if lr_cfg.get("type", "one_cycle") == "one_cycle":
        lr_max = lr_cfg.get("lr_max", 3e-3)
        div_factor = lr_cfg.get("div_factor", 10.0)
        pct_start = lr_cfg.get("pct_start", 0.4)
        opt = build_one_cycle_optimizer(
            det.module, lr_max=lr_max, total_steps=total_steps,
            wd=dict(cfg["optimizer"]).get("wd", 0.01),
            moms=lr_cfg.get("moms", (0.95, 0.85)), div_factor=div_factor,
            pct_start=pct_start, grad_clip=grad_clip)
        lr_sched = one_cycle_lr(lr_max, total_steps, div_factor, pct_start)
    else:
        # the reference lr_updater family with the config-built optimizer
        lr_sched = build_lr_schedule(lr_cfg, total_steps,
                                     steps_per_epoch=steps_per_epoch)
        opt = build_optimizer(dict(cfg["optimizer"]), lr_sched, det.module,
                              grad_clip=grad_clip)

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
               if args.tensorboard and main_rank else None)
    sink_hook = None
    sinks = [dict(h) for h in log_cfg.get("hooks", []) if isinstance(h, dict)
             and h.get("type") in ("PaviLoggerHook", "MetricsSinkHook")]
    hooks = closure_hooks(log_cfg.get("hooks", []))
    runner = types.SimpleNamespace(model=det, optimizer=opt,
                                   work_dir=work_dir, rank=rank, epoch=0,
                                   iter=start_step, outputs=None)

    def call_hooks(stage, outputs=None, **state):
        vars(runner).update(state, outputs=outputs)
        for h in hooks:
            fn = getattr(h, stage, None)
            if fn is not None:
                fn(runner)
    if sinks and main_rank:
        sink_hook = MetricsSinkHook(
            path=sinks[0].get("path", os.path.join(work_dir, "metrics.jsonl")),
            interval=sinks[0].get("interval", log_interval))
    timer = IterTimer()

    # the step's metrics stay device tensors until a flush, which copies
    # the whole window to the host at once (the JAX CLI's flush_pending)
    pending = []

    def flush_pending():
        if not main_rank:   # the terms are global: rank 0 logs them
            pending.clear()
            return
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
    voxelize = None
    if det.input_kind == "voxels":
        from ..ops.voxelize import DeviceVoxelizer

        voxelize = DeviceVoxelizer(cfg["voxel_generator"], device,
                                   vg_mv if isinstance(vg_mv, int)
                                   else vg_mv[0])
    # the seg loss's per-epoch weight (the reference's curriculum); 1.0
    # past the list's end
    curriculum = cfg.get("curriculum_weights")
    profiler = None
    step_i = start_step
    epoch = step_i // max(steps_per_epoch, 1)
    call_hooks("before_run", epoch=epoch, iter=step_i)
    while step_i < total_steps:
        loader.set_epoch(epoch)
        call_hooks("before_epoch", epoch=epoch, iter=step_i)
        for batch in mesh.batches(loader, grid):
            if step_i >= total_steps:
                break
            call_hooks("before_iter", iter=step_i)
            if (args.profile_dir and main_rank
                    and step_i == start_step + 10):
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
            if curriculum is not None:
                ex["seg_loss_decay"] = float(
                    curriculum[epoch] if epoch < len(curriculum) else 1.0)
            transfer_time = timer.lap()
            if voxelize is not None:
                ex.update(voxelize(ex["points"], ex["points_mask"]))
            metrics = step(ex, dropout_generator(args.seed, step_i, d,
                                                 n_data))
            # no host read here: the next step's data work overlaps the
            # card's; the window is read at the flush
            forward_time = timer.lap()
            pending.append((step_i, epoch, metrics, {
                "data_time": data_time, "transfer_time": transfer_time,
                "forward_time": forward_time,
                "time": data_time + transfer_time + forward_time}))
            if (step_i + 1) % log_interval == 0:
                flush_pending()
            call_hooks("after_iter", iter=step_i, outputs=metrics)
            step_i += 1
            if args.max_steps_per_epoch and step_i % steps_per_epoch == 0:
                break
        epoch += 1
        flush_pending()
        # the data-only layout: every rank gathers its model slices
        state, opt_state = (tp.full_state_dict(det.module),
                            optimizer_state(det.module, opt))
        if main_rank:
            save_checkpoint(
                work_dir, step_i, state,
                meta=dict(epoch=epoch, step=step_i, config=config_text),
                keep=dict(cfg.get("checkpoint_config", {})).get("keep", 5),
                opt_state=opt_state)
            logger.info(f"epoch {epoch} done @ step {step_i}; checkpoint "
                        "saved")

        if args.validate and epoch % eval_interval == 0:
            if val_dataset is None:
                val_dataset = build_dataset(dict(cfg["data"]["val"]))
            result, _ = evaluate(det, val_dataset, work_dir, logger, device,
                                 max_points=args.max_points,
                                 max_frames=args.eval_max_frames, cfg=cfg)
            if result is not None:
                det_metrics = (result[0] if isinstance(result, tuple)
                               else result)
                logger.info(f"[val] epoch {epoch}: {det_metrics}")
                if tb_hook is not None and det_metrics:
                    tb_hook.log(step_i, {
                        f"val/{k}": v for k, v in det_metrics.items()
                        if isinstance(v, (int, float)) and np.isfinite(v)})
        call_hooks("after_epoch", epoch=epoch, iter=step_i)
        timer.lap()  # the next step's data_time leaves this epoch's end out

    call_hooks("after_run", epoch=epoch, iter=step_i)
    if profiler is not None:
        profiler.stop()
    if sink_hook is not None:
        sink_hook.close()
    if tb_hook is not None:
        tb_hook.close()
    logger.info("training complete")
    if owned:
        dist.finalize()
    return step_i


if __name__ == "__main__":
    main()
