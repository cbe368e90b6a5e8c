"""Evaluation CLI of the port (counterpart of ``tools/dist_test.py``).

    python -m partner_tpu_torch.tools.dist_test CONFIG --checkpoint CKPT
        [--work_dir D] [--speed_test] [--testset] [--max_frames N]
        [--max_points P] [--batch_size B] [--input auto|points|voxels]
        [--device cuda|cpu] [--static_rpe] [--mesh auto|data=N]
    python -m torch.distributed.run --nproc_per_node N \
        -m partner_tpu_torch.tools.dist_test CONFIG ... --mesh data=N

Reads the config with ``utils.config.load_config``, builds the detector on
``--device`` (the card unless ``--device cpu``; with no card it stops with
an error rather than run on the CPU), loads the weights of a port or JAX
checkpoint (a step directory, a ``latest`` pointer, ``state.pt`` or
``state.pkl``; without one the weights are random, seed 0), and runs
:func:`eval.evaluator.evaluate` over ``data.val``: middle-third FPS,
``prediction.pkl`` and the dataset's metrics (nuScenes: the 3-tuple of
det metrics, seg mIoU and panoptic PQ / SQ / RQ, the last two filled in
for a seg config whose val infos carry ``lidarseg_path``, and printed).
``--input`` picks the input
contract (``auto``: the detector's own, ``points``; ``voxels``: each
batch voxelized on the device by ``ops.voxelize.dynamic_voxelize`` first).
``--static_rpe`` fills the
static-RPE cache (``E2EDetector.prepare_inference``) on a small all-padding
example before the loop, as ``bench.py`` does behind its knob; a detector
without the cache (the CenterPoint detectors) stops with a message.

Under torchrun each process joins the group first
(``parallel.dist.initialize``: NCCL on the cards, gloo with ``--device
cpu``) and the eval is sharded: ``--batch_size`` is the global batch
(which the world size must divide), each rank predicts its part of each,
and rank 0 gathers the detections, writes ``prediction.pkl`` and
evaluates (``eval.evaluator``). ``--mesh`` is the JAX CLI's spec: every
rank on ``data`` (``auto``, or ``data=N`` with N the world size); the
``model`` and ``azimuth`` axes stop the run (ROADMAP.md queue 1 item 9a).
"""

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--work_dir", default="./eval_out")
    p.add_argument("--speed_test", action="store_true")
    p.add_argument("--testset", action="store_true")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--max_points", type=int, default=200000)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--input", choices=["auto", "points", "voxels"],
                   default="auto",
                   help="input contract fed to the detector; auto uses the "
                        "detector's declared input_kind")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--static_rpe", action="store_true",
                   help="fill the static-RPE cache before the loop")
    p.add_argument("--mesh", default=None,
                   help="'auto' or 'data=N' (N the torchrun world size): "
                        "each rank predicts its part of each global batch")
    return p.parse_args(argv)


def main(argv=None):
    """-> (result, fps): ``dataset.evaluation``'s result (None on a rank
    other than 0) and the middle-third frames per second."""
    args = parse_args(argv)
    import torch

    from ..data import build_dataset
    from ..eval.evaluator import evaluate, init_example
    from ..models import build_detector
    from ..models.strobe import no_sweep_loader
    from ..parallel import dist
    from ..parallel.mesh import data_axis
    from ..train.checkpoint import load_checkpoint
    from ..train.hooks import get_logger
    from ..utils.config import load_config

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("dist_test: no CUDA device; pass --device cpu to run on "
                 "the CPU")
    owned = dist.initialize(args.device)
    rank, world = dist.process_info()
    data_axis(args.mesh, world, "dist_test")
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    cfg = load_config(args.config)
    os.makedirs(args.work_dir, exist_ok=True)
    logger = get_logger(args.work_dir)

    det = build_detector(cfg["model"], cfg.get("train_cfg"),
                         cfg.get("test_cfg"), device=device)
    if det.input_kind == "sweeps":
        sys.exit(no_sweep_loader("dist_test", cfg["model"]["type"]))
    dataset = build_dataset(dict(cfg["data"]["val"]))
    kind = args.input if args.input != "auto" else det.input_kind
    logger.info(f"model type {cfg['model']['type']}, input contract: "
                f"{kind}, device {device}")
    if args.checkpoint:
        payload, _ = load_checkpoint(args.checkpoint)
        det.module.load_state_dict(payload["state_dict"], strict=True)
        logger.info(f"loaded {args.checkpoint}")
    else:
        logger.info("no checkpoint: random weights (seed 0)")
    if args.static_rpe:
        if not hasattr(det, "prepare_inference"):
            sys.exit(f"dist_test: --static_rpe fills the E2E head's "
                     f"static-RPE cache; {cfg['model']['type']} has no such "
                     "cache")
        tables = det.prepare_inference(init_example(dataset, device, kind))
        logger.info(f"static-RPE cache: {len(tables)} tables, "
                    f"{sum(t.nbytes for t in tables.values())} bytes")

    # --speed_test forces batch 1, as the reference's dist_test does
    batch_size = 1 if args.speed_test else args.batch_size
    if batch_size % world:
        sys.exit(f"dist_test: the global batch {batch_size} does not split "
                 f"over {world} ranks")
    result, fps = evaluate(det, dataset, args.work_dir, logger, device,
                           batch_size=batch_size, max_points=args.max_points,
                           max_frames=args.max_frames, testset=args.testset,
                           cfg=cfg, input_kind=kind)
    if isinstance(result, tuple) and len(result) == 3:
        logger.info(f"seg mIoU: {result[1]}, panoptic: {result[2]}")
    if owned:
        dist.finalize()
    return result, fps


if __name__ == "__main__":
    main()
