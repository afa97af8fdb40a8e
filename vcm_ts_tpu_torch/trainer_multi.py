"""Multi-process training CLI: one process per GPU.

    torchrun --standalone --nproc-per-node N \
        -m vcm_ts_tpu_torch.trainer_multi --config-file CFG.yaml \
        [--fsdp] [--device cuda|cpu] [--seed 0] [KEY VALUE ...]

(`torchrun` is `python -m torch.distributed.run`.) The port's counterpart
of the root trainer_multi.py: torchrun's RANK, WORLD_SIZE and LOCAL_RANK
start the process group (parallel/mesh.initialize_distributed: NCCL on
cuda:LOCAL_RANK, gloo with --device cpu), rank 0 writes OUTPUT_DIR and
cfg.yaml while the others wait at a barrier, every rank builds the same
seeded DMC and reads the checkpoint or PRETRAINED_WEIGHTS, each rank's
loader takes its shard of every epoch (DistributedSampler-style,
SOLVER.LAMBDAS rows a rank), the test and object-detection loaders exist
on rank 0 only, and the stage curriculum runs data parallel over the
"data" mesh (train/train_loop.do_train with mesh=; the lr scales by
sqrt(world size)), or fully sharded with --fsdp.
--tp > 1 (tensor parallelism) raises: it waits for ROADMAP.md Queue 1
item 7. --fsdp and --tp exclude each other, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from .data import make_data_loader, make_object_detection_data_loader
from .eval.detector import build_eval_detector
from .models.dmc import DMC
from .parallel import mesh as pm
from .parallel.tensor import check_tp
from .train.checkpoint import CheckPointer
from .train.losses import get_perceptual_loss
from .train.train_loop import do_train
from .trainer import _i_frame_fn
from .utils.common import enable_debug_nans
from .utils.config import default_training_cfg
from .utils.logger import setup_logger
from .utils.weights import init_params


def main(argv=None):
    parser = argparse.ArgumentParser(description="DCVC-HEM multi-process "
                                                 "training")
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel width; > 1 waits for "
                             "ROADMAP.md Queue 1 item 7")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard weights, gradients and Adam moments "
                             "over the ranks (torch fully_shard)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; one rank per device) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="overrides: KEY VALUE pairs")
    args = parser.parse_args(argv)
    if args.fsdp and args.tp > 1:
        raise SystemExit("--fsdp and --tp are mutually exclusive (TP "
                         "already shards the weights, over 'model')")
    check_tp(args.tp)

    pm.initialize_distributed(device=args.device)
    rank, world_size = pm.get_rank(), pm.get_world_size()
    device = pm.local_device(args.device)

    cfg = default_training_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    if rank == 0:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(os.path.join(cfg.OUTPUT_DIR, "cfg.yaml"), "w") as f:
            f.write(cfg.dump())
    pm.synchronize()

    logger = setup_logger("CORE", rank, cfg.OUTPUT_DIR if rank == 0 else "")
    logger.info("world_size=%d rank=%d device=%s", world_size, rank,
                device)
    if cfg.SOLVER.DEBUG_NANS:
        enable_debug_nans()
        logger.info("autograd anomaly mode ON (debug only: slow)")

    cmv, cn, cm = cfg.MODEL.CHANNELS
    model = init_params(DMC(anchor_num=len(cfg.SOLVER.LAMBDAS),
                            channel_mv=cmv, channel_N=cn, channel_M=cm,
                            device=device), seed=args.seed)

    # every rank reads; do_train writes from rank 0 alone
    checkpointer = CheckPointer(cfg.OUTPUT_DIR, logger)
    start_epoch = 0
    resume_opt_state = None
    if cfg.MODEL.PRETRAINED_WEIGHTS or checkpointer.has_checkpoint():
        extra = checkpointer.load(
            model, path=cfg.MODEL.PRETRAINED_WEIGHTS or None)
        start_epoch = int(extra.get("epoch", 0))
        resume_opt_state = checkpointer.load_opt_state(
            path=cfg.MODEL.PRETRAINED_WEIGHTS or None)

    i_frame_fn = (_i_frame_fn(cfg, device, logger)
                  if cfg.MODEL.I_FRAME_PRETRAINED_WEIGHTS else None)
    pl_fn = None
    if any(stage[7] == "true" for stage in cfg.SOLVER.STAGES):
        pl_fn = get_perceptual_loss(cfg, device, seed=args.seed)

    # this rank's shard of every epoch; SOLVER.LAMBDAS rows a rank
    train_loader = make_data_loader(cfg, args.seed, is_train=True,
                                    rank=rank, world_size=world_size)
    test_loader = (make_data_loader(cfg, args.seed, is_train=False)
                   if rank == 0 and cfg.DATASET.TEST_ROOT_DIRS else None)
    od_loader = detector_fn = None
    if (rank == 0 and cfg.DATASET.TEST_OD_ROOT_DIRS
            and len(cfg.SOLVER.STAGES) + 1 > cfg.DATASET.OD_STAGE):
        od_loader = make_object_detection_data_loader(cfg)
        detector_fn = build_eval_detector(cfg, device=device)

    # one process without torchrun: no group, no mesh (--fsdp then raises)
    mesh = (pm.make_global_mesh(device_type=device.type)
            if dist.is_initialized() else None)
    if args.fsdp and mesh is None:
        raise SystemExit("--fsdp shards over the ranks of a process group: "
                         "start under torchrun (python -m "
                         "torch.distributed.run)")
    if args.fsdp:
        logger.info("FSDP: weights, gradients and Adam moments sharded "
                    "over 'data' (%d-way)", world_size)
    return do_train(cfg, model, train_loader, checkpointer,
                    start_epoch=start_epoch, seed=args.seed,
                    test_loader=test_loader, i_frame_fn=i_frame_fn,
                    pl_fn=pl_fn, mesh=mesh, od_loader=od_loader,
                    detector_fn=detector_fn,
                    resume_opt_state=resume_opt_state,
                    fsdp=args.fsdp)


if __name__ == "__main__":
    main()
