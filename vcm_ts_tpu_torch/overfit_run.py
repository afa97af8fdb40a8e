"""Synthetic-clip overfit run: convergence and trained-weights evidence
(the port's counterpart of the JAX package's tools/overfit_run.py).

Drives the REAL training loop (train/train_loop.do_train: the stage
curriculum, the stage optimizer's freeze masks, the metric writer) on an
in-memory synthetic moving sequence until it visibly overfits, then, with
--bf16-check, measures the bf16-vs-f32 recon agreement on the TRAINED
weights. Six stages run (me -> rec -> all, single frame, then the
all-cascade), so the run crosses every kind of stage transition; --p4
appends the reference curriculum's p_frames=4 cascade stage.

Usage (one H100, published widths):
  python -m vcm_ts_tpu_torch.overfit_run --iters 60 --size 256 \
      --out artifacts/overfit --bf16-check
CPU smoke (tiny widths 16/16/24, 64x64, two anchors):
  python -m vcm_ts_tpu_torch.overfit_run --device cpu --tiny --iters 6

Prints a per-stage table and a final JSON verdict line; exits non-zero if
the run did not converge (loss down in at least two stages, eval PSNR up
by more than 10 dB). Writes OUT/overfit_final.pt (a port checkpoint whose
epoch stamp is the curriculum's end, so a rerun over a finished OUT
resumes past the end and trains nothing) and OUT/overfit_final.pth (the
DMC's state_dict with its q-scale tables, which utils/weights
.load_codec_weights, bf16_bd_gate and test_video --model_path read). Each
epoch's checkpoint lets a killed run resume where it stopped, with the
optimizer's moments when it stopped mid-stage. The metrics go to
OUT/metrics.jsonl only (no TensorBoard files); the verdict reads them
back.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

from .models.dmc import DMC, make_dpb
from .train.checkpoint import CheckPointer
from .train.stages import calc_max_epoch
from .train.tensorboard import MetricWriter
from .train.train_loop import do_train
from .utils.config import default_training_cfg
from .utils.device import resolve_device, set_codec_numerics
from .utils.precision import cast_params
from .utils.weights import init_params


def make_synthetic_batch(n_rows, t, size, seed=0):
    """Moving synthetic content: smooth low-frequency pattern translating
    ~2 px/frame with light temporal noise — flow magnitudes the motion
    branch can actually learn. (N, T, H, W, 3) float32, numpy only (the
    JAX tool's draws, bit for bit)."""
    rng = np.random.default_rng(seed)
    base = rng.random((n_rows, size + 16, size + 16, 3)).astype(np.float32)
    # low-pass via box blurs to make content piecewise smooth
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)
                + np.roll(base, -1, 1) + np.roll(base, -1, 2)) / 5
    frames = []
    for i in range(t):
        shifted = np.roll(base, 2 * i, axis=2)[:, 8:8 + size, 8:8 + size]
        frames.append(shifted)
    seq = np.stack(frames, axis=1)  # (N, T, H, W, C)
    seq += 0.01 * rng.standard_normal(seq.shape).astype(np.float32)
    return np.clip(seq, 0, 1).astype(np.float32)


class OverfitLoader:
    """Fixed batch replayed `iters` times per epoch (the overfit target)."""

    def __init__(self, batch, iters):
        self.batch = batch
        self.iters = iters

    def __len__(self):
        return self.iters

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        for _ in range(self.iters):
            yield self.batch, self.batch


def build_cfg(args, channels, lambdas):
    """The overfit run's training config (factored out for wiring tests)."""
    lr = str(args.lr)
    e = str(args.epochs)
    cfg = default_training_cfg()
    cfg.MODEL.CHANNELS = channels
    cfg.SOLVER.LAMBDAS = lambdas
    # from-scratch training (the reference never does this — it fine-tunes
    # pretrained DCVC weights) needs gradient clipping: random-init rate
    # estimates are astronomically large and their gradients blow up the
    # recurrent DPB chain
    cfg.SOLVER.GRAD_CLIP_NORM = 1.0
    # --mp: the bf16-compute / f32-master regime (SOLVER.MIXED_PRECISION);
    # getattr: callers (tests) may pass a bare args object without it
    cfg.SOLVER.MIXED_PRECISION = bool(getattr(args, "mp", False))
    # cascade stage: remat + G=2 anchor-microbatch accumulation, as the
    # JAX tool's default
    cfg.SOLVER.GRAD_ACCUM_STEPS = int(getattr(args, "grad_accum", 2))
    # the reference curriculum shape (training_settings.py:55-66): dist-only
    # before each rate stage, single-frame before cascade
    cascade_lr = str(args.lr / 2)  # reference drops lr for cascade stages
    cfg.SOLVER.STAGES = [
        ["1", "me", "single", "me", "none", lr, e, "false"],
        ["1", "me", "single", "me", "me", lr, e, "false"],
        ["1", "rec", "single", "rec", "none", lr, e, "false"],
        ["1", "rec", "single", "rec", "rec", lr, e, "false"],
        ["1", "all", "single", "rec", "all", lr, e, "false"],
        ["2", "all", "cascade", "rec", "all", cascade_lr, e, "false"],
    ]
    seq_len = 3
    if getattr(args, "p4", False):
        # the reference curriculum's real final depth: p_frames=4 cascade
        # (reference training_settings.py:55-66). Needs a 5-frame sequence.
        cfg.SOLVER.STAGES.append(
            ["4", "all", "cascade", "rec", "all", cascade_lr, e, "false"])
        seq_len = 5
    cfg.DATASET.SEQUENCE_LENGTH = seq_len
    cfg.OUTPUT_DIR = args.out
    cfg.TENSORBOARD.BEST_SAMPLES_NUM = 0
    cfg.TENSORBOARD.WORST_SAMPLES_NUM = 0
    cfg.freeze()
    return cfg


def read_verdict(out_dir: str) -> tuple[bool, dict]:
    """The per-stage table and the convergence verdict from
    OUT/metrics.jsonl (printed as they are read)."""
    records = []
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        for line in f:
            records.append(json.loads(line))
    stage_by_step = {r["step"]: int(r["value"]) for r in records
                     if r["tag"] == "train/stage"}
    # a killed-and-resumed run re-appends the dying stage's steps: keep only
    # the LAST record per (tag, step) so stale pre-death values don't mix in
    loss_by_step = {}
    psnr_by_step = {}
    for r in records:
        if r["tag"].startswith("train/loss/") and r["step"] in stage_by_step:
            loss_by_step[(r["tag"], r["step"])] = r["value"]
        elif r["tag"].startswith("eval/psnr/"):
            psnr_by_step[(r["tag"], r["step"])] = r["value"]
    per_stage = {}
    for (_, step), value in loss_by_step.items():
        s = stage_by_step[step]
        per_stage.setdefault(s, {"steps": []})["steps"].append((step, value))
    eval_psnr = sorted((step, v) for (_, step), v in psnr_by_step.items())

    print("\nstage | first-loss | last-loss | improved")
    stage_results = {}
    for s, d in sorted(per_stage.items()):
        steps = sorted(d["steps"])
        if len(steps) < 2:
            continue
        k = max(1, len(steps) // 8)
        first = float(np.mean([v for _, v in steps[:k]]))
        last = float(np.mean([v for _, v in steps[-k:]]))
        improved = last < first
        stage_results[s] = {"first": first, "last": last,
                            "improved": improved}
        print(f"{s:5d} | {first:10.4f} | {last:9.4f} | {improved}")

    # convergence bar: loss down through at least two stage transitions,
    # eval PSNR up materially over the run. me-only stages can plateau
    # quickly from scratch; requiring every stage to improve
    # over-constrains a short overfit.
    n_improved = sum(1 for d in stage_results.values() if d["improved"])
    ok = n_improved >= 2

    psnr_first = psnr_last = None
    if eval_psnr:
        psnr_first, psnr_last = eval_psnr[0][1], eval_psnr[-1][1]
        best = max(v for _, v in eval_psnr)
        print(f"eval psnr: {psnr_first:.2f} -> {psnr_last:.2f} dB "
              f"(best {best:.2f})")
        ok = ok and (psnr_last > psnr_first + 10.0)
    return ok, {"converged": bool(ok), "stages": stage_results,
                "eval_psnr_first": psnr_first, "eval_psnr_last": psnr_last}


@torch.no_grad()
def bf16_agreement(model, batch, channels) -> dict:
    """bf16-cast parameters against f32 on the trained weights: one
    P-frame forward (is_first_p, no noise) of the batch's frame 1 off
    frame 0; recon agreement PSNR and the relative bpp change."""
    dev = next(model.parameters()).device
    model.eval()
    bp = cast_params(copy.deepcopy(model), torch.bfloat16)
    x_f = torch.from_numpy(batch[:, 1]).to(dev)
    dpb_f = make_dpb(torch.from_numpy(batch[:, 0]).to(dev), channels[1],
                     channels[2])
    out_f = model(x_f, dpb_f, 1.0, 1.0, True)
    dpb_b = {k: v.to(torch.bfloat16) for k, v in dpb_f.items()}
    out_b = bp(x_f.to(torch.bfloat16), dpb_b, 1.0, 1.0, True)
    rf = out_f["dpb"]["ref_frame"].float().cpu().numpy()
    rb = out_b["dpb"]["ref_frame"].float().cpu().numpy()
    agree_psnr = float(-10 * np.log10(np.mean((rf - rb) ** 2) + 1e-12))
    bpp_f = float(np.mean(out_f["bpp"].float().cpu().numpy()))
    bpp_b = float(np.mean(out_b["bpp"].float().cpu().numpy()))
    return {"bf16_recon_agreement_db": round(agree_psnr, 2),
            "bpp_f32": round(bpp_f, 5),
            "bpp_bf16_rel_delta": round((bpp_b - bpp_f) / max(bpp_f, 1e-9),
                                        5)}


def run(args):
    """Train, print the table and the verdict; returns the exit code,
    do_train's record (per epoch its seconds and kernel launches) and the
    verdict."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_codec_numerics()
    if args.tiny:
        channels, size, lambdas = [16, 16, 24], 64, [85.0, 170.0]
    else:
        channels, size, lambdas = [64, 64, 96], args.size, \
            [85.0, 170.0, 380.0, 840.0]

    cfg = build_cfg(args, channels, lambdas)
    seq_len = cfg.DATASET.SEQUENCE_LENGTH
    os.makedirs(args.out, exist_ok=True)

    model = init_params(DMC(anchor_num=len(lambdas), channel_mv=channels[0],
                            channel_N=channels[1], channel_M=channels[2],
                            device=device), seed=args.seed)

    batch = make_synthetic_batch(len(lambdas), seq_len, size,
                                 seed=args.seed)
    loader = OverfitLoader(batch, args.iters)
    test_loader = OverfitLoader(batch, 1)

    # Per-epoch checkpointing + auto-resume: with epochs == 1 per stage
    # every epoch boundary is a stage boundary, so a killed run resumes at
    # the stage it died in; with --epochs > 1 a resume can land mid-stage,
    # and do_train restores the saved moments there.
    ckpt = CheckPointer(args.out)
    start_epoch = 0
    resume_opt_state = None
    if ckpt.has_checkpoint():
        extra = ckpt.load(model)
        start_epoch = int(extra.get("epoch", 0))
        resume_opt_state = ckpt.load_opt_state()
        print(f"resuming from epoch {start_epoch} "
              f"({ckpt.get_checkpoint_file()})")
    elif args.init_from:
        # warm start: e.g. --p4 over a completed 6-stage run's final
        # checkpoint (its epoch stamp = the 6-stage max_epoch) drops
        # straight into the appended p4 cascade stage
        extra = ckpt.load(model, path=args.init_from, use_latest=False)
        start_epoch = int(extra.get("epoch", 0))
        print(f"warm start from {args.init_from} (epoch {start_epoch})")

    writer = MetricWriter(args.out, enable_tb=False)
    try:
        record = do_train(cfg, model, loader, ckpt, start_epoch=start_epoch,
                          seed=args.seed, test_loader=test_loader,
                          writer=writer, resume_opt_state=resume_opt_state)
    finally:
        writer.close()
    for e in record["epochs"]:
        print(f"epoch {e['epoch']} (stage {e['stage']}): {e['frames']} "
              f"frames in {e['train_s']:.3f} s "
              f"({e['frames'] / max(e['train_s'], 1e-9):.2f} frames/s), "
              f"eval {e['eval_s']:.3f} s, checkpoint "
              f"{e['checkpoint_s']:.3f} s")

    ok, verdict = read_verdict(args.out)

    # ---- persist trained weights for downstream checks -------------------
    # the epoch stamp keeps last_checkpoint.txt resume-consistent: a rerun
    # over a completed output dir resumes past the end (no-op) instead of
    # restarting stage 0 with trained weights
    ckpt.save("overfit_final", model, None,
              epoch=calc_max_epoch(cfg.SOLVER.STAGES))
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(args.out, "overfit_final.pth"))

    # ---- bf16 agreement on TRAINED weights -------------------------------
    if args.bf16_check:
        verdict.update(bf16_agreement(model, batch, channels))
        print(f"bf16-vs-f32 on trained weights: recon agreement "
              f"{verdict['bf16_recon_agreement_db']:.1f} dB, bpp delta "
              f"{100 * verdict['bpp_bf16_rel_delta']:.2f}%")

    print(json.dumps(verdict))
    return (0 if ok else 1), record, verdict


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=60,
                    help="iterations per epoch")
    ap.add_argument("--epochs", type=int, default=1,
                    help="epochs per stage")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny channels + 64x64 (CPU smoke)")
    ap.add_argument("--out", default="artifacts/overfit")
    ap.add_argument("--bf16-check", action="store_true",
                    help="re-validate bf16 agreement on the trained weights")
    ap.add_argument("--mp", action="store_true",
                    help="train under SOLVER.MIXED_PRECISION (bf16 compute, "
                         "f32 master params/moments)")
    ap.add_argument("--init-from", default=None,
                    help="warm-start checkpoint when the output dir has no "
                         "resume tag (e.g. a completed 6-stage run's "
                         "overfit_final.pt before a --p4 extension)")
    ap.add_argument("--p4", action="store_true",
                    help="append the reference curriculum's final depth: "
                         "a p_frames=4 cascade stage (5-frame sequences)")
    ap.add_argument("--grad-accum", type=int, default=2,
                    help="SOLVER.GRAD_ACCUM_STEPS for the cascade stage")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    raise SystemExit(main())
