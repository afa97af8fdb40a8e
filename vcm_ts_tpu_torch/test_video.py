"""Codec evaluation harness: RD sweep over datasets x sequences x rate points.

    python -m vcm_ts_tpu_torch.test_video --test_config CFG.json \
        --output_path OUT.json [--model_path DMC.pth] \
        [--i_frame_model_path INTRA.pth] [--rate_num 4] [--write_stream 1] \
        [--batch_rates 1] [--device cuda|cpu]

The port's counterpart of the root test_video.py: the same CLI (plus
`--device`), JSON test-config schema (root_path, test_classes -> base_path,
test, sequences -> gop, frames), q-scale rules (the checkpoint's values, CLI
overrides, or a log-spaced ladder), per-frame I/P GOP loop, PSNR and MS-SSIM
per frame (on the device), and nested {dataset -> sequence -> rate -> log}
output JSON, written as the JAX harness writes it.

One process drives one device and runs the tasks one after another (or,
with --batch_rates, all rate points of a sequence through the batch axis of
every stage). Under torchrun (WORLD_SIZE > 1) each rank takes every
world-th task (tasks[rank::world]) on cuda:LOCAL_RANK and writes its own
<output_path>.rankK with no gather, as the JAX harness does. --fleet (with
--batch_rates) splits each batched call's rate rows over this process's
devices (codec/engine.py's fleet serving; fleet_mesh_size picks how many),
and with one device prints that fleet serving is disabled and runs as
before.

Without a .pth the codecs are the seeded damped inits of utils/weights
(IntraNoAR N=192, DMC 64/64/96), and the harness says so.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from .codec import bitstream as bs
from .codec.engine import IntraCodec, VideoCodec
from .codec.png_io import PNGReader, save_image
from .models.dmc import make_dpb
from .ops.msssim import ms_ssim, psnr as psnr_fn
from .utils import weights
from .utils.common import (create_folder, dump_json, generate_log_json,
                           interpolate_log, str2bool)
from .parallel import mesh as pm
from .utils.device import resolve_device, to_device
from .utils.profiling import HostTimers


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="codec testing script")
    parser.add_argument("--i_frame_model_path", type=str)
    parser.add_argument("--i_frame_q_scales", type=float, nargs="+")
    parser.add_argument("--force_intra", type=str2bool, nargs="?",
                        const=True, default=False)
    parser.add_argument("--force_frame_num", type=int, default=-1)
    parser.add_argument("--force_intra_period", type=int, default=-1)
    parser.add_argument("--model_path", type=str)
    parser.add_argument("--p_frame_y_q_scales", type=float, nargs="+")
    parser.add_argument("--p_frame_mv_y_q_scales", type=float, nargs="+")
    parser.add_argument("--rate_num", type=int, default=4)
    parser.add_argument("--test_config", type=str, required=True)
    parser.add_argument("--force_root_path", type=str, default=None)
    parser.add_argument("--worker", "-w", type=int, default=1)
    parser.add_argument("--fleet", type=str2bool, nargs="?",
                        const=True, default=False,
                        help="with --batch_rates: one rate-point row group "
                             "per local device (codec/engine.py fleet "
                             "serving)")
    parser.add_argument("--batch_rates", type=str2bool, nargs="?",
                        const=True, default=False,
                        help="run all rate points of a sequence through one "
                             "batched device pass")
    parser.add_argument("--write_stream", type=str2bool, nargs="?",
                        const=True, default=False)
    parser.add_argument("--stream_path", type=str, default="out_bin")
    parser.add_argument("--save_decoded_frame", type=str2bool, default=False)
    parser.add_argument("--decoded_frame_path", type=str,
                        default="decoded_frames")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--verbose", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _resolve_q_scales(ckpt_scales, cli_scales, rate_num, label):
    print(f"{label} in ckpt: " + "".join(f"{q:.3f}, " for q in ckpt_scales))
    if cli_scales is not None:
        assert len(cli_scales) == rate_num
        return np.asarray(cli_scales)
    if len(ckpt_scales) == rate_num:
        return np.asarray(ckpt_scales)
    return interpolate_log(ckpt_scales[-1], ckpt_scales[0], rate_num)


@torch.no_grad()
def _metrics(x_hat, x):
    """(PSNR, MS-SSIM) lists, one per row, computed on x_hat's device row
    by row: a reduction's order may follow the batch size, and a batched
    run's rows must measure as the rows run alone."""
    x = to_device(torch.from_numpy(x), x_hat.device)
    x_hat = x_hat.float()
    rows = [(psnr_fn(x_hat[i:i + 1], x[i:i + 1]),
             ms_ssim(x_hat[i:i + 1], x[i:i + 1]))
            for i in range(x.shape[0])]
    return ([float(p) for p, _ in rows], [float(m) for _, m in rows])


def run_test(video_codec, i_codec, task, verbose=0, timers=None):
    """Per-sequence GOP loop: I-frames every gop_size frames, chained
    P-frames between; real .bin streams with task["write_stream"], else the
    entropy-estimated forward. `timers` (utils/profiling.HostTimers), if
    given, takes each frame's wall time (coding and metrics, which wait
    for the device) under "i_frame" or "p_frame"."""
    frame_num = task["frame_num"]
    gop_size = task["gop_size"]
    write_stream = task.get("write_stream", False)
    save_decoded = task.get("save_decoded_frame", False)

    src_reader = PNGReader(task["img_path"])

    frame_types, psnrs, msssims, bits = [], [], [], []
    frame_pixel_num = 0

    start_time = time.time()
    p_frame_number = 0
    overall_p_encoding_time = 0.0
    overall_p_decoding_time = 0.0
    dpb = None
    is_first_p = True
    for frame_idx in range(frame_num):
        frame_start = time.time()
        rgb = src_reader.read_one_frame()
        x = rgb[None]  # (1, H, W, 3)
        pic_height, pic_width = x.shape[1], x.shape[2]
        if frame_pixel_num == 0:
            frame_pixel_num = pic_height * pic_width
        else:
            assert frame_pixel_num == pic_height * pic_width

        x_padded = bs.pad_image(x)
        bin_path = (os.path.join(task["bin_folder"], f"{frame_idx}.bin")
                    if write_stream else None)
        is_i = frame_idx % gop_size == 0
        with (timers.track("i_frame" if is_i else "p_frame")
              if timers is not None else contextlib.nullcontext()):
            if is_i:
                result = i_codec.encode_decode(
                    x_padded, task["i_frame_q_scale"], bin_path,
                    pic_height=pic_height, pic_width=pic_width)
                recon = torch.clamp(result["x_hat"], 0, 1)
                dpb = (make_dpb(recon, video_codec.model.channel_N,
                                video_codec.model.channel_M)
                       if video_codec is not None else None)
                is_first_p = True
                frame_types.append(0)
            else:
                result = video_codec.encode_decode(
                    x_padded, dpb, bin_path,
                    pic_height=pic_height, pic_width=pic_width,
                    mv_y_q_scale=task["p_frame_mv_y_q_scale"],
                    y_q_scale=task["p_frame_y_q_scale"],
                    is_first_p=is_first_p)
                dpb = result["dpb"]
                dpb["ref_frame"] = torch.clamp(dpb["ref_frame"], 0, 1)
                recon = dpb["ref_frame"]
                is_first_p = False
                frame_types.append(1)
                p_frame_number += 1
                overall_p_encoding_time += result.get("encoding_time", 0)
                overall_p_decoding_time += result.get("decoding_time", 0)
            bits.append(result["bit"])
            x_hat = recon[:, :pic_height, :pic_width, :]
            p, m = _metrics(x_hat, x)
        psnrs.append(p[0])
        msssims.append(m[0])

        if verbose >= 2:
            print(f"frame {frame_idx}, {time.time() - frame_start:.3f} s, "
                  f"bits: {bits[-1]:.1f}, PSNR: {psnrs[-1]:.4f}, "
                  f"MS-SSIM: {msssims[-1]:.4f}")
        if save_decoded:
            save_image(x_hat.float().cpu().numpy(),
                       os.path.join(task["decoded_frame_folder"],
                                    f"{frame_idx}.png"))

    test_time = time.time() - start_time
    if verbose >= 1 and p_frame_number > 0:
        print(f"encoding/decoding {p_frame_number} P frames, "
              f"avg enc {overall_p_encoding_time / p_frame_number * 1e3:.0f} "
              f"ms, avg dec "
              f"{overall_p_decoding_time / p_frame_number * 1e3:.0f} ms.")

    return generate_log_json(frame_num, frame_types, bits, psnrs, msssims,
                             frame_pixel_num, test_time)


def _q_rows(qs, write_stream):
    """Per-row q scales as an (N, 1, 1, 1) f32 array (rounded to the .bin
    container's q index with write_stream) and the q indexes."""
    qs = np.asarray(qs, np.float32)
    idx = None
    if write_stream:
        qs, idx = zip(*[bs.get_rounded_q(float(q)) for q in qs])
        qs = np.asarray(qs, np.float32)
    return qs.reshape(-1, 1, 1, 1), idx


@torch.no_grad()
def run_test_batched(video_codec, i_codec, tasks, verbose=0):
    """All rate points of one sequence in a single batched GOP loop: the
    rate-point axis rides the batch axis of every stage (compress_batch /
    decompress_batch / forward). Each row codes as if alone
    (ops/rowwise.py), so every log and every .bin equals the sequential
    run_test's."""
    n = len(tasks)
    t0 = tasks[0]
    frame_num, gop_size = t0["frame_num"], t0["gop_size"]
    write_stream = t0.get("write_stream", False)
    save_decoded = t0.get("save_decoded_frame", False)
    device = (video_codec or i_codec).device

    i_qs, i_q_idx = _q_rows([t["i_frame_q_scale"] for t in tasks],
                            write_stream)
    has_p = video_codec is not None
    if has_p:
        y_qs, y_q_idx = _q_rows([t["p_frame_y_q_scale"] for t in tasks],
                                write_stream)
        mv_qs, mv_q_idx = _q_rows(
            [t["p_frame_mv_y_q_scale"] for t in tasks], write_stream)

    src_reader = PNGReader(t0["img_path"])

    frame_types = []
    bits = [[] for _ in range(n)]
    psnrs = [[] for _ in range(n)]
    msssims = [[] for _ in range(n)]
    frame_pixel_num = 0
    start_time = time.time()
    dpb = None
    is_first_p = True
    for frame_idx in range(frame_num):
        rgb = src_reader.read_one_frame()
        x = rgb[None]
        pic_height, pic_width = x.shape[1], x.shape[2]
        frame_pixel_num = frame_pixel_num or pic_height * pic_width
        x_padded = bs.pad_image(x)
        padded_pixels = x_padded.shape[1] * x_padded.shape[2]
        x_tiled = to_device(torch.from_numpy(np.repeat(x_padded, n, 0)),
                            device)

        if frame_idx % gop_size == 0:
            frame_types.append(0)
            if write_stream:
                streams = i_codec.compress_batch(x_tiled, i_qs)
                rb = []
                for r, t in enumerate(tasks):
                    path = os.path.join(t["bin_folder"], f"{frame_idx}.bin")
                    bs.encode_i(pic_height, pic_width, i_q_idx[r],
                                streams[r], path)
                    bits[r].append(bs.filesize(path) * 8)
                    rb.append(bs.decode_i(path)[3])
                x_hat = i_codec.decompress_batch(rb, pic_height, pic_width,
                                                 i_qs)
            else:
                out = i_codec.forward(x_tiled, i_qs)
                x_hat = out["x_hat"]
                bpp = out["bpp"].tolist()
                for r in range(n):
                    bits[r].append(bpp[r] * padded_pixels)
            recon = torch.clamp(x_hat, 0, 1)
            dpb = (make_dpb(recon, video_codec.model.channel_N,
                            video_codec.model.channel_M) if has_p else None)
            is_first_p = True
        else:
            frame_types.append(1)
            if write_stream:
                enc = video_codec.compress_batch(x_tiled, dpb, mv_qs, y_qs,
                                                 is_first_p)
                rb = []
                for r, t in enumerate(tasks):
                    path = os.path.join(t["bin_folder"], f"{frame_idx}.bin")
                    bs.encode_p(enc["bit_streams"][r], mv_q_idx[r],
                                y_q_idx[r], path)
                    bits[r].append(bs.filesize(path) * 8)
                    rb.append(bs.decode_p(path)[2])
                out = video_codec.decompress_batch(
                    dpb, rb, pic_height, pic_width, mv_qs, y_qs, is_first_p)
                dpb = out["dpb"]
            else:
                out = video_codec.forward(x_tiled, dpb, mv_qs, y_qs,
                                          is_first_p)
                dpb = out["dpb"]
                bpp = out["bpp"].tolist()
                for r in range(n):
                    bits[r].append(bpp[r] * padded_pixels)
            dpb["ref_frame"] = torch.clamp(dpb["ref_frame"], 0, 1)
            recon = dpb["ref_frame"]
            is_first_p = False

        x_hat_rows = recon[:, :pic_height, :pic_width, :]
        p, m = _metrics(x_hat_rows, np.repeat(x, n, 0))
        if save_decoded:
            host = x_hat_rows.float().cpu().numpy()
        for r in range(n):
            psnrs[r].append(p[r])
            msssims[r].append(m[r])
            if save_decoded:
                save_image(host[r:r + 1],
                           os.path.join(tasks[r]["decoded_frame_folder"],
                                        f"{frame_idx}.png"))
        if verbose >= 2:
            print(f"frame {frame_idx} (x{n} rates), "
                  f"PSNR: {[round(psnrs[r][-1], 3) for r in range(n)]}")

    test_time = time.time() - start_time
    return [generate_log_json(frame_num, frame_types, bits[r], psnrs[r],
                              msssims[r], frame_pixel_num, test_time)
            for r in range(n)]


def fleet_mesh_size(tasks, n_local_devices):
    """(group_rows, fleet devices) for --fleet serving (the JAX harness's
    rule): the fleet must tile every batched group's rows, and group
    sizes are not always rate_num (a multi-process run strides the task
    list), so it takes the gcd of this process's per-(dataset, sequence)
    row counts, capped by the local device count."""
    import math

    rows = 0
    group_sizes = {}
    for task in tasks:
        key = (task["ds_name"], task["video_path"])
        group_sizes[key] = group_sizes.get(key, 0) + 1
    for size in group_sizes.values():
        rows = math.gcd(rows, size)
    if rows == 0:  # no tasks on this rank: gcd(0, n) = n would lie
        return 0, 1
    return rows, math.gcd(rows, n_local_devices)


def _local_devices(device) -> list:
    """This process's devices: its own card under torchrun (one rank per
    device), every card of the host in one process, or the CPU."""
    if device.type != "cuda":
        return [device]
    if pm.get_world_size() > 1:
        return [pm.local_device(device)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_codecs(args):
    """The engines, once for every task: .pth weights where given, else
    the seeded damped inits."""
    device = pm.local_device(args.device)

    def model(make, path, name):
        m = make(device)
        if path and os.path.exists(path):
            weights.load_codec_weights(m, path)
        else:
            print(f"{name}: no checkpoint given, using the seeded damped "
                  "init (utils/weights)")
        return m

    i_codec = IntraCodec(model(weights.make_intra, args.i_frame_model_path,
                               "I-frame model"), device=device)
    video_codec = None
    if not args.force_intra:
        video_codec = VideoCodec(model(weights.make_dmc, args.model_path,
                                       "P-frame model"), device=device)

    if args.write_stream:
        i_codec.update(force=True)
        if video_codec is not None:
            video_codec.update(force=True)
    return i_codec, video_codec


def _ckpt_pth(path):
    return bool(path) and os.path.exists(path) and path.endswith(".pth")


def main(argv=None, timers=None):
    """Runs the sweep and writes --output_path; returns the nested log.
    `timers`, a dict, if given, receives a utils/profiling.HostTimers per
    sequential task, keyed (dataset, sequence, rate index): each frame's
    wall time under "i_frame" or "p_frame"."""
    begin_time = time.time()
    args = parse_args(argv)
    if args.fleet and not args.batch_rates:
        raise SystemExit("--fleet requires --batch_rates")
    resolve_device(args.device)
    pm.initialize_distributed(device=args.device)

    with open(args.test_config) as f:
        config = json.load(f)

    rate_num = args.rate_num
    if _ckpt_pth(args.i_frame_model_path):
        ckpt_q = weights.get_i_frame_q_scales_from_ckpt(
            args.i_frame_model_path)
    else:
        ckpt_q = interpolate_log(0.3, 1.5, rate_num)
    i_frame_q_scales = _resolve_q_scales(ckpt_q, args.i_frame_q_scales,
                                         rate_num, "intra q_scales")

    if not args.force_intra:
        if _ckpt_pth(args.model_path):
            y_q, mv_q = weights.get_q_scales_from_ckpt(args.model_path)
        else:
            y_q = interpolate_log(0.3, 1.5, rate_num)
            mv_q = interpolate_log(0.3, 1.5, rate_num)
        p_frame_y_q_scales = _resolve_q_scales(
            y_q, args.p_frame_y_q_scales, rate_num, "y_q_scales")
        p_frame_mv_y_q_scales = _resolve_q_scales(
            mv_q, args.p_frame_mv_y_q_scales, rate_num, "mv_y_q_scales")

    i_codec, video_codec = build_codecs(args)

    root_path = args.force_root_path or config["root_path"]
    config = config["test_classes"]

    tasks = []
    count_frames = 0
    count_sequences = 0
    for ds_name in config:
        if config[ds_name]["test"] == 0:
            continue
        for seq_name in config[ds_name]["sequences"]:
            count_sequences += 1
            seq_cfg = config[ds_name]["sequences"][seq_name]
            for rate_idx in range(rate_num):
                task = {
                    "rate_idx": rate_idx,
                    "i_frame_q_scale": float(i_frame_q_scales[rate_idx]),
                    "video_path": seq_name,
                    "ds_name": ds_name,
                    "gop_size": (1 if args.force_intra else
                                 (args.force_intra_period
                                  if args.force_intra_period > 0
                                  else seq_cfg["gop"])),
                    "frame_num": (args.force_frame_num
                                  if args.force_frame_num > 0
                                  else seq_cfg["frames"]),
                    "img_path": os.path.join(
                        root_path, config[ds_name]["base_path"], seq_name),
                    "write_stream": args.write_stream,
                    "save_decoded_frame": args.save_decoded_frame,
                }
                if not args.force_intra:
                    task["p_frame_y_q_scale"] = float(
                        p_frame_y_q_scales[rate_idx])
                    task["p_frame_mv_y_q_scale"] = float(
                        p_frame_mv_y_q_scales[rate_idx])
                if args.write_stream:
                    task["bin_folder"] = os.path.join(
                        args.stream_path, seq_name, str(rate_idx))
                    create_folder(task["bin_folder"], True)
                if args.save_decoded_frame:
                    task["decoded_frame_folder"] = os.path.join(
                        f"{args.decoded_frame_path}_DMC_{rate_idx}", seq_name)
                    create_folder(task["decoded_frame_folder"])
                count_frames += task["frame_num"]
                tasks.append(task)

    # multi-process sweeps: each rank runs every world-th task and writes
    # its own <output_path>.rankK holding only those (no gather)
    world = pm.get_world_size()
    if world > 1:
        tasks = tasks[pm.get_rank()::world]
        args.output_path = f"{args.output_path}.rank{pm.get_rank()}"

    if args.fleet:
        devices = _local_devices(pm.local_device(args.device))
        rows, n_dev = fleet_mesh_size(tasks, len(devices))
        if n_dev > 1:
            for codec in (i_codec, video_codec):
                if codec is not None:
                    codec.set_fleet_sharding(devices[:n_dev])
            print(f"fleet serving over {n_dev} local devices "
                  f"({rows}-row rate groups)")
        else:
            print("fleet serving disabled: group row count "
                  f"({rows}) shares no factor with the local device "
                  f"count ({len(devices)})")

    results = []
    if args.batch_rates:
        groups = {}
        for task in tasks:
            groups.setdefault((task["ds_name"], task["video_path"]),
                              []).append(task)
        for group in groups.values():
            group.sort(key=lambda t: t["rate_idx"])
            logs = run_test_batched(video_codec, i_codec, group,
                                    verbose=args.verbose)
            for task, res in zip(group, logs):
                res["ds_name"] = task["ds_name"]
                res["video_path"] = task["video_path"]
                res["rate_idx"] = task["rate_idx"]
                results.append(res)
    else:
        for task in tasks:
            task_timers = HostTimers()
            res = run_test(video_codec, i_codec, task, verbose=args.verbose,
                           timers=task_timers)
            if timers is not None:
                timers[(task["ds_name"], task["video_path"],
                        task["rate_idx"])] = task_timers
            if args.verbose >= 1:
                print(f"rate {task['rate_idx']}: " + ", ".join(
                    f"{k} {v['mean_ms']:.1f} ms x{v['count']}"
                    for k, v in sorted(task_timers.report().items())))
            res["ds_name"] = task["ds_name"]
            res["video_path"] = task["video_path"]
            res["rate_idx"] = task["rate_idx"]
            results.append(res)

    log_result = {}
    for res in results:
        log_result.setdefault(res["ds_name"], {}).setdefault(
            res["video_path"], {})[f"{res['rate_idx']:03d}"] = res

    out_dir = os.path.dirname(args.output_path)
    if out_dir:
        create_folder(out_dir, True)
    with open(args.output_path, "w") as fp:
        dump_json(log_result, fp, float_digits=6, indent=2)

    print("Test finished")
    print(f"Tested {count_frames} frames from {count_sequences} sequences")
    print(f"Total elapsed time: {(time.time() - begin_time) / 60:.1f} min")
    return log_result


if __name__ == "__main__":
    main()
