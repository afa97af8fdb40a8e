"""Bjontegaard-Delta metrics CLI.

    python -m vcm_ts_tpu_torch.bd_rate --decod-dir DIR --out-path OUT \
        [--anchor NAME] [--method pchip|cubic|akima] [--compare-gop 1]

The port's counterpart of the root bd_rate.py: the same directory layout
(<decod-dir>/<codec>/<video>/quality_k/ beside quality_k_metrics.json, as
benchmark_plot writes them), the same bd_metrics.txt text, on the port's
eval/bd_metrics.py. The metrics are host numpy/scipy; `--device` (cuda
by default) is resolved as every entry point of the port resolves it.
"""

from __future__ import annotations

import argparse
import json
import os

from .eval.bd_metrics import bd_psnr, bd_rate, fix_curve
from .utils.device import resolve_device


def str2bool(s):
    return s.lower() in ("true", "1")


def _detection_models(metrics_entry):
    return sorted(metrics_entry.get("mean_ap", {}).keys())


def compute_bd(metrics, anchor, method, out_dir):
    """Every codec against the anchor codec, per video: BD-rate and BD-PSNR,
    and BD-rate / BD-mAP per detection model."""
    codecs = sorted(metrics.keys())
    videos = sorted(metrics[codecs[0]].keys())
    out_file = os.path.join(out_dir, "bd_metrics.txt")
    if os.path.exists(out_file):
        os.remove(out_file)
    for video in videos:
        rate_anchor = [info["bpp"] for info in metrics[anchor][video]]
        psnr_anchor = [info["psnr"] for info in metrics[anchor][video]]
        detection_models = _detection_models(metrics[codecs[0]][video][0])
        map_anchors = {
            m: fix_curve([info["mean_ap"][m]["map"]
                          for info in metrics[anchor][video]])
            for m in detection_models}

        for codec in codecs:
            if codec == anchor:
                continue
            rate_test = [info["bpp"] for info in metrics[codec][video]]
            psnr_test = [info["psnr"] for info in metrics[codec][video]]
            bdr = bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test,
                          method=method)
            bdp = bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test,
                          method=method)
            with open(out_file, "a") as f:
                f.write(f"Codec {codec} for {video}\n")
                f.write(f"\tBD-Rate (PSNR): {bdr:.4f} %\n")
                f.write(f"\tBD-PSNR: {bdp:.4f} dB\n")
            for m in detection_models:
                map_test = fix_curve([info["mean_ap"][m]["map"]
                                      for info in metrics[codec][video]])
                bdr_m = bd_rate(rate_anchor, map_anchors[m], rate_test,
                                map_test, method=method)
                bd_m = bd_psnr(rate_anchor, map_anchors[m], rate_test,
                               map_test, method=method)
                with open(out_file, "a") as f:
                    f.write(f"\tBD-mAP for model {m}\n")
                    f.write(f"\t\tBD-Rate (mAP): {bdr_m:.4f} %\n")
                    f.write(f"\t\tBD-mAP: {bd_m:.4f} %\n")


def compute_bd_gop(metrics, anchor, method, out_dir):
    """GOP-wise comparison mode: codec folders named "<name> gop<N>", each
    GOP size of a codec against its GOP `anchor`."""
    codecs = sorted(metrics.keys())
    videos = sorted(metrics[codecs[0]].keys())
    gop_metrics = {}
    out_file = os.path.join(out_dir, "bd_metrics.txt")
    if os.path.exists(out_file):
        os.remove(out_file)
    for codec in codecs:
        name = codec.split("gop")[0].strip()
        gop_metrics.setdefault(name, {})
        gop = str(metrics[codec][videos[0]][0]["gop"])
        gop_metrics[name][gop] = {v: metrics[codec][v] for v in videos}

    names = sorted(gop_metrics.keys())
    gops = list(map(str, sorted(map(int, gop_metrics[names[0]]))))

    for video in videos:
        for codec in names:
            rate_anchor = [i["bpp"] for i in gop_metrics[codec][anchor][video]]
            psnr_anchor = [i["psnr"] for i in gop_metrics[codec][anchor][video]]
            detection_models = _detection_models(
                gop_metrics[names[0]][gops[0]][video][0])
            map_anchors = {
                m: fix_curve([i["mean_ap"][m]["map"]
                              for i in gop_metrics[codec][anchor][video]])
                for m in detection_models}
            with open(out_file, "a") as f:
                f.write(f"Codec {codec} with anchor {anchor}:\n")
            for gop in gops:
                if gop == anchor:
                    continue
                rate_test = [i["bpp"] for i in gop_metrics[codec][gop][video]]
                psnr_test = [i["psnr"] for i in gop_metrics[codec][gop][video]]
                bdr = bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test,
                              method=method)
                bdp = bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test,
                              method=method)
                with open(out_file, "a") as f:
                    f.write(f"\tGOP {gop} for {video}\n")
                    f.write(f"\t\tBD-Rate (PSNR): {bdr:.4f} %\n")
                    f.write(f"\t\tBD-PSNR: {bdp:.4f} dB\n")
                for m in detection_models:
                    map_test = fix_curve(
                        [i["mean_ap"][m]["map"]
                         for i in gop_metrics[codec][gop][video]])
                    bdr_m = bd_rate(rate_anchor, map_anchors[m], rate_test,
                                    map_test, method=method)
                    bd_m = bd_psnr(rate_anchor, map_anchors[m], rate_test,
                                   map_test, method=method)
                    with open(out_file, "a") as f:
                        f.write(f"\t\tBD-mAP for model {m}\n")
                        f.write(f"\t\t\tBD-Rate (mAP): {bdr_m:.4f} %\n")
                        f.write(f"\t\t\tBD-mAP: {bd_m:.4f} %\n")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Bjøntegaard-Delta metrics calculation")
    parser.add_argument("--decod-dir", dest="decod_dir", type=str,
                        required=True, help="Path to decoded dir")
    parser.add_argument("--out-path", dest="out_path", type=str,
                        required=True, help="Path to output dir")
    parser.add_argument("--anchor", dest="anchor", type=str,
                        default="HEVC veryslow")
    parser.add_argument("--method", dest="method", type=str, default="pchip")
    parser.add_argument("--compare-gop", dest="compare_gop", type=str2bool,
                        default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    metrics = {}
    for codec_folder in (f for f in os.scandir(args.decod_dir) if f.is_dir()):
        metrics[codec_folder.name] = {}
        for video_folder in (f for f in os.scandir(codec_folder)
                             if f.is_dir()):
            entries = []
            qualities = sorted((f for f in os.scandir(video_folder)
                                if f.is_dir()), key=lambda f: f.name)
            for quality in qualities:
                metrics_json = quality.path + "_metrics.json"
                if not os.path.exists(metrics_json):
                    raise RuntimeError(f"No file with metrics for {quality}")
                with open(metrics_json) as f:
                    entries.append(json.load(f))
            metrics[codec_folder.name][video_folder.name] = entries

    os.makedirs(args.out_path, exist_ok=True)
    if args.compare_gop:
        compute_bd_gop(metrics, args.anchor, args.method, args.out_path)
    else:
        compute_bd(metrics, args.anchor, args.method, args.out_path)


if __name__ == "__main__":
    main()
