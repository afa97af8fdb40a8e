"""Benchmark metrics (and RD plots) over decoded directories.

    python -m vcm_ts_tpu_torch.benchmark_plot --config CFG.json \
        --decod-dir DIR --out-path OUT [--use-ms-ssim 1] [--device cuda|cpu]

The port's counterpart of the root benchmark_plot.py, same flow and files:
read the ground-truth annotation dumps (object / license detection, license
recognition), run the detectors on the decoded frames, compute mAP / mAP50
(and per class), the OCR text-match metrics and PSNR / MS-SSIM (on the
device, ops/msssim.py), cache them per quality as *_metrics.json, and plot.

- YOLO detection and plate OCR run the port's native modules
  (eval/yolo_native.py on a tools/export_yolo_detector.py .npz,
  eval/ocr_native.py on pretrained/plate_ocr.npz).
- Faster-RCNN (`build_rcnn`) runs the port's native detector
  (eval/rcnn_native.py) on
  pretrained/fasterrcnn_resnet50_fpn_v2_coco-dd69338a.pth at torchvision's
  default sizes (min 800, max 1333), as the root script's native branch;
  without the file it raises and names it.
- `plot_graphs` needs matplotlib, which it imports itself: without it, it
  raises and names the package; the metrics need none of it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
from glob import glob

import numpy as np
import torch

from .codec.png_io import PNGReader
from .eval.detection_metrics import MeanAveragePrecision
from .eval.ocr_native import PlateOCRNative
from .eval.text_metrics import calculate_ocr_metrics
from .eval.yolo_native import YOLOv8NativeDetector
from .ops.msssim import ms_ssim, psnr as psnr_fn
from .utils.device import resolve_device, to_device

# Plot-label strings and line styles of the JAX package's benchmark_plot.py
# (the reference's, verbatim): output-compatibility constants so
# plots from either framework are directly comparable, incl. the RU locale.
labels = {
    "en": {
        "orig_performance": "Original performance ({0:.2f}%)",
        "loss_1": "1% mAP loss",
        "loss_2": "2% mAP loss",
        "obj_performance": "Object detection performance on {0} for {1}",
        "class_performance":
            "Object detection performance for class {0} on {1} for {2}",
        "matching": "Text matching on {0} for {1}",
        "matching_value": "Metric value, %",
        "rd_curve_psnr": "Rate and distortion curves (PSNR) for {0}",
        "rd_curve_ssim": "Rate and distortion curves (MS-SSIM) for {0}",
        "rd_metric_psnr": "PSNR, db",
        "bbp_per_frame": "Bpp per frame for codec {0} and video {1}",
    },
    "ru": {
        "orig_performance": "Исходная точность ({0:.2f}%)",
        "loss_1": "1% mAP потери",
        "loss_2": "2% mAP потери",
        "obj_performance":
            "Сравнение зависимости mAP модели {0} от bpp для видео {1}",
        "class_performance":
            "Сравнение зависимости mAP для класса {0} модели {1} от bpp "
            "для видео {2}",
        "matching": "Соответствие текста по метрике {0} от bpp для видео {1}",
        "matching_value": "Значение метрики, %",
        "rd_curve_psnr": "Сравнение зависимости PSNR от bpp для видео {0}",
        "rd_curve_ssim": "Сравнение зависимости MS-SSIM от bpp для видео {0}",
        "rd_metric_psnr": "PSNR, Дб",
        "bbp_per_frame":
            "Сравнение зависимости bpp от номера кадра в GOP для кодека {0} "
            "и видео {1}",
    },
}
line_styles = ["o-", "v--", "s-.", "*:"]
line_colors = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
               "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"]


# ------------------------------------------------------------- adapters

def build_rcnn(device="cuda", weights=None):
    """The native Faster-RCNN on a torchvision v2 checkpoint (`weights`,
    else the repository's pretrained/ file); labels offset by the
    caller's labels_start_index."""
    from .eval.rcnn_native import FasterRCNNNativeDetector
    from .train.losses import RCNN_WEIGHTS
    from .utils.weights import PRETRAINED

    weights = weights or os.path.join(PRETRAINED, RCNN_WEIGHTS)
    if not os.path.exists(weights):
        raise FileNotFoundError(
            f"Faster-RCNN inference needs {weights}, which is not in the "
            "repository")
    det_native = FasterRCNNNativeDetector.load_pth(weights, device=device)

    def det(rgb, labels_start_index):
        if rgb.dtype != np.uint8:
            rgb = np.rint(rgb * 255).clip(0, 255).astype(np.uint8)
        out = det_native.detect(rgb)
        out["labels"] = out["labels"] + labels_start_index
        return out

    det.detector = det_native
    return det


def build_yolo(weights, device="cuda"):
    """The port's native YOLOv8 on a .npz: `weights` names the .npz, or a
    .pt whose sibling .npz (tools/export_yolo_detector.py) is read."""
    native = weights if weights.endswith(".npz") else (
        os.path.splitext(weights)[0] + ".npz")
    if not os.path.exists(native):
        raise FileNotFoundError(
            f"YOLO inference needs {native} (export it once with "
            "tools/export_yolo_detector.py)")
    det_native = YOLOv8NativeDetector.load(native, device=device)

    def det(rgb, labels_start_index):
        # callers hand float [0,1] RGB (png_io readers); detect_padded
        # expects uint8 pixels
        if rgb.dtype != np.uint8:
            rgb = np.rint(rgb * 255).clip(0, 255).astype(np.uint8)
        boxes, scores, labels = det_native.detect_padded(rgb)
        return {"boxes": boxes,
                "labels": labels.astype(np.int64) + labels_start_index,
                "scores": scores}

    return det


def build_ocr(device="cuda"):
    """The port's native CRNN-CTC plate recognizer."""
    native = os.environ.get(
        "VCM_PLATE_OCR_NPZ", os.path.join("pretrained", "plate_ocr.npz"))
    if not os.path.exists(native):
        raise FileNotFoundError(
            f"plate OCR needs {native} (train it once with "
            f"tools/train_plate_ocr.py --out {native})")
    ocr_native = PlateOCRNative.load(native, device=device)

    def run(rgb, boxes):
        return [re.sub("[^A-Z0-9]+", "", t.upper())
                for t in ocr_native(rgb, boxes)]

    return run


# --------------------------------------------------------- annotation io

def read_object_detection(path):
    boxes, lab = [], []
    with open(path) as f:
        for line in f.readlines():
            e = list(map(int, line.split()))
            boxes.append(e[1:5])
            lab.append(e[0])
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(lab, np.int64)}


def read_license_detection(path):
    boxes = []
    with open(path) as f:
        for line in f.readlines():
            boxes.append(list(map(int, line.split())))
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.zeros(len(boxes), np.int64)}


def read_license_recognition(path):
    boxes, texts = [], []
    with open(path) as f:
        for line in f.readlines():
            e = line.split()
            boxes.append(list(map(int, e[1:5])))
            texts.append(e[0])
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "texts": texts}


def delete_unsupported_annotations(annotations, classes):
    """Keep the detections whose label is one of the dataset's classes."""
    for key in annotations.keys():
        if key in ("yolo_lp_detection", "ocr_result") or not annotations[key]:
            continue
        for ann in annotations[key]:
            mask = np.isin(ann["labels"], classes)
            ann["boxes"] = ann["boxes"][mask]
            ann["labels"] = ann["labels"][mask]
            ann["scores"] = ann["scores"][mask]


def calculate_mean_ap(annotations, dataset, video_name):
    """mAP and mAP50 (x100) per detection model, per class for the object
    detectors."""
    mean_ap = {}
    for model in annotations.keys():
        if model == "ocr_result" or not annotations[model]:
            continue
        if model in ("rcnn", "yolo_detection"):
            gt = dataset[video_name]["annotations"]["object_detection"]
        elif model == "yolo_lp_detection":
            gt = dataset[video_name]["annotations"]["license_detection"]
        else:
            raise RuntimeError("Invalid model type for calculate metrics")
        m = MeanAveragePrecision()
        m50 = MeanAveragePrecision(iou_thresholds=[0.5])
        for pred, target in zip(annotations[model], gt):
            m.update(pred, target)
            m50.update(pred, target)
        res, res50 = m.compute(), m50.compute()
        entry = {"class_map": {}, "class_map_50": {},
                 "map": res["map"] * 100, "map_50": res["map_50"] * 100}
        if model in ("rcnn", "yolo_detection"):
            names = dataset[video_name]["class_names"]
            ids = dataset[video_name]["classes"]
            for ap, cid in zip(res["map_per_class"], res["classes"]):
                entry["class_map"][names[ids.index(cid)]] = float(ap) * 100
            for ap, cid in zip(res50["map_per_class"], res50["classes"]):
                entry["class_map_50"][names[ids.index(cid)]] = float(ap) * 100
        mean_ap[model] = entry
    return mean_ap


# ------------------------------------------------------------ dataset

def read_dataset(config, detectors):
    """Ground truth, source frames and the detectors' mAP on the source
    frames (the original performance)."""
    dataset = {}
    for sequence in config["sequences"]:
        print(f"Sequence: {sequence['name']}")
        sequence_path = os.path.join(config["dataset_dir"], sequence["name"])
        images_folder = os.path.join(sequence_path, "images")
        source_images = sorted(glob(os.path.join(images_folder, "*.png")))
        annotations = {}
        for ann_type in sequence["annotation_types"]:
            files = sorted(glob(os.path.join(sequence_path, ann_type,
                                             "*.txt")))
            assert len(source_images) == len(files)
            reader = {"object_detection": read_object_detection,
                      "license_detection": read_license_detection,
                      "license_recognition": read_license_recognition}[ann_type]
            annotations[ann_type] = [reader(f) for f in files]

        src_reader = PNGReader(images_folder)
        images = []
        for _ in source_images:
            images.append(src_reader.read_one_frame())

        classes, class_names = [], []
        with open(os.path.join(sequence_path, "metadata.txt")) as f:
            for line in f.readlines():
                e = line.split(": ")
                classes.append(int(e[0]))
                class_names.append(e[1].strip())

        dataset[sequence["name"]] = dict(images=images,
                                         annotations=annotations,
                                         classes=classes,
                                         class_names=class_names)

        ann_types = annotations.keys()
        mean_ap = 0
        if "object_detection" in ann_types or "license_detection" in ann_types:
            origin = {"rcnn": [], "yolo_detection": [], "yolo_lp_detection": []}
            lsi = config["labels_start_index"]
            for image in images:
                if "object_detection" in ann_types:
                    origin["rcnn"].append(detectors["rcnn"](image, lsi - 1))
                    origin["yolo_detection"].append(
                        detectors["yolo"](image, lsi))
                elif "license_detection" in ann_types:
                    origin["yolo_lp_detection"].append(
                        detectors["yolo_lp"](image, 0))
            delete_unsupported_annotations(origin, classes)
            mean_ap = calculate_mean_ap(origin, dataset, sequence["name"])
        dataset[sequence["name"]]["mean_ap"] = mean_ap
    return dataset


# ------------------------------------------------------------- metrics

def calculate_metrics(dataset, images, annotations, video_name, use_ms_ssim,
                      device="cuda"):
    """(mAP per model, OCR metrics, mean PSNR, mean MS-SSIM or None) of one
    decoded quality; PSNR and MS-SSIM on `device`."""
    dataset_images = dataset[video_name]["images"]
    ocr_results = {}
    if annotations.get("ocr_result"):
        gt = dataset[video_name]["annotations"]["license_recognition"]
        merged = list(itertools.chain.from_iterable(annotations["ocr_result"]))
        merged_gt = list(itertools.chain.from_iterable(
            d["texts"] for d in gt))
        ocr_results = calculate_ocr_metrics(merged_gt, merged)
    mean_ap = calculate_mean_ap(annotations, dataset, video_name)

    device = resolve_device(device)
    psnr_list, ssim_list = [], []
    with torch.no_grad():
        for gt_img, img in zip(dataset_images, images):
            a = to_device(torch.from_numpy(np.asarray(img, np.float32)[None]),
                          device)
            b = to_device(torch.from_numpy(
                np.asarray(gt_img, np.float32)[None]), device)
            psnr_list.append(float(psnr_fn(a, b)[0]))
            if use_ms_ssim:
                ssim_list.append(float(ms_ssim(a, b)[0]))
    return (mean_ap, ocr_results, float(np.mean(psnr_list)),
            float(np.mean(ssim_list)) if use_ms_ssim else None)


def get_metrics(decod_dir, detectors, ocr, dataset, use_ms_ssim,
                labels_start_index, device="cuda"):
    """Metrics of every <codec>/<video>/quality_k folder of decod_dir,
    cached beside it as quality_k_metrics.json."""
    metrics = {}
    for model_folder in (f for f in os.scandir(decod_dir) if f.is_dir()):
        print(f"Calculate metrics for {model_folder.name}")
        metrics[model_folder.name] = {}
        for video_folder in (f for f in os.scandir(model_folder)
                             if f.is_dir()):
            if video_folder.name not in dataset:
                continue
            entries = []
            images_folders = sorted((f for f in os.scandir(video_folder)
                                     if f.is_dir()), key=lambda f: f.name)
            ann_types = dataset[video_folder.name]["annotations"].keys()
            for images_folder in images_folders:
                metrics_json = images_folder.path + "_metrics.json"
                if os.path.exists(metrics_json):
                    with open(metrics_json) as f:
                        entries.append(json.load(f))
                    continue
                with open(images_folder.path + ".json") as f:
                    seq_info = json.load(f)
                annotations = {"rcnn": [], "yolo_detection": [],
                               "yolo_lp_detection": [], "ocr_result": []}
                src_reader = PNGReader(images_folder.path)
                images = []
                n = len(glob(os.path.join(images_folder.path, "*.png")))
                for i in range(n):
                    rgb = src_reader.read_one_frame()
                    if "object_detection" in ann_types:
                        annotations["rcnn"].append(
                            detectors["rcnn"](rgb, labels_start_index - 1))
                        annotations["yolo_detection"].append(
                            detectors["yolo"](rgb, labels_start_index))
                    if "license_detection" in ann_types:
                        annotations["yolo_lp_detection"].append(
                            detectors["yolo_lp"](rgb, 0))
                    if "license_recognition" in ann_types:
                        boxes = dataset[video_folder.name]["annotations"][
                            "license_recognition"][i]["boxes"]
                        annotations["ocr_result"].append(ocr(rgb, boxes))
                    images.append(rgb)
                delete_unsupported_annotations(
                    annotations, dataset[video_folder.name]["classes"])
                mean_ap, ocr_results, psnr, ssim = calculate_metrics(
                    dataset, images, annotations, video_folder.name,
                    use_ms_ssim, device)
                info = dict(mean_ap=mean_ap, ocr_results=ocr_results,
                            psnr=psnr, ssim=ssim, bpp=seq_info["avg_bpp"],
                            frame_bpp=seq_info.get("frame_bpp", []),
                            gop=seq_info["gop"], quality=images_folder.name)
                entries.append(info)
                with open(metrics_json, "w") as fp:
                    json.dump(info, fp)
            metrics[model_folder.name][video_folder.name] = entries
    return metrics


# --------------------------------------------------------------- plots

def _style(i):
    return line_styles[i % len(line_styles)], line_colors[i % len(line_colors)]


def plot_graphs(metrics, dataset, out_path, use_ms_ssim, compare_gop, lang):
    """RD and machine-task plots (PNG files in out_path)."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("plot_graphs needs matplotlib, which is not "
                           "installed; the metrics (get_metrics) do not")\
            from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import AutoMinorLocator

    def new_axes(title, xlabel, ylabel):
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.set_title(title)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.grid(True, which="major", alpha=0.5)
        ax.grid(True, which="minor", alpha=0.2)
        ax.xaxis.set_minor_locator(AutoMinorLocator())
        ax.yaxis.set_minor_locator(AutoMinorLocator())
        return fig, ax

    L = labels[lang]
    os.makedirs(out_path, exist_ok=True)
    codecs = sorted(metrics.keys())
    videos = sorted(metrics[codecs[0]].keys())

    for video in videos:
        # ---- detection performance per model
        det_models = sorted({m for c in codecs
                             for e in metrics[c][video]
                             for m in (e["mean_ap"] or {})})
        for model in det_models:
            fig, ax = new_axes(L["obj_performance"].format(model, video),
                               "bpp", "mAP, %")
            for i, codec in enumerate(codecs):
                entries = metrics[codec][video]
                xs = [e["bpp"] for e in entries]
                ys = [e["mean_ap"][model]["map"] for e in entries
                      if e["mean_ap"]]
                style, color = _style(i)
                ax.plot(xs[:len(ys)], ys, style, color=color, label=codec)
            orig = dataset[video]["mean_ap"]
            if orig and model in orig:
                o = orig[model]["map"]
                ax.axhline(o, linestyle="-", color="black",
                           label=L["orig_performance"].format(o))
                ax.axhline(o - 1, linestyle="--", color="dimgray",
                           label=L["loss_1"])
                ax.axhline(o - 2, linestyle=":", color="gray",
                           label=L["loss_2"])
            ax.legend()
            fig.savefig(os.path.join(out_path, f"{video}_{model}_map.png"),
                        dpi=150, bbox_inches="tight")
            plt.close(fig)

            # per-class curves
            class_names = sorted({cn for c in codecs
                                  for e in metrics[c][video] if e["mean_ap"]
                                  for cn in e["mean_ap"].get(model, {}).get(
                                      "class_map", {})})
            for cn in class_names:
                fig, ax = new_axes(
                    L["class_performance"].format(cn, model, video),
                    "bpp", "mAP, %")
                for i, codec in enumerate(codecs):
                    entries = metrics[codec][video]
                    xs = [e["bpp"] for e in entries]
                    ys = [e["mean_ap"][model]["class_map"].get(cn, np.nan)
                          for e in entries if e["mean_ap"]]
                    style, color = _style(i)
                    ax.plot(xs[:len(ys)], ys, style, color=color, label=codec)
                ax.legend()
                fig.savefig(os.path.join(
                    out_path, f"{video}_{model}_{cn}_map.png"),
                    dpi=150, bbox_inches="tight")
                plt.close(fig)

        # ---- OCR text matching
        text_metrics = sorted({k for c in codecs for e in metrics[c][video]
                               for k in (e.get("ocr_results") or {})})
        for tm in text_metrics:
            fig, ax = new_axes(L["matching"].format(tm, video), "bpp",
                               L["matching_value"])
            for i, codec in enumerate(codecs):
                entries = metrics[codec][video]
                xs = [e["bpp"] for e in entries]
                ys = [e["ocr_results"].get(tm, np.nan) for e in entries
                      if e.get("ocr_results")]
                style, color = _style(i)
                ax.plot(xs[:len(ys)], ys, style, color=color, label=codec)
            ax.legend()
            fig.savefig(os.path.join(out_path, f"{video}_ocr_{tm}.png"),
                        dpi=150, bbox_inches="tight")
            plt.close(fig)

        # ---- RD curves
        fig, ax = new_axes(L["rd_curve_psnr"].format(video), "bpp",
                           L["rd_metric_psnr"])
        for i, codec in enumerate(codecs):
            entries = metrics[codec][video]
            label = codec
            if compare_gop and entries:
                label = f"{codec} (gop {entries[0]['gop']})"
            style, color = _style(i)
            ax.plot([e["bpp"] for e in entries],
                    [e["psnr"] for e in entries], style, color=color,
                    label=label)
        ax.legend()
        fig.savefig(os.path.join(out_path, f"{video}_rd_psnr.png"), dpi=150,
                    bbox_inches="tight")
        plt.close(fig)

        if use_ms_ssim:
            fig, ax = new_axes(L["rd_curve_ssim"].format(video), "bpp",
                               "MS-SSIM")
            for i, codec in enumerate(codecs):
                entries = metrics[codec][video]
                ys = [e["ssim"] for e in entries if e["ssim"] is not None]
                style, color = _style(i)
                ax.plot([e["bpp"] for e in entries][:len(ys)], ys, style,
                        color=color, label=codec)
            ax.legend()
            fig.savefig(os.path.join(out_path, f"{video}_rd_msssim.png"),
                        dpi=150, bbox_inches="tight")
            plt.close(fig)

        # ---- bpp per frame (one plot per codec with frame_bpp)
        for codec in codecs:
            entries = metrics[codec][video]
            if not entries or not entries[0].get("frame_bpp"):
                continue
            fig, ax = new_axes(L["bbp_per_frame"].format(codec, video),
                               "frame", "bpp")
            for i, e in enumerate(entries):
                style, color = _style(i)
                ax.plot(range(len(e["frame_bpp"])), e["frame_bpp"], style,
                        color=color, markersize=2,
                        label=e.get("quality", str(i)))
            ax.legend()
            fig.savefig(os.path.join(
                out_path, f"{video}_{codec}_frame_bpp.png"),
                dpi=150, bbox_inches="tight")
            plt.close(fig)


def str2bool(s):
    return s.lower() in ("true", "1")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Benchmark metrics + plots")
    parser.add_argument("--config", dest="config", type=str, required=True)
    parser.add_argument("--decod-dir", dest="decod_dir", type=str,
                        required=True)
    parser.add_argument("--out-path", dest="out_path", type=str, required=True)
    parser.add_argument("--use-ms-ssim", dest="use_ms_ssim", type=str2bool,
                        default=True)
    parser.add_argument("--compare-gop", dest="compare_gop", type=str2bool,
                        default=False)
    parser.add_argument("--lang", dest="lang", type=str, default="en",
                        choices=("en", "ru"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    with open(args.config) as f:
        config = json.load(f)

    need = {t for s in config["sequences"] for t in s["annotation_types"]}
    detectors = {}
    ocr = None
    if "object_detection" in need:
        detectors["rcnn"] = build_rcnn(args.device)
        detectors["yolo"] = build_yolo(config.get("yolo_weights",
                                                  "pretrained/yolov8m.pt"),
                                       args.device)
    if "license_detection" in need:
        detectors["yolo_lp"] = build_yolo(
            config.get("yolo_lp_weights", "pretrained/yolov8-lp.pt"),
            args.device)
    if "license_recognition" in need:
        ocr = build_ocr(args.device)

    dataset = read_dataset(config, detectors)
    metrics = get_metrics(args.decod_dir, detectors, ocr, dataset,
                          args.use_ms_ssim, config["labels_start_index"],
                          args.device)
    plot_graphs(metrics, dataset, args.out_path, args.use_ms_ssim,
                args.compare_gop, args.lang)


if __name__ == "__main__":
    main()
