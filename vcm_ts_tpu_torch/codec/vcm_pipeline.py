"""VCM codec pipeline: DCVC-HEM base layer + ROI enhancement layer.

The port's counterpart of vcm_ts_tpu/codec/vcm_pipeline.py, with the same
functions, paths, file names and file formats: video <-> frames, the
base layer through the port's codec engines (`.bin` containers), ROI
detection with the shipped detectors (uint16 xyxy box pickles), masked
residuals, the learned enhancement layer (IntraCodec `.bin` files) or
H.265 through ffmpeg, gradient-mask fusion, and the bitrate and PSNR
reports (`info/*.txt`, `quality.json`).

Frames are PNG files read and written by the port's own PNG codec
(codec/png_io.py), RGB in memory. The residual, mask, fusion and metric
arithmetic runs as f32 tensors on the device, in numpy's order of
operations and casts: the uint8 casts of compute_residuals and
fuse_layers truncate after the clip, the learned layer rounds. Every
function that computes takes `device` ("cuda" unless the caller asks for
the CPU).

OpenCV and ffmpeg are optional host tools: video_to_frames, encode_frames,
encode_same_bitrate and calc_bitrate_metrics (its video probe) need them
and raise with what to do when they are missing. No DCVC checkpoint is
required: an empty weights path builds the port's seeded init.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import time
from glob import glob
from subprocess import call

import numpy as np
import torch

from ..utils.device import resolve_device, to_device
from ..utils.video import get_video_length, get_video_resolution, require_cv2
from ..utils.weights import PRETRAINED
from . import bitstream as bs
from .png_io import PNGReader, imread, imwrite, save_image

_LOGGER_NAME = "CODEC"
PATHS_ARTIFACTS_SOURCE_FRAMES = "artifacts/source_frames"
PATHS_ARTIFACTS_DCVC_HEM = "artifacts/dcvc_hem"
PATHS_ARTIFACTS_RESIDUALS = "artifacts/residuals"
PATHS_ARTIFACTS_RESIDUALS_ENCODED = "artifacts/residuals_h265"
PATHS_ARTIFACTS_RESULT = "artifacts/result_frames"
PATHS_ARTIFACTS_SAME_BITRATE = "artifacts/same_bitrate"
PATHS_ENCODED_DIR = "encoded"
PATHS_DECODED_DIR = "decoded"
PATHS_INFO = "info"


def _require_ffmpeg():
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg (with libx265) is required for the H.265 enhancement "
            "layer but was not found on PATH (set ENHANCEMENT_LAYER.CODEC: "
            "intra for the learned enhancement layer)")


def _frame(path: str, device) -> torch.Tensor:
    """A PNG as an (H, W, 3) f32 tensor of 0..255 values on `device`."""
    return to_device(torch.from_numpy(imread(path)), device).float()


def _fresh_dir(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)


# --------------------------------------------------------------------------
# frames <-> video
# --------------------------------------------------------------------------

def video_to_frames(video_path, result_root, subdir,
                    filename_template="im%05d.png") -> int:
    """Split a video into PNG frames (needs OpenCV to decode the video)."""
    cv = require_cv2("splitting a video into frames")
    logger = logging.getLogger(_LOGGER_NAME)
    cap = cv.VideoCapture(video_path)
    if not cap.isOpened():
        logger.error("Failed to open video file '%s'", video_path)
        return 0
    res_folder = os.path.join(result_root, subdir)
    _fresh_dir(res_folder)
    cnt = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        imwrite(os.path.join(res_folder, filename_template % (cnt + 1)),
                np.ascontiguousarray(frame[:, :, ::-1]))
        cnt += 1
    cap.release()
    logger.info("Video splitting results in %d frames", cnt)
    return cnt


# --------------------------------------------------------------------------
# base layer
# --------------------------------------------------------------------------

def run_dcvc(video_codec, i_codec, args) -> None:
    """Per-frame GOP loop writing decoded PNGs and, with write_stream, one
    .bin stream per frame."""
    from ..models.dmc import make_dpb

    logger = logging.getLogger(_LOGGER_NAME)
    frame_num = args["frame_num"]
    gop = args["gop"]
    write_stream = args.get("write_stream", False)
    device = i_codec.device
    src_reader = PNGReader(args["img_path"])

    out_dir = args["decoded_frame_folder"]
    _fresh_dir(out_dir)

    encoding_time = decoding_time = 0.0
    dpb = None
    is_first_p = True
    for frame_idx in range(frame_num):
        x = src_reader.read_one_frame()[None]
        pic_height, pic_width = x.shape[1], x.shape[2]
        x_padded = to_device(torch.from_numpy(bs.pad_image(x)), device)
        bin_path = (os.path.join(args["bin_folder"],
                                 f"im{str(frame_idx + 1).zfill(5)}.bin")
                    if write_stream else None)

        if frame_idx % gop == 0:
            result = i_codec.encode_decode(
                x_padded, args["i_frame_q_scale"], bin_path,
                pic_height=pic_height, pic_width=pic_width)
            recon = result["x_hat"].clamp(0, 1)
            dpb = make_dpb(recon, video_codec.model.channel_N,
                           video_codec.model.channel_M)
            is_first_p = True
        else:
            result = video_codec.encode_decode(
                x_padded, dpb, bin_path,
                pic_height=pic_height, pic_width=pic_width,
                mv_y_q_scale=args["p_frame_mv_y_q_scale"],
                y_q_scale=args["p_frame_y_q_scale"], is_first_p=is_first_p)
            dpb = dict(result["dpb"])
            dpb["ref_frame"] = dpb["ref_frame"].clamp(0, 1)
            recon = dpb["ref_frame"]
            is_first_p = False

        encoding_time += result.get("encoding_time", 0)
        decoding_time += result.get("decoding_time", 0)
        x_hat = recon[:, :pic_height, :pic_width, :].float().cpu().numpy()
        save_image(x_hat, os.path.join(
            out_dir, f"im{str(frame_idx + 1).zfill(5)}.png"))

    logger.info("Average encoding time %.2f ms",
                encoding_time / frame_num * 1000)
    logger.info("Average decoding time %.2f ms",
                decoding_time / frame_num * 1000)


def _q_ladder(q, rate_count):
    """q-scale rate ladder; constant (untrained) anchors cannot be
    log-interpolated and give a constant ladder."""
    from ..utils.common import interpolate_log

    q = np.asarray(q).reshape(-1)
    if q[0] <= q[-1]:
        return np.full(rate_count, float(q[0]))
    return interpolate_log(q[-1], q[0], rate_count)


def load_video_model(video_model_weights, anchor_num=4, device="cuda"):
    """(DMC, y q-scale anchors, mv q-scale anchors) from a reference .pth,
    or the port's seeded init for an empty path."""
    from ..models.dmc import DMC
    from ..utils.weights import (get_q_scales_from_ckpt, init_params,
                                 load_codec_weights)

    model = DMC(anchor_num=anchor_num, device=device)
    if video_model_weights:
        load_codec_weights(model, video_model_weights)
        y_q, mv_q = get_q_scales_from_ckpt(video_model_weights)
    else:
        init_params(model, seed=1)
        y_q = model.y_q_scale.detach().cpu().numpy().reshape(-1)
        mv_q = model.mv_y_q_scale.detach().cpu().numpy().reshape(-1)
    return model.eval(), y_q, mv_q


def load_intra_codec(image_model_weights, rate_count=6, update=True,
                     device="cuda"):
    """An IntraCodec and its q-scale rate ladder, from a reference .pth, or
    the port's seeded init for an empty path (smoke runs). `update` builds
    the CDF coding tables (needed for real bitstreams)."""
    from ..models.intra import IntraNoAR
    from ..utils.weights import (get_i_frame_q_scales_from_ckpt, init_params,
                                 load_codec_weights)
    from .engine import IntraCodec

    model = IntraNoAR(device=device)
    if image_model_weights:
        load_codec_weights(model, image_model_weights)
        i_q = get_i_frame_q_scales_from_ckpt(image_model_weights)
    else:
        init_params(model, seed=0)
        i_q = model.q_scale.detach().cpu().numpy().reshape(-1)
    codec = IntraCodec(model, device=device)
    if update:
        codec.update(force=True)
    return codec, _q_ladder(i_q, rate_count)


def encode_decode_dcvc(frames_dir, image_model_weights, video_model_weights,
                       anchor_num, gop, rate_count, quality, write_stream,
                       out_frames_dir, out_bins_dir, device="cuda") -> None:
    """Base layer: q-scale ladders of rate_count points, models, CDF
    tables, then the GOP loop."""
    from .engine import VideoCodec

    logger = logging.getLogger(_LOGGER_NAME)
    if not image_model_weights:
        raise ValueError("Invalid image model weights")
    if not video_model_weights:
        raise ValueError("Invalid video model weights")
    device = resolve_device(device)

    i_codec, i_scales = load_intra_codec(image_model_weights, rate_count,
                                         update=write_stream, device=device)
    p_model, y_q, mv_q = load_video_model(video_model_weights, anchor_num,
                                          device)
    y_scales = _q_ladder(y_q, rate_count)
    mv_scales = _q_ladder(mv_q, rate_count)

    video_codec = VideoCodec(p_model, device=device)
    if write_stream:
        video_codec.update(force=True)

    _fresh_dir(out_frames_dir)
    _fresh_dir(out_bins_dir)
    frame_num = len(glob(os.path.join(frames_dir, "*.png")))
    logger.info("Encoding/decoding with DCVC-HEM (%s)", device)
    run_dcvc(video_codec, i_codec, dict(
        i_frame_q_scale=float(i_scales[quality]),
        p_frame_y_q_scale=float(y_scales[quality]),
        p_frame_mv_y_q_scale=float(mv_scales[quality]),
        gop=gop, frame_num=frame_num, write_stream=write_stream,
        bin_folder=out_bins_dir, img_path=frames_dir,
        decoded_frame_folder=out_frames_dir))


# --------------------------------------------------------------------------
# ROI detection
# --------------------------------------------------------------------------

def detect_rois(root, kind, prob=0.8, padding=0, detector=None,
                filename_template="%05d", device="cuda") -> None:
    """Detect license plates ('liplates') or faces ('faces') on the source
    frames and pickle uint16 xyxy boxes per frame. `detector` is a
    callable (frame (H, W, 3) uint8) -> (boxes xyxy (N, 4), scores (N,));
    None builds the shipped one (build_detector)."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not (prob > 0.0 and padding >= 0):
        raise ValueError(f"need prob > 0 and padding >= 0, got {prob}, "
                         f"{padding}")
    device = resolve_device(device)
    if detector is None:
        detector = build_detector(kind, device)

    files = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_SOURCE_FRAMES,
                                     "*.png")))
    res_folder = os.path.join(
        root, PATHS_ENCODED_DIR,
        "liplates_coords" if kind == "liplates" else "faces_coords")
    _fresh_dir(res_folder)

    logger.info("Detecting %s", kind)
    for i, path in enumerate(files):
        frame = to_device(torch.from_numpy(imread(path)), device)
        h, w, _ = frame.shape
        boxes, scores = detector(frame)
        coords = []
        for box, score in zip(np.asarray(boxes).reshape(-1, 4),
                              np.asarray(scores).reshape(-1)):
            if score < prob:
                continue
            x1, y1, x2, y2 = box
            coords.append([
                max(min(int(x1 - padding), w), 0),
                max(min(int(y1 - padding), h), 0),
                max(min(int(x2 + padding), w), 0),
                max(min(int(y2 + padding), h), 0),
            ])
        with open(os.path.join(res_folder, filename_template % (i + 1)),
                  "wb") as f:
            pickle.dump(np.array(coords, dtype=np.uint16), f)
    logger.info("%s coordinates saved to '%s'", kind, res_folder)


def build_detector(kind: str, device="cuda"):
    """The shipped detector of `kind` on `device`: YOLOv8-LP
    (pretrained/yolov8-lp.npz) for 'liplates', MTCNN (pretrained/mtcnn.npz)
    for 'faces'. A missing weights file raises."""
    names = {"liplates": "yolov8-lp.npz", "faces": "mtcnn.npz"}
    if kind not in names:
        raise ValueError(f"unknown detector kind: {kind}")
    path = os.path.join(PRETRAINED, names[kind])
    if not os.path.exists(path):
        tool = "yolo_detector" if kind == "liplates" else "mtcnn"
        raise FileNotFoundError(
            f"{kind} detection needs {path} (export once with "
            f"tools/export_{tool}.py or train with the "
            "tools/train_*_detector.py scripts)")
    if kind == "liplates":
        from ..eval.yolo_native import build_lp_adapter
        return build_lp_adapter(path, device=device)
    from ..eval.mtcnn_native import build_face_adapter
    return build_face_adapter(path, device=device)


# --------------------------------------------------------------------------
# enhancement layer: residuals, learned or H.265 coding, fusion
# --------------------------------------------------------------------------

def _load_coords(root, kind, count):
    folder = os.path.join(root, PATHS_ENCODED_DIR, f"{kind}_coords")
    files = sorted(glob(os.path.join(folder, "*")))
    if len(files) != count:
        raise ValueError(f"{folder}: {len(files)} box files for {count} "
                         "frames")
    out = []
    for f in files:
        with open(f, "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _boxes(coords):
    return [tuple(int(v) for v in b)
            for b in np.asarray(coords).reshape(-1, 4)]


def compute_residuals(root, use_liplates, use_faces, out_residuals_dir,
                      filename_template="im%05d.png", device="cuda") -> None:
    """(source - decoded + 128), clipped to 0..255, masked by the ROI
    boxes."""
    logger = logging.getLogger(_LOGGER_NAME)
    device = resolve_device(device)
    source = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_SOURCE_FRAMES,
                                      "*.png")))
    encoded = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_DCVC_HEM,
                                       "*.png")))
    lp = _load_coords(root, "liplates", len(source)) if use_liplates else None
    fc = _load_coords(root, "faces", len(source)) if use_faces else None

    _fresh_dir(out_residuals_dir)
    logger.info("Compute residuals")
    for i, (s_path, e_path) in enumerate(zip(source, encoded)):
        s = _frame(s_path, device)
        e = _frame(e_path, device)
        h, w, _ = s.shape
        residual = (s - e + 128).clamp(0.0, 255.0)
        mask = torch.zeros((h, w, 1), dtype=torch.float32, device=device)
        for boxes in ((lp[i] if lp is not None else []),
                      (fc[i] if fc is not None else [])):
            for x1, y1, x2, y2 in _boxes(boxes):
                mask[y1:y2, x1:x2] = 1.0
        out = (residual * mask).to(torch.uint8)
        imwrite(os.path.join(out_residuals_dir, filename_template % (i + 1)),
                out.cpu().numpy())
    logger.info("Residuals saved to '%s'", out_residuals_dir)


def encode_folder_crf(src_files, out_path, crf, preset="ultrafast",
                      pix_fmt="gbrp"):
    _require_ffmpeg()
    call(["ffmpeg", "-i", src_files, "-pix_fmt", pix_fmt, "-c:v", "libx265",
          "-preset", preset, "-crf", str(crf), "-y", out_path])
    return out_path


def encode_folder_bitrate(src_files, out_path, bitrate, preset="ultrafast",
                          pix_fmt="gbrp"):
    _require_ffmpeg()
    call(["ffmpeg", "-i", src_files, "-pix_fmt", pix_fmt, "-c:v", "libx265",
          "-preset", preset, "-b:v", f"{bitrate}k", "-y", out_path])
    return out_path


def encode_frames(src_root, video_path, crf, preset="medium", pix_fmt="gbrp",
                  save_to_frames=True, frames_path="",
                  filename_template="im%05d.png") -> None:
    """H.265-encode a PNG folder (ffmpeg), and split it back into PNGs."""
    logger = logging.getLogger(_LOGGER_NAME)
    src_files = os.path.join(src_root, filename_template)
    os.makedirs(os.path.dirname(video_path), exist_ok=True)
    logger.info("Encoding '%s' frames to '%s'", src_files, video_path)
    encode_folder_crf(src_files, video_path, crf=crf, preset=preset,
                      pix_fmt=pix_fmt)
    if save_to_frames:
        _fresh_dir(frames_path)
        video_to_frames(video_path, frames_path, "", filename_template)


def encode_residuals_learned(root, image_model_weights, quality,
                             out_frames_dir, rate_count=6,
                             filename_template="im%05d.png",
                             device="cuda") -> None:
    """The learned enhancement layer: every masked-residual frame through
    the learned IntraCodec (in BGR order, as the JAX pipeline codes it),
    one container .bin per frame under
    encoded/enhancement_bins, decoded residuals written to
    `out_frames_dir` for fuse_layers (no external binaries; selected by
    ENHANCEMENT_LAYER.CODEC = "intra")."""
    logger = logging.getLogger(_LOGGER_NAME)
    device = resolve_device(device)
    codec, scales = load_intra_codec(image_model_weights, rate_count,
                                     device=device)
    q_scale = float(scales[quality])

    residuals = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_RESIDUALS,
                                         "*.png")))
    bins_dir = os.path.join(root, PATHS_ENCODED_DIR, "enhancement_bins")
    _fresh_dir(bins_dir)
    _fresh_dir(out_frames_dir)
    # a result root encoded before with CODEC='h265' may hold a stale
    # enhancement_layer.h265, which the size accounting would prefer
    stale = os.path.join(root, PATHS_ENCODED_DIR, "enhancement_layer.h265")
    if os.path.exists(stale):
        os.remove(stale)

    logger.info("Encoding %d residual frames with the learned intra codec "
                "(q_scale=%.4f)", len(residuals), q_scale)
    t0, total_bits = time.time(), 0
    for i, path in enumerate(residuals):
        # BGR, the channel order of the JAX pipeline's cv2 arrays: the codec
        # is not symmetric in its channels, and the streams must be the same
        res = imread(path)[:, :, ::-1].astype(np.float32) / 255.0
        h, w, _ = res.shape
        x = to_device(torch.from_numpy(bs.pad_image(res[None])), device)
        bin_name = os.path.splitext(filename_template % (i + 1))[0] + ".bin"
        out = codec.encode_decode(
            x, q_scale, output_path=os.path.join(bins_dir, bin_name),
            pic_height=h, pic_width=w)
        total_bits += out["bit"]
        recon = out["x_hat"][0, :h, :w, :].float().flip(-1)
        imwrite(os.path.join(out_frames_dir, filename_template % (i + 1)),
                (recon.clamp(0, 1) * 255).round().to(torch.uint8).cpu()
                .numpy())
    logger.info("Learned enhancement layer: %d bits total, %.2f s",
                int(total_bits), time.time() - t0)


def _enhancement_layer_bits(root) -> int:
    """Size in bits of whichever enhancement layer exists: the H.265 file
    or the learned per-frame .bin directory (0 when neither)."""
    h265 = os.path.join(root, PATHS_ENCODED_DIR, "enhancement_layer.h265")
    if os.path.exists(h265):
        return 8 * os.path.getsize(h265)
    bins = os.path.join(root, PATHS_ENCODED_DIR, "enhancement_bins")
    if os.path.isdir(bins):
        return 8 * get_dir_size(bins)
    return 0


def create_gradient_mask(w, h, border_size: int):
    """Soft ROI border ramp, (h, w, 1) f32 numpy: 1 - linspace(0.9, 0,
    border_size) from the edge inwards, 1 inside."""
    if border_size > 0:
        mask = np.zeros((h, w, 1), np.float32)
        for i, x in enumerate(np.linspace(0.9, 0.0, border_size)):
            mask[i:h - i, i:w - i, :] = 1 - x
    else:
        mask = np.ones((h, w, 1), np.float32)
    return mask


def gradient_mask(w: int, h: int, border_size: int, device) -> torch.Tensor:
    """create_gradient_mask on the device: the pixel at distance d from the
    nearest edge takes ramp value min(d, border_size - 1) (the ramp's
    values are numpy's f64 linspace, cast to f32 as the numpy loop
    stores them)."""
    if border_size <= 0:
        return torch.ones((h, w, 1), dtype=torch.float32, device=device)
    ramp = torch.from_numpy(
        (1 - np.linspace(0.9, 0.0, border_size)).astype(np.float32)).to(
            device)
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    dy = torch.minimum(ys, h - 1 - ys)[:, None]
    dx = torch.minimum(xs, w - 1 - xs)[None, :]
    d = torch.minimum(dy, dx).clamp(max=border_size - 1)
    return ramp[d][:, :, None]


def fuse_layers(root, faces_enable=True, liplates_enable=True,
                faces_padding=0, liplates_padding=0,
                filename_template="im%05d.png", device="cuda") -> None:
    """Decoded base + gradient-masked residual, clipped and cast to uint8."""
    logger = logging.getLogger(_LOGGER_NAME)
    device = resolve_device(device)
    base = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_DCVC_HEM, "*.png")))
    enh = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_RESIDUALS_ENCODED,
                                   "*.png")))
    if not enh:  # the raw residuals (lossless enhancement)
        enh = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_RESIDUALS,
                                       "*.png")))
    lp = _load_coords(root, "liplates", len(base)) if liplates_enable else None
    fc = _load_coords(root, "faces", len(base)) if faces_enable else None

    res_folder = os.path.join(root, PATHS_ARTIFACTS_RESULT)
    _fresh_dir(res_folder)
    logger.info("Creating result frames")
    for i, (b_path, e_path) in enumerate(zip(base, enh)):
        b = _frame(b_path, device)
        e = _frame(e_path, device) - 128
        h, w, _ = b.shape
        mask = torch.zeros((h, w, 1), dtype=torch.float32, device=device)
        for coords, pad in ((lp[i] if lp is not None else None,
                             liplates_padding),
                            (fc[i] if fc is not None else None,
                             faces_padding)):
            if coords is None:
                continue
            for x1, y1, x2, y2 in _boxes(coords):
                if y2 > y1 and x2 > x1:  # boxes lie inside the frame
                    mask[y1:y2, x1:x2] = gradient_mask(
                        x2 - x1, y2 - y1, pad, device)
        out = (b + mask * e).clamp(0, 255).to(torch.uint8)
        imwrite(os.path.join(res_folder, filename_template % (i + 1)),
                out.cpu().numpy())
    logger.info("Created %d result frames", len(base))


def encode_same_bitrate(root, source_video_path, out_video_path,
                        preset="medium", pix_fmt="gbrp", save_to_frames=True,
                        frames_path="", filename_template="im%05d.png"):
    """Bitrate-matched H.265 comparison encode (OpenCV and ffmpeg)."""
    cv = require_cv2("the same-bitrate comparison encode")
    cap = cv.VideoCapture(source_video_path)
    fps = cap.get(cv.CAP_PROP_FPS)
    frame_count = int(cap.get(cv.CAP_PROP_FRAME_COUNT))
    cap.release()
    duration = frame_count / fps

    enh = _enhancement_layer_bits(root)
    base = 8 * get_dir_size(os.path.join(root, PATHS_ENCODED_DIR,
                                         "dcvc_hem_bins"))
    bitrate = int((enh + base) / duration / 1000)

    src_files = os.path.join(root, PATHS_ARTIFACTS_RESULT, filename_template)
    encode_folder_bitrate(src_files, out_video_path, bitrate=bitrate,
                          preset=preset, pix_fmt=pix_fmt)
    if save_to_frames:
        _fresh_dir(frames_path)
        video_to_frames(out_video_path, frames_path, "", filename_template)


def get_dir_size(start_path: str = ".") -> int:
    total = 0
    for dirpath, _, filenames in os.walk(start_path):
        for f in filenames:
            fp = os.path.join(dirpath, f)
            if not os.path.islink(fp):
                total += os.path.getsize(fp)
    return total


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def calc_bitrate_metrics(root, video_path, gop) -> dict:
    """Source and encoded sizes and bpp of each layer
    (info/bitrate_metrics.txt, info/quality.json)."""
    logger = logging.getLogger(_LOGGER_NAME)
    frames_num = get_video_length(video_path)
    frame_w, frame_h = get_video_resolution(video_path)
    total_pixels = frames_num * frame_w * frame_h
    if total_pixels <= 0:
        raise ValueError(f"{video_path}: no frames")

    src_size = 8 * os.path.getsize(video_path)
    enh_size = _enhancement_layer_bits(root)
    base_size = 8 * get_dir_size(
        os.path.join(root, PATHS_ENCODED_DIR, "dcvc_hem_bins"))
    encoded_size = enh_size + base_size

    src_bpp = src_size / total_pixels
    encoded_bpp = encoded_size / total_pixels

    os.makedirs(os.path.join(root, PATHS_INFO), exist_ok=True)
    metrics_file = os.path.join(root, PATHS_INFO, "bitrate_metrics.txt")
    with open(metrics_file, "w") as f:
        f.write(f"Results for: {video_path}\n")
        f.write(f"Source kB: {src_size / 8 / 1024}\n")
        f.write(f"Encoded kB: {encoded_size / 8 / 1024}\n")
        f.write(f"Source bpp: {src_bpp}\n")
        f.write(f"Encoded bpp [total]: {encoded_bpp}\n")
        f.write(f"Encoded bpp [enhancement layer]: "
                f"{enh_size / total_pixels}\n")
        f.write(f"Encoded bpp [base layer]: {base_size / total_pixels}\n")
        f.write(f"Recompression ratio [total]: "
                f"{src_bpp / max(encoded_bpp, 1e-12)}\n")
        f.write(f"Recompression ratio [enhancement layer]: "
                f"{src_bpp / max(enh_size / total_pixels, 1e-12)}\n")
        f.write(f"Recompression ratio [base layer]: "
                f"{src_bpp / max(base_size / total_pixels, 1e-12)}\n")
    logger.info("Saved bitrate metrics to %s", metrics_file)

    log_result = {"gop": gop, "avg_bpp": encoded_bpp}
    with open(os.path.join(root, PATHS_INFO, "quality.json"), "w") as fp:
        json.dump(log_result, fp)
    return log_result


def _psnr(total: float, count: int) -> float:
    return 10 * np.log10(1.0 / max(total / count, 1e-12))


def calc_visual_metrics(root, video_path, liplates_padding=0,
                        faces_padding=0, device="cuda") -> dict:
    """Total, base (outside the ROIs), ROI and same-bitrate PSNR
    (info/psnr_metrics.txt)."""
    logger = logging.getLogger(_LOGGER_NAME)
    device = resolve_device(device)
    source = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_SOURCE_FRAMES,
                                      "*.png")))
    result = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_RESULT, "*.png")))
    same_bitrate = sorted(glob(os.path.join(root, PATHS_ARTIFACTS_SAME_BITRATE,
                                            "*.png")))
    lp_files = sorted(glob(os.path.join(root, PATHS_ENCODED_DIR,
                                        "liplates_coords", "*")))
    fc_files = sorted(glob(os.path.join(root, PATHS_ENCODED_DIR,
                                        "faces_coords", "*")))

    psnrs, psnrs_base, psnrs_enh, psnrs_sb = [], [], [], []
    for idx in range(len(source)):
        hr = _frame(source[idx], device) / 255.0
        res = _frame(result[idx], device) / 255.0
        h, w, _ = hr.shape
        mask = torch.zeros((h, w, 1), dtype=torch.float32, device=device)
        for files, pad in ((lp_files, liplates_padding),
                           (fc_files, faces_padding)):
            if len(files) != len(source):
                continue
            with open(files[idx], "rb") as f:
                for x1, y1, x2, y2 in _boxes(pickle.load(f)):
                    # the uint16 box +- padding wraps as numpy's does
                    mask[(y1 + pad) & 0xFFFF:(y2 - pad) & 0xFFFF,
                         (x1 + pad) & 0xFFFF:(x2 - pad) & 0xFFFF] = 1.0
        mse = (hr - res) ** 2
        # one pull: the sums and the mask's count
        sums = torch.stack([mse.sum(), (mse * (1 - mask)).sum(),
                            (mse * mask).sum(), mask.count_nonzero().float()
                            ]).double().cpu().numpy()
        mask_nonzeros = int(sums[3])
        mask_zeros = hr.numel() - mask_nonzeros
        psnrs.append(_psnr(sums[0], hr.numel()))
        if mask_zeros > 0:
            psnrs_base.append(_psnr(sums[1], mask_zeros))
        if mask_nonzeros > 0:
            psnrs_enh.append(_psnr(sums[2], mask_nonzeros))
        if len(same_bitrate) == len(source):
            sb = _frame(same_bitrate[idx], device) / 255.0
            psnrs_sb.append(_psnr(float(((hr - sb) ** 2).sum()),
                                  hr.numel()))

    os.makedirs(os.path.join(root, PATHS_INFO), exist_ok=True)
    metrics_file = os.path.join(root, PATHS_INFO, "psnr_metrics.txt")
    out = {
        "total_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "base_psnr": float(np.mean(psnrs_base)) if psnrs_base else 0.0,
        "roi_psnr": float(np.mean(psnrs_enh)) if psnrs_enh else 0.0,
        "same_bitrate_psnr": float(np.mean(psnrs_sb)) if psnrs_sb else 0.0,
    }
    with open(metrics_file, "w") as f:
        f.write(f"Results for: {video_path}\n")
        f.write(f"Total PSNR [RGB format]: {out['total_psnr']}\n")
        f.write(f"DCVC-HEM PSNR [RGB format]: {out['base_psnr']}\n")
        f.write(f"Enhancement layer PSNR [RGB format]: {out['roi_psnr']}\n")
        f.write(f"H265 encoded with same bitrate as total PSNR [RGB format]: "
                f"{out['same_bitrate_psnr']}\n")
    logger.info("Saved PSNR metrics to %s", metrics_file)
    return out
