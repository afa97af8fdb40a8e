"""Decoding sweep: DCVC-HEM rate points (and HEVC anchors, which need
ffmpeg and cv2).

    python -m vcm_ts_tpu_torch.benchmark_videos_decoding --config CFG.json \
        [--device cuda|cpu]

The port's counterpart of the root benchmark_videos_decoding.py: the same
JSON config schema (dataset_dir, gop, rate_count, out_dir, codecs {HEVC,
DCVC-HEM}), output layout (<out>/<codec>/<video>/quality_k/ with
imNNNNN.png frames, and quality_k.json with gop, avg_bpp, frame_bpp) and
q-scale rules. The DCVC-HEM branch runs the entropy-estimated forward of
the port's engines on the device, one (sequence, rate point) after
another. The HEVC branch (`decod_hevc`, `encode_folder`, `video_to_frames`,
`get_video_bpp`) shells out to ffmpeg and reads video with cv2: each raises
and names the tool when it is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from glob import glob
from subprocess import call

import numpy as np
import torch

from .codec import bitstream as bs
from .codec.engine import IntraCodec, VideoCodec
from .codec.png_io import PNGReader, save_image
from .models.dmc import DMC, make_dpb
from .models.intra import IntraNoAR
from .utils.common import interpolate_log
from .utils.device import resolve_device, to_device
from .utils.video import require_cv2
from .utils.weights import (get_i_frame_q_scales_from_ckpt,
                            get_q_scales_from_ckpt, load_codec_weights)


def generate_log_json(frame_num, gop, frame_types, bits, frame_pixel_num):
    i_bit = p_bit = 0
    i_num = p_num = 0
    for idx in range(frame_num):
        if frame_types[idx] == 0:
            i_bit += bits[idx]
            i_num += 1
        else:
            p_bit += bits[idx]
            p_num += 1
    return {
        "gop": gop,
        "i_frame_num": i_num,
        "p_frame_num": p_num,
        "avg_i_frame_bpp": i_bit / i_num / frame_pixel_num,
        "avg_p_frame_bpp": (p_bit / (p_num * frame_pixel_num)
                            if p_num > 0 else 0),
        "avg_bpp": (i_bit + p_bit) / (frame_num * frame_pixel_num),
        "frame_bpp": list(np.array(bits) / frame_pixel_num),
        "frame_type": frame_types,
    }


@torch.no_grad()
def run_test(video_codec, i_codec, args):
    """Code one (sequence, rate point) with entropy-estimated bits and write
    its decoded frames and quality_k.json. Without an I-frame codec the
    I-frames are lossless: the PNG itself is the reference and its size the
    I-frame's bits."""
    frame_num = args["frame_num"]
    gop = args["gop"]
    src_reader = PNGReader(args["img_path"])

    frame_types, bits = [], []
    frame_pixel_num = 0
    temp_dir = os.path.join(args["decoded_frame_folder"], "temp")
    shutil.rmtree(temp_dir, ignore_errors=True)
    os.makedirs(temp_dir, exist_ok=True)

    dpb = None
    is_first_p = True
    for frame_idx in range(frame_num):
        rgb, png_path = src_reader.read_one_frame(get_png_path=True)
        x = rgb[None]
        pic_height, pic_width = x.shape[1], x.shape[2]
        if frame_pixel_num == 0:
            frame_pixel_num = pic_height * pic_width
        else:
            assert frame_pixel_num == pic_height * pic_width
        x_padded = bs.pad_image(x)

        if frame_idx % gop == 0:
            if i_codec is not None:
                result = i_codec.encode_decode(
                    x_padded, args["i_frame_q_scale"],
                    pic_height=pic_height, pic_width=pic_width)
                recon = torch.clamp(result["x_hat"], 0, 1)
                bit = result["bit"]
            else:
                recon = to_device(torch.from_numpy(x_padded),
                                  video_codec.device).to(
                                      video_codec.param_dtype)
                bit = bs.filesize(png_path) * 8
            dpb = make_dpb(recon, video_codec.model.channel_N,
                           video_codec.model.channel_M)
            is_first_p = True
            frame_types.append(0)
            bits.append(bit)
        else:
            result = video_codec.encode_decode(
                x_padded, dpb, pic_height=pic_height, pic_width=pic_width,
                mv_y_q_scale=args["p_frame_mv_y_q_scale"],
                y_q_scale=args["p_frame_y_q_scale"], is_first_p=is_first_p)
            dpb = result["dpb"]
            dpb["ref_frame"] = torch.clamp(dpb["ref_frame"], 0, 1)
            recon = dpb["ref_frame"]
            is_first_p = False
            frame_types.append(1)
            bits.append(result["bit"])

        x_hat = recon.float().cpu().numpy()[:, :pic_height, :pic_width, :]
        save_image(x_hat, os.path.join(
            temp_dir, f"im{str(frame_idx + 1).zfill(5)}.png"))

    log_result = generate_log_json(frame_num, gop, frame_types, bits,
                                   frame_pixel_num)
    result_name = f"quality_{args['rate_idx']}"
    frames_dir = os.path.join(args["decoded_frame_folder"], result_name)
    with open(os.path.join(args["decoded_frame_folder"],
                           result_name + ".json"), "w") as fp:
        json.dump(log_result, fp)
    shutil.rmtree(frames_dir, ignore_errors=True)
    os.rename(temp_dir, frames_dir)
    return log_result


def _resolve_scales(ckpt_scales, cfg_scales, interpolate_flag, rate_count):
    if cfg_scales:
        if interpolate_flag:
            return interpolate_log(cfg_scales[-1], cfg_scales[0], rate_count)
        assert len(cfg_scales) == rate_count
        return np.asarray(cfg_scales)
    if len(ckpt_scales) == rate_count:
        return np.asarray(ckpt_scales)
    return interpolate_log(ckpt_scales[-1], ckpt_scales[0], rate_count)


def decod_dcvc(dataset_dir, gop, rate_count, out_dir, config, device="cuda"):
    """Every video folder of dataset_dir (<video>/images/imNNNNN.png) at
    every rate point, with the .pth weights the config names."""
    device = resolve_device(device)
    if config["image_model_weights"]:
        i_ckpt_q = get_i_frame_q_scales_from_ckpt(config["image_model_weights"])
        i_scales = _resolve_scales(i_ckpt_q, config.get("i_frame_q_scales"),
                                   config.get("interpolate_q_scales"),
                                   rate_count)
    else:
        i_scales = [0] * rate_count

    y_ckpt, mv_ckpt = get_q_scales_from_ckpt(config["video_model_weights"])
    y_scales = _resolve_scales(y_ckpt, config.get("p_frame_y_q_scales"),
                               config.get("interpolate_q_scales"), rate_count)
    mv_scales = _resolve_scales(mv_ckpt, config.get("p_frame_mv_q_scales"),
                                config.get("interpolate_q_scales"), rate_count)

    i_codec = None
    if config["image_model_weights"]:
        i_codec = IntraCodec(load_codec_weights(
            IntraNoAR(device=device), config["image_model_weights"]),
            device=device)
    video_codec = VideoCodec(load_codec_weights(
        DMC(anchor_num=int(config["anchor_num"]), device=device),
        config["video_model_weights"]), device=device)

    model_dir = os.path.join(out_dir, config["name"])
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir, exist_ok=True)
    for video_folder in (f for f in os.scandir(dataset_dir) if f.is_dir()):
        images_path = os.path.join(video_folder.path, "images")
        frame_num = len(glob(os.path.join(images_path, "*.png")))
        decoded_frame_folder = os.path.join(model_dir, video_folder.name)
        shutil.rmtree(decoded_frame_folder, ignore_errors=True)
        os.makedirs(decoded_frame_folder, exist_ok=True)
        print(f"Video: {video_folder.name}")
        for rate_idx in range(rate_count):
            print(f"\tRate: {rate_idx + 1}")
            run_test(video_codec, i_codec, dict(
                rate_idx=rate_idx,
                i_frame_q_scale=float(i_scales[rate_idx]),
                p_frame_y_q_scale=float(y_scales[rate_idx]),
                p_frame_mv_y_q_scale=float(mv_scales[rate_idx]),
                gop=gop, frame_num=frame_num, img_path=images_path,
                decoded_frame_folder=decoded_frame_folder))


# ---------------------------------------------------------------- HEVC anchor

def get_video_bpp(path, countable=True):
    cv2 = require_cv2("get_video_bpp")
    cap = cv2.VideoCapture(path)
    size = os.path.getsize(path) * 8
    w = cap.get(cv2.CAP_PROP_FRAME_WIDTH)
    h = cv2.VideoCapture(path).get(cv2.CAP_PROP_FRAME_HEIGHT)
    if countable:
        count = cap.get(cv2.CAP_PROP_FRAME_COUNT)
    else:
        count = 0
        while cap.isOpened():
            ret, _ = cap.read()
            if not ret:
                break
            count += 1
    return size / count / w / h


def video_to_frames(video_path, out_dir, gop, quality_index):
    cv2 = require_cv2("video_to_frames")
    os.makedirs(out_dir, exist_ok=True)
    result_name = f"quality_{quality_index}"
    with open(os.path.join(out_dir, result_name + ".json"), "w") as fp:
        json.dump({"gop": gop,
                   "avg_bpp": get_video_bpp(video_path, countable=False)}, fp)

    frames_dir = os.path.join(out_dir, result_name)
    shutil.rmtree(frames_dir, ignore_errors=True)
    os.makedirs(frames_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = 1
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        cv2.imwrite(os.path.join(frames_dir, f"im{str(i).zfill(5)}.png"),
                    frame)
        i += 1
    cap.release()


def encode_folder(src_files, out_path, framerate, crf=0, gop=32,
                  preset="ultrafast"):
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg (libx265) required for HEVC anchors")
    call(["ffmpeg", "-hide_banner", "-pix_fmt", "yuv420p",
          "-framerate", str(framerate), "-loglevel", "error",
          "-i", src_files, "-c:v", "libx265",
          "-x265-params", f"crf={crf}:keyint={gop}",
          "-preset", preset, "-tune", "zerolatency", "-f", "hevc",
          "-y", out_path])


def decod_hevc(dataset_dir, out_dir, rate_num, gop, config):
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("the HEVC anchors need ffmpeg (libx265), which "
                           "is not installed")
    require_cv2("decod_hevc")
    crfs = np.linspace(config["crf_start"], config["crf_end"], num=rate_num,
                       dtype=np.int32).tolist()
    codec_dir = os.path.join(out_dir, config["name"])
    temp_dir = os.path.join(codec_dir, "temp")
    shutil.rmtree(codec_dir, ignore_errors=True)
    os.makedirs(codec_dir, exist_ok=True)
    for video_folder in (f for f in os.scandir(dataset_dir) if f.is_dir()):
        frames_dir = os.path.join(video_folder.path, "images", "im%05d.png")
        result_dir = os.path.join(codec_dir, video_folder.name)
        shutil.rmtree(temp_dir, ignore_errors=True)
        os.makedirs(temp_dir, exist_ok=True)
        shutil.rmtree(result_dir, ignore_errors=True)
        os.makedirs(result_dir, exist_ok=True)
        for index, crf in enumerate(crfs):
            out_path = os.path.join(temp_dir, f"crf_{crf}.mp4")
            encode_folder(frames_dir, out_path, framerate=config["fps"],
                          crf=crf, gop=gop, preset=config["preset"])
            video_to_frames(out_path, result_dir, gop, index)
        shutil.rmtree(temp_dir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Benchmark models decoding")
    parser.add_argument("--config", dest="config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    with open(args.config) as f:
        config = json.load(f)

    dataset_dir = config["dataset_dir"]
    gop = config["gop"]
    rate_count = config["rate_count"]
    out_dir = config["out_dir"]
    for key, value in config["codecs"].items():
        if key == "HEVC":
            for hevc_config in value:
                print(f"Decoding with {hevc_config['name']}")
                decod_hevc(dataset_dir, out_dir, rate_count, gop, hevc_config)
        elif key == "DCVC-HEM":
            for dcvc_config in value:
                print(f"Decoding with {dcvc_config['name']}")
                decod_dcvc(dataset_dir, gop, rate_count, out_dir, dcvc_config,
                           device=args.device)
        else:
            raise AttributeError("Invalid model in config file")


if __name__ == "__main__":
    main()
