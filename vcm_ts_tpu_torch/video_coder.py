"""VCM codec CLI of the port: Video Coding for Machines for Traffic Scenes.

    python -m vcm_ts_tpu_torch.video_coder --video-path IN.avi \
        --result-root OUT [--settings-file configs/codec_settings.yaml] \
        [--do-encode yes|no] [--do-decode yes|no] [--device cuda|cpu]

The flags, settings tree, artifact layout and reports of the repository's
video_coder.py, on the port's pipeline (codec/vcm_pipeline.py): the
DCVC-HEM base layer, ROI detection with the shipped detectors, masked
residuals, the enhancement layer (learned with ENHANCEMENT_LAYER.CODEC:
intra, else H.265 through ffmpeg), fusion, and the bitrate and PSNR
reports. Splitting the input video into frames needs OpenCV; without
ffmpeg the H.265 steps are skipped with a warning, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import shutil

from .codec import vcm_pipeline as vp
from .utils.common import str2bool
from .utils.config import default_codec_settings
from .utils.device import resolve_device
from .utils.logger import setup_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Video Coding for Machines for Traffic Scenes (PyTorch)")
    parser.add_argument("--video-path", dest="video_path", type=str,
                        required=True, help="Path to video to recompress")
    parser.add_argument("--settings-file", dest="settings_file", type=str,
                        default="configs/codec_settings.yaml", metavar="FILE")
    parser.add_argument("--result-root", dest="result_root", type=str,
                        required=True)
    parser.add_argument("--do-encode", dest="do_encode", type=str2bool,
                        default=True)
    parser.add_argument("--do-decode", dest="do_decode", type=str2bool,
                        default=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the codecs, detectors and "
                             "metrics (default cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    logger = setup_logger("CODEC", 0)
    logger.info(args)

    codec_settings = default_codec_settings()
    if args.settings_file and os.path.exists(args.settings_file):
        codec_settings.merge_from_file(args.settings_file)
    codec_settings.freeze()

    os.makedirs(os.path.join(args.result_root, vp.PATHS_INFO), exist_ok=True)
    with open(os.path.join(args.result_root, vp.PATHS_INFO,
                           "codec_settings.yaml"), "w") as f:
        f.write(str(codec_settings))

    dets = codec_settings.ENHANCEMENT_LAYER.DETECTORS
    root = args.result_root

    if args.do_encode:
        vp.video_to_frames(args.video_path, root,
                           vp.PATHS_ARTIFACTS_SOURCE_FRAMES)

        bl = codec_settings.BASE_LAYER.DCVC_HEM
        vp.encode_decode_dcvc(
            frames_dir=os.path.join(root, vp.PATHS_ARTIFACTS_SOURCE_FRAMES),
            image_model_weights=bl.I_FRAME_WEIGHTS,
            video_model_weights=bl.P_FRAME_WEIGHTS,
            anchor_num=bl.ANCHOR_NUM, gop=bl.GOP,
            rate_count=bl.RATE_COUNT, quality=bl.QUALITY,
            write_stream=bl.WRITE_STREAM,
            out_frames_dir=os.path.join(root, vp.PATHS_ARTIFACTS_DCVC_HEM),
            out_bins_dir=os.path.join(root, vp.PATHS_ENCODED_DIR,
                                      "dcvc_hem_bins"),
            device=device)

        if dets.LIPLATES.ENABLE:
            vp.detect_rois(root, "liplates", prob=dets.LIPLATES.PROB,
                           padding=dets.LIPLATES.PADDING, device=device)
        if dets.FACES.ENABLE:
            vp.detect_rois(root, "faces", prob=dets.FACES.PROB,
                           padding=dets.FACES.PADDING, device=device)

        vp.compute_residuals(
            root, use_liplates=dets.LIPLATES.ENABLE,
            use_faces=dets.FACES.ENABLE,
            out_residuals_dir=os.path.join(root,
                                           vp.PATHS_ARTIFACTS_RESIDUALS),
            device=device)

        enh_codec = codec_settings.ENHANCEMENT_LAYER.CODEC
        if enh_codec not in ("h265", "intra"):
            raise ValueError(
                f"ENHANCEMENT_LAYER.CODEC must be 'h265' or 'intra', got "
                f"{enh_codec!r}")
        have_ffmpeg = shutil.which("ffmpeg") is not None
        if enh_codec == "intra":
            learned = codec_settings.ENHANCEMENT_LAYER.LEARNED
            vp.encode_residuals_learned(
                root,
                image_model_weights=(
                    learned.I_FRAME_WEIGHTS
                    or codec_settings.BASE_LAYER.DCVC_HEM.I_FRAME_WEIGHTS),
                quality=learned.QUALITY, rate_count=learned.RATE_COUNT,
                out_frames_dir=os.path.join(
                    root, vp.PATHS_ARTIFACTS_RESIDUALS_ENCODED),
                device=device)
        elif have_ffmpeg:
            # drop stale learned-layer bins of an earlier CODEC=intra run so
            # the size accounting counts this run's layer only
            shutil.rmtree(os.path.join(root, vp.PATHS_ENCODED_DIR,
                                       "enhancement_bins"),
                          ignore_errors=True)
            h265 = codec_settings.ENHANCEMENT_LAYER.H265
            vp.encode_frames(
                src_root=os.path.join(root, vp.PATHS_ARTIFACTS_RESIDUALS),
                video_path=os.path.join(root, vp.PATHS_ENCODED_DIR,
                                        "enhancement_layer.h265"),
                crf=h265.CRF, preset=h265.PRESET, pix_fmt=h265.PIX_FMT,
                save_to_frames=True,
                frames_path=os.path.join(
                    root, vp.PATHS_ARTIFACTS_RESIDUALS_ENCODED))
        else:
            logger.warning(
                "ffmpeg not found: skipping H.265 enhancement-layer encode; "
                "the decoder will fuse the raw (lossless) residual PNGs "
                "(set ENHANCEMENT_LAYER.CODEC: intra for the ffmpeg-free "
                "learned enhancement layer)")

        vp.calc_bitrate_metrics(root, args.video_path,
                                gop=codec_settings.BASE_LAYER.DCVC_HEM.GOP)

    if args.do_decode:
        vp.fuse_layers(root, faces_enable=dets.FACES.ENABLE,
                       liplates_enable=dets.LIPLATES.ENABLE,
                       faces_padding=dets.FACES.PADDING,
                       liplates_padding=dets.LIPLATES.PADDING, device=device)

        if shutil.which("ffmpeg") is not None:
            vp.encode_frames(
                src_root=os.path.join(root, vp.PATHS_ARTIFACTS_RESULT),
                video_path=os.path.join(root, vp.PATHS_DECODED_DIR,
                                        "vcm-ts_decoded.h265"),
                crf=0, preset="medium", pix_fmt="gbrp", save_to_frames=False)

            cmp265 = codec_settings.COMPARE.H265
            vp.encode_same_bitrate(
                root, args.video_path,
                out_video_path=os.path.join(root, vp.PATHS_DECODED_DIR,
                                            "same_bitrate.h265"),
                preset=cmp265.PRESET, pix_fmt=cmp265.PIX_FMT,
                save_to_frames=True,
                frames_path=os.path.join(root,
                                         vp.PATHS_ARTIFACTS_SAME_BITRATE))
        else:
            logger.warning(
                "ffmpeg not found: skipping lossless export and the "
                "same-bitrate H.265 comparison encode")

        vp.calc_visual_metrics(root, args.video_path,
                               liplates_padding=dets.LIPLATES.PADDING,
                               faces_padding=dets.FACES.PADDING,
                               device=device)


if __name__ == "__main__":
    main()
