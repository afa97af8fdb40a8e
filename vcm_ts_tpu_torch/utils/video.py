"""Video probing through OpenCV (the port's copy of vcm_ts_tpu/utils/video.py).

OpenCV is an optional host tool: the GPU machines the port runs on may not
have it, and then these raise with what to do instead.
"""

from __future__ import annotations


def require_cv2(what: str):
    """The cv2 module, or a RuntimeError naming what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{what} needs OpenCV (cv2), which is not installed; run the "
            "pipeline on a folder of PNG frames instead (the port reads and "
            "writes PNG itself)") from e
    return cv2


def get_video_length(video_path: str, from_header: bool = True) -> int:
    cv = require_cv2("reading a video's frame count")
    cap = cv.VideoCapture(video_path)
    if not cap.isOpened():
        return 0
    if from_header:
        length = int(cap.get(cv.CAP_PROP_FRAME_COUNT))
        cap.release()
        return length
    count = 0
    while True:
        ret, _ = cap.read()
        if not ret:
            break
        count += 1
    cap.release()
    return count


def get_video_resolution(video_path: str):
    cv = require_cv2("reading a video's resolution")
    cap = cv.VideoCapture(video_path)
    if not cap.isOpened():
        return 0, 0
    w = int(cap.get(cv.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return w, h
