"""Drawing and degradation primitives for the detector and OCR trainers'
synthetic scenes, in numpy and scipy (no cv2, no PIL).

The JAX package's trainers (tools/train_plate_detector.py,
tools/train_face_detector.py, tools/train_plate_ocr.py) draw their scenes
with OpenCV and PIL. These functions give the same shapes and the same
artefacts from the same random draws; they are not those libraries'
bytes:

- `fill_rect`, `draw_line`, `fill_ellipse`, `fill_circle`: cv2.rectangle
  (filled, inclusive corners), cv2.line (LINE_8: cv2's 8-connected run at
  thickness 1; its fixed-point band polygon and round caps beyond),
  cv2.ellipse (axis-aligned, filled: cv2's polygon of the ellipse, an arc
  closed through the centre) and cv2.circle (filled), drawn in place into
  an (H, W) or (H, W, C) float array; cv2's pixels, but for an arc's
  chord (cv2 fills arcs with its general polygon fill);
- `paste_rgba`: alpha paste;
- `rotation_matrix` / `warp_affine`: cv2.getRotationMatrix2D and
  cv2.warpAffine (bilinear, constant 0 border) through
  scipy.ndimage.affine_transform;
- `warp_perspective`: the four-corner homography of cv2.
  getPerspectiveTransform and cv2.warpPerspective (bilinear, replicate
  border);
- `gaussian_blur` / `box_blur_h`: cv2.GaussianBlur with sigma 0 (the
  binomial 3 and 5 taps cv2 uses then) and the horizontal motion-blur
  kernel of cv2.filter2D, both with cv2's reflect-101 border;
- `resize_area`: cv2.resize(..., INTER_AREA) on the host (the
  coefficient tables of ops/cv_resize);
- `resize_bilinear_u8` / `rotate_u8`: PIL's Image.resize(BILINEAR)
  (a triangle filter widened by the shrink factor) and
  Image.rotate(angle, expand=True, fillcolor, BILINEAR) on uint8 gray;
- `jpeg_roundtrip`: an 8x8 DCT, quantisation by the IJG luminance table
  scaled to the quality as libjpeg scales it, rounding and the inverse
  DCT: JPEG's blocking and ringing, not libjpeg's bytes.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import fft as sfft
from scipy import ndimage

from ..ops.cv_resize import area_matrices


def _clip_box(img, x1, y1, x2, y2):
    """The integer box [x1, x2] x [y1, y2] clipped to img, or None."""
    h, w = img.shape[:2]
    x1, x2 = max(int(math.floor(x1)), 0), min(int(math.ceil(x2)), w - 1)
    y1, y2 = max(int(math.floor(y1)), 0), min(int(math.ceil(y2)), h - 1)
    if x1 > x2 or y1 > y2:
        return None
    return x1, y1, x2, y2


def fill_rect(img: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(img, p1, p2, color, -1): corners inclusive."""
    (xa, ya), (xb, yb) = p1, p2
    box = _clip_box(img, min(xa, xb), min(ya, yb), max(xa, xb), max(ya, yb))
    if box is not None:
        x1, y1, x2, y2 = box
        img[y1:y2 + 1, x1:x2 + 1] = (np.asarray(color, img.dtype)
                                     if img.ndim == 3 else color)


def _bresenham(x1: int, y1: int, x2: int, y2: int):
    """cv2's 8-connected LineIterator, drawn from the left end: the
    pixels' x and y."""
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    i = np.arange(major + 1)
    # minor steps taken before pixel i: cv2's error term goes negative at
    # the pixels where ceil((2 minor i - major) / (2 major)) grows
    k = (np.maximum(-((major - 2 * minor * i) // (2 * major)), 0)
         if major else np.zeros(1, np.int64))
    if steep:
        return x1 + k, y1 + sy * i
    return x1 + i, y1 + sy * k


# cv2's drawing code works in 16-bit fixed point (XY_SHIFT in
# imgproc/src/drawing.cpp); the thick line and the ellipse below follow
# its integer steps, so that they give cv2's pixels
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _line_fixed(mask: np.ndarray, p1, p2) -> None:
    """cv2's Line2: the 8-connected line between two fixed-point points."""
    h, w = mask.shape
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        x_step, y_step = XY_ONE, _cdiv(dy * XY_ONE, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        x_step, y_step = _cdiv(dx * XY_ONE, ay | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    x1, y1 = x1 + HALF, y1 + HALF
    pts = [((x2 + HALF) >> XY_SHIFT, (y2 + HALF) >> XY_SHIFT)]
    if ax > ay:
        x = x1 >> XY_SHIFT
        for _ in range(count + 1):
            pts.append((x, y1 >> XY_SHIFT))
            x, y1 = x + 1, y1 + y_step
    else:
        y = y1 >> XY_SHIFT
        for _ in range(count + 1):
            pts.append((x1 >> XY_SHIFT, y))
            x1, y = x1 + x_step, y + 1
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = True


def _fill_convex(mask: np.ndarray, v: list) -> None:
    """cv2's FillConvexPoly (LINE_8) of fixed-point vertices: the outline
    by _line_fixed, then each row's span between the two edges walked
    from the top vertex."""
    h, w = mask.shape
    n = len(v)
    imin = min(range(n), key=lambda i: (v[i][1], i))
    p0 = v[-1]
    for p in v:
        _line_fixed(mask, p0, p)
        p0 = p
    xs_all = [p[0] for p in v]
    ys_all = [p[1] for p in v]
    xmin, xmax = (min(xs_all) + HALF) >> XY_SHIFT, (max(xs_all) + HALF) >> \
        XY_SHIFT
    ymin, ymax = (min(ys_all) + HALF) >> XY_SHIFT, (max(ys_all) + HALF) >> \
        XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
             {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    left_edges = n
    y = ymin
    while True:
        for e in edges:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                left_edges -= 1
                if left_edges < 0:
                    break
                ty = (v[idx][1] + HALF) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, x=xs, idx=idx,
                             dx=_cdiv((xe - xs) * 2 + (ty - y),
                                      2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if left_edges < 0:
            break
        if y >= 0:
            a, b = sorted((edges[0]["x"], edges[1]["x"]))
            x1, x2 = (a + HALF) >> XY_SHIFT, (b + HALF) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = True
        edges[0]["x"] += edges[0]["dx"]
        edges[1]["x"] += edges[1]["dx"]
        y += 1
        if y > ymax:
            break


def _bresenham(x1: int, y1: int, x2: int, y2: int):
    """cv2's 8-connected LineIterator, drawn from the left end: the
    pixels' x and y."""
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    i = np.arange(major + 1)
    # minor steps taken before pixel i: cv2's error term goes negative at
    # the pixels where ceil((2 minor i - major) / (2 major)) grows
    k = (np.maximum(-((major - 2 * minor * i) // (2 * major)), 0)
         if major else np.zeros(1, np.int64))
    if steep:
        return x1 + k, y1 + sy * i
    return x1 + i, y1 + sy * k


def _disc(mask: np.ndarray, cx: int, cy: int, r: int) -> None:
    h, w = mask.shape
    yy, xx = np.ogrid[0:h, 0:w]
    mask |= (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r


def _paint_mask(img: np.ndarray, mask: np.ndarray, color) -> None:
    img[mask] = np.asarray(color, img.dtype) if img.ndim == 3 else color


def draw_line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """cv2.line (LINE_8): at thickness 1 cv2's 8-connected run; thicker,
    cv2's ThickLine: the band's four fixed-point corners at half the
    thickness (rounded up to a whole pixel when odd) filled as cv2 fills a
    convex polygon, and round caps of radius (thickness + 1) // 2."""
    (x1, y1), (x2, y2) = (int(v) for v in p1), (int(v) for v in p2)
    h, w = img.shape[:2]
    if thickness <= 1:
        xs, ys = _bresenham(x1, y1, x2, y2)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        mask = np.zeros((h, w), bool)
        mask[ys[ok], xs[ok]] = True
        _paint_mask(img, mask, color)
        return
    mask = np.zeros((h, w), bool)
    fx1, fy1, fx2, fy2 = (v << XY_SHIFT for v in (x1, y1, x2, y2))
    dx, dy = float(x1 - x2), float(y2 - y1)
    r2 = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if r2 > 0:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r2)
        px, py = int(round(dy * r)), int(round(dx * r))
        _fill_convex(mask, [(fx1 + px, fy1 + py), (fx1 - px, fy1 - py),
                            (fx2 - px, fy2 - py), (fx2 + px, fy2 + py)])
    cap = (half + HALF) >> XY_SHIFT
    _disc(mask, x1, y1, cap)
    _disc(mask, x2, y2, cap)
    _paint_mask(img, mask, color)


def _ellipse_vertices(center, axes, start: int, end: int) -> list:
    """cv2's EllipseEx polygon (angle 0): ellipse2Poly's points every 5-90
    degrees (by the larger axis) from cv2's float sine table, in fixed
    point, repeats dropped; an arc closes through the centre."""
    cx, cy = center[0] << XY_SHIFT, center[1] << XY_SHIFT
    ax, ay = abs(axes[0]) << XY_SHIFT, abs(axes[1]) << XY_SHIFT
    step = (max(ax, ay) + HALF) >> XY_SHIFT
    step = 90 if step < 3 else 30 if step < 10 else 18 if step < 15 else 5
    out, prev = [], None
    for a in range(start, end + step, step):
        a = min(a, end)
        px = cx + ax * float(np.float32(math.sin(math.radians(450 - a))))
        py = cy + ay * float(np.float32(math.sin(math.radians(a))))
        qx = int(round(px / XY_ONE)) << XY_SHIFT
        qy = int(round(py / XY_ONE)) << XY_SHIFT
        q = (qx + int(round(px - qx)), qy + int(round(py - qy)))
        if q != prev:
            out.append(q)
            prev = q
    if len(out) == 1:
        out = [(cx, cy), (cx, cy)]
    if end - start < 360:
        out.append((cx, cy))
    return out


def fill_ellipse(img: np.ndarray, center, axes, start: int, end: int,
                 color) -> None:
    """cv2.ellipse(img, center, axes, 0, start, end, color, -1): the
    polygon of _ellipse_vertices filled as cv2 fills a convex polygon
    (cv2 fills an arc's polygon with its general polygon fill, which can
    differ at the arc's chord by a pixel)."""
    mask = np.zeros(img.shape[:2], bool)
    _fill_convex(mask, _ellipse_vertices(
        (int(center[0]), int(center[1])), (int(axes[0]), int(axes[1])),
        int(start), int(end)))
    _paint_mask(img, mask, color)


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1): the pixels within
    `radius` of the centre."""
    mask = np.zeros(img.shape[:2], bool)
    _disc(mask, int(center[0]), int(center[1]), int(radius))
    _paint_mask(img, mask, color)


def paste_rgba(img: np.ndarray, patch: np.ndarray, x: int, y: int) -> None:
    """Blend an (h, w, 4) RGB + alpha patch into img at (x, y)."""
    ph, pw = patch.shape[:2]
    a = patch[:, :, 3:4]
    img[y:y + ph, x:x + pw] = (img[y:y + ph, x:x + pw] * (1 - a)
                               + patch[:, :, :3] * a)


# ----------------------------------------------------------- geometry
def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3), angle in degrees counter-clockwise
    on the screen (y down)."""
    cx, cy = center
    a = scale * math.cos(math.radians(angle))
    b = scale * math.sin(math.radians(angle))
    return np.array([[a, b, (1 - a) * cx - b * cy],
                     [-b, a, b * cx + (1 - a) * cy]], np.float64)


def warp_affine(img: np.ndarray, m: np.ndarray, size) -> np.ndarray:
    """cv2.warpAffine(img, m, (w, h)): dst(x, y) = src(m^-1 (x, y)),
    bilinear, 0 outside (blended at the edges, as cv2's constant border)."""
    w, h = size
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2]
    (a, b, c), (d, e, f) = inv
    if img.ndim == 2:
        return ndimage.affine_transform(
            img, [[e, d], [b, a]], offset=[f, c], output_shape=(h, w),
            order=1, mode="grid-constant", cval=0.0).astype(img.dtype)
    return ndimage.affine_transform(
        img, [[e, d, 0], [b, a, 0], [0, 0, 1]], offset=[f, c, 0],
        output_shape=(h, w, img.shape[2]), order=1, mode="grid-constant",
        cval=0.0).astype(img.dtype)


def perspective_matrix(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform: the 3x3 homography taking the four
    src points onto the four dst points (h33 = 1)."""
    a = np.zeros((8, 8), np.float64)
    rhs = np.zeros(8, np.float64)
    for i, ((x, y), (u, v)) in enumerate(zip(np.asarray(src, np.float64),
                                             np.asarray(dst, np.float64))):
        a[i] = (x, y, 1, 0, 0, 0, -x * u, -y * u)
        a[i + 4] = (0, 0, 0, x, y, 1, -x * v, -y * v)
        rhs[i], rhs[i + 4] = u, v
    return np.append(np.linalg.solve(a, rhs), 1.0).reshape(3, 3)


def warp_perspective(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """cv2.warpPerspective(img, m, (w, h), borderMode=BORDER_REPLICATE)
    on a uint8 image of that size: bilinear, rounded."""
    h, w = img.shape[:2]
    inv = np.linalg.inv(m)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    den = inv[2, 0] * xx + inv[2, 1] * yy + inv[2, 2]
    sx = (inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]) / den
    sy = (inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]) / den
    out = ndimage.map_coordinates(img.astype(np.float64), [sy, sx], order=1,
                                  mode="nearest")
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- filters
_BINOMIAL = {3: np.array([1, 2, 1], np.float64) / 4,
             5: np.array([1, 4, 6, 4, 1], np.float64) / 16}


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (k, k), 0) for k in (3, 5): cv2's fixed
    binomial kernels, reflect-101 border ("mirror")."""
    taps = _BINOMIAL[k]
    out = ndimage.correlate1d(img.astype(np.float64), taps, axis=0,
                              mode="mirror")
    out = ndimage.correlate1d(out, taps, axis=1, mode="mirror")
    return out.astype(np.float32)


def box_blur_h(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.filter2D with a k x k kernel whose middle row is 1 / k: a
    horizontal mean of k pixels, reflect-101 border."""
    return ndimage.correlate1d(img.astype(np.float64), np.full(k, 1.0 / k),
                               axis=1, mode="mirror").astype(np.float32)


def _band(m: np.ndarray):
    """A resize matrix whose rows have contiguous support as (rows, K)
    source indexes and weights (K the widest row; unused taps weigh 0)."""
    nz = m != 0
    lo = nz.argmax(1)
    k = int((m.shape[1] - nz[:, ::-1].argmax(1) - lo).max())
    idx = np.minimum(lo[:, None] + np.arange(k)[None], m.shape[1] - 1)
    wts = np.take_along_axis(m, idx, 1)
    wts[lo[:, None] + np.arange(k)[None] >= m.shape[1]] = 0
    return idx, wts


def resize_area(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA) of an
    (H, W) or (H, W, C) float image: OpenCV's coefficient tables
    (ops/cv_resize.area_matrices) applied as banded sums, rows then
    columns (f32 sums in another order than cv2's)."""
    src = np.asarray(img, np.float32)
    flat = src.ndim == 2
    if flat:
        src = src[:, :, None]
    ry, rx = area_matrices(src.shape[0], src.shape[1], dh, dw)
    iy, wy = _band(ry)
    ix, wx = _band(rx)
    rows = np.einsum("yk,ykwc->ywc", wy, src[iy])
    out = np.einsum("xk,yxkc->yxc", wx, rows[:, ix])
    return out[:, :, 0] if flat else out


# ------------------------------------------------- PIL resize / rotate
def _pil_bilinear_taps(src: int, dst: int):
    """PIL's BILINEAR resample of one axis as (dst, K) source indexes and
    weights: a triangle of radius max(src / dst, 1) around each output
    centre, over PIL's tap window, normalised (unused taps weigh 0)."""
    scale = src / dst
    fscale = max(scale, 1.0)
    center = (np.arange(dst) + 0.5) * scale
    lo = np.maximum((center - fscale + 0.5).astype(np.int64), 0)
    hi = np.minimum((center + fscale + 0.5).astype(np.int64), src)
    j = lo[:, None] + np.arange(int((hi - lo).max()))[None]
    wts = np.clip(1.0 - np.abs((j - center[:, None] + 0.5) / fscale), 0.0,
                  None) * (j < hi[:, None])
    total = wts.sum(1, keepdims=True)
    wts = np.divide(wts, total, out=np.zeros_like(wts), where=total > 0)
    return np.minimum(j, src - 1), wts


def resize_bilinear_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """PIL Image.resize((w, h), BILINEAR) of an (H, W) uint8 image: the
    horizontal pass, rounded to uint8, then the vertical pass."""
    xi, xw = _pil_bilinear_taps(img.shape[1], w)
    yi, yw = _pil_bilinear_taps(img.shape[0], h)
    mid = np.einsum("hwk,wk->hw", img.astype(np.float64)[:, xi], xw)
    mid = np.clip(np.floor(mid + 0.5), 0, 255)
    out = np.einsum("hkw,hk->hw", mid[yi], yw)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def rotate_u8(img: np.ndarray, angle: float, fill: int) -> np.ndarray:
    """PIL Image.rotate(angle, expand=True, fillcolor=fill,
    resample=BILINEAR) of an (H, W) uint8 image: counter-clockwise, the
    canvas grown to hold every corner, `fill` where the source point
    falls outside the image, truncated to uint8 as PIL stores it."""
    h, w = img.shape
    rad = -math.radians(angle % 360.0)
    a, b = round(math.cos(rad), 15), round(math.sin(rad), 15)
    d, e = round(-math.sin(rad), 15), round(math.cos(rad), 15)
    cx, cy = w / 2.0, h / 2.0
    c = a * -cx + b * -cy + cx
    f = d * -cx + e * -cy + cy
    xs, ys = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        xs.append(a * x + b * y + c)
        ys.append(d * x + e * y + f)
    nw = math.ceil(max(xs)) - math.floor(min(xs))
    nh = math.ceil(max(ys)) - math.floor(min(ys))
    ox, oy = -(nw - w) / 2.0, -(nh - h) / 2.0
    c, f = a * ox + b * oy + c, d * ox + e * oy + f
    yy, xx = np.mgrid[0:nh, 0:nw].astype(np.float64) + 0.5
    xin = a * xx + b * yy + c
    yin = d * xx + e * yy + f
    outside = (xin < 0) | (xin >= w) | (yin < 0) | (yin >= h)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = np.floor(xin).astype(np.int64), np.floor(yin).astype(np.int64)
    dx, dy = xin - x0, yin - y0
    src = img.astype(np.float64)

    def tap(yi, xi):
        return src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]

    top = tap(y0, x0) * (1 - dx) + tap(y0, x0 + 1) * dx
    bot = tap(y0 + 1, x0) * (1 - dx) + tap(y0 + 1, x0 + 1) * dx
    # PIL reuses the top row where y0 + 1 falls off the image
    bot = np.where(y0 + 1 < h, bot, top)
    out = top * (1 - dy) + bot * dy
    out = np.where(outside, float(fill), out)
    return np.clip(out, 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- JPEG
_IJG_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.int64)


def jpeg_table(quality: int) -> np.ndarray:
    """The IJG luminance table at `quality` (libjpeg's
    jpeg_quality_scaling, baseline: entries in 1..255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((_IJG_LUMA * scale + 50) // 100, 1, 255)


def jpeg_roundtrip(gray: np.ndarray, quality: int) -> np.ndarray:
    """A baseline-JPEG-style round trip of an (H, W) uint8 image: edge
    pad to 8x8 blocks, level shift, orthonormal 8x8 DCT (JPEG's
    normalisation), quantise and round, dequantise, inverse DCT, round
    and clip."""
    h, w = gray.shape
    ph, pw = -h % 8, -w % 8
    x = np.pad(gray.astype(np.float64), ((0, ph), (0, pw)), mode="edge")
    x -= 128.0
    hb, wb = x.shape[0] // 8, x.shape[1] // 8
    blocks = x.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
    q = jpeg_table(quality).astype(np.float64)
    coef = sfft.dctn(blocks, type=2, axes=(2, 3), norm="ortho")
    coef = np.round(coef / q) * q
    y = sfft.idctn(coef, type=2, axes=(2, 3), norm="ortho")
    y = y.transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8)[:h, :w] + 128.0
    return np.clip(np.floor(y + 0.5), 0, 255).astype(np.uint8)
