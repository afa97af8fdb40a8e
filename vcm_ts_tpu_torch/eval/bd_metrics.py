"""Bjontegaard-Delta metrics (BD-rate, BD-quality) in numpy/scipy (the
port's copy of vcm_ts_tpu/eval/bd_metrics.py): pchip (default), cubic or
akima interpolation of the RD curves over their common interval.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate


def _interp(x, y, method: str):
    order = np.argsort(x)
    x, y = np.asarray(x, float)[order], np.asarray(y, float)[order]
    if method == "pchip":
        return interpolate.PchipInterpolator(x, y)
    if method == "akima":
        return interpolate.Akima1DInterpolator(x, y)
    if method == "cubic":
        return interpolate.CubicSpline(x, y)
    raise ValueError(f"unknown interpolation method: {method}")


def bd_rate(rate_anchor, quality_anchor, rate_test, quality_test,
            method: str = "pchip") -> float:
    """Average bitrate difference (%) at equal quality."""
    log_ra = np.log(np.asarray(rate_anchor, float))
    log_rt = np.log(np.asarray(rate_test, float))
    qa = np.asarray(quality_anchor, float)
    qt = np.asarray(quality_test, float)

    lo = max(qa.min(), qt.min())
    hi = min(qa.max(), qt.max())
    if hi <= lo:
        return float("nan")

    fa = _interp(qa, log_ra, method)
    ft = _interp(qt, log_rt, method)
    int_a = fa.antiderivative()(hi) - fa.antiderivative()(lo)
    int_t = ft.antiderivative()(hi) - ft.antiderivative()(lo)
    avg_diff = (int_t - int_a) / (hi - lo)
    return float((np.exp(avg_diff) - 1) * 100)


def bd_quality(rate_anchor, quality_anchor, rate_test, quality_test,
               method: str = "pchip") -> float:
    """Average quality difference at equal bitrate (aka BD-PSNR)."""
    log_ra = np.log(np.asarray(rate_anchor, float))
    log_rt = np.log(np.asarray(rate_test, float))
    qa = np.asarray(quality_anchor, float)
    qt = np.asarray(quality_test, float)

    lo = max(log_ra.min(), log_rt.min())
    hi = min(log_ra.max(), log_rt.max())
    if hi <= lo:
        return float("nan")

    fa = _interp(log_ra, qa, method)
    ft = _interp(log_rt, qt, method)
    int_a = fa.antiderivative()(hi) - fa.antiderivative()(lo)
    int_t = ft.antiderivative()(hi) - ft.antiderivative()(lo)
    return float((int_t - int_a) / (hi - lo))


# name parity with the bjontegaard package API used by bd_rate.py
bd_psnr = bd_quality


def fix_curve(points, eps: float = 1e-8):
    """Monotonicity fixup (reference bd_rate.py:12-31)."""
    is_asc = points[0] < points[-1]
    result = []
    for point in points:
        if not result:
            result.append(point)
        elif is_asc:
            result.append(point if point > result[-1] else result[-1] + eps)
        else:
            result.append(point if point < result[-1] else result[-1] - eps)
    return result
