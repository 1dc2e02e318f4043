"""Sensor preprocessing on the host, in numpy: what phase 1
(``data/dataset.py:CarlaDataset``) decodes raw frames with and what the
agents prepare their camera and radar inputs with.

The module imports numpy and nothing of torch, so the spawned workers of
``preprocess_to_pickles`` start without loading torch.

- ``scale_and_crop_image``: integer downscale and center crop (uint8 HWC in
  and out). The reference downscales with PIL's ``Image.resize`` (bicubic by
  default); ``resize_bicubic_pil`` is PIL's 8-bit resampler in numpy (its
  coefficients, 22-bit fixed point and rounding, horizontal pass first),
  equal to PIL's pixels for gray and RGB images.
- ``radar_to_size_np``: fit a variable-length return set to exactly 81 rows.
  Surplus rows with the largest |velocity/depth| are deleted, keeping the
  survivors in their original order; a short set is zero-padded.
- ``transform_2d_points_np`` / ``lidar_to_histogram_features_np``: the
  float64 re-registration and the ``np.histogramdd`` binning with which
  phase 1 makes training samples, copied from the JAX package as they are,
  so the port's pickles equal the JAX package's bit for bit.
  ``histogramdd`` counts a point on the last edge into the last bin, where
  kernel 1 (``ops/lidar.py``) drops it; no kernel runs here.
- The BEV grid's constants, which ``ops/lidar.py`` and its kernel share.
"""

from __future__ import annotations

import math

import numpy as np

PIXELS_PER_METER = 8
HIST_MAX_PER_PIXEL = 5.0
X_RANGE = (-16.0, 16.0)
Y_RANGE = (-24.0, 8.0)
HEIGHT_SPLIT = -2.0  # z <= -2 -> "below" channel 0, else "above" channel 1


def scale_and_crop_image(image: np.ndarray, scale: int = 1, crop: int = 256) -> np.ndarray:
    """Downscale by an integer factor (PIL's default resample, as the
    reference's ``image.resize((w, h))``) and center-crop to (crop, crop, C).
    The row offset comes from the height and the column offset from the
    width, as in the reference."""
    image = np.asarray(image)
    h, w = image.shape[:2]
    if scale != 1:
        new_w, new_h = int(w // scale), int(h // scale)
        image = resize_bicubic_pil(image, new_w, new_h)
        h, w = new_h, new_w
    row0 = h // 2 - crop // 2
    col0 = w // 2 - crop // 2
    return image[row0:row0 + crop, col0:col0 + crop]


_PRECISION_BITS = 32 - 8 - 2      # PIL's fixed point for 8-bit images


def _bicubic(x: float) -> float:
    """PIL's bicubic kernel (a = -0.5), in PIL's order of operations."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _resample_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the full
    box: (first input index, number of taps, (out_size, ksize) int64 weights
    in 22-bit fixed point) of each output pixel."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            fixed = w * (1 << _PRECISION_BITS)
            weights[xx, x] = int(fixed - 0.5) if w < 0 else int(fixed + 0.5)
        first[xx] = xmin
    return first, weights


def _resample_axis(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (1: columns, 0: rows) of (h, w, c) uint8."""
    in_size = image.shape[axis]
    first, weights = _resample_coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), in_size - 1)
    taps = np.take(image, idx, axis=axis).astype(np.int64)   # taps after ``axis``
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = weights.shape
    acc = (taps * weights.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic_pil(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.fromarray(image).resize((width, height))`` for an (h, w)
    or (h, w, 3) uint8 image, pixel for pixel: bicubic, horizontal pass
    first, each pass rounded and clipped to uint8. PIL premultiplies an RGBA
    image's alpha first, which this does not do, so it refuses RGBA."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or \
            (image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"resize_bicubic_pil takes gray (h, w) or RGB (h, w, 3) uint8, "
                         f"not {image.dtype} {image.shape} (RGBA would need PIL's "
                         "premultiplied alpha)")
    out = image[:, :, None] if image.ndim == 2 else image
    if width != out.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != out.shape[0]:
        out = _resample_axis(out, height, 0)
    return out[:, :, 0] if image.ndim == 2 else out


def radar_to_size_np(data: np.ndarray, target_size=(81, 5)) -> np.ndarray:
    data = np.asarray(data)
    out = np.zeros(target_size)
    if data.shape[0] >= target_size[0]:
        n_extra = data.shape[0] - target_size[0]
        order = (-np.abs(data[:, 0] / data[:, 3])).argsort()
        out = np.delete(data, order[:n_extra], 0)
    else:
        out[:data.shape[0], :] = data
    return out


def transform_2d_points_np(xyz: np.ndarray, r1: float, t1_x: float, t1_y: float,
                           r2: float, t2_x: float, t2_y: float) -> np.ndarray:
    """Map points from the pose-1 frame to the pose-2 frame in float64 (the
    frame-to-world transform is ``[[cos r, sin r, tx], [-sin r, cos r, ty]]``
    applied to [x, y, 1]); further columns are carried through."""
    out = np.array(xyz, dtype=np.float64, copy=True)
    c1, s1 = np.cos(r1), np.sin(r1)
    c2, s2 = np.cos(r2), np.sin(r2)
    x, y = xyz[:, 0], xyz[:, 1]
    wx = c1 * x + s1 * y + t1_x
    wy = -s1 * x + c1 * y + t1_y
    # inverse of the pose-2 frame-to-world transform
    dx, dy = wx - t2_x, wy - t2_y
    out[:, 0] = c2 * dx - s2 * dy
    out[:, 1] = s2 * dx + c2 * dy
    return out


def lidar_to_histogram_features_np(lidar: np.ndarray) -> np.ndarray:
    """(N, >=3) points -> (256, 256, 2) float32 NHWC through
    ``np.histogramdd`` (channel 0 below the split, 1 above; [x-bin, y-bin])."""
    nx = int((X_RANGE[1] - X_RANGE[0]) * PIXELS_PER_METER)
    xbins = np.linspace(X_RANGE[0], X_RANGE[1], nx + 1)
    ybins = np.linspace(Y_RANGE[0], Y_RANGE[1], nx + 1)

    def splat(points: np.ndarray) -> np.ndarray:
        hist = np.histogramdd(points[..., :2], bins=(xbins, ybins))[0]
        hist[hist > HIST_MAX_PER_PIXEL] = HIST_MAX_PER_PIXEL
        return hist / HIST_MAX_PER_PIXEL

    below = lidar[lidar[..., 2] <= HEIGHT_SPLIT]
    above = lidar[lidar[..., 2] > HEIGHT_SPLIT]
    return np.stack([splat(below), splat(above)], axis=-1).astype(np.float32)
