"""Illustration line-art detail maps -> per-latent loss-weight masks.

Counterpart of ``aozora_sdxl_training_tpu/tools/semantic_maps.py`` (the
reference's semantic.py:10-52): a single Laplacian high-frequency response
with coherence boosting and a robust percentile scaling gives an [H, W]
map in [0, 1] of lines and fine texture; reduced to the latent grid it
weights the flow-matching loss toward detailed regions (the QAT repair
trainer's line-art loss).

The JAX package computes it with OpenCV; the port needs no cv2. Each of its
calls is written here in numpy with OpenCV's defaults:

* ``cvtColor(RGB2GRAY)`` on uint8: the 15-bit fixed-point luma
  (9798 R + 19235 G + 3735 B + 2^14) >> 15 (equal to OpenCV's on all
  2^24 colours);
* ``GaussianBlur((3, 3), 0.55)``: ``getGaussianKernel``'s float32 taps,
  the row pass then the column pass;
* ``Laplacian(ksize=3)``: the 3x3 kernel [[2, 0, 2], [0, -8, 0], [2, 0, 2]];
* ``blur((5, 5))``: the normalized box, summed in float64;
* all three over BORDER_REFLECT_101;
* ``resize(INTER_AREA)`` at an integer ratio: the block mean. Every
  reduction on the repair path is one (pixels / 2, then / 4); any other
  ratio raises rather than approximate OpenCV's fractional weights.
"""

from __future__ import annotations

import numpy as np


def _rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def _reflect101(x: np.ndarray, pad: int) -> np.ndarray:
    return np.pad(x, pad, mode="reflect")    # numpy's "reflect" is REFLECT_101


def _gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """``cv::getGaussianKernel(ksize, sigma, CV_32F)``."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (taps * (1.0 / taps.astype(np.float64).sum())).astype(np.float32)


def _gaussian_blur3(x: np.ndarray, sigma: float) -> np.ndarray:
    k0, k1 = _gaussian_taps(3, sigma)[[1, 0]]
    p = _reflect101(x, 1)
    rows = p[:, 1:-1] * k0 + (p[:, :-2] + p[:, 2:]) * k1
    return rows[1:-1] * k0 + (rows[:-2] + rows[2:]) * k1


def _laplacian3(x: np.ndarray) -> np.ndarray:
    p = _reflect101(x, 1)
    two = np.float32(2.0)
    out = p[:-2, :-2] * two + p[:-2, 2:] * two
    out = out + p[1:-1, 1:-1] * np.float32(-8.0)
    out = out + p[2:, :-2] * two
    return out + p[2:, 2:] * two


def _box_blur(x: np.ndarray, k: int) -> np.ndarray:
    """The normalized k x k box: float64 sums, as OpenCV sums float input."""
    r = k // 2
    p = _reflect101(x.astype(np.float64), r)
    h, w = x.shape
    rows = sum(p[:, j:j + w] for j in range(k))
    out = sum(rows[i:i + h] for i in range(k))
    return (out * (1.0 / (k * k))).astype(np.float32)


def area_reduce(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(x, (out_w, out_h), interpolation=INTER_AREA)`` for float32
    ``x`` whose size is an integer multiple of the output's: the float32
    mean of each block."""
    h, w = x.shape
    fy, fx = h / out_h, w / out_w
    if fy != int(fy) or fx != int(fx) or fy < 1 or fx < 1:
        raise ValueError(f"area_reduce: {h}x{w} -> {out_h}x{out_w} is not an "
                         "integer reduction; only those are supported")
    fy, fx = int(fy), int(fx)
    blocks = x.astype(np.float32).reshape(out_h, fy, out_w, fx)
    if (fy, fx) == (2, 2):
        total = ((blocks[:, 0, :, 0] + blocks[:, 0, :, 1])
                 + (blocks[:, 1, :, 0] + blocks[:, 1, :, 1]))
    else:
        total = np.zeros((out_h, out_w), np.float32)
        for i in range(fy):
            row = blocks[:, i, :, 0]
            for j in range(1, fx):
                row = row + blocks[:, i, :, j]
            total = total + row
    return total * np.float32(1.0 / (fy * fx))


def generate_illustration_detail_map(pil_image, sensitivity: float = 0.55) -> np.ndarray:
    """[H, W] float32 map in [0, 1] of line/texture density."""
    rgb = np.asarray(pil_image.convert("RGB"), dtype=np.uint8)
    gray = _rgb_to_gray_u8(rgb).astype(np.float32) / np.float32(255.0)
    gray = _gaussian_blur3(gray, 0.55)
    detail = np.abs(_laplacian3(gray))

    # clustered detail is boosted over isolated pixel noise
    coherence = _box_blur(detail, 5)
    coherence /= max(float(np.percentile(coherence, 99.0)), 1.0e-6)
    detail *= 0.65 + 0.35 * np.clip(coherence, 0.0, 1.0)

    sensitivity = float(np.clip(sensitivity, 0.0, 1.0))
    floor = float(np.percentile(detail, 88.0 - sensitivity * 48.0))
    ceiling = float(np.percentile(detail, 99.5))
    detail = np.clip((detail - floor) / max(ceiling - floor, 1.0e-6), 0.0, 1.0)
    return detail.astype(np.float32)


def generate_lineart_loss_map(pil_image, latent_h: int, latent_w: int,
                              oversample: int = 4) -> np.ndarray:
    """Per-latent loss-weight mask, shape (1, latent_h*o, latent_w*o) fp32."""
    detail = generate_illustration_detail_map(pil_image, sensitivity=0.55)
    oversample = max(1, int(oversample))
    resized = area_reduce(detail, int(latent_h) * oversample, int(latent_w) * oversample)
    return resized[None].astype(np.float32)


def loss_weight_mask_for_latents(pil_image, latent_h: int, latent_w: int,
                                 base_weight: float = 1.0,
                                 detail_weight: float = 1.0) -> np.ndarray:
    """(latent_h, latent_w) mask = base + detail * detail_map (mean ~normed)."""
    detail = generate_illustration_detail_map(pil_image)
    resized = area_reduce(detail, int(latent_h), int(latent_w))
    return (base_weight + detail_weight * resized).astype(np.float32)

