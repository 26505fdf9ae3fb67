"""Host-side image preparation for cache building.

Copy of ``aozora_sdxl_training_tpu/data/image_prep.py`` (which imports no
JAX), kept in the port so that the port imports nothing of the JAX package.
PIL-based validation, cover-resize and center-crop identical in math to the
reference trainer (train.py:240-246, 1018-1084): these pixels feed the VAE,
so the resize path must stay byte-stable for cache compatibility. The
per-image validation runs in a spawn process pool; only the encoder forward
runs on the device.
"""

from __future__ import annotations

import multiprocessing
from pathlib import Path

import numpy as np
from PIL import Image

from .buckets import cover_resize_geometry, get_optimal_bucket
from .captions import caption_signature, primary_caption, read_caption_variants


def fix_alpha_channel(img: Image.Image) -> Image.Image:
    if img.mode == "P" and "transparency" in img.info:
        img = img.convert("RGBA")
    if img.mode in ("RGBA", "PA", "LA"):
        return img.convert("RGB")
    return img.convert("RGB")


def smart_resize(image: Image.Image, target_w: int, target_h: int) -> Image.Image:
    """Lanczos cover-resize then center crop to exactly (target_w, target_h)."""
    orig_w, orig_h = image.size
    scale = max(target_w / max(orig_w, 1), target_h / max(orig_h, 1))
    new_w = max(int(round(orig_w * scale)), target_w)
    new_h = max(int(round(orig_h * scale)), target_h)
    resized = image.resize((new_w, new_h), Image.Resampling.LANCZOS)
    crop_left = (new_w - target_w) // 2
    crop_top = (new_h - target_h) // 2
    cropped = resized.crop((crop_left, crop_top,
                            crop_left + target_w, crop_top + target_h))
    assert cropped.size == (target_w, target_h), (
        f"smart_resize failed: expected ({target_w},{target_h}), got {cropped.size}")
    return cropped


def image_to_array(image: Image.Image) -> np.ndarray:
    """HWC float32 in [-1, 1] (VAE input convention)."""
    arr = np.asarray(fix_alpha_channel(image), dtype=np.float32) / 127.5 - 1.0
    return arr


def validate_and_assign_resolution(args):
    """Pool worker: verify the image, assign its bucket, read captions.

    args: (image_path, target_area, stride, should_upscale[, caption_mode]).
    Returns the per-image metadata dict or None on any error (corrupt images
    are skipped with a message, matching train.py:1082-1084).
    """
    if len(args) >= 5:
        ip, target_area, stride, should_upscale, caption_mode = args[:5]
    else:
        ip, target_area, stride, should_upscale = args
        caption_mode = "txt"
    try:
        with Image.open(ip) as img:
            img.verify()
        with Image.open(ip) as img:
            img.load()
            w, h = img.size
            if w <= 0 or h <= 0:
                return None

        target_w, target_h = get_optimal_bucket(w, h, target_area, stride,
                                                should_upscale)
        scaled, crop = cover_resize_geometry(w, h, target_w, target_h)

        variants = read_caption_variants(Path(ip), caption_mode)
        return {
            "ip": Path(ip),
            "caption": primary_caption(variants),
            "caption_variants": variants,
            "caption_signature": caption_signature(variants),
            "target_resolution": (target_w, target_h),
            "original_size": (w, h),
            "scaled_size": scaled,
            "crop_coords": crop,
            "original_area": w * h,
            "target_area": target_w * target_h,
            "was_upscaled": should_upscale and (w * h) < target_area,
        }
    except Exception as e:  # noqa: BLE001 — any failure means "skip image"
        print(f"\n[CORRUPT IMAGE OR READ ERROR] Skipping {ip}, Reason: {e}")
        return None


def validate_images_parallel(image_paths, target_area, should_upscale,
                             caption_mode, max_workers: int = 8):
    """Run validate_and_assign_resolution over a process pool (<=8 workers)."""
    args = [(p, target_area, 64, should_upscale, caption_mode)
            for p in image_paths]
    workers = max(1, min(max_workers, multiprocessing.cpu_count() or 1))
    if workers == 1 or len(args) <= 2:
        return [validate_and_assign_resolution(a) for a in args]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        return list(pool.imap(validate_and_assign_resolution, args))


def load_and_resize_for_bucket(meta: dict) -> np.ndarray:
    """Open + resize one image to its assigned bucket; HWC [-1,1] fp32."""
    with Image.open(meta["ip"]) as img:
        img.load()
        img = fix_alpha_channel(img)
        tw, th = meta["target_resolution"]
        return image_to_array(smart_resize(img, tw, th))


def clip_frame_count(requested: int) -> int:
    """Round a frame request down to the causal VAE's 1 + 4k contract."""
    requested = max(1, int(requested))
    return 1 + (requested - 1) // 4 * 4


def load_clip_for_bucket(meta: dict, frames: int) -> np.ndarray:
    """(T, H, W, 3) [-1,1] clip from an animated GIF/WEBP (or a still).

    Decodes up to ``frames`` (a 1+4k count) frames via PIL ``seek``; files
    with fewer frames loop cyclically so every clip in a run has the same
    temporal length (uniform (B, T, H, W, C) batches).
    """
    frames = clip_frame_count(frames)
    tw, th = meta["target_resolution"]
    decoded: list[np.ndarray] = []
    with Image.open(meta["ip"]) as img:
        n = int(getattr(img, "n_frames", 1) or 1)
        for i in range(min(n, frames)):
            img.seek(i)
            frame = fix_alpha_channel(img.copy())
            decoded.append(image_to_array(smart_resize(frame, tw, th)))
    idx = np.arange(frames) % len(decoded)
    return np.stack([decoded[i] for i in idx])
