"""Synthetic datasets with matching caches, and a random DiT checkpoint,
made from a seed.

The dataset writers put images with ``.txt`` captions under a root and
write the cache the JAX package's cache builders would write for them (same
index, payload names, option keys, file signatures and payload metadata),
with random latents and text embeddings in place of encoder outputs. The
real cache checks (``check_if_caching_needed`` for SDXL,
``check_if_anima_caching_needed`` for Anima) accept the result, so the
trainers run on it without the encoders or downloaded weights.
"""

from __future__ import annotations

from pathlib import Path

import ml_dtypes
import numpy as np
import torch

from . import cache_store as cs
from .buckets import (cover_resize_geometry, get_multi_bucket_resolutions,
                      max_bucket_resolution_for_config)
from .captions import caption_signature, read_caption_variants

_BF16 = np.dtype(ml_dtypes.bfloat16)


def _write_items(root: Path, config, options: dict, cache_dir: Path,
                 n_images: int, image_size: tuple[int, int], rng, payloads):
    """Writes ``img{i}.png`` + caption for each i under ``root`` and the
    te/lat payloads ``payloads(rng, target_w, target_h) -> (te_tensors,
    lat_tensors)`` returns into ``cache_dir``; returns the index entries."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    max_res = max_bucket_resolution_for_config(config)
    w, h = image_size
    files = []
    for i in range(n_images):
        image_path = root / f"img{i}.png"
        color = tuple(int(c) for c in rng.integers(0, 256, size=3))
        Image.new("RGB", (w, h), color).save(image_path)
        image_path.with_suffix(".txt").write_text(f"synthetic image {i}",
                                                  encoding="utf-8")
        tw, th = get_multi_bucket_resolutions(w, h, max_res * max_res,
                                              bool(config.SHOULD_UPSCALE), 0)[0]
        scaled, crop = cover_resize_geometry(w, h, tw, th)
        meta = {
            "cache_options": options,
            "relative_path": str(image_path.relative_to(root)),
            "original_size": [w, h],
            "scaled_size": list(scaled),
            "target_size": [tw, th],
            "crop_coords": list(crop),
            "bucket_variant_index": 0,
            "caption_signature": caption_signature(
                read_caption_variants(image_path, "txt")),
        }
        stem = cs.cache_stem_for_image(root, image_path)
        te_path = cs.te_path_for(cache_dir, stem)
        lat_path = cs.lat_path_for(cache_dir, stem)
        te, lat = payloads(rng, tw, th)
        cs.save_payload(te_path, te, {**meta, "caption": f"synthetic image {i}"})
        cs.save_payload(lat_path, lat, meta)
        files.append({
            **{k: v for k, v in meta.items() if k != "cache_options"},
            "te_path": str(te_path),
            "lat_path": str(lat_path),
            "image_file_signature": cs.file_stat_signature(image_path),
            "caption_file_signature": cs.caption_file_signature(image_path, "txt"),
        })
    return files


def write_synthetic_dataset(root, config, *, n_images: int,
                            image_size: tuple[int, int], seq_len: int,
                            embed_dim: int, pooled_dim: int,
                            latent_channels: int = 4, seed: int = 0) -> Path:
    """SDXL: images ``img{i}.png`` of ``image_size`` (w, h) under ``root``,
    and their cache in the directory ``config`` selects. Returns the cache
    dir."""
    root = Path(root)
    options = cs.cache_options_for_config(config)
    cache_dir = root / cs.sdxl_cache_dir_name(bool(config.is_rectified_flow))

    def payloads(rng, tw, th):
        return ({"embeds": rng.normal(size=(seq_len, embed_dim)).astype(_BF16),
                 "pooled": rng.normal(size=(pooled_dim,)).astype(_BF16)},
                {"latents": (rng.normal(size=(th // 8, tw // 8, latent_channels))
                             * 0.5).astype(_BF16)})

    files = _write_items(root, config, options, cache_dir, n_images, image_size,
                         np.random.default_rng(seed), payloads)
    cs.save_index(cache_dir, {"version": cs.CACHE_OPTIONS_VERSION,
                              "cache_options": options, "files": files})
    return cache_dir


def write_synthetic_anima_dataset(root, config, *, n_images: int,
                                  image_size: tuple[int, int],
                                  source_dim: int = 1024, vocab: int = 32128,
                                  latent_channels: int = 16,
                                  seed: int = 0) -> Path:
    """Anima: images under ``root`` and their cache: latents (H/8, W/8,
    ``latent_channels``) bf16, ``prompt_emb`` (512, ``source_dim``) fp32 and
    ``t5xxl_ids`` (512,) int32 from 1 to ``vocab`` - 1. Returns the cache
    dir."""
    from .anima_cache import (ANIMA_CACHE_VERSION, CONTEXT_TOKENS,
                              anima_cache_dir_name, anima_cache_options)
    root = Path(root)
    options = anima_cache_options(config)
    cache_dir = root / anima_cache_dir_name(config)

    def payloads(rng, tw, th):
        return ({"prompt_emb": rng.normal(size=(CONTEXT_TOKENS, source_dim)
                                          ).astype(np.float32),
                 "t5xxl_ids": rng.integers(1, vocab, size=(CONTEXT_TOKENS,)
                                           ).astype(np.int32)},
                {"latents": (rng.normal(size=(th // 8, tw // 8, latent_channels))
                             * 0.5).astype(_BF16)})

    files = _write_items(root, config, options, cache_dir, n_images, image_size,
                         np.random.default_rng(seed), payloads)
    cs.save_index(cache_dir, {"version": ANIMA_CACHE_VERSION,
                              "cache_options": options, "files": files})
    return cache_dir


def write_random_dit_checkpoint(path, cfg, *, seed: int, device="cpu") -> int:
    """A DiT of ``cfg`` from ``models.anima.dit.init_params`` (a torch
    generator on ``device`` seeded with ``seed``), written in bf16 under the
    ``pipe.dit.`` prefix one tensor at a time. Returns the parameter count."""
    from ..ckpt.anima_checkpoint import save_dit_model
    from ..models.anima.dit import init_params
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         dtype=torch.bfloat16)
    save_dit_model(path, params, prefix="pipe.dit.")
    return sum(t.numel() for t in params.values())
