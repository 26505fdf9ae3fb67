"""Synthetic datasets and random checkpoints, made from a seed.

The cached-dataset writers put images with ``.txt`` captions under a root
and write the cache the JAX package's cache builders would write for them
(same index, payload names, option keys, file signatures and payload
metadata), with random latents and text embeddings in place of encoder
outputs. The real cache checks (``check_if_caching_needed`` for SDXL,
``check_if_anima_caching_needed`` for Anima) accept the result, so the
trainers run on it without the encoders or downloaded weights.

``write_image_dataset`` writes images and captions only, for the cache
builder to encode; ``write_random_sd_checkpoint`` writes a random SD
single-file checkpoint (UNet, CLIP-L, bigG and the SD-VAE) under the key
names the loaders read; ``write_random_dit_checkpoint`` a random Anima DiT,
``write_random_qwen3_checkpoint`` and ``write_random_wan_vae_checkpoint``
the Anima cache's text encoder and Wan VAE (the encoder, or with
``decoder=True`` a full file, the decoder too); ``write_clip_dataset``
writes captioned animated-WEBP clips for Anima's video mode.
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
    ``t5xxl_ids`` (512,) int32 from 1 to ``vocab`` - 1. In video mode
    (``ANIMA_VIDEO_FRAMES`` > 1) each latent is a clip's (T', H/8, W/8,
    ``latent_channels``), T' = 1 + (frames - 1) // 4. Returns the cache
    dir."""
    from .anima_cache import (ANIMA_CACHE_VERSION, CONTEXT_TOKENS,
                              anima_cache_dir_name, anima_cache_options,
                              clip_frames_for_config)
    root = Path(root)
    options = anima_cache_options(config)
    cache_dir = root / anima_cache_dir_name(config)
    frames = clip_frames_for_config(config)
    lead = (1 + (frames - 1) // 4,) if frames > 1 else ()

    def payloads(rng, tw, th):
        return ({"prompt_emb": rng.normal(size=(CONTEXT_TOKENS, source_dim)
                                          ).astype(np.float32),
                 "t5xxl_ids": rng.integers(1, vocab, size=(CONTEXT_TOKENS,)
                                           ).astype(np.int32)},
                {"latents": (rng.normal(size=(*lead, th // 8, tw // 8, latent_channels))
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


def _write_bf16(path, params: dict) -> int:
    """``params`` (tensors on any device) in bf16, one tensor on the host at
    a time; returns the parameter count."""
    from ..ckpt.safetensors_io import write_streaming
    from ..ckpt.sd_checkpoint import tensor_to_numpy
    write_streaming(path, {k: (tuple(t.shape), _BF16,
                               lambda t=t: tensor_to_numpy(t, _BF16))
                           for k, t in params.items()})
    return sum(t.numel() for t in params.values())


def write_random_qwen3_checkpoint(path, cfg, *, seed: int, device="cpu") -> int:
    """A Qwen3 text encoder of ``cfg`` from ``models.anima.qwen3.init_params``
    (a torch generator on ``device`` seeded with ``seed``) in bf16 under its
    HF names (``model.*``, torch layout), as a Qwen3 file holds it. Returns
    the parameter count."""
    from ..models.anima.qwen3 import init_params
    return _write_bf16(path, init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), dtype=torch.bfloat16))


def write_random_wan_vae_checkpoint(path, cfg, *, seed: int, device="cpu",
                                    decoder: bool = False) -> int:
    """The encoder half of a Wan VAE of ``cfg`` from
    ``models.anima.wan_vae.init_params`` (a torch generator on ``device``
    seeded with ``seed``) in bf16, in a Wan file's layout (5-D causal
    kernels, the temporal downsamples' ``time_conv``, gammas with their
    broadcast dims), no key prefix. With ``decoder`` a full Wan file: the
    decoder with its temporal upsamples' ``time_conv`` too
    (``init_decoder_params(..., video=True)``, drawn after the encoder from
    the same generator, so the encoder's tensors are those of the
    encoder-only file of the same seed). Returns the parameter count."""
    from ..models.anima.wan_vae import init_decoder_params, init_params
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, g, dtype=torch.bfloat16)
    if decoder:
        params.update(init_decoder_params(cfg, g, dtype=torch.bfloat16, video=True))
    return _write_bf16(path, params)


def write_image_dataset(root, *, n_images: int, image_size: tuple[int, int],
                        seed: int = 0) -> list[Path]:
    """Images ``img{i}.png`` of ``image_size`` (w, h), random colour noise
    over a random gradient, each with a ``.txt`` caption, and no cache."""
    from PIL import Image

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = image_size
    ramp = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    paths = []
    for i in range(n_images):
        base = rng.uniform(0, 255, size=(1, 1, 3)) * ramp
        noise = rng.normal(0, 40, size=(h, w, 3))
        arr = np.clip(base + 96 + noise, 0, 255).astype(np.uint8)
        path = root / f"img{i}.png"
        Image.fromarray(arr).save(path)
        path.with_suffix(".txt").write_text(
            f"synthetic image {i}, a colourful noisy gradient", encoding="utf-8")
        paths.append(path)
    return paths


def write_clip_dataset(root, *, n_clips: int, frames: int, image_size: tuple[int, int],
                       seed: int = 0) -> list[Path]:
    """Clips ``clip{i}.webp`` of ``frames`` frames of ``image_size`` (w, h),
    animated WEBP (lossless): a random colour gradient that drifts a few
    pixels a frame, with colour noise, each with a ``.txt`` caption, and no
    cache."""
    from PIL import Image

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = image_size
    paths = []
    for i in range(n_clips):
        base = rng.uniform(0, 255, size=(1, 1, 3))
        images = []
        for f in range(frames):
            ramp = (np.arange(w, dtype=np.float32)[None, :, None] + 8 * f) % w / w
            noise = rng.normal(0, 20, size=(h, w, 3))
            arr = np.clip(base * ramp + 64 + noise, 0, 255).astype(np.uint8)
            images.append(Image.fromarray(arr))
        path = root / f"clip{i}.webp"
        images[0].save(path, save_all=True, append_images=images[1:], lossless=True,
                       duration=100, loop=0)
        path.with_suffix(".txt").write_text(
            f"synthetic clip {i}, a drifting colourful gradient", encoding="utf-8")
        paths.append(path)
    return paths


def vae_sd_shapes(channels=(128, 256, 512, 512), latent_channels: int = 4,
                  layers_per_block: int = 2) -> dict[str, tuple[int, ...]]:
    """SD key -> shape of a KL-VAE (encoder, decoder, ``quant_conv`` and
    ``post_quant_conv``) with these stage widths: the SD-VAE of SDXL at the
    defaults."""
    shapes: dict[str, tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        shapes[f"first_stage_model.{name}.weight"] = (cout, cin, k, k)
        shapes[f"first_stage_model.{name}.bias"] = (cout,)

    def norm(name, c):
        shapes[f"first_stage_model.{name}.weight"] = (c,)
        shapes[f"first_stage_model.{name}.bias"] = (c,)

    def resnet(prefix, cin, cout):
        norm(f"{prefix}.norm1", cin)
        conv(f"{prefix}.conv1", cin, cout, 3)
        norm(f"{prefix}.norm2", cout)
        conv(f"{prefix}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{prefix}.nin_shortcut", cin, cout, 1)

    def mid(part, c):
        resnet(f"{part}.mid.block_1", c, c)
        norm(f"{part}.mid.attn_1.norm", c)
        for proj in ("q", "k", "v", "proj_out"):
            conv(f"{part}.mid.attn_1.{proj}", c, c, 1)
        resnet(f"{part}.mid.block_2", c, c)

    z, top = latent_channels, channels[-1]
    conv("encoder.conv_in", 3, channels[0], 3)
    cin = channels[0]
    for i, cout in enumerate(channels):
        for j in range(layers_per_block):
            resnet(f"encoder.down.{i}.block.{j}", cin if j == 0 else cout, cout)
        if i < len(channels) - 1:
            conv(f"encoder.down.{i}.downsample.conv", cout, cout, 3)
        cin = cout
    mid("encoder", top)
    norm("encoder.norm_out", top)
    conv("encoder.conv_out", top, 2 * z, 3)
    conv("quant_conv", 2 * z, 2 * z, 1)
    conv("post_quant_conv", z, z, 1)
    conv("decoder.conv_in", z, top, 3)
    mid("decoder", top)
    cin = top
    for i in reversed(range(len(channels))):
        cout = channels[i]
        for j in range(layers_per_block + 1):
            resnet(f"decoder.up.{i}.block.{j}", cin if j == 0 else cout, cout)
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", cout, cout, 3)
        cin = cout
    norm("decoder.norm_out", cin)
    conv("decoder.conv_out", cin, 3, 3)
    return shapes


def random_vae_sd(generator: torch.Generator, channels=(128, 256, 512, 512),
                  latent_channels: int = 4, dtype=torch.float32) -> dict:
    """A random KL-VAE as {SD key: tensor} on the generator's device:
    N(0, 1/fan_in) convs, unit norm scales, zero biases, drawn in key order
    (the SD-VAE of SDXL at the defaults)."""
    import math
    device = generator.device
    out = {}
    for key, shape in vae_sd_shapes(channels, latent_channels).items():
        if key.endswith(".bias"):
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
        elif len(shape) == 1:
            out[key] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[key] = (torch.randn(shape, generator=generator, device=device)
                        * math.prod(shape[1:]) ** -0.5).to(dtype)
    return out


def write_random_sd_checkpoint(path, *, seed: int, unet_cfg=None, clip_l=None,
                               clip_g=None, vae_channels=(128, 256, 512, 512),
                               latent_channels: int = 4, device="cpu") -> dict:
    """A random SD single-file checkpoint in bf16, written one tensor at a
    time: the UNet of ``unet_cfg`` (default SDXL_BASE) under
    ``model.diffusion_model.``, CLIP-L (HF layout) and bigG (OpenCLIP
    layout) of ``clip_l`` / ``clip_g`` (default CLIP_L / CLIP_BIGG) under
    ``conditioner.embedders.{0,1}``, and the KL-VAE of ``vae_channels``
    under ``first_stage_model.``, with a ``<path>.arch.json`` sidecar of the
    UNet config. Weights come from a generator on ``device`` seeded with
    ``seed``: the models' own inits, and N(0, 1/fan_in) VAE convs with unit
    norms and zero biases. Returns the parameter count of each part."""
    import json
    from dataclasses import asdict

    from ..ckpt.safetensors_io import write_streaming
    from ..ckpt.sd_checkpoint import tensor_to_numpy
    from ..ckpt.sd_keys import unet_key_mapping
    from ..models.sdxl import clip as clip_mod
    from ..models.sdxl.arch import SDXL_BASE
    from ..models.sdxl.unet import init_params

    unet_cfg = SDXL_BASE if unet_cfg is None else unet_cfg
    clip_l = clip_mod.CLIP_L if clip_l is None else clip_l
    clip_g = clip_mod.CLIP_BIGG if clip_g is None else clip_g
    g = torch.Generator(device=device).manual_seed(seed)
    unet = init_params(unet_cfg, g, dtype=torch.bfloat16)
    mapping = unet_key_mapping(list(unet))
    params = {mapping[n]: t for n, t in unet.items()}
    params.update(clip_mod.clip_l_sd_from_params(
        clip_mod.init_clip_params(clip_l, g, dtype=torch.bfloat16), clip_l.num_layers))
    params.update(clip_mod.clip_bigg_sd_from_params(
        clip_mod.init_clip_params(clip_g, g, dtype=torch.bfloat16), clip_g.num_layers))
    vae = random_vae_sd(g, vae_channels, latent_channels, dtype=torch.bfloat16)
    params.update(vae)
    counts = {"unet": sum(t.numel() for t in unet.values()),
              "clip_l": sum(t.numel() for k, t in params.items()
                            if k.startswith(clip_mod.CLIP_L_PREFIX)),
              "clip_g": sum(t.numel() for k, t in params.items()
                            if k.startswith(clip_mod.CLIP_BIGG_PREFIX)),
              "vae": sum(t.numel() for t in vae.values())}
    write_streaming(path, {k: (tuple(t.shape), _BF16,
                               lambda t=t: tensor_to_numpy(t, _BF16))
                           for k, t in params.items()})
    Path(str(path) + ".arch.json").write_text(json.dumps(asdict(unet_cfg)))
    return counts
