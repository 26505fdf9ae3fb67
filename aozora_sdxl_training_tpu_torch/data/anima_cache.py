"""Anima cache: two-phase (Qwen3 text + Wan VAE) build, validation, dataset.

Counterpart of ``aozora_sdxl_training_tpu/data/anima_cache.py``, writing the
same cache:

* the version-6 option schema, with the VAE tiling parameters, and the
  same cache check over the same files;
* text payload = Qwen3 ``prompt_emb`` (512 x 1024) + raw T5 token ids (the
  LLM adapter runs inside the DiT forward, trainable);
* the two-phase build on one device: the text pass in batches of 8
  captions, then the tiled VAE pass image by image, then the null embeds
  and the index;
* video mode (``ANIMA_VIDEO_FRAMES`` > 1, rounded down to 1 + 4k): each
  item is a clip of that many frames (animated WEBP, or a still repeated),
  encoded whole by the Wan VAE's ``encode_video`` into (T', H/8, W/8, z)
  latents, T' = 1 + k, under the ``video_frames`` cache option;
* the QAT repair trainer's line-art loss (``ANIMA_REPAIR_LINEART_LOSS_
  ENABLED``): each latent payload carries a ``lineart_mask`` at latent
  resolution (``tools/semantic_maps.py``, without cv2), from the image or
  from a clip's first frame, under the cache options
  ``repair_lineart_loss_enabled`` / ``repair_lineart_mask_version``;
* dataset-side conditioning: dual Qwen/T5 null dropout and deterministic
  per-caption T5 token dropout, ids padded to 512.
"""

from __future__ import annotations

import hashlib
import random
from pathlib import Path

import numpy as np
import torch

from . import cache_store as cs
from .buckets import (get_multi_bucket_resolutions, make_bucket_variant_metadata,
                      max_bucket_resolution_for_config)
from .captions import CAPTION_JSON_TYPES, caption_source_type, caption_weights_from_config
from .dataset import unpack_sample_index
from .image_prep import (clip_frame_count, load_and_resize_for_bucket,
                         load_clip_for_bucket, validate_images_parallel)
from ..train.anima_objectives import apply_t5_token_dropout

ANIMA_CACHE_VERSION = 6
CONTEXT_TOKENS = 512


def anima_cache_dir_name(config) -> str:
    return str(getattr(config, "ANIMA_CACHE_FOLDER_NAME",
                       ".precomputed_anima_dit_cache"))


def clip_frames_for_config(config) -> int:
    return clip_frame_count(getattr(config, "ANIMA_VIDEO_FRAMES", 1) or 1)


def anima_cache_options(config) -> dict:
    """Version-6 option schema."""
    json_mode = caption_source_type(config) == "json"
    frames = clip_frames_for_config(config)
    return {
        **cs.cache_options_for_config(config),
        "version": ANIMA_CACHE_VERSION,
        "caption_chunking_enabled": False,
        "caption_embedding_layout": "anima_qwen_t5_ids",
        "caption_json_types": (list(CAPTION_JSON_TYPES) if json_mode else ["txt"]),
        "vae_caching_tiled": bool(getattr(config, "VAE_CACHING_TILED", True)),
        "vae_caching_tile_size": list(getattr(config, "VAE_CACHING_TILE_SIZE", [96, 96])),
        "vae_caching_tile_stride": list(getattr(config, "VAE_CACHING_TILE_STRIDE", [72, 72])),
        # line-art loss masks ride the latent payloads; the keys appear only
        # when enabled so standard caches stay valid
        **({"repair_lineart_loss_enabled": True,
            "repair_lineart_mask_version": 2}
           if bool(getattr(config, "ANIMA_REPAIR_LINEART_LOSS_ENABLED",
                           False)) else {}),
        **({"video_frames": frames} if frames > 1 else {}),
    }


def _image_layout_match(cached, expected) -> bool:
    keys = cs.CACHE_IMAGE_LAYOUT_OPTION_KEYS + ("caption_json_types",)
    return cs.options_match(cached, expected, keys)


def _latent_match(cached, expected) -> bool:
    keys = cs.CACHE_LATENT_OPTION_KEYS + (
        "vae_caching_tiled", "vae_caching_tile_size", "vae_caching_tile_stride",
        "repair_lineart_loss_enabled", "repair_lineart_mask_version",
        "video_frames")
    return cs.options_match(cached, expected, keys)


def check_if_anima_caching_needed(config) -> bool:
    cache_dir_name = anima_cache_dir_name(config)
    expected = anima_cache_options(config)
    caption_mode = caption_source_type(config)

    if bool(getattr(config, "REBUILD_CACHE", False)):
        return True
    for ds in config.INSTANCE_DATASETS:
        root = Path(ds["path"])
        if not root.exists():
            continue
        cache_dir = root / cache_dir_name
        image_paths = cs.collect_image_paths(root)
        if not image_paths:
            continue
        if not cs.index_exists(cache_dir):
            return True
        try:
            index_data = cs.load_index(cache_dir)
        except Exception:
            return True
        if not _image_layout_match(index_data.get("cache_options"), expected):
            return True
        indexed = index_data.get("files", [])
        if len(indexed) < len(image_paths):
            return True
        for item in indexed:
            te_paths = cs.te_paths_for_index_item(item)
            lat_path = item.get("lat_path")
            if (not te_paths or not lat_path or not Path(lat_path).exists()
                    or any(not Path(p).exists() for p in te_paths)):
                return True
            try:
                for p in te_paths:
                    if not cs.text_options_match(
                            cs.load_payload_meta(p).get("cache_options"), expected):
                        return True
                if not _latent_match(
                        cs.load_payload_meta(lat_path).get("cache_options"),
                        expected):
                    return True
            except Exception:
                return True
            rel = item.get("relative_path")
            if rel:
                match = cs.cached_file_signatures_match(item, root / rel,
                                                        caption_mode)
                if match is False:
                    return True
    return False


class AnimaCacheEncoders:
    """encode_prompt(captions) -> (prompt_emb list, t5_ids list);
    encode_image(pixels HWC) -> latents (H/8, W/8, z);
    encode_clip(frames THWC) -> latents (1+(T-1)/4, H/8, W/8, z). numpy in
    and out."""

    def __init__(self, *, encode_prompt, encode_image, encode_clip=None):
        self.encode_prompt = encode_prompt
        self.encode_image = encode_image
        self.encode_clip = encode_clip

    @classmethod
    def from_config(cls, config, device=None):
        """The Qwen3 text encoder and the Wan VAE encoder (fp32) of the
        config's files, on ``device`` (default:
        ``core.platform.resolve_device()``), with both tokenizers."""
        from ..ckpt.anima_checkpoint import load_text_encoder_state, load_vae_state
        from ..core.platform import resolve_device
        from ..models.anima import qwen3, wan_vae

        device = resolve_device() if device is None else torch.device(device)
        te_state = load_text_encoder_state(config.TEXT_ENCODER_PATH)
        q_cfg = qwen3.detect_config(te_state)
        q_params = qwen3.params_from_torch_state(te_state, q_cfg, device=device)
        del te_state
        vae_params = wan_vae.params_from_torch_state(load_vae_state(config.DIT_VAE_PATH),
                                                     device=device)
        v_cfg = wan_vae.detect_config(vae_params)

        qwen_tok = _load_hf_tokenizer(getattr(config, "TOKENIZER_PATH", ""))
        t5_tok = _load_hf_tokenizer(getattr(config, "TOKENIZER_T5XXL_PATH", ""))
        tiled = bool(getattr(config, "VAE_CACHING_TILED", True))
        tile_size = tuple(getattr(config, "VAE_CACHING_TILE_SIZE", [96, 96]))
        tile_stride = tuple(getattr(config, "VAE_CACHING_TILE_STRIDE", [72, 72]))

        @torch.inference_mode()
        def encode_prompt(captions: list[str]):
            ids, masks, t5_ids_list = [], [], []
            for caption in captions:
                enc = qwen_tok(caption, padding="max_length",
                               max_length=CONTEXT_TOKENS, truncation=True)
                row = list(enc.input_ids)
                ids.append(row)
                masks.append([1 if t != qwen_tok.pad_token_id else 0 for t in row])
                t5 = t5_tok(caption, truncation=True, max_length=CONTEXT_TOKENS)
                t5_ids_list.append(np.asarray(t5.input_ids, np.int32))
            emb = qwen3.qwen3_forward(
                q_params, torch.as_tensor(ids, dtype=torch.int32, device=device),
                torch.as_tensor(masks, dtype=torch.int32, device=device), q_cfg)
            emb = emb.float().cpu().numpy()
            return [emb[i] for i in range(len(captions))], t5_ids_list

        @torch.inference_mode()
        def encode_tile(px: np.ndarray) -> np.ndarray:
            out = wan_vae.encode_image(vae_params, torch.as_tensor(px, device=device),
                                       cfg=v_cfg)
            return out.float().cpu().numpy()

        def encode_image(pixels_hwc: np.ndarray) -> np.ndarray:
            px = pixels_hwc[None]
            if tiled:
                out = wan_vae.encode_image_tiled(
                    vae_params, px, cfg=v_cfg, tile_size=tile_size,
                    tile_stride=tile_stride, encode_fn=encode_tile)
            else:
                out = encode_tile(px)
            return out[0]

        @torch.inference_mode()
        def encode_clip(frames_thwc: np.ndarray) -> np.ndarray:
            # the whole clip at once (no spatial tiling), as in JAX
            out = wan_vae.encode_video(
                vae_params, torch.as_tensor(frames_thwc, device=device)[None], cfg=v_cfg)
            return out[0].float().cpu().numpy()

        return cls(encode_prompt=encode_prompt, encode_image=encode_image,
                   encode_clip=encode_clip)


def _load_hf_tokenizer(path):
    from .tokenization import HashTokenizer
    p = Path(path) if path else None
    if p and p.exists():
        try:
            from transformers import AutoTokenizer
            return AutoTokenizer.from_pretrained(str(p))
        except Exception as e:  # noqa: BLE001
            print(f"WARNING: could not load tokenizer from {p}: {e}; "
                  f"falling back to hash tokenizer")
    else:
        print("WARNING: no tokenizer path configured — captions use the "
              "deterministic HASH tokenizer (fine for tests/dry runs, "
              "WRONG for real training). Set anima_qwen_tokenizer / "
              "anima_t5xxl_tokenizer to local HF tokenizer dirs.")
    return HashTokenizer(model_max_length=CONTEXT_TOKENS)


def precompute_and_cache_anima(config, encoders: AnimaCacheEncoders | None = None,
                               *, force: bool = False, device=None) -> None:
    """Build or refresh the cache of every dataset root; the encoders load
    on ``device`` when none are given."""
    from .cache_builder import _cache_dtype, null_conditioning_cache_needed

    if not force and not check_if_anima_caching_needed(config):
        print("\n" + "=" * 60 + "\nINFO: Anima datasets already cached.\n"
              + "=" * 60 + "\n")
        return
    if encoders is None:
        encoders = AnimaCacheEncoders.from_config(config, device=device)

    cache_dir_name = anima_cache_dir_name(config)
    options = anima_cache_options(config)
    caption_mode = caption_source_type(config)
    json_mode = caption_mode == "json"
    max_res = max_bucket_resolution_for_config(config)
    extra = (int(getattr(config, "MULTI_BUCKET_EXTRA_BUCKETS", 0) or 0)
             if getattr(config, "MULTI_BUCKET_ENABLED", False) else 0)
    text_dtype = _cache_dtype(getattr(config, "TEXT_CACHE_PRECISION", "bfloat16"))
    vae_dtype = _cache_dtype(getattr(config, "VAE_CACHE_PRECISION", "bfloat16"))
    caption_types = (("tags", "nl", "tags_nl", "nl_tags") if json_mode else ("txt",))

    for ds in config.INSTANCE_DATASETS:
        root = Path(ds["path"])
        if not root.exists():
            continue
        cache_dir = root / cache_dir_name
        cache_dir.mkdir(parents=True, exist_ok=True)
        image_paths = cs.collect_image_paths(root)
        current_stems = {cs.cache_stem_for_image(root, p) for p in image_paths}
        for f in cache_dir.glob("*.safetensors"):
            stem = cs.base_stem_from_cache_path(f)
            if stem is not None and stem not in current_stems:
                f.unlink(missing_ok=True)
        if not image_paths:
            cs.save_index(cache_dir, {"version": ANIMA_CACHE_VERSION,
                                      "cache_options": options, "files": []})
            continue

        print(f"INFO: Validating {len(image_paths)} images in {root} ...")
        metas = [m for m in validate_images_parallel(
            image_paths, max_res * max_res,
            getattr(config, "SHOULD_UPSCALE", False), caption_mode) if m]
        variant_metas = []
        for meta in metas:
            w, h = meta["original_size"]
            for vi, (bw, bh) in enumerate(get_multi_bucket_resolutions(
                    w, h, max_res * max_res,
                    getattr(config, "SHOULD_UPSCALE", False), extra)):
                variant_metas.append(make_bucket_variant_metadata(meta, bw, bh, vi))

        # phase 1: text
        text_jobs = []
        for meta in variant_metas:
            stem = cs.cache_stem_for_image(root, meta["ip"]) + meta["cache_suffix"]
            for ctype in caption_types:
                caption = meta["caption_variants"].get(ctype)
                if caption is None:
                    continue
                te_path = cs.te_path_for(cache_dir, stem, ctype, json_mode)
                if te_path.exists():
                    try:
                        pm = cs.load_payload_meta(te_path)
                        if (cs.text_options_match(pm.get("cache_options"), options)
                                and pm.get("caption_signature") == meta["caption_signature"]):
                            continue
                    except Exception:
                        pass
                text_jobs.append((meta, ctype, caption, te_path))
        if text_jobs:
            print(f"INFO: Anima cache phase 1/2: encoding {len(text_jobs)} captions")
            batch = 8
            for start in range(0, len(text_jobs), batch):
                chunk = text_jobs[start:start + batch]
                embs, t5s = encoders.encode_prompt([j[2] for j in chunk])
                for (meta, ctype, caption, te_path), emb, t5 in zip(chunk, embs, t5s):
                    cs.save_payload(te_path, {
                        "prompt_emb": np.asarray(emb, np.float32).astype(text_dtype),
                        "t5xxl_ids": np.asarray(t5, np.int32),
                    }, _meta(root, meta, options, caption_mode, caption=caption,
                             caption_type=ctype))

        # phase 2: VAE
        lat_jobs = []
        for meta in variant_metas:
            stem = cs.cache_stem_for_image(root, meta["ip"]) + meta["cache_suffix"]
            lat_path = cs.lat_path_for(cache_dir, stem)
            if lat_path.exists():
                try:
                    if _latent_match(cs.load_payload_meta(lat_path).get("cache_options"),
                                     options):
                        continue
                except Exception:
                    pass
            lat_jobs.append((meta, lat_path))
        if lat_jobs:
            print(f"INFO: Anima cache phase 2/2: encoding {len(lat_jobs)} latents "
                  f"(tiled={options['vae_caching_tiled']})")
            lineart_on = bool(options.get("repair_lineart_loss_enabled"))
            n_frames = int(options.get("video_frames", 1) or 1)
            for meta, lat_path in lat_jobs:
                try:
                    if n_frames > 1:
                        frames = load_clip_for_bucket(meta, n_frames)
                        pixels = frames[0]
                        latents = encoders.encode_clip(frames)
                    else:
                        pixels = load_and_resize_for_bucket(meta)
                        latents = encoders.encode_image(pixels)
                    payload = {"latents": np.asarray(latents, np.float32).astype(vae_dtype)}
                    if lineart_on:
                        # at latent resolution, from the 4x oversampled map;
                        # a clip's mask is its first frame's
                        payload["lineart_mask"] = _lineart_mask_for(
                            pixels, int(latents.shape[-3]), int(latents.shape[-2]))
                    cs.save_payload(lat_path, payload, _meta(root, meta, options, caption_mode))
                except Exception as e:  # noqa: BLE001
                    print(f"[SKIP ANIMA VAE] {meta['ip'].name}: {e}")

        # null conditioning
        if null_conditioning_cache_needed(config) or \
                float(getattr(config, "QWEN_NULL_DROPOUT_CHANCE", 0) or 0) > 0 or \
                float(getattr(config, "T5_NULL_DROPOUT_CHANCE", 0) or 0) > 0:
            null_path = cache_dir / "null_embeds.safetensors"
            if not null_path.exists():
                embs, t5s = encoders.encode_prompt([""])
                cs.save_payload(null_path, {
                    "prompt_emb": np.asarray(embs[0], np.float32).astype(text_dtype),
                    "t5xxl_ids": np.asarray(t5s[0], np.int32),
                }, {"cache_options": options})

        # index
        files = []
        for meta in variant_metas:
            stem = cs.cache_stem_for_image(root, meta["ip"]) + meta["cache_suffix"]
            item = {
                "te_path": str(cs.te_path_for(
                    cache_dir, stem, "tags_nl" if json_mode else "txt", json_mode)),
                "lat_path": str(cs.lat_path_for(cache_dir, stem)),
                "relative_path": str(meta["ip"].relative_to(root)),
                "original_size": list(meta["original_size"]),
                "scaled_size": list(meta["scaled_size"]),
                "target_size": list(meta["target_resolution"]),
                "crop_coords": list(meta["crop_coords"]),
                "bucket_variant_index": meta["bucket_variant_index"],
                "caption_signature": meta["caption_signature"],
                "image_file_signature": cs.file_stat_signature(meta["ip"]),
                "caption_file_signature": cs.caption_file_signature(
                    meta["ip"], caption_mode),
            }
            if json_mode:
                item["caption_variants"] = {
                    ctype: {"te_path": str(cs.te_path_for(cache_dir, stem, ctype, True))}
                    for ctype in caption_types
                    if ctype in meta["caption_variants"]
                }
            if all(Path(p).exists() for p in (item["te_path"], item["lat_path"])):
                files.append(item)
        cs.save_index(cache_dir, {"version": ANIMA_CACHE_VERSION,
                                  "cache_options": options, "files": files})
        print(cache_complete_message(len(files), cache_dir))


def cache_complete_message(n_files: int, cache_dir) -> str:
    """The cache-completion line. The GUI keys its cache-created signal on
    the lowercase substring "anima dit items", so the wording is part of
    the wire format."""
    return f"INFO: Cached {n_files} Anima DiT items to {cache_dir}"


def _lineart_mask_for(pixels_hwc: np.ndarray, lat_h: int, lat_w: int) -> np.ndarray:
    """(lat_h, lat_w) fp32 line-art detail mask in [0, 1] from the already
    bucket-resized [-1, 1] pixels: the detail map area-reduced onto the 4x
    oversampled latent grid, then onto the latent grid."""
    from PIL import Image

    from ..tools.semantic_maps import area_reduce, generate_lineart_loss_map
    u8 = np.clip((np.asarray(pixels_hwc, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    over = generate_lineart_loss_map(Image.fromarray(u8), lat_h, lat_w)
    return area_reduce(over[0], lat_h, lat_w)


def _meta(root, meta, options, caption_mode, caption=None, caption_type=None):
    out = {
        "cache_options": options,
        "relative_path": str(meta["ip"].relative_to(root)),
        "original_size": list(meta["original_size"]),
        "scaled_size": list(meta["scaled_size"]),
        "target_size": list(meta["target_resolution"]),
        "crop_coords": list(meta["crop_coords"]),
        "bucket_variant_index": meta["bucket_variant_index"],
        "caption_signature": meta["caption_signature"],
    }
    if caption is not None:
        out["caption"] = caption
        out["caption_type"] = caption_type
    return out


class AnimaLatentDataset:
    """Cached Anima items with per-sample dual-null dropout and T5 token
    dropout."""

    def __init__(self, config):
        self.config = config
        self.seed = int(config.SEED if config.SEED else 42)
        self.json_mode = caption_source_type(config) == "json"
        self.caption_weights = caption_weights_from_config(config)
        cache_dir_name = anima_cache_dir_name(config)

        self.items, self.bucket_keys = [], []
        for ds in config.INSTANCE_DATASETS:
            cache_dir = Path(ds["path"]) / cache_dir_name
            if not cs.index_exists(cache_dir):
                print(f"WARNING: Index missing at {cache_dir}. Please re-run caching!")
                continue
            index_data = cs.load_index(cache_dir)
            stable = sorted(index_data["files"], key=cs.stable_cache_item_key)
            for _ in range(int(ds.get("repeats", 1))):
                for item in stable:
                    self.items.append(item)
                    self.bucket_keys.append(tuple(item["target_size"]))
        if not self.items:
            raise ValueError("No cached Anima files found.")
        order = np.random.Generator(np.random.PCG64(self.seed)).permutation(
            len(self.items))
        self.items = [self.items[i] for i in order]
        self.bucket_keys = [self.bucket_keys[i] for i in order]

        self.qwen_null_chance = min(max(float(getattr(
            config, "QWEN_NULL_DROPOUT_CHANCE", 0.0) or 0.0), 0.0), 1.0)
        self.t5_null_chance = min(max(float(getattr(
            config, "T5_NULL_DROPOUT_CHANCE", 0.0) or 0.0), 0.0), 1.0)
        self.null_prompt_emb = None
        self.null_t5_ids = None
        if self.qwen_null_chance > 0 or self.t5_null_chance > 0:
            null_path = (Path(config.INSTANCE_DATASETS[0]["path"])
                         / cache_dir_name / "null_embeds.safetensors")
            try:
                tensors, _ = cs.load_payload(null_path)
                self.null_prompt_emb = np.asarray(tensors["prompt_emb"], np.float32)
                self.null_t5_ids = np.asarray(tensors["t5xxl_ids"], np.int32)
            except Exception:
                self.qwen_null_chance = self.t5_null_chance = 0.0

    def __len__(self):
        return len(self.items)

    def _rng(self, dataset_index, sample_index) -> random.Random:
        payload = f"{self.seed}:anima-sample:{sample_index}:{dataset_index}"
        digest = hashlib.sha256(payload.encode()).digest()
        return random.Random(int.from_bytes(digest[:8], "little"))

    def fetch(self, packed_index: int, context_tokens: int = CONTEXT_TOKENS):
        try:
            di, si = unpack_sample_index(packed_index)
            rng = self._rng(di, si)
            item = self.items[di]
            te_path = cs.selected_te_path(item, rng, self.caption_weights,
                                          enabled=self.json_mode)
            te, te_meta = cs.load_payload(te_path)
            lat, _ = cs.load_payload(item["lat_path"])
            prompt_emb = np.asarray(te["prompt_emb"], np.float32)
            t5_ids = np.asarray(te["t5xxl_ids"], np.int32)
            latents = np.asarray(lat["latents"], np.float32)
            if not np.isfinite(latents).all():
                return None
            if self.qwen_null_chance > 0 and rng.random() < self.qwen_null_chance:
                prompt_emb = self.null_prompt_emb
            if self.t5_null_chance > 0 and rng.random() < self.t5_null_chance:
                t5_ids = self.null_t5_ids
            t5_ids = apply_t5_token_dropout(
                t5_ids, te_meta.get("caption", ""), self.config)
            padded = np.zeros(context_tokens, np.int32)
            padded[: min(len(t5_ids), context_tokens)] = t5_ids[:context_tokens]
            sample = {"latents": latents, "prompt_emb": prompt_emb,
                      "t5xxl_ids": padded}
            if "lineart_mask" in lat:
                sample["lineart_mask"] = np.asarray(lat["lineart_mask"], np.float32)
            return sample
        except Exception as e:  # noqa: BLE001
            print(f"[ANIMA DATASET] Failed to load item {packed_index}: {e}")
            return None

    def fetch_batch(self, packed_batch):
        samples = [s for s in (self.fetch(i) for i in packed_batch) if s]
        if not samples:
            return None
        batch = {key: np.stack([s[key] for s in samples])
                 for key in ("latents", "prompt_emb", "t5xxl_ids")}
        if all("lineart_mask" in s for s in samples):
            batch["lineart_mask"] = np.stack([s["lineart_mask"] for s in samples])
        return batch
