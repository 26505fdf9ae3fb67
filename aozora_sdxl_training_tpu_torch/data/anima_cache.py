"""Anima cache: option schema, validation and the training dataset.

Counterpart of ``aozora_sdxl_training_tpu/data/anima_cache.py`` without the
encoders: the same version-6 option schema, the same cache check over the
same files, and the same dataset (text payload = Qwen3 ``prompt_emb``
(512 x 1024) + raw T5 token ids; dual Qwen/T5 null dropout; deterministic
per-caption T5 token dropout; ids padded to 512). Building the cache needs
the Qwen3 text encoder and the Wan VAE, which are not ported yet, so
``precompute_and_cache_anima`` raises and names the JAX package's cache
builder.
"""

from __future__ import annotations

import hashlib
import random
from pathlib import Path

import numpy as np

from . import cache_store as cs
from .captions import CAPTION_JSON_TYPES, caption_source_type, caption_weights_from_config
from .dataset import unpack_sample_index
from ..train.anima_objectives import apply_t5_token_dropout

ANIMA_CACHE_VERSION = 6
CONTEXT_TOKENS = 512


def anima_cache_dir_name(config) -> str:
    return str(getattr(config, "ANIMA_CACHE_FOLDER_NAME",
                       ".precomputed_anima_dit_cache"))


def clip_frame_count(requested: int) -> int:
    """Round a frame request down to the causal VAE's 1 + 4k contract."""
    requested = max(1, int(requested))
    return 1 + (requested - 1) // 4 * 4


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


def precompute_and_cache_anima(config) -> None:
    raise NotImplementedError(
        "The Anima cache must be (re)built before the PyTorch port can train: "
        "the Qwen3 text encoder and the Wan VAE are not ported yet. Build it "
        "with the JAX package: python -m aozora_sdxl_training_tpu.cli."
        "cache_datasets --config <preset.json>")


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
