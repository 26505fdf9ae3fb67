"""Anima component bundle: one-call loading of DiT + text encoder + VAE.

Counterpart of ``aozora_sdxl_training_tpu/models/anima/pipeline.py``: loads
the three model components from local checkpoint files (with the loaders'
prefix rules) onto one device, resolves both tokenizers, and provides
``preprocess_image`` ([-1, 1] channel-last float conversion).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AnimaTrainingComponents:
    dit_params: dict
    dit_config: object
    dit_prefix: str
    text_encoder_params: dict
    text_encoder_config: object
    vae_params: dict
    tokenizer: object
    tokenizer_t5xxl: object

    @classmethod
    def from_pretrained(cls, *, dit_path, text_encoder_path, vae_path,
                        tokenizer_path=None, tokenizer_t5xxl_path=None,
                        dtype=torch.float32, device=None) -> "AnimaTrainingComponents":
        """``device`` defaults to ``core.platform.resolve_device()``."""
        from ...ckpt.anima_checkpoint import (load_dit_state,
                                              load_text_encoder_state,
                                              load_vae_state)
        from ...core.platform import resolve_device
        from ...data.anima_cache import _load_hf_tokenizer
        from ...train.anima_trainer import _dit_config_for_state
        from . import dit as dit_mod
        from . import qwen3, wan_vae

        device = resolve_device() if device is None else torch.device(device)
        dit_state, prefix = load_dit_state(dit_path)
        dit_cfg = _dit_config_for_state(dit_state)
        dit_params = dit_mod.params_from_torch_state(dit_state, dit_cfg, dtype, device)
        del dit_state

        te_state = load_text_encoder_state(text_encoder_path)
        te_cfg = qwen3.detect_config(te_state)
        te_params = qwen3.params_from_torch_state(te_state, te_cfg, dtype, device)
        del te_state

        vae_params = wan_vae.params_from_torch_state(load_vae_state(vae_path),
                                                     dtype, device)

        return cls(
            dit_params=dit_params, dit_config=dit_cfg, dit_prefix=prefix,
            text_encoder_params=te_params, text_encoder_config=te_cfg,
            vae_params=vae_params,
            tokenizer=_load_hf_tokenizer(tokenizer_path),
            tokenizer_t5xxl=_load_hf_tokenizer(tokenizer_t5xxl_path),
        )

    @staticmethod
    def preprocess_image(image) -> np.ndarray:
        """PIL image -> (H, W, 3) float32 in [-1, 1]."""
        arr = np.asarray(image.convert("RGB"), np.float32)
        return arr / 127.5 - 1.0
