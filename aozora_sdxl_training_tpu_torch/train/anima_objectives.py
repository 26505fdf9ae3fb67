"""Anima flow-matching objective and T5 token dropout.

Counterpart of ``aozora_sdxl_training_tpu/train/anima_objectives.py``:

* ticket -> (sigma, timestep): ``sigmas = linspace(1, 0, 1001)[:-1]``,
  indexed at ``999 - ticket`` so tickets ascend as sigma ascends; the DiT is
  conditioned on ``timestep / 1000``;
* ``flowmatch_noise_and_target``: x_t = (1-s) x0 + s n, target n - x0;
* ``weighted_flowmatch_mse``: per-sample fp32 MSE x per-sample weight
  (weights index the loss curve by ticket), with the sample mask of padded
  batches and the line-art spatial mask;
* deterministic per-caption T5 token dropout keyed by
  sha256(seed:t5:caption), on the host in numpy (the same code).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def anima_sigma_table() -> np.ndarray:
    """sigma per ticket (ascending): sigmas[999 - ticket] of linspace(1,0,1001)[:-1]."""
    sigmas = np.linspace(1.0, 0.0, 1001, dtype=np.float32)[:-1]
    return sigmas[::-1].copy()  # index by ticket directly


def ticket_to_sigma_timestep(tickets: torch.Tensor):
    """tickets int in [0, 1000) -> (sigma, timestep=sigma*1000), fp32."""
    table = torch.from_numpy(anima_sigma_table()).to(tickets.device)
    sigma = table[torch.clamp(tickets.long(), 0, 999)]
    return sigma, sigma * 1000.0


def flowmatch_noise_and_target(latents, noise, sigmas):
    s = sigmas.reshape((sigmas.shape[0],) + (1,) * (latents.dim() - 1))
    latents, noise = latents.float(), noise.float()
    return (1.0 - s) * latents + s * noise, noise - latents


def weighted_flowmatch_mse(pred, target, weights, sample_mask=None,
                           spatial_mask=None, spatial_strength: float = 0.5):
    """Flow-matching MSE x per-sample ticket weight, then mean, for NHWC
    (image) or NTHWC (video) ``pred``/``target``.

    ``spatial_mask`` (B, H, W) in [0, 1] boosts the per-pixel loss by
    ``1 + mask * strength`` (resized bilinearly to the error map's H, W when
    they differ; a clip's one mask holds for each of its frames).
    ``sample_mask`` (B,) zeroes padded samples; the mean then divides by
    the real count.
    """
    sq = (pred.float() - target.float()) ** 2
    if spatial_mask is not None and spatial_strength > 0.0:
        m = torch.clamp(spatial_mask.float(), 0.0, 1.0)
        hw = tuple(sq.shape[-3:-1])          # NHWC or NTHWC error map
        if tuple(m.shape[-2:]) != hw:
            m = F.interpolate(m[:, None], size=hw, mode="bilinear",
                              align_corners=False, antialias=True)[:, 0]
        if sq.dim() == 5:                    # video: broadcast over T
            m = m[:, None]
        sq = sq * (1.0 + m[..., None] * spatial_strength)
    per_sample = sq.reshape(sq.shape[0], -1).mean(dim=1)
    weighted = per_sample * weights.float()
    if sample_mask is None:
        return weighted.mean()
    sm = sample_mask.float()
    return (weighted * sm).sum() / torch.clamp(sm.sum(), min=1.0)


def apply_t5_token_dropout(t5_ids: np.ndarray, captions, config,
                           pad_id: int = 0) -> np.ndarray:
    """Deterministic per-caption masking of non-pad T5 ids.

    Seed = sha256(f"{seed}:t5:{caption}"); a single chance roll gates the
    caption, then a uniform rate in [min, max] picks how many candidate
    tokens to replace with pad.
    """
    if config is None or not getattr(config, "T5_TOKEN_DROPOUT_ENABLED", False):
        return t5_ids
    chance = min(max(float(getattr(config, "T5_TOKEN_DROPOUT_CHANCE", 0.0) or 0.0), 0.0), 1.0)
    min_rate = min(max(float(getattr(config, "T5_TOKEN_DROPOUT_MIN", 0.0) or 0.0), 0.0), 1.0)
    max_rate = min(max(float(getattr(config, "T5_TOKEN_DROPOUT_MAX", 0.0) or 0.0), 0.0), 1.0)
    if max_rate < min_rate:
        min_rate, max_rate = max_rate, min_rate
    if chance <= 0.0 or max_rate <= 0.0:
        return t5_ids

    out = np.array(t5_ids, copy=True)
    squeeze = out.ndim == 1
    if squeeze:
        out = out[None]
    if isinstance(captions, str):
        captions = [captions]
    seed_base = int(getattr(config, "SEED", 42) or 42)
    for i, caption in enumerate(captions):
        ids = out[i]
        candidates = np.flatnonzero(ids != pad_id)
        if candidates.size == 0:
            continue
        digest = hashlib.sha256(
            f"{seed_base}:t5:{caption}".encode("utf-8", errors="ignore")).digest()
        rng = np.random.Generator(np.random.PCG64(
            int.from_bytes(digest[:8], "little") % (2 ** 63)))
        if rng.random() >= chance:
            continue
        rate = min_rate + (max_rate - min_rate) * rng.random()
        drop_count = int(round(candidates.size * rate))
        if drop_count <= 0:
            continue
        perm = rng.permutation(candidates.size)
        ids[candidates[perm[:drop_count]]] = pad_id
    return out[0] if squeeze else out
