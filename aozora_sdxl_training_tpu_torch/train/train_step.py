"""SDXL train step: loss, micro step (fwd + bwd + accumulation) and apply
step.

Counterpart of ``aozora_sdxl_training_tpu/train/train_step.py`` for one
device, run eagerly:

* ``micro_step`` — fwd + bwd of one micro-batch. Gradients accumulate in
  each trainable tensor's ``.grad``, in the master weights' dtype: the
  memory plan's accumulator dtype (fp32 with fp32 masters, bf16 with bf16
  masters, as the JAX accumulation tree); ``keep == 0`` on the first micro
  step of a window clears them first.
* ``apply_step`` — scales the accumulated gradients by 1/GA, clips them by
  their global norm and runs the Raven AdamW update in place, freeing each
  gradient once its tensor is updated.

At GA 1 (the plan's ``fused_apply``) a micro step then an apply step is the
JAX package's ``make_fused_step``: fwd + bwd, the clip, then the update of
each tensor, its gradient freed right after, so no accumulation outlives
the step. JAX compiles it into one program with donated buffers to avoid a
second gradient tree; eagerly, ``.grad`` is already the only one.

Parameters are split into trainable/frozen dicts by the reference's fnmatch
freeze rule; only trainable tensors require gradients.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Any

import torch

from ..models.sdxl.arch import UNetConfig
from ..models.sdxl.unet import unet_forward
from ..opt import adamw
from . import objectives

Params = dict[str, torch.Tensor]


def split_trainable(params: dict, exclude_keywords: list[str]):
    """Split the flat param dict by the reference's fnmatch freeze rule:
    a param is FROZEN iff any keyword matches (kw if it has a '*' else *kw*).
    """
    trainable, frozen = {}, {}
    for name, p in params.items():
        excluded = any(
            fnmatch.fnmatch(name, kw if "*" in kw else f"*{kw}*")
            for kw in exclude_keywords)
        (frozen if excluded else trainable)[name] = p
    return trainable, frozen


@dataclass(frozen=True)
class TrainStepConfig:
    unet: UNetConfig
    prediction_type: str = "v_prediction"  # epsilon | v_prediction | rectified_flow
    grad_accum_steps: int = 1
    clip_grad_norm: float = 1.0
    attn_impl: str = "xla"
    compute_dtype: Any = torch.bfloat16
    remat: Any = False                     # False | True | mode string
    # (hires_tokens, full_tokens) for "*_hires" remat modes, from the plan
    remat_thresholds: tuple | None = None


def make_loss_fn(cfg: TrainStepConfig):
    def loss_fn(trainable: Params, frozen: Params, latents, embeds, pooled,
                time_ids, timesteps, sample_mask, loss_weights, seed: int,
                micro_step: int, noise=None, rf_jitter=None):
        """-> (loss, sigma). ``noise``/``rf_jitter`` default to the step-keyed
        streams of ``objectives``; tests pass their own."""
        if noise is None:
            noise = objectives.noise_for_step(seed, micro_step, latents.shape,
                                              latents.device)
        if rf_jitter is None and cfg.prediction_type == "rectified_flow":
            rf_jitter = objectives.rf_jitter_for_step(
                seed, micro_step, latents.shape[0], latents.device)
        noisy, target, t_cond, sigma = objectives.prepare_batch(
            cfg.prediction_type, latents, noise, timesteps, rf_jitter)
        pred = unet_forward(
            {**frozen, **trainable}, noisy.to(cfg.compute_dtype), t_cond,
            embeds, pooled, time_ids, cfg=cfg.unet, attn_impl=cfg.attn_impl,
            compute_dtype=cfg.compute_dtype, remat=cfg.remat,
            remat_thresholds=cfg.remat_thresholds)
        loss = objectives.weighted_mse_loss(pred, target, timesteps,
                                            loss_weights, sample_mask)
        return loss, sigma

    return loss_fn


def make_micro_step(cfg: TrainStepConfig):
    """micro_step(trainable, frozen, batch..., keep) -> (loss, sigma0),
    accumulating d(loss)/d(trainable) into ``.grad``."""
    loss_fn = make_loss_fn(cfg)

    def micro_step(trainable, frozen, latents, embeds, pooled, time_ids,
                   timesteps, sample_mask, loss_weights, seed, micro_step_idx,
                   keep: float, noise=None, rf_jitter=None):
        if keep == 0.0:
            for p in trainable.values():
                p.grad = None
        loss, sigma = loss_fn(trainable, frozen, latents, embeds, pooled,
                              time_ids, timesteps, sample_mask, loss_weights,
                              seed, micro_step_idx, noise, rf_jitter)
        loss.backward()
        return loss.detach(), sigma[0]

    return micro_step


def make_apply_step(cfg: TrainStepConfig, opt_cfg: adamw.AdamWConfig):
    """apply_step(trainable, opt_state, lr) -> (raw_grad_norm, update_norm),
    updating ``trainable`` and ``opt_state`` in place, whatever its moments'
    storage (bf16, fp32, or int8 codes and scales in the JAX layout). The
    accumulated gradients are taken out of ``.grad`` times 1/GA and clipped
    by their global norm; each is freed once its tensor is updated."""
    inv_ga = 1.0 / float(cfg.grad_accum_steps)

    @torch.no_grad()
    def apply_step(trainable, opt_state, lr):
        grads = {}
        for name, p in trainable.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads[name] = g.mul_(inv_ga) if inv_ga != 1.0 else g
        grads, raw_norm = adamw.clip_by_global_norm(grads, cfg.clip_grad_norm)
        _, _, update_sq = adamw.apply_updates(trainable, grads, opt_state,
                                              opt_cfg, lr=lr, release=True)
        return raw_norm, torch.sqrt(update_sq)

    return apply_step
