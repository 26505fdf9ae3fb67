"""SDXL train step: loss, micro step (fwd + bwd + accumulation) and apply
step.

Counterpart of ``aozora_sdxl_training_tpu/train/train_step.py``, run
eagerly:

* ``micro_step`` — fwd + bwd of one micro-batch. Gradients accumulate in
  each trainable tensor's ``.grad``, in the master weights' dtype: the
  memory plan's accumulator dtype (fp32 with fp32 masters, bf16 with bf16
  masters, as the JAX accumulation tree); ``keep == 0`` on the first micro
  step of a window clears them first.
* ``apply_step`` — scales the accumulated gradients by 1/GA, clips them by
  their global norm and runs the Raven AdamW update in place, freeing each
  gradient once its tensor is updated.

On the ranks of a torchrun world both steps take the run's FSDP
(``parallel/sharding.FSDP``): the micro step gathers every sharded tensor
once and reduce-scatters its gradient into the shard's accumulator, the
apply step sums the rest over the ranks and updates the shards. Under
tensor parallelism the step config's ``tp`` (``FSDP.tp_config``) runs the
UNet's Megatron splits on the tp slices that FSDP holds; their gradients
accumulate in the slices' ``.grad`` like a replicated tensor's.

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
    # parallel.tensor_parallel.TPConfig under tensor parallelism, or None
    tp: Any = None


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
            remat_thresholds=cfg.remat_thresholds, tp=cfg.tp)
        loss = objectives.weighted_mse_loss(pred, target, timesteps,
                                            loss_weights, sample_mask)
        return loss, sigma

    return loss_fn


def accumulate_gradients(loss_fn, trainable, frozen, inputs: tuple, keep: float,
                         loss_scale: float = 1.0, fsdp=None):
    """One micro step's forward and backward of ``loss_fn(trainable,
    frozen, *inputs) -> (loss, aux)`` times ``loss_scale``, its
    gradients added into the trainable tensors' ``.grad`` (cleared first
    when ``keep`` is 0). Returns (loss, aux), detached.

    Under FSDP (``parallel/sharding.FSDP``) the micro step runs on compute
    copies: every sharded tensor gathered once at the start (the JAX
    package's gather-once ``precast_params``), the forward and backward on
    them, then their gradients reduce-scattered into the shards' ``.grad``
    (the sharded accumulators: the JAX package's ``grad_accum`` carries
    its parameter's sharding), and the copies freed on return."""
    if keep == 0.0:
        for p in trainable.values():
            p.grad = None
    run_t, run_f = ((fsdp.compute_copies(trainable), fsdp.compute_copies(frozen))
                    if fsdp is not None else (trainable, frozen))
    loss, aux = loss_fn(run_t, run_f, *inputs)
    loss = loss * loss_scale
    loss.backward()
    if fsdp is not None:
        fsdp.reduce_scatter(run_t, trainable)
    return loss.detach(), aux.detach()


def make_micro_step(cfg: TrainStepConfig, fsdp=None):
    """micro_step(trainable, frozen, batch..., keep) -> (loss, sigma0),
    accumulating d(loss)/d(trainable) into ``.grad``. ``loss_scale`` turns
    a dp rank's loss into its share of the global batch's (1 on one
    device); ``fsdp``: the run's ``parallel.sharding.FSDP``, or None."""
    loss_fn = make_loss_fn(cfg)

    def micro_step(trainable, frozen, latents, embeds, pooled, time_ids,
                   timesteps, sample_mask, loss_weights, seed, micro_step_idx,
                   keep: float, noise=None, rf_jitter=None, loss_scale: float = 1.0):
        loss, sigma = accumulate_gradients(
            loss_fn, trainable, frozen,
            (latents, embeds, pooled, time_ids, timesteps, sample_mask, loss_weights,
             seed, micro_step_idx, noise, rf_jitter), keep, loss_scale, fsdp)
        return loss, sigma[0]

    return micro_step


def make_apply_step(cfg: TrainStepConfig, opt_cfg: adamw.AdamWConfig, fsdp=None):
    """apply_step(trainable, opt_state, lr) -> (raw_grad_norm, update_norm),
    updating ``trainable`` and ``opt_state`` in place, whatever its moments'
    storage (bf16, fp32, or int8 codes and scales in the JAX layout). The
    accumulated gradients are taken out of ``.grad`` times 1/GA and clipped
    by their global norm; each is freed once its tensor is updated.

    With ``fsdp`` the gradients are first summed over the ranks
    (``FSDP.sync``), the norm is the global one (``FSDP.grad_norm``), and
    each rank updates its shards and the replicated tensors."""
    inv_ga = 1.0 / float(cfg.grad_accum_steps)

    @torch.no_grad()
    def apply_step(trainable, opt_state, lr):
        if fsdp is not None:
            fsdp.sync(trainable)
        grads = {}
        for name, p in trainable.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads[name] = g.mul_(inv_ga) if inv_ga != 1.0 else g
        if fsdp is None:
            grads, raw_norm = adamw.clip_by_global_norm(grads, cfg.clip_grad_norm)
        else:
            grads, raw_norm = adamw.clip_by_global_norm(grads, cfg.clip_grad_norm,
                                                        norm=fsdp.grad_norm(grads))
        _, _, update_sq = adamw.apply_updates(trainable, grads, opt_state,
                                              opt_cfg, lr=lr, release=True)
        return raw_norm, torch.sqrt(update_sq)

    return apply_step


def make_two_pass_step(loss_fn, opt_cfg: adamw.AdamWConfig, clip_grad_norm: float):
    """The two-pass GA=1 step over ``loss_fn(trainable, frozen, *batch,
    **kw) -> (loss, aux)`` (``make_loss_fn``, or the Anima trainer's
    ``make_anima_loss_fn``):

    ``step(trainable, frozen, opt_state, *batch, lr, **kw) -> (loss, aux0,
    raw_norm, update_norm)``, updating ``trainable`` and ``opt_state`` in
    place (moments held on the device). ``raw_norm`` is the gradients'
    global norm before the clip (pass 1's), ``update_norm`` the norm of the
    parameters' fp32 delta. The hooks are removed after each pass, so no
    other step sees them."""
    clip = clip_grad_norm is not None and float(clip_grad_norm) > 0

    def run_pass(trainable, on_grad, frozen, batch, kw):
        """fwd + bwd with ``on_grad(name, grad)`` at each tensor's complete
        gradient, which is dropped from ``.grad`` first."""
        def hook(name):
            def at_grad(p):
                g, p.grad = p.grad, None
                on_grad(name, g)
            return at_grad

        handles = [p.register_post_accumulate_grad_hook(hook(name))
                   for name, p in trainable.items()]
        try:
            loss, aux = loss_fn(trainable, frozen, *batch, **kw)
            loss.backward()
        finally:
            for h in handles:
                h.remove()
        return loss.detach(), aux.detach().reshape(-1)[0]

    def step(trainable, frozen, opt_state, *batch, lr, **kw):
        if opt_state.host is not None:
            raise ValueError("the two-pass step keeps the moments on the device")
        for p in trainable.values():
            p.grad = None
        device = next(iter(trainable.values())).device
        norm_sq = torch.zeros((), dtype=torch.float32, device=device)
        update_sq = torch.zeros((), dtype=torch.float32, device=device)
        scale = None

        def add_square(name, g):
            norm_sq.add_((g.float() ** 2).sum())

        def update(name, g):
            if clip:
                adamw.clip_tensor_(g, scale)
            else:                       # one pass: its norm is the raw norm
                add_square(name, g)
            update_sq.add_(adamw.update_tensor(
                name, trainable[name], g, opt_state.exp_avg[name],
                opt_state.exp_avg_sq[name], opt_cfg, scalars, opt_state.layout))

        if clip:
            loss, aux0 = run_pass(trainable, add_square, frozen, batch, kw)
            scale = adamw.clip_scale(torch.sqrt(norm_sq), float(clip_grad_norm))
        opt_state.step += 1
        scalars = adamw.step_scalars(opt_cfg, opt_state.step, lr)
        out = run_pass(trainable, update, frozen, batch, kw)
        if not clip:
            loss, aux0 = out
        return loss, aux0, torch.sqrt(norm_sq), torch.sqrt(update_sq)

    return step
