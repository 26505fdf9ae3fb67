"""Anima DiT training loop (flow matching) for one CUDA device.

Counterpart of ``aozora_sdxl_training_tpu/train/anima_trainer.py::
run_anima_training`` with the same phases and the same output as the port's
SDXL trainer: cache check -> DiT load (key prefix detected, config read off
the checkpoint's shapes) -> dataset, ticket sampler and schedule -> micro
and apply steps -> progress lines (Ticket + Sigma) and optimizer blocks ->
scheduled / ``force_save.flag`` saves -> final DiT save under the detected
prefix. Tickets map to flow-matching sigmas, the DiT is conditioned on
sigma, loss weights are indexed by ticket, and the LLM adapter trains
inside the DiT forward.

The step runs eagerly on fp32 master weights: the micro step accumulates
gradients into ``.grad``, the apply step (shared with the SDXL trainer)
scales them by 1/GA, clips their global norm and runs the Raven AdamW
update. At GA 1 it runs micro + apply, which is the JAX package's fused
step's arithmetic. ``ANIMA_GRADIENT_CHECKPOINTING_MODE`` "Full" (the
default) recomputes each block in the backward, "Off" keeps everything.

Not ported yet, and refused with an error when the config asks for them:
resume (and the training-state file), "Conservative" checkpointing,
preview sampling, sequence/pipeline/tensor parallelism, the line-art loss,
video mode, a cache rebuild and int8 moments. There is no memory planner:
masters are fp32. ``AOZORA_PROFILE_DIR`` traces micro steps 3-8
(``train/profiling.py``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..ckpt.anima_checkpoint import (load_dit_state, resolve_save_prefix,
                                     save_dit_model)
from ..ckpt.train_state import output_model_stem
from ..config.runtime import parse_exclude_targets
from ..core.platform import resolve_device
from ..data.anima_cache import (AnimaLatentDataset, check_if_anima_caching_needed,
                                precompute_and_cache_anima)
from ..data.dataset import BatchPrefetcher, pack_sample_schedule, pad_batch_arrays
from ..data.schedule import TimestepTicketSampler, build_image_batch_schedule
from ..models.anima import dit as dit_mod
from ..opt import adamw
from . import anima_objectives, curves, objectives
from .profiling import StepProfiler
from .reporter import MetricsReporter, optimizer_block
from .train_step import make_apply_step, split_trainable
from .trainer import (attention_impl, consume_force_save_flag, force_save_flag_path,
                      make_optimizer_config, print_optimizer_summary)


@dataclass(frozen=True)
class AnimaStepConfig:
    dit: dit_mod.AnimaDiTConfig
    grad_accum_steps: int = 1
    clip_grad_norm: float = 1.0
    attn_impl: str = "xla"
    compute_dtype: Any = torch.bfloat16
    remat: Any = "full"                    # False | "full"


def make_anima_loss_fn(cfg: AnimaStepConfig):
    def loss_fn(trainable, frozen, latents, prompt_emb, t5_ids, tickets,
                sample_mask, loss_weights, seed: int, micro_step: int,
                noise=None):
        """latents (B, H, W, C) -> (loss, sigma of sample 0). ``noise``
        defaults to the step-keyed stream of ``objectives``."""
        sigmas, timesteps = anima_objectives.ticket_to_sigma_timestep(tickets)
        if noise is None:
            noise = objectives.noise_for_step(seed, micro_step, latents.shape,
                                              latents.device)
        noisy, target = anima_objectives.flowmatch_noise_and_target(
            latents, noise, sigmas)
        cd = cfg.compute_dtype
        pred = dit_mod.dit_forward(
            {**frozen, **trainable}, noisy[:, None].to(cd), timesteps / 1000.0,
            prompt_emb.to(cd), cfg=cfg.dit, t5_ids=t5_ids,
            attn_impl=cfg.attn_impl, compute_dtype=cd, remat=cfg.remat)[:, 0]
        weights = loss_weights[torch.clamp(tickets.long(), 0, loss_weights.shape[0] - 1)]
        loss = anima_objectives.weighted_flowmatch_mse(pred, target, weights,
                                                       sample_mask=sample_mask)
        return loss, sigmas[0]

    return loss_fn


def make_anima_micro_step(cfg: AnimaStepConfig):
    """micro_step(trainable, frozen, batch..., keep) -> (loss, sigma0),
    accumulating d(loss)/d(trainable) into ``.grad``."""
    loss_fn = make_anima_loss_fn(cfg)

    def micro_step(trainable, frozen, latents, prompt_emb, t5_ids, tickets,
                   sample_mask, loss_weights, seed, micro_step_idx,
                   keep: float, noise=None):
        if keep == 0.0:
            for p in trainable.values():
                p.grad = None
        loss, sigma = loss_fn(trainable, frozen, latents, prompt_emb, t5_ids,
                              tickets, sample_mask, loss_weights, seed,
                              micro_step_idx, noise)
        loss.backward()
        return loss.detach(), sigma

    return micro_step


def _dit_config_for_state(state: dict) -> dit_mod.AnimaDiTConfig:
    """The DiT size from checkpoint shapes (torch layout; tiny test models
    too): width, depth, heads, LoRA and context widths, adapter size and
    the latent channels of the patchify/unpatchify projections."""
    d = int(state["x_embedder.proj.1.weight"].shape[0])
    n = 0
    while f"blocks.{n}.self_attn.q_proj.weight" in state:
        n += 1
    an = 0
    while f"llm_adapter.blocks.{an}.cross_attn.q_proj.weight" in state:
        an += 1
    base = dit_mod.ANIMA_BASE
    patch_elems = base.patch_temporal * base.patch_spatial ** 2
    adapter_tgt = int(state["llm_adapter.embed.weight"].shape[1])
    return replace(
        base, model_channels=d, num_blocks=n,
        num_heads=d // int(state["blocks.0.self_attn.q_norm.weight"].shape[0]),
        adaln_lora_dim=int(state["blocks.0.adaln_modulation_self_attn.1.weight"].shape[0]),
        crossattn_emb_channels=int(state["blocks.0.cross_attn.k_proj.weight"].shape[1]),
        in_channels=(int(state["x_embedder.proj.1.weight"].shape[1]) // patch_elems
                     - (1 if base.concat_padding_mask else 0)),
        out_channels=int(state["final_layer.linear.weight"].shape[0]) // patch_elems,
        adapter_source_dim=int(
            state["llm_adapter.blocks.0.cross_attn.k_proj.weight"].shape[1]),
        adapter_target_dim=adapter_tgt, adapter_layers=an,
        adapter_vocab=int(state["llm_adapter.embed.weight"].shape[0]),
        adapter_heads=adapter_tgt // int(
            state["llm_adapter.blocks.0.self_attn.q_norm.weight"].shape[0]),
        context_tokens=512 if d >= 1024 else 16)


def anima_remat_mode(config):
    """ANIMA_GRADIENT_CHECKPOINTING_MODE: "Full" -> "full", "Off" -> False."""
    mode = str(getattr(config, "ANIMA_GRADIENT_CHECKPOINTING_MODE", "Full")).title()
    if mode == "Off":
        return False
    if mode == "Full":
        return "full"
    raise NotImplementedError(
        f"ANIMA_GRADIENT_CHECKPOINTING_MODE {mode!r} is not ported yet (the "
        "selective policy that saves the MLP down-projections and the flash "
        "outputs); use 'Full' or 'Off'")


def _refuse_unported(config) -> None:
    refused = (
        (config.RESUME_TRAINING,
         "RESUME_TRAINING: resume and the training-state file"),
        (int(getattr(config, "ANIMA_PREVIEW_EVERY_N_STEPS", 0) or 0) > 0,
         "ANIMA_PREVIEW_EVERY_N_STEPS: preview sampling"),
        (any(int(getattr(config, key, 1) or 1) > 1 for key in (
            "SEQUENCE_PARALLEL_SIZE", "PIPELINE_PARALLEL_SIZE",
            "TENSOR_PARALLEL_SIZE")),
         "SEQUENCE/PIPELINE/TENSOR_PARALLEL_SIZE > 1: multi-device meshes"),
        (bool(getattr(config, "ANIMA_REPAIR_LINEART_LOSS_ENABLED", False)),
         "ANIMA_REPAIR_LINEART_LOSS_ENABLED: the line-art loss"),
        (int(getattr(config, "ANIMA_VIDEO_FRAMES", 1) or 1) > 1,
         "ANIMA_VIDEO_FRAMES > 1: video mode"),
    )
    for asked, what in refused:
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch package yet")


def run_anima_training(config, *, device: torch.device | None = None) -> None:
    """``device`` defaults to ``core.platform.resolve_device()``."""
    device = resolve_device() if device is None else torch.device(device)
    _refuse_unported(config)
    remat = anima_remat_mode(config)
    output_dir = Path(config.OUTPUT_DIR)
    output_dir.mkdir(parents=True, exist_ok=True)
    flag_path = force_save_flag_path()
    print("\n" + "=" * 50 + "\n--- STARTING ANIMA DIT TRAINING (flow matching) ---\n"
          + "=" * 50 + "\n")
    print(f"INFO: Set random seed to {config.SEED}")

    # ---- caching ----
    if check_if_anima_caching_needed(config):
        precompute_and_cache_anima(config)

    # ---- model ----
    print("\n--- Loading Anima DiT ---")
    state, detected_prefix = load_dit_state(config.DIT_PATH)
    dit_cfg = _dit_config_for_state(state)
    save_prefix = resolve_save_prefix(config, detected_prefix)
    print(f"INFO: DiT key prefix: detected='{detected_prefix}' save='{save_prefix}'")
    exclude = parse_exclude_targets(getattr(config, "DIT_EXCLUDE_TARGETS", ""))
    global_batch = int(config.BATCH_SIZE)

    # ---- schedules ----
    dataset = AnimaLatentDataset(config)
    ts_sampler = TimestepTicketSampler(config, batch_size=global_batch)
    loss_weights = torch.as_tensor(
        curves.timestep_loss_curve_from_config(config, 1000), device=device)
    schedule = build_image_batch_schedule(
        dataset.bucket_keys, config.MAX_TRAIN_STEPS, global_batch,
        config.SEED, ts_sampler.ticket_pool, ts_sampler.bin_ranges,
        bool(getattr(config, "TIMESTEP_FORCE_IMAGE_BIN_SPREAD", False)))
    packed = pack_sample_schedule(schedule, global_batch)
    print(f"INFO: Precomputed batch schedule for {len(packed):,} step(s).")

    opt_cfg = make_optimizer_config(config)
    lr_curve = curves.LRCurve(config.LR_CUSTOM_CURVE, config.MAX_TRAIN_STEPS,
                              fallback_lr=getattr(config, 'LEARNING_RATE', None))
    attn_impl = attention_impl(config, device)
    if attn_impl == "flash" and config.compute_dtype == torch.float16:
        raise NotImplementedError(
            "MIXED_PRECISION float16: the flash-attention kernels take "
            "bfloat16 (or float32) only; use bfloat16, or "
            "MEMORY_EFFICIENT_ATTENTION 'xla' for the einsum path")
    print(f"INFO: Device {device}; attention {attn_impl}; gradient "
          f"checkpointing {remat or 'off'}; fp32 master weights")

    # ---- weights ----
    params = dit_mod.params_from_torch_state(state, dit_cfg, dtype=torch.float32,
                                             device=device)
    del state
    # the reference's freeze rule (the JAX package's split_trainable_dit)
    trainable, frozen = split_trainable(params, exclude)
    del params
    for p in trainable.values():
        p.requires_grad_(True)
    n_t = sum(p.numel() for p in trainable.values())
    n_f = sum(p.numel() for p in frozen.values())
    print(f"INFO: DiT Parameters: total={n_t + n_f:,} trainable={n_t:,} "
          f"frozen={n_f:,}")

    step_cfg = AnimaStepConfig(
        dit=dit_cfg, grad_accum_steps=config.GRADIENT_ACCUMULATION_STEPS,
        clip_grad_norm=float(config.CLIP_GRAD_NORM), attn_impl=attn_impl,
        compute_dtype=config.compute_dtype, remat=remat)
    micro_fn = make_anima_micro_step(step_cfg)
    apply_fn = make_apply_step(step_cfg, opt_cfg)
    opt_state = adamw.init_state(trainable, opt_cfg)
    seed = int(config.SEED or 42)
    print_optimizer_summary(config, opt_cfg, trainable, lr_curve.initial_lr,
                            device)

    # ---- loop ----
    reporter = MetricsReporter(total_steps=config.MAX_TRAIN_STEPS)

    def upload(batch):
        # H2D copies happen in the prefetch thread, overlapping device compute
        out = pad_batch_arrays(batch, 0)
        lat = out["latents"]
        if lat.ndim == 4 and lat.shape[1] == dit_cfg.in_channels \
                and lat.shape[1] < lat.shape[-1]:
            out["latents"] = np.transpose(lat, (0, 2, 3, 1))  # NCHW cache -> NHWC
        for key in ("latents", "prompt_emb", "t5xxl_ids", "sample_mask"):
            out[key] = torch.as_tensor(out[key], device=device)
        return out

    prefetcher = BatchPrefetcher(dataset, packed, transform=upload)
    diag_losses: deque = deque(maxlen=config.GRADIENT_ACCUMULATION_STEPS)
    step_times: deque = deque(maxlen=50)
    optim_times: deque = deque(maxlen=20)
    start_time = last_step_time = last_optim_time = time.time()
    ga = config.GRADIENT_ACCUMULATION_STEPS
    micro_step = optimizer_step = 0
    pending = None  # (micro_step, loss_dev, sigma_dev, ticket, optim_diag)

    def emit(pending_entry, s_per_step):
        ms, loss_dev, sigma_dev, ticket, diag = pending_entry
        loss_val = float(loss_dev)
        diag_losses.append(loss_val)
        block = None
        if diag is not None:
            raw_norm = float(diag["raw_norm"])
            clipped = (min(raw_norm, step_cfg.clip_grad_norm)
                       if step_cfg.clip_grad_norm > 0 else raw_norm)
            block = optimizer_block(
                diag["optim_step"], sum(diag_losses) / max(len(diag_losses), 1),
                diag["lr"], diag["optim_step_time"],
                sum(optim_times) / max(len(optim_times), 1),
                raw_norm, clipped, float(diag["update_norm"]))
            diag_losses.clear()
        eta = ((config.MAX_TRAIN_STEPS - ms)
               * (sum(step_times) / max(len(step_times), 1))
               if step_times else 0)
        reporter.log_step(ms - 1, loss=loss_val, timestep=ticket,
                          sigma=float(sigma_dev), s_per_step=s_per_step, eta=eta,
                          elapsed=time.time() - start_time, optim_block=block)

    def save_model(path):
        save_dit_model(path, {**frozen, **trainable}, prefix=save_prefix,
                       dtype=config.compute_dtype)

    profiler = StepProfiler.from_env("anima")
    for batch in prefetcher:
        if micro_step >= config.MAX_TRAIN_STEPS:
            break
        if not batch:
            continue
        micro_step += 1
        profiler.before_step(micro_step)
        tickets = ts_sampler.sample(int(batch["real_n"]))
        keep = 0.0 if (micro_step - 1) % ga == 0 else 1.0
        loss_dev, sigma_dev = micro_fn(
            trainable, frozen, batch["latents"], batch["prompt_emb"],
            batch["t5xxl_ids"], torch.as_tensor(np.asarray(tickets), device=device),
            batch["sample_mask"], loss_weights, seed, micro_step, keep)

        diag = None
        if micro_step % ga == 0:
            lr = lr_curve.lr_at(micro_step)
            raw_norm, update_norm = apply_fn(trainable, opt_state, lr)
            optimizer_step += 1
            optim_dt = time.time() - last_optim_time
            optim_times.append(optim_dt)
            last_optim_time = time.time()
            diag = {"optim_step": optimizer_step, "lr": lr,
                    "raw_norm": raw_norm, "update_norm": update_norm,
                    "optim_step_time": optim_dt}
            scheduled = (config.SAVE_EVERY_N_STEPS > 0
                         and optimizer_step % config.SAVE_EVERY_N_STEPS == 0)
            forced = consume_force_save_flag(flag_path)
            if scheduled or forced:
                reason = ("Emergency checkpoint requested"
                          if forced and not scheduled else "Saving checkpoint")
                reporter.log_message(
                    f"\n--- {reason} at optimizer step {optimizer_step} ---")
                stem = output_model_stem(config, config.DIT_PATH)
                save_model(output_dir / f"{stem}_step_{optimizer_step}.safetensors")
                print("WARNING: the training-state file is not written: it is "
                      "not ported to the PyTorch package yet")

        message = profiler.after_step(micro_step)
        if message:
            reporter.log_message(message)

        # report the *previous* step so the host never waits on this one
        now = time.time()
        step_times.append(now - last_step_time)
        last_step_time = now
        if pending is not None:
            emit(pending, step_times[-1])
        pending = (micro_step, loss_dev, sigma_dev, int(tickets[0]), diag)

    if pending is not None:
        emit(pending, step_times[-1] if step_times else 0.0)
    reporter.log_message("\nTraining complete.")
    reporter.shutdown()
    save_model(output_dir / f"{output_model_stem(config, config.DIT_PATH)}.safetensors")
    print("All tasks complete. Final model saved.")
