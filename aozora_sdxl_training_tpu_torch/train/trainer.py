"""SDXL training loop for one CUDA device.

Counterpart of ``aozora_sdxl_training_tpu/train/trainer.py::
run_sdxl_training`` with the same phases and the same output: cache check
-> model load -> dataset, ticket sampler and schedule -> micro and apply
steps -> progress lines and optimizer blocks -> scheduled /
``force_save.flag`` saves -> final merged save. The step runs eagerly on
fp32 master weights with moments in the configured dtype and gradients
accumulated in ``.grad``.

Not ported yet, and refused with an error when the config asks for them:
resume (and the training-state file), preview sampling, tensor-parallel
meshes, int8 moments. There is no memory planner: remat follows
``AOZORA_SDXL_REMAT`` (``off`` by default, or ``full``).
``AOZORA_PROFILE_DIR`` traces micro steps 3-8 (``train/profiling.py``).
"""

from __future__ import annotations

import os
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..ckpt.sd_checkpoint import (detect_unet_io_channels, load_sd_tensors,
                                  save_merged_checkpoint)
from ..ckpt.train_state import output_model_stem
from ..core.platform import resolve_device
from ..data.cache_builder import check_if_caching_needed, precompute_and_cache
from ..data.dataset import (BatchPrefetcher, CachedLatentDataset,
                            pack_sample_schedule, pad_batch_arrays)
from ..data.schedule import TimestepTicketSampler, build_image_batch_schedule
from ..models.sdxl.arch import SDXL_BASE, UNetConfig
from ..models.sdxl.conversion import params_from_sd_state
from ..opt import adamw
from . import curves
from .profiling import StepProfiler
from .reporter import MetricsReporter, optimizer_block
from .train_step import (TrainStepConfig, make_apply_step, make_micro_step,
                         split_trainable)


def force_save_flag_path() -> Path:
    """``force_save.flag`` in the working directory — the GUI drops the flag
    next to the trainer script it launched, which is the process CWD here."""
    return Path.cwd() / "force_save.flag"


def consume_force_save_flag(flag_path: Path) -> bool:
    if not flag_path.exists():
        return False
    try:
        flag_path.unlink()
        return True
    except OSError as e:
        print(f"WARNING: Emergency checkpoint flag found but could not be "
              f"deleted: {e}")
        return False


def unet_config_for_checkpoint(path, sidecar_fallback=None) -> UNetConfig:
    """UNetConfig for a single-file checkpoint: a ``<checkpoint>.arch.json``
    sidecar overrides fields of SDXL_BASE; otherwise only the in/out channel
    counts are peeked from conv shapes."""
    import json
    from dataclasses import fields, replace
    sidecar = Path(str(path) + ".arch.json")
    if not sidecar.exists() and sidecar_fallback is not None:
        sidecar = Path(str(sidecar_fallback) + ".arch.json")
    overrides = {}
    if sidecar.exists():
        with open(sidecar, "r", encoding="utf-8") as f:
            raw = json.load(f)
        valid = {fld.name for fld in fields(UNetConfig)}
        overrides = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in raw.items() if k in valid}
        print(f"INFO: UNet architecture overrides from {sidecar.name}: "
              f"{sorted(overrides)}")
    in_ch, out_ch = detect_unet_io_channels(path)
    overrides.setdefault("in_channels", in_ch)
    overrides.setdefault("out_channels", out_ch)
    return replace(SDXL_BASE, **overrides)


def make_optimizer_config(config) -> adamw.AdamWConfig:
    opt_type = str(config.OPTIMIZER_TYPE).lower()
    if opt_type == "titan":
        raw = dict(getattr(config, "TITAN_PARAMS", {}) or {})
    elif opt_type == "raven":
        raw = dict(getattr(config, "RAVEN_PARAMS", {}) or {})
    elif opt_type == "paged_adamw_8bit":
        raw = dict(getattr(config, "PAGED_ADAMW_8BIT_PARAMS", {}) or {})
        raw.setdefault("debias_strength", 1.0)
        raw.setdefault("momentum_dtype", "int8_blockwise")
    else:
        raise ValueError(f"Unsupported optimizer type: '{config.OPTIMIZER_TYPE}'")
    return adamw.AdamWConfig.from_params_dict(raw)


def print_optimizer_summary(config, opt_cfg: adamw.AdamWConfig, trainable,
                            initial_lr: float, device) -> None:
    names = {"raven": "RavenAdamW", "titan": "TitanAdamW",
             "paged_adamw_8bit": "PagedAdamW8bit"}
    key = str(config.OPTIMIZER_TYPE).lower()
    n_tensors = len(trainable)
    n_elements = sum(p.numel() for p in trainable.values())
    dtype_name = str(opt_cfg.momentum_dtype).replace("torch.", "")
    print("\n" + "=" * 58)
    print("INFO: Optimizer Configuration")
    print(f"  - Optimizer:           {names.get(key, key)} (PyTorch, on {device.type})")
    print(f"  - Config key:          {key}")
    print(f"  - Trainable tensors:   {n_tensors:,}")
    print(f"  - Trainable elements:  {n_elements:,}")
    print(f"  - Initial LR:          {initial_lr:.8g}")
    print(f"  - Betas:               {tuple(opt_cfg.betas)}")
    print(f"  - Epsilon:             {opt_cfg.eps:.8g}")
    print(f"  - Weight decay:        {opt_cfg.weight_decay:.8g}")
    print(f"  - Debias strength:     {opt_cfg.debias_strength:.8g}")
    print(f"  - Momentum state:      {device.type} {dtype_name}")
    print("  - Update math:         FP32, in place, per tensor")
    print("=" * 58 + "\n")
    print(f"GUI_PARAM_INFO::Trainable: {n_elements:,} elements in "
          f"{n_tensors:,} tensors | Optimizer: {names.get(key, key)} | "
          f"LR: {initial_lr:.8g}", flush=True)


def print_dataset_resolution_sample(dataset, sample_count: int = 5) -> None:
    """Log the first cached items' bucket geometry."""
    sample_count = min(sample_count, len(dataset.items))
    if sample_count <= 0:
        return
    plural = "s" if sample_count != 1 else ""
    print(f"INFO: Dataset resolution sample ({sample_count} cached item{plural}):")
    for item in dataset.items[:sample_count]:
        ow, oh = item["original_size"]
        tw, th = item["target_size"]
        orig_ar = ow / oh if oh else 1.0
        targ_ar = tw / th if th else 1.0
        ar_err = (abs(orig_ar - targ_ar) / orig_ar * 100) if orig_ar else 0.0
        stem = Path(item.get("relative_path", item["lat_path"])).stem
        variant = item.get("bucket_variant_index", 0)
        label = f", variant {variant}" if variant else ""
        print(f"INFO:   {stem}: original {ow}x{oh} (AR {orig_ar:.4f}) -> "
              f"target {tw}x{th} (AR {targ_ar:.4f}){label}, "
              f"AR diff {ar_err:.2f}%, cropped not stretched")


def print_param_stats(trainable: dict, frozen: dict) -> None:
    t = sum(p.numel() for p in trainable.values())
    f = sum(p.numel() for p in frozen.values())
    total = t + f
    print(f"\n{'=' * 50}\nINFO: UNet Parameter Statistics:")
    print(f"  - Total Parameters:     {total:,}")
    print(f"  - Frozen Parameters:    {f:,}")
    print(f"  - Trainable Parameters: {t:,}")
    print(f"  - Percentage Frozen:    {(f / max(total, 1)) * 100:.2f}%")
    print("=" * 50 + "\n")


def sdxl_remat_mode():
    """AOZORA_SDXL_REMAT: unset/auto/off -> False, full -> "full"; the JAX
    package's partial policies are not ported."""
    mode = os.environ.get("AOZORA_SDXL_REMAT", "").strip().lower()
    if mode in ("", "auto", "off", "none", "0", "false"):
        return False
    if mode in ("full", "1", "true", "on"):
        return "full"
    raise NotImplementedError(f"AOZORA_SDXL_REMAT={mode!r} is not ported yet "
                              "(only off and full)")


def attention_impl(config, device: torch.device) -> str:
    """The reference's sdpa/cudnn/xformers switch: on CUDA every option maps
    to the flash kernels (long-KV self-attention); "xla"/"einsum" and the
    CPU take the einsum path."""
    pref = str(getattr(config, "MEMORY_EFFICIENT_ATTENTION", "sdpa")).lower()
    if pref in ("xla", "einsum") or device.type != "cuda":
        return "xla"
    return "flash"


def _refuse_unported(config) -> None:
    if config.RESUME_TRAINING:
        raise NotImplementedError(
            "RESUME_TRAINING: resume and the training-state file are not "
            "ported to the PyTorch package yet")
    if int(getattr(config, "PREVIEW_EVERY_N_STEPS", 0) or 0) > 0:
        raise NotImplementedError(
            "PREVIEW_EVERY_N_STEPS: preview sampling is not ported yet")
    if int(getattr(config, "TENSOR_PARALLEL_SIZE", 1) or 1) > 1:
        raise NotImplementedError(
            "TENSOR_PARALLEL_SIZE > 1: meshes are not ported yet")


def run_sdxl_training(config, *, unet_cfg: UNetConfig | None = None,
                      device: torch.device | None = None) -> None:
    """``unet_cfg`` overrides checkpoint-shape detection (tiny test models);
    ``device`` defaults to ``core.platform.resolve_device()``."""
    device = resolve_device() if device is None else torch.device(device)
    _refuse_unported(config)
    output_dir = Path(config.OUTPUT_DIR)
    output_dir.mkdir(parents=True, exist_ok=True)
    flag_path = force_save_flag_path()

    mode_str = ("RECTIFIED FLOW" if config.is_rectified_flow
                else f"STANDARD SDXL ({config.PREDICTION_TYPE})")
    micro_step = optimizer_step = 0
    model_to_load = Path(config.SINGLE_FILE_CHECKPOINT_PATH)
    print("\n" + "=" * 50 + f"\n--- STARTING {mode_str} TRAINING ---\n" + "=" * 50 + "\n")
    print(f"INFO: Noise type: {getattr(config, 'NOISE_MODE', 'normal')}")
    print(f"INFO: Set random seed to {config.SEED}")

    # ---- caching ----
    if check_if_caching_needed(config):
        precompute_and_cache(config)

    # ---- model config ----
    print("\n--- Loading Model ---")
    if unet_cfg is None:
        unet_cfg = unet_config_for_checkpoint(model_to_load)
    print(f"INFO: Detected UNet configuration - in_channels: "
          f"{unet_cfg.in_channels}, out_channels: {unet_cfg.out_channels}")
    global_batch = int(config.BATCH_SIZE)

    # ---- schedules ----
    print("\n--- Initializing Dataset ---")
    dataset = CachedLatentDataset(config)
    print_dataset_resolution_sample(dataset)
    ts_sampler = TimestepTicketSampler(config, batch_size=global_batch)
    loss_weights = torch.as_tensor(
        curves.timestep_loss_curve_from_config(config, 1000), device=device)
    image_schedule = build_image_batch_schedule(
        dataset.bucket_keys, config.MAX_TRAIN_STEPS, global_batch,
        config.SEED, ts_sampler.ticket_pool, ts_sampler.bin_ranges,
        bool(getattr(config, "TIMESTEP_FORCE_IMAGE_BIN_SPREAD", False)))
    packed_schedule = pack_sample_schedule(image_schedule, global_batch)
    print(f"INFO: Precomputed image batch schedule for {len(packed_schedule):,} step(s).")

    opt_cfg = make_optimizer_config(config)
    attn_impl = attention_impl(config, device)
    if attn_impl == "flash" and config.compute_dtype == torch.float16:
        raise NotImplementedError(
            "MIXED_PRECISION float16: the flash-attention kernels take "
            "bfloat16 (or float32) only; use bfloat16, or "
            "MEMORY_EFFICIENT_ATTENTION 'xla' for the einsum path")
    remat = sdxl_remat_mode()
    print(f"INFO: Device {device}; attention {attn_impl}; remat "
          f"{remat or 'off'}; fp32 master weights")

    # ---- model weights ----
    sd_tensors = load_sd_tensors(model_to_load)
    params = params_from_sd_state(sd_tensors, unet_cfg, dtype=torch.float32,
                                  device=device)
    del sd_tensors
    trainable, frozen = split_trainable(params, config.UNET_EXCLUDE_TARGETS)
    del params
    for p in trainable.values():
        p.requires_grad_(True)
    print_param_stats(trainable, frozen)

    # ---- optimizer / steps ----
    lr_curve = curves.LRCurve(config.LR_CUSTOM_CURVE, config.MAX_TRAIN_STEPS,
                              fallback_lr=getattr(config, 'LEARNING_RATE', None))
    step_cfg = TrainStepConfig(
        unet=unet_cfg,
        prediction_type=config.PREDICTION_TYPE,
        grad_accum_steps=config.GRADIENT_ACCUMULATION_STEPS,
        clip_grad_norm=float(config.CLIP_GRAD_NORM),
        attn_impl=attn_impl,
        compute_dtype=config.compute_dtype,
        remat=remat)
    micro_fn = make_micro_step(step_cfg)
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
        for key in ("latents", "embeds", "pooled", "time_ids", "sample_mask"):
            out[key] = torch.as_tensor(out[key], device=device)
        return out

    prefetcher = BatchPrefetcher(dataset, packed_schedule, transform=upload)
    diag_losses: deque = deque(maxlen=config.GRADIENT_ACCUMULATION_STEPS)
    step_times: deque = deque(maxlen=50)
    optim_times: deque = deque(maxlen=20)
    start_time = last_step_time = last_optim_time = time.time()
    ga = config.GRADIENT_ACCUMULATION_STEPS
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
                diag["optim_step"],
                sum(diag_losses) / max(len(diag_losses), 1),
                diag["lr"], diag["optim_step_time"],
                sum(optim_times) / max(len(optim_times), 1),
                raw_norm, clipped, float(diag["update_norm"]))
            diag_losses.clear()
        eta = ((config.MAX_TRAIN_STEPS - ms)
               * (sum(step_times) / max(len(step_times), 1))
               if step_times else 0)
        reporter.log_step(
            ms - 1, loss=loss_val, timestep=ticket,
            sigma=(float(sigma_dev) if config.is_rectified_flow else None),
            s_per_step=s_per_step, eta=eta,
            elapsed=time.time() - start_time, optim_block=block)

    def save_checkpoint(step):
        stem = output_model_stem(config, config.SINGLE_FILE_CHECKPOINT_PATH)
        save_merged_checkpoint(output_dir / f"{stem}_step_{step}.safetensors",
                               {**frozen, **trainable},
                               config.SINGLE_FILE_CHECKPOINT_PATH,
                               config.compute_dtype)
        print("WARNING: the training-state file is not written: it is not "
              "ported to the PyTorch package yet")

    profiler = StepProfiler.from_env("sdxl")
    for batch in prefetcher:
        if micro_step >= config.MAX_TRAIN_STEPS:
            break
        if not batch:
            continue
        micro_step += 1
        profiler.before_step(micro_step)
        real_n = int(batch.get("real_n", batch["latents"].shape[0]))
        tickets = ts_sampler.sample(real_n)
        ticket0 = int(tickets[0])
        keep = 0.0 if (micro_step - 1) % ga == 0 else 1.0
        loss_dev, sigma_dev = micro_fn(
            trainable, frozen, batch["latents"], batch["embeds"],
            batch["pooled"], batch["time_ids"],
            torch.as_tensor(np.asarray(tickets), device=device),
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
                save_checkpoint(optimizer_step)

        message = profiler.after_step(micro_step)
        if message:
            reporter.log_message(message)

        # report the *previous* step so the host never waits on this one
        now = time.time()
        step_times.append(now - last_step_time)
        last_step_time = now
        if pending is not None:
            emit(pending, step_times[-1])
        pending = (micro_step, loss_dev, sigma_dev, ticket0, diag)

    if pending is not None:
        emit(pending, step_times[-1] if step_times else 0.0)
    reporter.log_message("\nTraining complete.")
    reporter.shutdown()

    stem = output_model_stem(config, config.SINGLE_FILE_CHECKPOINT_PATH)
    save_merged_checkpoint(
        output_dir / f"{stem}.safetensors", {**frozen, **trainable},
        config.SINGLE_FILE_CHECKPOINT_PATH, config.compute_dtype)
    print("All tasks complete. Final model saved.")
