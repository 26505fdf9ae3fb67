"""SDXL training loop on one CUDA device, or on the dp ranks of a torchrun
world.

Counterpart of ``aozora_sdxl_training_tpu/train/trainer.py::
run_sdxl_training`` with the same phases and the same output: resume
(training-state file, counters, sampler state) -> cache check and
(re)build -> model load -> dataset, ticket sampler and schedule -> micro
and apply steps -> progress lines and optimizer blocks -> scheduled /
``force_save.flag`` saves (model + training state) and preview PNGs ->
final merged save. The training-state file is the JAX package's: a run
resumes from either package's files.

Before the weights load, ``train/memory_policy.py`` plans the run for the
card's memory as the JAX package plans it for the TPU's: the master
weights' dtype (fp32, or bf16 under ``MASTER_DTYPE`` bfloat16 or a tight
budget), the accumulator (``.grad`` in the masters' dtype; at GA 1, the
plan's fused step, each gradient is freed once its tensor is updated), the
moments' dtype (downgraded to int8 blockwise when
the requested one does not fit), the attention route and the remat mode
(``AOZORA_SDXL_REMAT`` pins it: off, full, dots, dots_no_batch,
dots_no_logits and the ``_hires`` tiers). The step runs eagerly. The plan's
two low-memory rungs at GA 1 take their own steps, as in JAX: ``two_pass``
the two-pass step (``train_step.make_two_pass_step``: no gradient tree),
``moments_host`` the fused step with the moments in pinned host memory,
streamed through a 0.5 GB window on the card (``opt/adamw.HostMoments``).
``AOZORA_LOWMEM_RUNG`` forces either at GA 1; on an H100 at 1024px and
batch 1 no plan reaches them on its own.

Under torchrun (``WORLD_SIZE`` > 1; the CLI starts the process group) the
ranks form the JAX trainer's data-parallel mesh (``parallel/sharding.py``):
``BATCH_SIZE`` is per rank, every rank draws the same global batch
(padded to ``BATCH_SIZE`` x dp), the same tickets and the same
step-keyed noise, and trains its own rows of them; the loss printed is the
global batch's. The state is sharded as the JAX package's FSDP shards it
(``parallel/sharding.FSDP``): every tensor of 2^16 elements or more whose
shape dp divides, trainable and frozen, with its gradient accumulator and
moments; a micro step gathers each such tensor's compute copy once (bf16
where it has two or more dimensions), reduce-scatters its gradient and
frees the copy, and the apply step updates each rank's shards. The memory
plan is one rank's (``dp_shard``; tp does not enter it, as in JAX). Only
global rank 0 prints, saves and renders previews; a save or a preview
gathers on every rank, on rank 0's word. The low-memory rungs run on one
device only: the ranks take the fused step, as the JAX trainer's do.

With ``TENSOR_PARALLEL_SIZE`` > 1 the ranks form the JAX trainer's dp x tp
mesh: the tp ranks of one dp index train on the same rows, noise and
timesteps, each holding its tp slice of the tensors the JAX package's
``tp_param_spec`` splits (with their accumulators and moments), and the
UNet's attention and GEGLU run as Megatron column and row splits
(``parallel/tensor_parallel.py``); the printed loss is averaged over the
dp group. Saves and previews gather the slices into the JAX layout.

Not ported yet, and refused with an error when the plan asks for them:
per-use gathers under FSDP (a plan whose ``gather_once`` is False).
``AOZORA_PROFILE_DIR`` traces micro steps 3-8 (``train/profiling.py``).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..ckpt.sd_checkpoint import (detect_unet_io_channels, load_sd_tensors,
                                  save_merged_checkpoint)
from ..ckpt.train_state import (check_resume_global_batch, load_train_state,
                                 output_model_stem, save_train_state)
from ..core.platform import resolve_device
from ..data.cache_builder import check_if_caching_needed, precompute_and_cache
from ..data.dataset import (BatchPrefetcher, CachedLatentDataset,
                            pack_sample_schedule, pad_batch_arrays)
from ..data.schedule import TimestepTicketSampler, build_image_batch_schedule
from ..models.sdxl.arch import SDXL_BASE, UNetConfig, param_shapes
from ..models.sdxl import vae as vae_mod
from ..models.sdxl.conversion import (from_jax_layout, params_from_sd_state,
                                      to_jax_layout)
from ..opt import adamw
from ..parallel import sharding as shard
from . import curves, memory_policy, objectives
from .profiling import StepProfiler
from .reporter import MetricsReporter, optimizer_block
from .sampler import PreviewRenderer
from .train_step import (TrainStepConfig, make_apply_step, make_loss_fn,
                         make_micro_step, make_two_pass_step, split_trainable)

# bytes of the card's staging window for host moments (the memory plan
# counts 0.5 GB for it: ``memory_policy.state_bytes``)
HOST_MOMENT_WINDOW = int(0.5 * memory_policy.GB)


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
                            initial_lr: float, device, moments_host: bool = False,
                            n_devices: int = 1, layout: adamw.Layout = adamw.SAME_LAYOUT) -> None:
    """``n_devices`` > 1: the moments are sharded over the world's ranks
    (FSDP); ``layout.elements`` counts a shard's whole tensor."""
    names = {"raven": "RavenAdamW", "titan": "TitanAdamW",
             "paged_adamw_8bit": "PagedAdamW8bit"}
    key = str(config.OPTIMIZER_TYPE).lower()
    n_tensors = len(trainable)
    sizes = {n: layout.elements(n, p) for n, p in trainable.items()}
    n_elements = sum(sizes.values())
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
    where = ((("pinned " if device.type == "cuda" else "") + "host memory")
             if moments_host else device.type)
    sharded = f", sharded over {n_devices} device(s) (ZeRO)" if n_devices > 1 else ""
    print(f"  - Momentum state:      {where} {dtype_name}{sharded}")
    if opt_cfg.int8_state:
        n_exempt = sum(1 for n in sizes.values() if n < opt_cfg.min_8bit_size)
        print(f"  - Min 8-bit size:      {opt_cfg.min_8bit_size} "
              f"({n_exempt} small tensor(s) keep fp32 state)")
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
    """Explicit rematerialization override for the SDXL UNet, or None when
    unset (the memory planner then picks the fastest mode that fits):
    AOZORA_SDXL_REMAT={full,dots,dots_no_batch,dots_no_logits,
    dots_no_logits_hires,full_hires,off} pins the mode
    (``models/sdxl/unet.unit_remat``), as in the JAX package: off is False,
    any other value full remat (True)."""
    mode = os.environ.get("AOZORA_SDXL_REMAT", "").strip().lower()
    if not mode or mode == "auto":
        return None
    if mode in ("off", "none", "0", "false"):
        return False
    if mode in ("dots", "dots_no_batch", "dots_no_logits",
                "dots_no_logits_hires", "full_hires"):
        return mode
    return True


def attention_impl(config, device: torch.device) -> str:
    """The reference's sdpa/cudnn/xformers switch: on CUDA every option maps
    to the flash kernels (long-KV self-attention); "xla"/"einsum" and the
    CPU take the einsum path."""
    pref = str(getattr(config, "MEMORY_EFFICIENT_ATTENTION", "sdpa")).lower()
    if pref in ("xla", "einsum") or device.type != "cuda":
        return "xla"
    return "flash"


def refuse_per_use_gathers(plan, fsdp) -> None:
    """The JAX package's per-use gathers (a plan with ``gather_once``
    False: no resident compute copies) are not ported: refused by name."""
    if fsdp is not None and fsdp.specs and not plan.gather_once:
        raise NotImplementedError(
            "the memory plan asks for per-use FSDP gathers (gather_once False): "
            "not ported to the PyTorch package yet; lower BATCH_SIZE or the "
            "bucket resolution so that gather-once fits")


def gathered(fsdp, params: dict, dtype=None, kind: str = "save") -> dict:
    """Every tensor of ``params`` whole: the sharded ones gathered (in
    ``dtype``; by default the compute copies' dtypes) on every rank, for a
    save or a preview that global rank 0 alone then makes."""
    return params if fsdp is None else fsdp.compute_copies(params, dtype, kind)


def run_sdxl_training(config, *, unet_cfg: UNetConfig | None = None,
                      device: torch.device | None = None) -> None:
    """``unet_cfg`` overrides checkpoint-shape detection (tiny test models);
    ``device`` defaults to ``core.platform.resolve_device()``. Under
    torchrun the CLI silences the stdout of every rank but global rank 0."""
    device = resolve_device() if device is None else torch.device(device)
    is_main = shard.global_rank() == 0
    output_dir = Path(config.OUTPUT_DIR)
    output_dir.mkdir(parents=True, exist_ok=True)
    flag_path = force_save_flag_path()

    mode_str = ("RECTIFIED FLOW" if config.is_rectified_flow
                else f"STANDARD SDXL ({config.PREDICTION_TYPE})")

    # ---- resume ----
    micro_step = optimizer_step = 0
    resume_meta, resume_opt_state = None, None
    model_to_load = Path(config.SINGLE_FILE_CHECKPOINT_PATH)
    initial_sampler_seed = config.SEED
    initial_ts_state = None
    layout = adamw.Layout(to_jax_layout, from_jax_layout)
    if config.RESUME_TRAINING:
        print("\n" + "=" * 50 + "\n--- RESUMING TRAINING SESSION ---\n")
        resume_meta, resume_opt_state = load_train_state(config.RESUME_STATE_PATH,
                                                         layout)
        global_step = int(resume_meta.get("global_step", 0))
        micro_step = int(resume_meta.get(
            "micro_step", global_step * config.GRADIENT_ACCUMULATION_STEPS))
        optimizer_step = micro_step // config.GRADIENT_ACCUMULATION_STEPS
        initial_sampler_seed = int(resume_meta.get("sampler_seed", config.SEED))
        initial_ts_state = resume_meta.get("timestep_sampler_state")
        model_to_load = Path(config.RESUME_MODEL_PATH)
    else:
        print("\n" + "=" * 50 + f"\n--- STARTING {mode_str} TRAINING ---\n" + "=" * 50 + "\n")
    print(f"INFO: Noise type: {getattr(config, 'NOISE_MODE', 'normal')}")
    print(f"INFO: Set random seed to {config.SEED}")

    # ---- caching ----
    if check_if_caching_needed(config):
        if shard.world_size() > 1:
            raise RuntimeError(
                "The SDXL cache must be current before a multi-rank run; build it "
                "first: python -m aozora_sdxl_training_tpu_torch.cli.cache_datasets "
                "--config <preset.json>")
        precompute_and_cache(config, device=device)

    # ---- model config ----
    print("\n--- Loading Model ---")
    if unet_cfg is None:
        unet_cfg = unet_config_for_checkpoint(
            model_to_load, sidecar_fallback=config.SINGLE_FILE_CHECKPOINT_PATH)
    print(f"INFO: Detected UNet configuration - in_channels: "
          f"{unet_cfg.in_channels}, out_channels: {unet_cfg.out_channels}")

    # ---- layout (decides the global batch the schedules use) ----
    mesh_layout = shard.resolve_mesh_layout(config)
    global_batch = mesh_layout.global_batch
    if resume_meta is not None:
        check_resume_global_batch(resume_meta, global_batch)
    if mesh_layout.pp > 1:
        # GPipe stages the Anima DiT's blocks (parallel/pipeline.py); the
        # UNet has no stage stack
        raise NotImplementedError(
            "PIPELINE_PARALLEL_SIZE > 1: pipeline parallelism is the Anima DiT "
            "trainer's; the SDXL trainer takes dp ranks")
    mesh = shard.mesh_for(mesh_layout)
    # this rank's rows of each global batch
    rows = (slice(mesh.dp_rank * int(config.BATCH_SIZE),
                  (mesh.dp_rank + 1) * int(config.BATCH_SIZE))
            if mesh is not None else slice(None))

    # ---- schedules ----
    print("\n--- Initializing Dataset ---")
    dataset = CachedLatentDataset(config)
    print_dataset_resolution_sample(dataset)
    ts_sampler = TimestepTicketSampler(config, batch_size=global_batch)
    if initial_ts_state is not None:
        ts_sampler.load_state_dict(initial_ts_state)
    elif config.RESUME_TRAINING and micro_step > 0:
        ts_sampler.set_current_step(micro_step)
    loss_weights = torch.as_tensor(
        curves.timestep_loss_curve_from_config(config, 1000), device=device)
    image_schedule = build_image_batch_schedule(
        dataset.bucket_keys, config.MAX_TRAIN_STEPS, global_batch,
        initial_sampler_seed, ts_sampler.ticket_pool, ts_sampler.bin_ranges,
        bool(getattr(config, "TIMESTEP_FORCE_IMAGE_BIN_SPREAD", False)))
    packed_schedule = pack_sample_schedule(image_schedule, global_batch)
    print(f"INFO: Precomputed image batch schedule for {len(packed_schedule):,} step(s).")

    # ---- memory plan (master/accum/moment dtypes, attn, remat) ----
    opt_cfg = make_optimizer_config(config)
    sizes = {n: int(np.prod(shape)) for n, (shape, _) in param_shapes(unet_cfg).items()}
    t_sizes, _ = split_trainable(sizes, config.UNET_EXCLUDE_TARGETS)
    trainable_elems = sum(t_sizes.values())
    max_latpix = max(((w // 8) * (h // 8) for (w, h) in dataset.bucket_keys),
                     default=128 * 128)
    plan = memory_policy.plan_sdxl_training(
        trainable_elems=trainable_elems,
        frozen_elems=sum(sizes.values()) - trainable_elems,
        batch_per_device=int(config.BATCH_SIZE),
        max_latent_pixels=int(max_latpix),
        ga_steps=int(config.GRADIENT_ACCUMULATION_STEPS),
        dp_shard=(mesh_layout.dp if mesh_layout.use_mesh else 1),
        attn_pref=attention_impl(config, device),
        requested_moment_dtype=opt_cfg.momentum_dtype,
        budget_bytes=memory_policy.device_budget_bytes(device),
        remat_override=sdxl_remat_mode(),
        master_override=str(getattr(config, "MASTER_DTYPE", "auto")))
    print(f"INFO: Device {device}")
    print(memory_policy.describe_plan(plan))
    # the low-memory rungs run on one device only, as in JAX: the ranks of
    # a torchrun world take the fused step with the moments on the card
    two_pass = plan.two_pass and mesh is None
    moments_host = plan.moments_host and mesh is None
    if mesh is not None and (plan.two_pass or plan.moments_host):
        print("INFO: the low-memory rung runs on one device only; the "
              f"{shard.world_size()} ranks take the fused step")
    # the port reads AOZORA_FLASH_MIN_KV of the three knobs (a user's pin wins)
    memory_policy.apply_fast_backward_knobs(plan)
    if plan.moment_dtype != opt_cfg.momentum_dtype:
        print("WARNING: moment storage downgraded to int8_blockwise to fit "
              "the HBM budget (update math is unchanged — fp32 scratch).")
        opt_cfg = replace(opt_cfg, momentum_dtype=plan.moment_dtype)

    # ---- model weights ----
    sd_tensors = load_sd_tensors(model_to_load)
    params = params_from_sd_state(sd_tensors, unet_cfg, dtype=plan.master_dtype,
                                  device=device)
    # preview sampling: keep the VAE decoder half when
    # PREVIEW_EVERY_N_STEPS > 0 (train/sampler.py); global rank 0 alone
    # renders
    vae_decoder_params = None
    if is_main and int(getattr(config, "PREVIEW_EVERY_N_STEPS", 0) or 0) > 0:
        try:
            vae_decoder_params = vae_mod.params_from_sd_state(
                sd_tensors, dtype=torch.float32, include_decoder=True,
                device=device)
        except ValueError as e:
            print(f"WARNING: preview sampling disabled: {e}")
    del sd_tensors
    trainable, frozen = split_trainable(params, config.UNET_EXCLUDE_TARGETS)
    del params
    for p in trainable.values():
        p.requires_grad_(True)
    print_param_stats(trainable, frozen)
    fsdp = None
    if mesh is not None:
        fsdp = shard.FSDP(mesh, {n: tuple(p.shape) for n, p in {**trainable, **frozen}.items()},
                          layout, config.compute_dtype)
        refuse_per_use_gathers(plan, fsdp)
        fsdp.shard_params(trainable)
        fsdp.shard_params(frozen)
    opt_layout = fsdp.opt_layout() if fsdp is not None else layout

    # ---- optimizer / steps ----
    lr_curve = curves.LRCurve(config.LR_CUSTOM_CURVE, config.MAX_TRAIN_STEPS,
                              fallback_lr=getattr(config, 'LEARNING_RATE', None))
    step_cfg = TrainStepConfig(
        unet=unet_cfg,
        prediction_type=config.PREDICTION_TYPE,
        grad_accum_steps=config.GRADIENT_ACCUMULATION_STEPS,
        clip_grad_norm=float(config.CLIP_GRAD_NORM),
        attn_impl=plan.attn_impl,
        compute_dtype=config.compute_dtype,
        remat=plan.remat,
        remat_thresholds=plan.remat_thresholds,
        tp=fsdp.tp_config if fsdp is not None else None)
    preview = PreviewRenderer(config, unet_cfg, attn_impl=plan.attn_impl,
                              compute_dtype=step_cfg.compute_dtype,
                              decoder_params=vae_decoder_params)
    if preview.enabled:
        print(f"INFO: preview sampling every {preview.every} optimizer "
              f"step(s) ({getattr(config, 'PREVIEW_SAMPLE_STEPS', 20)} "
              f"DDIM/Euler steps)")
    # the accumulator is .grad, in the masters' dtype: the plan's accum dtype
    # (fp32 with fp32 masters, bf16 with bf16 masters). At GA 1 (the plan's
    # fused_apply) a micro step then the apply step is the JAX fused step:
    # .grad is the only gradient tree, and each is freed once its tensor is
    # updated
    micro_fn = make_micro_step(step_cfg, fsdp)
    apply_fn = make_apply_step(step_cfg, opt_cfg, fsdp)
    # the two-pass rung: one step in place of the micro and apply steps
    two_pass_fn = (make_two_pass_step(make_loss_fn(step_cfg), opt_cfg,
                                      step_cfg.clip_grad_norm)
                   if two_pass else None)
    host_window = HOST_MOMENT_WINDOW if moments_host else None
    # restore or start fresh before any moment is on the device: the
    # restored moments are host tensors, and a zero state made first would
    # sit beside them
    opt_state = None
    if resume_opt_state is not None:
        # moments of tensors that are not trainable now are left out
        if set(trainable) <= set(resume_opt_state.exp_avg):
            if fsdp is not None:
                resume_opt_state = fsdp.shard_state(resume_opt_state)
            opt_state = adamw.restored_state(resume_opt_state, trainable, opt_cfg,
                                             host_window=host_window)
            print("INFO: Restored optimizer state from resume checkpoint.")
        else:
            print("WARNING: Resume optimizer state does not match trainable set; "
                  "starting moments fresh.")
    if opt_state is None:
        opt_state = adamw.init_state(trainable, opt_cfg, opt_layout, host_window=host_window)
    del resume_opt_state
    seed = int(config.SEED or 42)
    print_optimizer_summary(config, opt_cfg, trainable, lr_curve.initial_lr,
                            device, moments_host=moments_host,
                            n_devices=(len(mesh_layout.devices)
                                       if fsdp and (fsdp.specs or fsdp.tps) else 1),
                            layout=opt_layout)
    if fsdp is not None and (fsdp.specs or fsdp.tps):
        fsdp.report(trainable, frozen, opt_state)

    # ---- loop ----
    reporter = MetricsReporter(total_steps=config.MAX_TRAIN_STEPS)

    def upload(batch):
        # H2D copies happen in the prefetch thread, overlapping device
        # compute; a dp rank pads the global batch, then takes its rows
        out = pad_batch_arrays(batch, global_batch if mesh is not None else 0)
        # this rank's loss is (its masked sum) / (the global batch's mask
        # count): its mean over its rows times this
        out["loss_scale"] = (max(float(np.sum(out["sample_mask"][rows])), 1.0)
                             / max(float(np.sum(out["sample_mask"])), 1.0))
        for key in ("latents", "embeds", "pooled", "time_ids", "sample_mask"):
            out[key] = torch.as_tensor(out[key][rows], device=device)
        return out

    prefetcher = BatchPrefetcher(dataset, packed_schedule,
                                 start_step=micro_step if config.RESUME_TRAINING else 0,
                                 transform=upload)
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

    def save_model(path):
        # every rank gathers; global rank 0 writes
        full = gathered(fsdp, {**frozen, **trainable}, config.compute_dtype)
        if is_main:
            save_merged_checkpoint(path, full, config.SINGLE_FILE_CHECKPOINT_PATH,
                                   config.compute_dtype)

    def save_checkpoint(step):
        stem = output_model_stem(config, config.SINGLE_FILE_CHECKPOINT_PATH)
        save_model(output_dir / f"{stem}_step_{step}.safetensors")
        if is_main or fsdp is not None:
            save_train_state(
                output_dir / f"{stem}_training_state_step_{step}.safetensors",
                global_step=step, micro_step=micro_step, opt_state=opt_state,
                sampler_seed=initial_sampler_seed, sampler_epoch=0,
                timestep_sampler_state=ts_sampler.state_dict(),
                extra={"schedule_global_batch": global_batch}, fsdp=fsdp)

    profiler = StepProfiler.from_env("sdxl", trace=is_main)
    for batch in prefetcher:
        if micro_step >= config.MAX_TRAIN_STEPS:
            break
        if not batch:
            continue
        micro_step += 1
        profiler.before_step(micro_step)
        real_n = int(batch.get("real_n", batch["latents"].shape[0]))
        preview.capture_conditioning(batch["latents"], batch["embeds"],
                                     batch["pooled"], batch["time_ids"])
        tickets = np.asarray(ts_sampler.sample(real_n))
        ticket0 = int(tickets[0])
        noise = rf_jitter = None
        if mesh is not None:
            # the padded global batch's tickets and step-keyed noise (and
            # rectified flow's jitter), then this rank's rows of each
            tickets = tickets[np.arange(global_batch) % real_n]
            shape = (global_batch, *batch["latents"].shape[1:])
            noise = objectives.noise_for_step(seed, micro_step, shape, device)[rows]
            if config.is_rectified_flow:
                rf_jitter = objectives.rf_jitter_for_step(
                    seed, micro_step, global_batch, device)[rows]
        keep = 0.0 if (micro_step - 1) % ga == 0 else 1.0
        step_inputs = (batch["latents"], batch["embeds"], batch["pooled"],
                       batch["time_ids"],
                       torch.as_tensor(tickets[rows], device=device),
                       batch["sample_mask"], loss_weights, seed, micro_step)
        if two_pass_fn is not None:
            lr = lr_curve.lr_at(micro_step)
            loss_dev, sigma_dev, raw_norm, update_norm = two_pass_fn(
                trainable, frozen, opt_state, *step_inputs, lr=lr)
        else:
            loss_dev, sigma_dev = micro_fn(trainable, frozen, *step_inputs, keep,
                                           noise=noise, rf_jitter=rf_jitter,
                                           loss_scale=batch["loss_scale"])
        if mesh is not None:
            # the global batch's loss: the dp ranks' shares summed
            loss_dev = loss_dev.reshape(1)
            dist.all_reduce(loss_dev, group=mesh.dp_group)
            loss_dev = loss_dev[0]

        diag = None
        if micro_step % ga == 0:
            lr = lr_curve.lr_at(micro_step)
            if two_pass_fn is None:
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
            forced = is_main and consume_force_save_flag(flag_path)
            render = is_main and preview.due(optimizer_step)
            if mesh is not None:
                # the flag file and the preview are rank 0's; the gathers
                # behind a save or a preview are every rank's
                forced, render = shard.rank0_says([forced, render], device)
            if scheduled or forced:
                reason = ("Emergency checkpoint requested"
                          if forced and not scheduled else "Saving checkpoint")
                reporter.log_message(
                    f"\n--- {reason} at optimizer step {optimizer_step} ---")
                save_checkpoint(optimizer_step)
            if render:
                full = gathered(fsdp, {**frozen, **trainable}, kind="preview")
                if is_main:
                    preview.maybe_render(optimizer_step, full, {}, output_dir)
                del full

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
    if fsdp is not None and fsdp.tps:
        print(fsdp.describe_tp_traffic())

    stem = output_model_stem(config, config.SINGLE_FILE_CHECKPOINT_PATH)
    save_model(output_dir / f"{stem}.safetensors")
    print("All tasks complete. Final model saved.")
