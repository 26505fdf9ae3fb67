"""Anima DiT training loop (flow matching) on one CUDA device, or on the
dp x sp or dp x pp ranks of a torchrun world.

Counterpart of ``aozora_sdxl_training_tpu/train/anima_trainer.py::
run_anima_training`` with the same phases and the same output as the port's
SDXL trainer: resume (``ANIMA_RESUME_MODEL_PATH`` and
``ANIMA_RESUME_STATE_PATH``, the JAX package's training-state file) ->
cache check -> DiT load (key prefix detected, config read off the
checkpoint's shapes) -> dataset, ticket sampler and schedule -> micro and
apply steps -> progress lines (Ticket + Sigma) and optimizer blocks ->
scheduled / ``force_save.flag`` saves (DiT + training state) -> final DiT
save under the detected prefix. Tickets map to flow-matching sigmas, the
DiT is conditioned on sigma, loss weights are indexed by ticket, and the
LLM adapter trains inside the DiT forward. In video mode
(``ANIMA_VIDEO_FRAMES`` > 1) the cache holds (T', H, W, C) clip latents and
the DiT takes them whole; ``ANIMA_PREVIEW_EVERY_N_STEPS`` renders a preview
after the optimizer steps it names (``train/anima_sampler.py``: Euler over
the DiT, then the Wan decoder of ``DIT_VAE_PATH`` when the file has one).

Before the DiT moves to the device, ``train/memory_policy.py`` plans the
state for the card's memory as the JAX package does for the TPU: master
and frozen weights in fp32 or bf16 (``MASTER_DTYPE``), the accumulator
(``.grad`` in the masters' dtype; at GA 1, the plan's fused step, a micro
step then the apply step, which frees each gradient once its tensor is
updated), and the moments' dtype (downgraded to int8
blockwise when the requested one does not fit); the trainer prints
``describe_plan``. The step runs eagerly: the micro step accumulates
gradients into ``.grad``, the apply step (shared with the SDXL trainer)
scales them by 1/GA, clips their global norm and runs the Raven AdamW
update. The plan's low-memory rungs at GA 1 run as in the SDXL trainer
(``train/trainer.py``): ``two_pass`` the two-pass step over this trainer's
loss, ``moments_host`` the moments in pinned host memory; as in JAX only
on one device (the dp x sp ranks take the fused step with the moments on
the card). ``ANIMA_GRADIENT_CHECKPOINTING_MODE`` "Full" (the default)
recomputes each block in the backward, "Conservative" keeps the MLP
down-projections and the flash outputs (``models/anima/dit.py``), "Off"
keeps everything.

Under torchrun (``WORLD_SIZE`` > 1; the CLI starts the process group) the
ranks form the JAX package's dp x sp layout (``parallel/sharding.py``):
every rank draws the same tickets and global batches, each dp rank trains
rows [r*B, (r+1)*B) of each global batch, and with
``SEQUENCE_PARALLEL_SIZE`` > 1 the DiT self-attention runs as ring
attention over the sp ranks (``ops/ring_attention.py``). Over dp the state
is sharded as the JAX package's FSDP shards it (``parallel/sharding.FSDP``,
as in the SDXL trainer): each tensor of 2^16 elements or more whose shape
dp divides, with its accumulator and moments, is held in shards over the
dp ranks, gathered once a micro step (bf16 where it has two or more
dimensions) and its gradient reduce-scattered; the replicated tensors'
gradients are summed over the ranks once per optimizer step, before the
global-norm clip, and every rank updates its shards and the replicated
tensors. The loss printed is the global batch's, and only global rank 0
prints and saves (the model and the training state; every rank gathers
for a save or a preview, on rank 0's word); on resume every rank reads the
state and keeps its shards. Under Full remat the ring's P2P runs again in
each block's recompute; every rank recomputes the same blocks in the same
order, which keeps that safe. Video mode runs under sequence parallelism
too: a clip's (T', H, W) latent tokens flatten in the JAX package's order
and shard over sp like an image's.

With ``PIPELINE_PARALLEL_SIZE`` > 1 the ranks form the JAX package's dp x
pp layout instead: the DiT blocks stack into ``__stack__.<suffix>`` leaves
(``parallel/pipeline.py``), each pp rank holding its stage's blocks (and
their accumulators and moments; the int8 decision and blocks taken over
the whole stacked leaf, as JAX takes them), and each dp rank's batch
splits into ``ANIMA_PIPELINE_MICROBATCHES`` (default ``BATCH_SIZE``)
microbatches that stream GPipe-style through the stages; the prologue and
epilogue of the DiT run replicated on every stage. As in JAX there is no
fused step under pp (the micro and apply steps at any GA). Saves and
previews gather the stages and write the reference's flat names; the
training-state file holds the moments under JAX's ``__stack__.`` keys. A
resumed non-pp state is restacked (int8 moments cannot be, and start
afresh, as in JAX), and a state whose keys do not match starts with
fresh moments.

When the cache check fails, the trainer first builds the cache on its
device (``data/anima_cache.py``: the Qwen3 text encoder and the Wan VAE),
then frees the encoders before the DiT loads; a multi-rank run asks for
the cache CLI instead, so that no two ranks write one cache.

The QAT repair trainer (``cli/train_anima_repair.py``) runs this loop
with two additions, as the JAX trainer has them: the line-art loss
(``ANIMA_REPAIR_LINEART_LOSS_ENABLED``: the cache's per-latent
``lineart_mask`` boosts each pixel's error by ``1 + mask *
ANIMA_REPAIR_LINEART_LOSS_STRENGTH``; under sequence parallelism every
rank holds the whole token grid, so the mask goes whole as in JAX), and a
``device_projector`` (``train/qat_project.py``) that projects the
controlled weights onto their quantized grid after every optimizer step,
with error-feedback residuals on the device.

With ``TENSOR_PARALLEL_SIZE`` > 1 the ranks form the JAX package's dp x tp
mesh instead: the tp ranks of one dp index train on the same rows, each
holding its tp slice of the tensors that ``tp_param_spec`` splits (the
blocks' and the LLM adapter's attention and MLP weights, with their
accumulators and moments), and the DiT runs them as Megatron column and
row splits (``parallel/tensor_parallel.py``); the trainable adapter's
output reaches the blocks' cross-attention through the tp "copy", and the
per-head q/k norm scales' partial gradients are summed over tp. Saves and
previews gather the slices into the JAX layout.

Not ported yet, and refused with an error when the plan asks for them:
FSDP's per-use gathers (a plan whose ``gather_once`` is False); the QAT
repair CLI refuses more than one rank.
``AOZORA_PROFILE_DIR`` traces micro steps 3-8 (``train/profiling.py``).
"""

from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..ckpt.anima_checkpoint import (load_dit_state, resolve_save_prefix,
                                     save_dit_model)
from ..ckpt.train_state import (check_resume_global_batch, load_train_state,
                                 output_model_stem, save_train_state)
from ..config.runtime import parse_exclude_targets
from ..core.platform import resolve_device
from ..data.anima_cache import (AnimaLatentDataset, check_if_anima_caching_needed,
                                precompute_and_cache_anima)
from ..data.dataset import BatchPrefetcher, pack_sample_schedule, pad_batch_arrays
from ..data.schedule import TimestepTicketSampler, build_image_batch_schedule
from ..models.anima import dit as dit_mod
from ..ops.ring_attention import SPRingConfig
from ..opt import adamw
from ..parallel import pipeline as pl_mod
from ..parallel import sharding as shard
from . import anima_objectives, curves, memory_policy, objectives
from .anima_sampler import AnimaPreviewRenderer, load_decoder_for_preview
from .profiling import StepProfiler
from .reporter import MetricsReporter, optimizer_block
from .train_step import (accumulate_gradients, make_apply_step, make_two_pass_step,
                         split_trainable)
from .trainer import (HOST_MOMENT_WINDOW, attention_impl, consume_force_save_flag,
                      force_save_flag_path, gathered, make_optimizer_config,
                      print_optimizer_summary, refuse_per_use_gathers)


@dataclass(frozen=True)
class AnimaStepConfig:
    dit: dit_mod.AnimaDiTConfig
    grad_accum_steps: int = 1
    clip_grad_norm: float = 1.0
    attn_impl: str = "xla"
    compute_dtype: Any = torch.bfloat16
    remat: Any = True                      # False | True | "conservative"
    spatial_strength: float = 0.0          # > 0: the line-art-masked loss
    pp: Any = None                         # parallel.pipeline.PPConfig, or None
    tp: Any = None                         # parallel.tensor_parallel.TPConfig, or None


def make_anima_loss_fn(cfg: AnimaStepConfig):
    def loss_fn(trainable, frozen, latents, prompt_emb, t5_ids, tickets,
                sample_mask, loss_weights, seed: int, micro_step: int,
                noise=None, spatial_mask=None):
        """latents (B, H, W, C), or a clip's (B, T, H, W, C) -> (loss, sigma
        of sample 0). ``noise`` defaults to the step-keyed stream of
        ``objectives``; ``spatial_mask`` (B, h, w), the line-art mask, is
        used when ``cfg.spatial_strength`` > 0."""
        sigmas, timesteps = anima_objectives.ticket_to_sigma_timestep(tickets)
        if noise is None:
            noise = objectives.noise_for_step(seed, micro_step, latents.shape,
                                              latents.device)
        noisy, target = anima_objectives.flowmatch_noise_and_target(
            latents, noise, sigmas)
        cd = cfg.compute_dtype
        # image mode: (B, H, W, C) -> (B, T=1, H, W, C); a clip goes straight
        # through
        video = noisy.dim() == 5
        x_in = (noisy if video else noisy[:, None]).to(cd)
        if cfg.pp is not None:
            # pipeline parallelism: the params carry this stage's stacked
            # __stack__.* block leaves; the block stack streams GPipe-style
            # over the pp group
            stacked, rest = pl_mod.split_stacked({**frozen, **trainable})
            pred = pl_mod.pp_dit_forward(
                stacked, rest, x_in, timesteps / 1000.0, prompt_emb.to(cd),
                cfg=cfg.dit, mesh=cfg.pp.mesh, microbatches=cfg.pp.microbatches,
                t5_ids=t5_ids, attn_impl=cfg.attn_impl, compute_dtype=cd,
                remat=cfg.remat)
        else:
            pred = dit_mod.dit_forward(
                {**frozen, **trainable}, x_in, timesteps / 1000.0, prompt_emb.to(cd),
                cfg=cfg.dit, t5_ids=t5_ids, attn_impl=cfg.attn_impl, compute_dtype=cd,
                remat=cfg.remat, tp=cfg.tp)
        pred = pred if video else pred[:, 0]
        weights = loss_weights[torch.clamp(tickets.long(), 0, loss_weights.shape[0] - 1)]
        loss = anima_objectives.weighted_flowmatch_mse(
            pred, target, weights, sample_mask=sample_mask, spatial_mask=spatial_mask,
            spatial_strength=cfg.spatial_strength)
        return loss, sigmas[0]

    return loss_fn


def make_anima_micro_step(cfg: AnimaStepConfig, fsdp=None):
    """micro_step(trainable, frozen, batch..., keep) -> (loss, sigma0),
    accumulating d(loss)/d(trainable) into ``.grad``
    (``train_step.accumulate_gradients``; ``fsdp``: the run's
    ``parallel.sharding.FSDP``, or None)."""
    loss_fn = make_anima_loss_fn(cfg)

    def micro_step(trainable, frozen, latents, prompt_emb, t5_ids, tickets,
                   sample_mask, loss_weights, seed, micro_step_idx,
                   keep: float, noise=None, loss_scale: float = 1.0,
                   spatial_mask=None):
        """``loss_scale`` turns a dp rank's loss into its share of the global
        batch's (1 on one device)."""
        return accumulate_gradients(
            loss_fn, trainable, frozen,
            (latents, prompt_emb, t5_ids, tickets, sample_mask, loss_weights, seed,
             micro_step_idx, noise, spatial_mask), keep, loss_scale, fsdp)

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
    """ANIMA_GRADIENT_CHECKPOINTING_MODE as the JAX trainer maps it: "Off"
    -> False, "Conservative" -> "conservative", anything else (the default
    "Full") -> True."""
    mode = str(getattr(config, "ANIMA_GRADIENT_CHECKPOINTING_MODE", "Full")).title()
    return (False if mode == "Off"
            else "conservative" if mode == "Conservative" else True)


def _restacked(moments: dict, num_blocks: int) -> dict:
    """A flat state's moments with the blocks' stacked (``stackify_params``);
    int8 (codes, scales) pairs do not stack: ValueError."""
    if any(isinstance(v, tuple) for k, v in moments.items() if pl_mod.BLOCK_RE.match(k)):
        raise ValueError("int8 (codes, scales) moments cannot be stacked")
    return pl_mod.stackify_params(moments, num_blocks)


def run_anima_training(config, *, device: torch.device | None = None,
                       device_projector=None,
                       dit_state: tuple[dict, str] | None = None) -> dict:
    """Returns {"trainable": ..., "qat_residuals": ...}: the trained
    parameters and the projector's residuals (None without one), on the
    device in the torch layout.

    ``device`` defaults to ``core.platform.resolve_device()``. Under
    torchrun the CLI silences the stdout of every rank but global rank 0,
    so the GUI reads one set of lines.

    ``device_projector``: an ``(init_residuals, project)`` pair from
    ``train.qat_project.make_device_projector``. The residuals are made
    once the trainable parameters are on the device, and ``project`` runs
    right after every optimizer step's update, before the save, the
    preview and the optimizer block (the QAT repair path).

    ``dit_state``: (torch-layout state, key prefix), trained instead of
    ``DIT_PATH``'s tensors (the repair CLI's dequantized weights); a resumed
    run still loads ``ANIMA_RESUME_MODEL_PATH``."""
    device = resolve_device() if device is None else torch.device(device)
    if device_projector is not None and int(getattr(config, "PIPELINE_PARALLEL_SIZE", 1)
                                            or 1) > 1:
        # the projector's format map is keyed by flat tensor names
        raise SystemExit("PIPELINE_PARALLEL_SIZE is not supported by the QAT repair "
                         "trainer (flat-name projector)")
    is_main = shard.global_rank() == 0
    remat = anima_remat_mode(config)
    output_dir = Path(config.OUTPUT_DIR)
    output_dir.mkdir(parents=True, exist_ok=True)
    flag_path = force_save_flag_path()
    print("\n" + "=" * 50 + "\n--- STARTING ANIMA DIT TRAINING (flow matching) ---\n"
          + "=" * 50 + "\n")
    print(f"INFO: Set random seed to {config.SEED}")

    # ---- resume ----
    micro_step = optimizer_step = 0
    resume_meta, resume_opt_state = None, None
    model_to_load = config.DIT_PATH
    initial_sampler_seed = config.SEED
    initial_ts_state = None
    dit_layout = adamw.Layout(dit_mod.to_jax_layout, dit_mod.from_jax_layout)
    if config.RESUME_TRAINING:
        print("--- RESUMING TRAINING SESSION ---")
        resume_meta, resume_opt_state = load_train_state(
            config.ANIMA_RESUME_STATE_PATH, dit_layout)
        global_step = int(resume_meta.get("global_step", 0))
        micro_step = int(resume_meta.get(
            "micro_step", global_step * config.GRADIENT_ACCUMULATION_STEPS))
        optimizer_step = micro_step // config.GRADIENT_ACCUMULATION_STEPS
        initial_sampler_seed = int(resume_meta.get("sampler_seed", config.SEED))
        initial_ts_state = resume_meta.get("timestep_sampler_state")
        model_to_load = config.ANIMA_RESUME_MODEL_PATH

    # ---- caching ----
    if check_if_anima_caching_needed(config):
        if shard.world_size() > 1:
            raise RuntimeError(
                "The Anima cache must be current before a multi-rank run; build "
                "it first: python -m aozora_sdxl_training_tpu_torch.cli."
                "cache_datasets --config <preset.json>")
        precompute_and_cache_anima(config, device=device)
        # the encoders went with the call; hand their blocks back before the
        # DiT loads, so the run's peak stays the DiT's
        gc.collect()
        torch.cuda.empty_cache()

    # ---- model ----
    print("\n--- Loading Anima DiT ---")
    if dit_state is not None and not config.RESUME_TRAINING:
        state, detected_prefix = dit_state
    else:
        state, detected_prefix = load_dit_state(model_to_load)
    dit_cfg = _dit_config_for_state(state)
    save_prefix = resolve_save_prefix(config, detected_prefix)
    print(f"INFO: DiT key prefix: detected='{detected_prefix}' save='{save_prefix}'")
    exclude = parse_exclude_targets(getattr(config, "DIT_EXCLUDE_TARGETS", ""))

    # ---- layout (decides the global batch the schedules use) ----
    layout = shard.resolve_mesh_layout(config)
    global_batch = layout.global_batch
    if resume_meta is not None:
        check_resume_global_batch(resume_meta, global_batch)
    mesh = shard.mesh_for(layout)
    # this rank's rows of each global batch
    rows = (slice(mesh.dp_rank * int(config.BATCH_SIZE),
                  (mesh.dp_rank + 1) * int(config.BATCH_SIZE))
            if mesh is not None else slice(None))

    # ---- schedules ----
    dataset = AnimaLatentDataset(config)
    ts_sampler = TimestepTicketSampler(config, batch_size=global_batch)
    if initial_ts_state is not None:
        ts_sampler.load_state_dict(initial_ts_state)
    elif config.RESUME_TRAINING and micro_step > 0:
        ts_sampler.set_current_step(micro_step)
    loss_weights = torch.as_tensor(
        curves.timestep_loss_curve_from_config(config, 1000), device=device)
    schedule = build_image_batch_schedule(
        dataset.bucket_keys, config.MAX_TRAIN_STEPS, global_batch,
        initial_sampler_seed, ts_sampler.ticket_pool, ts_sampler.bin_ranges,
        bool(getattr(config, "TIMESTEP_FORCE_IMAGE_BIN_SPREAD", False)))
    packed = pack_sample_schedule(schedule, global_batch)
    print(f"INFO: Precomputed batch schedule for {len(packed):,} step(s).")

    opt_cfg = make_optimizer_config(config)
    lr_curve = curves.LRCurve(config.LR_CUSTOM_CURVE, config.MAX_TRAIN_STEPS,
                              fallback_lr=getattr(config, 'LEARNING_RATE', None))
    attn_impl = attention_impl(config, device)
    print(f"INFO: Device {device}; attention {attn_impl}")

    # ---- memory plan: sized from the checkpoint's shapes before any
    # tensor reaches the device; one rank's share under FSDP ----
    t_sizes, f_sizes = split_trainable(
        {k: int(np.prod(np.shape(v))) for k, v in state.items()}, exclude)
    ps = max(int(dit_cfg.patch_spatial), 1)
    max_tokens = max(((w // 8 // ps) * (h // 8 // ps) for (w, h) in dataset.bucket_keys),
                     default=64 * 64)
    clip_frames = int(getattr(config, "ANIMA_VIDEO_FRAMES", 0) or 0)
    if clip_frames > 1:           # a clip's latent frames: 1 + (T - 1) // 4
        max_tokens *= 1 + (clip_frames - 1) // 4
    plan = memory_policy.plan_anima_training(
        trainable_elems=sum(t_sizes.values()), frozen_elems=sum(f_sizes.values()),
        batch_per_device=int(config.BATCH_SIZE), tokens=int(max_tokens),
        ga_steps=int(config.GRADIENT_ACCUMULATION_STEPS), remat=remat,
        dp_shard=(layout.dp if layout.use_mesh else 1),
        requested_moment_dtype=opt_cfg.momentum_dtype,
        budget_bytes=memory_policy.device_budget_bytes(device),
        master_override=str(getattr(config, "MASTER_DTYPE", "auto")))
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
    base_attn_impl = attn_impl
    if mesh is not None and layout.sp > 1:
        # the training step's attn_impl becomes an SPRingConfig (dit.py
        # dispatches on it)
        attn_impl = SPRingConfig(group=mesh.sp_group, axis_size=layout.sp,
                                 base_impl=attn_impl)
        print(f"INFO: Sequence parallelism: DiT self-attention tokens shard "
              f"over sp={layout.sp} (ring flash attention, KV hops the ring "
              f"over torch.distributed).")
    # pipeline parallelism (PIPELINE_PARALLEL_SIZE > 1): the block params
    # stage-stack into __stack__ leaves, each rank holding its stage's;
    # microbatches stream GPipe-style (parallel/pipeline.py)
    pp_cfg = None
    if mesh is not None and layout.pp > 1:
        if dit_cfg.num_blocks % layout.pp:
            raise SystemExit(
                f"PIPELINE_PARALLEL_SIZE={layout.pp} does not divide "
                f"num_blocks={dit_cfg.num_blocks}")
        micro_m = int(getattr(config, "ANIMA_PIPELINE_MICROBATCHES", 0)
                      or 0) or int(config.BATCH_SIZE)
        if int(config.BATCH_SIZE) % micro_m:
            raise SystemExit(
                f"ANIMA_PIPELINE_MICROBATCHES={micro_m} does not divide "
                f"BATCH_SIZE={config.BATCH_SIZE}")
        pp_cfg = pl_mod.PPConfig(mesh, micro_m)

    # ---- weights ----
    # under pp the blocks stack on the host, and only this stage's slices
    # reach the device
    params = dit_mod.params_from_torch_state(
        state, dit_cfg, dtype=plan.master_dtype,
        device="cpu" if pp_cfg is not None else device)
    del state
    # the reference's freeze rule (the JAX package's split_trainable_dit)
    trainable, frozen = split_trainable(params, exclude)
    del params
    if pp_cfg is not None:
        trainable = pl_mod.stackify_params(trainable, dit_cfg.num_blocks)
        frozen = pl_mod.stackify_params(frozen, dit_cfg.num_blocks)
        print(f"INFO: Pipeline parallelism: {dit_cfg.num_blocks} DiT blocks "
              f"in {layout.pp} GPipe stages x {pp_cfg.microbatches} microbatch(es) "
              f"per dp shard (dp={layout.dp}).")
    for p in trainable.values():
        p.requires_grad_(True)
    n_t = sum(p.numel() for p in trainable.values())
    n_f = sum(p.numel() for p in frozen.values())
    print(f"INFO: DiT Parameters: total={n_t + n_f:,} trainable={n_t:,} "
          f"frozen={n_f:,}")
    fsdp = None
    if mesh is not None:
        fsdp = shard.FSDP(mesh, {n: tuple(p.shape) for n, p in {**trainable, **frozen}.items()},
                          dit_layout, config.compute_dtype)
        refuse_per_use_gathers(plan, fsdp)
        fsdp.shard_params(trainable)
        fsdp.shard_params(frozen)
    if pp_cfg is not None:
        for group in (trainable, frozen):
            for name, p in group.items():
                group[name] = p.detach().to(device).requires_grad_(p.requires_grad)
    opt_layout = fsdp.opt_layout() if fsdp is not None else dit_layout
    lineart = bool(getattr(config, "ANIMA_REPAIR_LINEART_LOSS_ENABLED", False))
    lineart_strength = max(0.0, float(getattr(
        config, "ANIMA_REPAIR_LINEART_LOSS_STRENGTH", 0.5)))
    if lineart:
        print(f"INFO: Cached line-art loss: enabled=True, "
              f"max_weight={1.0 + lineart_strength:g}x")

    step_cfg = AnimaStepConfig(
        dit=dit_cfg, grad_accum_steps=config.GRADIENT_ACCUMULATION_STEPS,
        clip_grad_norm=float(config.CLIP_GRAD_NORM), attn_impl=attn_impl,
        compute_dtype=config.compute_dtype, remat=remat,
        spatial_strength=lineart_strength if lineart else 0.0, pp=pp_cfg,
        tp=fsdp.tp_config if fsdp is not None else None)
    micro_fn = make_anima_micro_step(step_cfg, fsdp)
    apply_fn = make_apply_step(step_cfg, opt_cfg, fsdp)
    # the two-pass rung: one step in place of the micro and apply steps
    two_pass_fn = (make_two_pass_step(make_anima_loss_fn(step_cfg), opt_cfg,
                                      step_cfg.clip_grad_norm)
                   if two_pass else None)
    host_window = HOST_MOMENT_WINDOW if moments_host else None
    if resume_opt_state is not None and pp_cfg is not None \
            and set(resume_opt_state.exp_avg) != set(trainable):
        # resume state saved by a run without pipeline parallelism: restack
        # its moments into the __stack__ namespace (float moments only: the
        # int8 (codes, scales) pairs do not stack)
        try:
            resume_opt_state = adamw.AdamWState(
                step=resume_opt_state.step, layout=resume_opt_state.layout,
                exp_avg=_restacked(resume_opt_state.exp_avg, dit_cfg.num_blocks),
                exp_avg_sq=_restacked(resume_opt_state.exp_avg_sq, dit_cfg.num_blocks))
            print("INFO: Restacked resumed optimizer state for pipeline "
                  "parallelism.")
        except ValueError as e:
            print(f"WARNING: could not restack resumed optimizer state for "
                  f"pipeline parallelism ({e}); starting with fresh moments.")
    # the restored moments are host tensors: they reach the device (or
    # pinned host memory) once, and no zero state is made beside them
    if resume_opt_state is not None and set(trainable) <= set(resume_opt_state.exp_avg):
        if fsdp is not None:
            resume_opt_state = fsdp.shard_state(resume_opt_state)
        opt_state = adamw.restored_state(resume_opt_state, trainable, opt_cfg,
                                         host_window=host_window)
        print("INFO: Restored optimizer state from resume checkpoint.")
    else:
        if resume_opt_state is not None:
            print("WARNING: resumed optimizer state keys do not match the "
                  "trainable set; starting with fresh moments.")
        opt_state = adamw.init_state(trainable, opt_cfg, opt_layout,
                                     host_window=host_window)
    del resume_opt_state
    qat_residuals, project = None, None
    if device_projector is not None:
        init_residuals, project = device_projector
        qat_residuals = init_residuals(trainable)
        print(f"INFO: on-device QAT projection active on {len(qat_residuals)} "
              "tensor(s) (residuals on the device, no host round trip)")
    seed = int(config.SEED or 42)
    print_optimizer_summary(config, opt_cfg, trainable, lr_curve.initial_lr,
                            device, moments_host=moments_host,
                            n_devices=(len(layout.devices)
                                       if fsdp and (fsdp.specs or fsdp.stages or fsdp.tps)
                                       else 1),
                            layout=opt_layout)
    if fsdp is not None and (fsdp.specs or fsdp.stages or fsdp.tps):
        fsdp.report(trainable, frozen, opt_state)

    def flat_view(params):
        """Saves and previews: stacked block leaves back to the reference's
        flat names (as they are without pipeline parallelism)."""
        return (pl_mod.unstackify_params(params, dit_cfg.num_blocks)
                if pp_cfg is not None else params)

    # previews take the single-device attention (not the SP ring); global
    # rank 0 alone renders them
    preview_decoder = None
    if is_main and int(getattr(config, "ANIMA_PREVIEW_EVERY_N_STEPS", 0) or 0) > 0:
        preview_decoder = load_decoder_for_preview(config, device=device)
    preview = AnimaPreviewRenderer(config, dit_cfg, attn_impl=base_attn_impl,
                                   compute_dtype=config.compute_dtype,
                                   decoder=preview_decoder)
    if preview.enabled:
        kind = "decoded pixels" if preview_decoder else "latent-RGB"
        print(f"INFO: preview sampling ({kind}) every {preview.every} "
              f"optimizer step(s)")

    # ---- loop ----
    reporter = MetricsReporter(total_steps=config.MAX_TRAIN_STEPS)

    def upload(batch):
        # H2D copies happen in the prefetch thread, overlapping device
        # compute; a dp rank pads the global batch, then takes its rows
        out = pad_batch_arrays(batch, global_batch if mesh is not None else 0)
        lat = out["latents"]
        if lat.ndim == 4 and lat.shape[1] == dit_cfg.in_channels \
                and lat.shape[1] < lat.shape[-1]:
            out["latents"] = np.transpose(lat, (0, 2, 3, 1))  # NCHW cache -> NHWC
        # this rank's loss is (its masked sum) / (the global batch's mask
        # count): its mean over its rows times this
        out["loss_scale"] = (max(float(np.sum(out["sample_mask"][rows])), 1.0)
                             / max(float(np.sum(out["sample_mask"])), 1.0))
        keys = ("latents", "prompt_emb", "t5xxl_ids", "sample_mask") + (
            ("lineart_mask",) if lineart and "lineart_mask" in out else ())
        for key in keys:
            out[key] = torch.as_tensor(out[key][rows], device=device)
        return out

    prefetcher = BatchPrefetcher(dataset, packed,
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
        # every rank gathers; global rank 0 writes
        full = flat_view(gathered(fsdp, {**frozen, **trainable}, config.compute_dtype))
        if is_main:
            save_dit_model(path, full, prefix=save_prefix, dtype=config.compute_dtype)

    def save_checkpoint(step):
        stem = output_model_stem(config, config.DIT_PATH)
        save_model(output_dir / f"{stem}_step_{step}.safetensors")
        if is_main or fsdp is not None:
            save_train_state(
                output_dir / f"{stem}_training_state_step_{step}.safetensors",
                global_step=step, micro_step=micro_step, opt_state=opt_state,
                sampler_seed=initial_sampler_seed, sampler_epoch=0,
                timestep_sampler_state=ts_sampler.state_dict(),
                extra={"schedule_global_batch": global_batch}, fsdp=fsdp)

    profiler = StepProfiler.from_env("anima", trace=is_main)
    for batch in prefetcher:
        if micro_step >= config.MAX_TRAIN_STEPS:
            break
        if not batch:
            continue
        micro_step += 1
        profiler.before_step(micro_step)
        real_n = int(batch["real_n"])
        tickets = np.asarray(ts_sampler.sample(real_n))
        noise = None
        if mesh is not None:
            # the padded global batch's tickets and step-keyed noise, then
            # this rank's rows of both
            tickets = tickets[np.arange(global_batch) % real_n]
            lat = batch["latents"]
            noise = objectives.noise_for_step(
                seed, micro_step, (global_batch, *lat.shape[1:]), device)[rows]
        keep = 0.0 if (micro_step - 1) % ga == 0 else 1.0
        preview.capture_conditioning(batch["latents"], batch["prompt_emb"],
                                     batch["t5xxl_ids"])
        step_inputs = (batch["latents"], batch["prompt_emb"], batch["t5xxl_ids"],
                       torch.as_tensor(tickets[rows], device=device),
                       batch["sample_mask"], loss_weights, seed, micro_step)
        if two_pass_fn is not None:
            lr = lr_curve.lr_at(micro_step)
            loss_dev, sigma_dev, raw_norm, update_norm = two_pass_fn(
                trainable, frozen, opt_state, *step_inputs, lr=lr, noise=noise,
                spatial_mask=batch.get("lineart_mask"))
        else:
            loss_dev, sigma_dev = micro_fn(trainable, frozen, *step_inputs, keep,
                                           noise=noise, loss_scale=batch["loss_scale"],
                                           spatial_mask=batch.get("lineart_mask"))
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
            if project is not None:
                project(trainable, qat_residuals)
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
                full = flat_view(gathered(fsdp, {**frozen, **trainable}, kind="preview"))
                if is_main:
                    preview.maybe_render(optimizer_step, full, output_dir)
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
        pending = (micro_step, loss_dev, sigma_dev, int(tickets[0]), diag)

    if pending is not None:
        emit(pending, step_times[-1] if step_times else 0.0)
    reporter.log_message("\nTraining complete.")
    reporter.shutdown()
    if fsdp is not None and fsdp.tps:
        print(fsdp.describe_tp_traffic())
    save_model(output_dir / f"{output_model_stem(config, config.DIT_PATH)}.safetensors")
    print("All tasks complete. Final model saved.")
    return {"trainable": trainable, "qat_residuals": qat_residuals}
