#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (aozora_sdxl_training_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (each prints the seconds
it took). The seeded random weight files (SDXL_BASE's checkpoint,
ANIMA_BASE's DiT, Qwen3-0.6B, the Wan VAE) are written once a run and
read by every phase that trains on them; the runs whose final model
nothing reads (the resumed runs, the int8 run, the plan phase's) skip
that save:

1. device: CUDA present; the card's name and power limit.
2. build: compiles every CUDA source of the port (one nvcc each, all at
   once, a current library too); for the wgmma kernels
   (csrc/flash_attention_sm90.cu: forward and backward at head_dim 64 and
   128, each template in bf16 and fp16, the bf16 forward at 512) prints
   ptxas's registers and spill bytes, the
   registers, dynamic shared memory and blocks per SM the runtime reports,
   and the HGMMA instructions `cuobjdump -sass` finds in each kernel, and
   for the fp32 kernels of csrc/flash_attention_fp32.cu (every one 3xTF32
   on mma.sync: all three at head_dim 64 and 128, the forward at 512)
   their registers, spills and TF32 HMMA instructions (a spill, or no
   HGMMA or HMMA, fails the phase; without cuobjdump it prints "not
   checked").
3. kernels: each flash-attention kernel against its plain PyTorch version:
   K1 forward, K2 dQ, K3 dK/dV (head_dim 64) at the SDXL shapes, K4a forward
   and K4b dQ, dK/dV (head_dim 128) at the Anima shapes (4096 tokens, and a
   video's 12288, timed too), K4a forward at
   head_dim 512 at the SD-VAE mid-attention shape (one head, 16384 tokens),
   with ragged and unequal lengths and lengths around one tile; the fp16
   kernels (the same templates on fp16) at every one of those shapes and
   cases at head_dim 64 and 128, held at the bf16 bar (2e-2 of the largest
   magnitude) against the plain version and against exact attention in
   float64 (out, lse, delta, dq, dk, dv, head by head); the fp32
   kernels (csrc/flash_attention_fp32.cu: all three at head_dim 64 and 128,
   the forward at 512) on fp32 inputs, held at 1e-4 of the largest
   reference magnitude and against a float64 reference at 1e-5 of it
   (3xTF32 products); at head_dim 64 and 128, in bf16, fp16 and fp32, two
   launches that must agree bitwise; then each timed beside its bound, its
   plain version and the
   device time (torch.profiler) of scaled_dot_product_attention (a
   yardstick only: its forward beside the forward kernels, its backward,
   and its forward plus backward, beside the backward kernels; on the same
   dtype as the kernel), the bf16 and fp16 kernels at the main shapes by
   device time (torch.profiler) and CUDA
   events, the fp32 ones at the unet and dit phases' shapes and at
   SDXL_BASE's widest head_dim-64 and ANIMA_BASE's head_dim-128 attention
   (at each shape first held at 1e-4 against the plain version), and at
   the SD-VAE's; at the bf16 main shapes the dispatcher ops
   (aozora::flash_fwd, aozora::flash_bwd) against the wrappers they call,
   by CUDA events and by the host's time to issue a call.
4. unet: a small UNet with head_dim 64 in fp32, flash path (the fp32
   kernels) against the einsum path, forward and parameter gradients, the
   launches counted.
5. dit: a small Anima DiT with head_dim 128, the same comparison.
6. vae: a random full-size SD-VAE at 1024px: the encoder (bf16, the route
   of tools_dev/cache_probe.py attn=flash; flash_fwd_d512) and the decoder
   (fp32, the preview's; flash_fwd_f32_d512) on the flash path against the
   einsum path, one head_dim-512 launch each.
7. trainer: the SDXL user's first run at SDXL_BASE width, 1024px, batch 1:
   a random SD checkpoint (UNet, CLIP-L, bigG, SD-VAE) and 2 captioned
   images; the port's cache_datasets CLI builds the cache (no flash launch;
   a second run encodes nothing); then the SDXL training CLI runs 4 micro
   steps (1 optimizer step at GA 4) with a preview after it of 4 DDIM
   steps; checks the GUI grammar, finite losses, the flash launch
   counts (70 of each of K1-K3 per micro step, 70 K1 per DDIM step, one
   fp32 head_dim-512 launch for the preview's decoder, 140 forward launches
   per micro step under full remat), the 1024x1024 preview PNG and the
   merged checkpoint.
8. anima: first the anima_cache phase, the Anima user's first run: random
   full-width Qwen3-0.6B and full Wan VAE files (encoder and decoder; bf16,
   from seeds) and 2
   captioned 1024px images; the port's cache_datasets CLI in Anima mode
   builds the cache (Qwen3 over 512 tokens, the Wan VAE over 4 tiles of
   96x96 latents an image; no flash launch), checked for 2 text and 2
   latent payloads (prompt_emb (512, 1024) bf16, int32 T5 ids, latents
   (128, 128, 16) bf16, finite), the index and the GUI's "Cached 2 Anima
   DiT items" line; a second run loads no encoder and encodes nothing; one
   caption's Qwen3 output and one tile's VAE output in fp32 are held
   against float64 on the card at 1e-4 of the largest magnitude; the times
   a caption batch and a latent and the pass's peak memory are printed
   beside the card's name and power limit. Then the port's Anima training
   CLI at ANIMA_BASE width and depth, 1024px, batch 1, GA 4, Full gradient
   checkpointing, 4 micro steps, on a random DiT checkpoint and that cache
   (its hash T5 ids run past the DiT's 32128-row vocabulary), with a
   preview after the optimizer step (16 Euler steps over the DiT, then
   the Wan decoder's decode_image in fp32; timed and left out of the step
   times); checks the GUI grammar, finite losses, the flash launch counts
   (per micro step 56 K4a: 28 forward + 28 recompute, 28 of each K4b
   kernel, no K1-K3; 448 K4a a preview), the decoded 1024x1024 preview PNGs
   (no latent-RGB fallback, no preview that disabled itself), the training
   peak memory (at most 0.5 GB above the 27.8 GB of a synthetic cache; a
   preview's peak is printed beside it) and the saved bf16 DiT under the
   detected key prefix.
9. k5: the stats-level entry points (flash_fwd_stats, flash_bwd_stats over
   the head_dim-128 kernels) against their plain versions at the Anima
   ring hop shape (B=1, H=16, D=128, 2048 and 1024 tokens a shard, bf16);
   then the ring's hop schedule for sp 2 and 4 composed on one card
   (ops/ring_attention.ring_on_one_device: each q shard against each KV
   shard in ring order, merged through the lse; the backward with the
   global (out, lse)) against full attention at 4096 tokens, forward and
   gradients, its launches counted; the entry points and
   scaled_dot_product_attention at the hop shapes by device time
   (torch.profiler), the schedule beside K4a/K4b at 4096 with CUDA events;
   last, the video ring's hop (6144 tokens a shard: a 3-latent-frame clip
   at sp 2), held against the plain versions and timed the same way.
10. k6: the fused GroupNorm+SiLU kernel in both layouts (NHWC, the op's,
   two launches; NCHW, the UNet's fused_gn route, one launch) against its
   plain version at every distinct resnet shape of SDXL_BASE at 1024px,
   bf16, fp16 and fp32, plus a ragged HW, C=320 at a small HW, a width the vector
   loads do not divide and a large mean (against float64); two calls
   bit-identical in each layout; then the NHWC op (group_norm_silu(...,
   use_pallas=True), forward and backward) over the 34 sites of one
   forward, its launches counted; both layouts' 34 forwards timed as CUDA
   graphs beside the bound, the plain versions and F.silu(F.group_norm(...))
   on contiguous NCHW and on the NCHW view of NHWC memory, with the device
   time by kernel, then both layouts in fp16 beside the same bytes bound;
   then one SDXL_BASE UNet forward and backward at 1024px, B=1, bf16 and
   then fp16, random weights, with fused_gn False and True: finite, in
   agreement (5e-2 relative L2), 34 NCHW launches in the True run, both
   synced times printed.
11. anima_sp: with two or more CUDA devices, torchrun runs the Anima CLI on
   2 ranks with SEQUENCE_PARALLEL_SIZE 2 (ring attention over NCCL) at
   ANIMA_BASE, 1024px, Full remat, 4 micro steps; checks rank 0's GUI
   lines (one set), finite losses, each rank's launch counts and the saved
   DiT. Then, on any number of devices, video mode under SP 2: random
   weights of ANIMA_BASE's widths with SP_VIDEO_BLOCKS blocks, synthetic
   clips of VIDEO_FRAMES frames at 1024px (3 latent frames, 12288 tokens,
   6144 a rank), Full remat, 4 micro steps, on 2 ranks (one card: both on
   it over gloo, the ring's hops staged through pinned host buffers; 2+
   cards: torchrun, NCCL), held against one process at the same depth
   (losses rtol 2e-2, the saved DiT < 0.05); per rank the exact launches
   of K5's entry points and K4a/K4b, the hops' bytes a micro step, the
   peak and the step times. (The image run at full depth is not run on one
   card: two replicas of ANIMA_BASE's state on it.)

12. resume: the trainer phase's run takes the GUI's emergency save
   (force_save.flag) at optimizer step 1, its last, the merged model and
   the training state (bf16 moments, the JAX package's format; the save is
   left out of the step times); the SDXL CLI resumes from them for micro
   steps 5-8: finite losses, optimizer steps going on at 2, the tickets a
   fresh 8-step run's schedule draws for micro steps 5-8 (and the unbroken
   run's those of a fresh 4-step run), every moment restored on the card
   bit for bit, the peak memory at most 0.5 GB above the unbroken run's;
   the losses and the step-2 update magnitude are printed (no unbroken run
   covers micro steps 5-8: the CPU tests hold resumed runs against
   unbroken ones); the state's bytes and the s to save, load and restore
   it are printed. Then
   paged_adamw_8bit (int8 blockwise moments): one optimizer step with a
   save and a one-step resume whose restored codes and scales must equal
   the saved ones bit for bit; its apply step is printed beside the bf16
   one. The anima phase's run does the same (save at step 1, resume for
   micro steps 5-8). The free disk is printed and checked first; every
   file goes once it has been used.

14. anima_video (after anima): Anima video mode at ANIMA_BASE. The same
   random Qwen3-0.6B and full Wan VAE files and 2 captioned 1024px
   animated-WEBP clips of 9 frames; the cache CLI with ANIMA_VIDEO_FRAMES 9
   (each clip whole through encode_video: latents (3, 128, 128, 16) bf16),
   s a clip and the peak printed; encode_video, decode_video and
   decode_image in fp32 against float64 on a 5-frame 256px clip at 1e-4 of
   the largest magnitude; then the Anima CLI on the clips' cache, 4 micro
   steps (12288 tokens a sample) with a preview after each optimizer step
   (16 Euler steps, then decode_video of the sampled clip: a filmstrip of 5
   of its 9 frames); checks finite losses, the launch counts (K4a 56 a
   micro step and 448 a preview, K4b 28 + 28 a micro step), the filmstrip
   PNGs and the saved DiT, and prints the plan's estimate beside the
   training peak, s per micro and optimizer step, s per preview and the
   model TFLOP/s at 12288 tokens.

15. repair (after anima_video): the QAT repair flow at ANIMA_BASE's widths,
   the DiT's depth cut to CUT_BLOCKS (8) of 28 blocks. First
   the device projection (train/qat_project.py) of a random full-width
   blocks.0.mlp.layer1.weight (8192 x 2048) in e4m3, e5m2, int8, nvfp4 and
   ternary against the numpy quantizer's round trip, bit for bit, each
   timed on the card and on the host. Then the random DiT (seed 4321)
   quantized by the port's convert_quants CLI (e4m3, target preset);
   the anima phase's random Qwen3-0.6B and Wan VAE files and 2 captioned
   1024px images, cached by the cache CLI with line-art masks (lineart_mask
   (128, 128) float32 in [0, 1] in each latent payload); then the repair
   CLI (cli/train_anima_repair.py) on them, 1024px, batch 1, GA 4, Full
   remat, 4 micro steps: the "QAT repair: N quantized tensors" line, the
   line-art loss on, finite losses, the launches (K4a 16, K4b 8 + 8 a
   micro step), the projection's ms an optimizer step (synced, left out
   of the steps) and its fp16 residuals' GB, the host's s to dequantize at
   load and to pack at save, s per micro and optimizer step, the peak
   beside the plan's estimate; repaired_quantized.safetensors reloads in
   the port's controller with every controlled key's format and shape
   unchanged, for four sampled tensors its dequantized values equal the
   card's projection of the trained (final + residual) bit for bit and lie
   within half an e4m3 step of it, and the share of codes that changed
   from the input is printed. Last, tools/profile_quants --mode dynamic on
   the random DiT (int8 trials of 8 layers, synthetic calibration at
   --latent-hw 64, 1024 tokens): 9 fp32 forwards, each timed, one
   flash_fwd_f32_d128 launch a block each.

16. fp16 (after repair): MIXED_PRECISION float16 on the flash route
   through both training CLIs, each on seeded random weights and a
   synthetic cache of 2 images at 1024px: SDXL_BASE (GA 4, 4 micro steps,
   then a preview of 2 DDIM steps, the decoder in fp32), then ANIMA_BASE's
   widths with CUT_BLOCKS (8) blocks under Full remat (4 micro steps, a
   latent-RGB preview of 2 Euler steps: no VAE file); each checks finite
   losses, the fp16 kernels' launches (a micro step 70 of each of K1-K3
   for SDXL, 16 K4a and 8 + 8 K4b for the DiT; 70 K1 a DDIM step, 8 K4a an
   Euler step; the SDXL preview's fp32
   head_dim-512 decode once) and no bf16 flash launch, a preview that did
   not disable itself and a saved model whose float tensors are all F16,
   and prints s per micro and optimizer step and the peak beside those of
   a bfloat16 run of the same preset just before it (the control; its
   bf16 kernels' launches checked the same way).

17. dp (after anima_sp): both training CLIs on 2 ranks, data parallel with
   FSDP (parallel/sharding.FSDP): with one card both ranks on it over gloo
   (each rank starts the gloo group, then the CLI takes it), with 2+ cards
   torchrun over NCCL. Random weights of SDXL_BASE's and ANIMA_BASE's
   widths at cut depth (DP_SDXL_LAYERS transformer layers a block,
   DP_ANIMA_BLOCKS blocks: gloo on one card moves ~0.6 GB/s), synthetic
   caches of 2 images at 1024px. SDXL at the default preset (BATCH_SIZE 1
   a rank, GA 4, raven, bf16, flash), 4 micro steps, held against one
   process at BATCH_SIZE 2 (this process) over the same steps: losses
   (rtol 2e-2) and the saved UNet (max relative difference < 0.05, the JAX
   end-to-end test's bar); then the DiT under Full remat, 4 micro steps,
   finite losses. For each rank: its exact flash launches (K1-K3 a
   self-attention layer a micro step, K4a 2 and K4b 1 a block), the
   backend and the bytes each collective took (all_gather_into_tensor and
   reduce_scatter_tensor a micro step, the apply step's all_reduce), half
   the sharded elements held, memory allocated after setup (and the
   one-process run's), the peak beside the plan's estimate at dp_shard=2
   (both ranks' peaks must fit the one card together), s a micro step and
   an optimizer step from its AOZORA_STEP_LOG. Rank 1 prints nothing.

18. pp (after dp): pipeline parallelism (GPipe) of the Anima DiT: the CLI
   with PIPELINE_PARALLEL_SIZE 2 on 2 ranks (one card: gloo on cuda:0, the
   stage hops staged through pinned host buffers; 2+ cards: torchrun,
   NCCL) at ANIMA_BASE's widths with PP_BLOCKS blocks (2 a stage), 1024px
   images, BATCH_SIZE 2 in 2 microbatches, Full remat, 4 micro steps, held
   against one process at the same depth and batch (losses rtol 2e-2, the
   saved DiT < 0.05). Per rank: the exact K4a/K4b launches (2 blocks x 2
   x 2 microbatches K4a and 2 x 2 of each K4b a micro step), the hops'
   path, count and bytes a micro step, half the stacked block elements
   held, memory allocated after setup beside the one-process run's, the
   peak, and s a micro and an optimizer step from its step log; the
   phase's seconds.

20. tp (after pp): tensor parallelism of both CLIs with
   TENSOR_PARALLEL_SIZE 2 on 2 ranks (one card: gloo on cuda:0; 2+ cards:
   torchrun, NCCL), dp 1, at the dp phase's cut depth: the SDXL UNet at
   the default preset and the DiT under Full remat, 4 micro steps each,
   each held against one process on the same preset (losses rtol 2e-2,
   the saved model < 0.05). Per rank: the tp line (a run that fell back to
   tp 1 fails), its exact flash launches at B·H = heads/2 (K1-K3 at 5 and
   10, K4a/K4b at 8), half the tp-split elements held, memory allocated
   after setup beside the one-process run's, the peak, the bytes it put
   into tp collectives a micro step (reduce and copy; gather and scatter
   where a layer's heads tp does not divide), s a micro step; the phase's
   seconds.

13. plan: the memory planner on the card's budget (its total memory),
   without the cache encoders (synthetic caches): each trainer's default
   plan printed; ANIMA_BASE (random, 1024px, batch 1, GA 4) under Full
   and under Conservative gradient checkpointing, 4 micro steps each in
   this process: the plans, s per micro step, the peak beside the plan's
   estimate, launches a micro step (K4a 56 under Full, 28 under
   Conservative; K4b 28 of each) and equal losses; then SDXL_BASE under
   its default plan (GA 4), with MASTER_DTYPE bfloat16 at GA 1 (the plan
   must be bf16 masters with the fused step) and under
   AOZORA_SDXL_REMAT=dots_no_logits_hires, 4 micro steps each, with the
   same numbers (11 K1 a micro step in each: these SDXL runs, and the
   two-pass run the GUI launches, train the dp phase's cut UNet; the host
   moments' run keeps SDXL_BASE, 70 K1 a micro step). CHIP_SMOKE_TRACE=1
   traces micro steps 3-8 of each run, CHIP_SMOKE_TRACE=label,label of the
   runs named (summary.json and kernels.txt under the log dir; a traced
   run is not a timing run).

`python3 chip_smoke.py --only anima_sp` runs the device, build and anima_sp
phases alone; `--only anima` runs the
anima_cache and anima phases; `--only anima_video` the video phase;
`--only resume` runs the trainer and anima phases with their resume parts;
`--only plan` the plan phase; `--only repair` the repair phase; `--only
fp16` the fp16 phase; `--only dp` the dp phase; `--only pp` the pp phase
(`--only pp,anima_sp` both multi-rank Anima phases, on one card); `--only
tp` the tp phase.

The second-to-last lines are the kernels JSON and the card's name and power
limit; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "aozora_sdxl_training_tpu_torch"
# the trainer's full output and a JSON summary go here
LOG_DIR = Path(os.environ.get("CHIP_SMOKE_LOG_DIR", REPO / "chip_smoke_out")).resolve()
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores, H100 SXM
H100_TF32_FLOPS = 495e12      # dense TF32 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM
SM90 = "flash_attention_sm90"      # the wgmma kernels (every bf16 and fp16 one)
FP32 = "flash_attention_fp32"      # the fp32 kernels
# the kernels of the fp32 source (all 3xTF32) as their mangled names spell
# them, (kernel, head dim, ""), and the kernel's index in
# aozora_flash_fp32_attributes
F32_D512_KERNEL = "flash_fwd_f32_d512_kernel"
TF32_KERNELS = {**{(kernel, d, ""): i for i, kernel in enumerate(
                    ("flash_fwd_3xtf32_kernel", "flash_bwd_dq_3xtf32_kernel",
                     "flash_bwd_dkv_3xtf32_kernel")) for d in (64, 128)},
                (F32_D512_KERNEL, 512, ""): 0}
SOURCES = (SM90, FP32, "groupnorm_silu")
FA = "aozora_sdxl_training_tpu/ops/flash_attention.py"
GN = "aozora_sdxl_training_tpu/ops/groupnorm_silu.py"
# each kernel (by its route name), the Pallas kernel it replaces (K1
# _fwd_kernel, K2 _bwd_dq_kernel, K3 _bwd_dkv_kernel; K4a
# _flash_forward_folded, K4b the dq and dk/dv pallas_calls of
# _flash_backward_folded), its head dim, the phase whose run counts its
# launches (the SDXL trainer: K1-K3 in training, the fp32 head_dim-512
# forward in the preview's decoder; the Anima trainer: head_dim 128; the
# fp16 phase: both trainers under MIXED_PRECISION float16, the fp16
# kernels; the unet and dit phases: the fp32 kernels at 64 and 128, which
# no trainer runs) and the CUDA kernel it launches
KERNELS = {
    "flash_fwd": (f"{FA}:65", 64, "trainer", "flash_fwd_sm90_kernel<bf16, 64, 1>"),
    "flash_bwd_dq": (f"{FA}:153", 64, "trainer", "flash_bwd_dq_sm90_kernel<bf16, 64, 1>"),
    "flash_bwd_dkv": (f"{FA}:186", 64, "trainer", "flash_bwd_dkv_sm90_kernel<bf16, 64, 1>"),
    "flash_fwd_d128": (f"{FA}:302", 128, "anima", "flash_fwd_sm90_kernel<bf16, 128, 2>"),
    "flash_bwd_dq_d128": (f"{FA}:355", 128, "anima", "flash_bwd_dq_sm90_kernel<bf16, 128, 2>"),
    "flash_bwd_dkv_d128": (f"{FA}:378", 128, "anima",
                           "flash_bwd_dkv_sm90_kernel<bf16, 128, 2>"),
    "flash_fwd_d512": (f"{FA}:302", 512, "vae", "flash_fwd_d512_sm90_kernel"),
    "flash_fwd_f32_d64": (f"{FA}:65", 64, "unet", "flash_fwd_3xtf32_kernel<64>"),
    "flash_bwd_dq_f32_d64": (f"{FA}:153", 64, "unet", "flash_bwd_dq_3xtf32_kernel<64>"),
    "flash_bwd_dkv_f32_d64": (f"{FA}:186", 64, "unet", "flash_bwd_dkv_3xtf32_kernel<64>"),
    "flash_fwd_f32_d128": (f"{FA}:302", 128, "dit", "flash_fwd_3xtf32_kernel<128>"),
    "flash_bwd_dq_f32_d128": (f"{FA}:355", 128, "dit", "flash_bwd_dq_3xtf32_kernel<128>"),
    "flash_bwd_dkv_f32_d128": (f"{FA}:378", 128, "dit", "flash_bwd_dkv_3xtf32_kernel<128>"),
    "flash_fwd_f32_d512": (f"{FA}:302", 512, "trainer", F32_D512_KERNEL),
    "flash_fwd_f16": (f"{FA}:65", 64, "fp16", "flash_fwd_sm90_kernel<f16, 64, 1>"),
    "flash_bwd_dq_f16": (f"{FA}:153", 64, "fp16", "flash_bwd_dq_sm90_kernel<f16, 64, 1>"),
    "flash_bwd_dkv_f16": (f"{FA}:186", 64, "fp16", "flash_bwd_dkv_sm90_kernel<f16, 64, 1>"),
    "flash_fwd_f16_d128": (f"{FA}:302", 128, "fp16", "flash_fwd_sm90_kernel<f16, 128, 2>"),
    "flash_bwd_dq_f16_d128": (f"{FA}:355", 128, "fp16",
                              "flash_bwd_dq_sm90_kernel<f16, 128, 2>"),
    "flash_bwd_dkv_f16_d128": (f"{FA}:378", 128, "fp16",
                               "flash_bwd_dkv_sm90_kernel<f16, 128, 2>"),
}
TRAIN_STEPS = 4               # one optimizer step at the presets' GA 4
RESUME_TO = 2 * TRAIN_STEPS   # a resumed run goes on to micro step 8: optimizer step 2
SHORT_STEPS = 4               # one: the anima_video and repair phases
GA = 4
# the DiT of the repair and fp16 phases: ANIMA_BASE's widths, its depth cut
# to 8 of 28 blocks for the script's time (the whole script took 1044.7 s
# of its 1200 s with them at full depth on an NVIDIA H100 80GB HBM3 at
# 700.00 W; the repair phase's host passes and tools scale with the
# depth). The plan phase keeps ANIMA_BASE whole: at 8 blocks its host
# moments move in 12 chunks, and the trace of a host apply step, which can
# lose a step's first few H2D copies, then holds too few to measure
CUT_BLOCKS = 8
# one SDXL_BASE forward at 128x128 latents, batch 1, as bench.py counts it;
# a training micro step does three times this work (forward + backward)
SDXL_FWD_FLOPS_1024 = 6.779495251968e12
# self-attention at 1024px per micro step, by head dim: (B, H, S, calls);
# SDXL at head_dim 64, the Anima DiT (28 blocks, 16 heads) at 128
MAIN_SHAPES = {64: ((1, 10, 4096, 10), (1, 20, 1024, 60)),
               128: ((1, 16, 4096, 28),)}
# the fp32 kernels' shapes in the unet and dit phases: batch 2, 2 heads,
# 1024 tokens (the UNet's 32 x 32 level, the DiT's 32 x 32 patches); then
# the widest self-attention at 1024px of SDXL_BASE (head_dim 64, 10 heads,
# 4096 tokens) and of ANIMA_BASE (head_dim 128), held and timed only
FP32_SHAPES = {64: ((2, 2, 1024), (1, 10, 4096)), 128: ((2, 2, 1024), (1, 16, 4096))}
SELF_ATTN_CALLS = {d: sum(c for *_, c in shapes) for d, shapes in MAIN_SHAPES.items()}
# Anima video mode at 1024px: a 9-frame clip is 3 latent frames of 64 x 64
# patches; the DiT's self-attention then runs at 12288 tokens (K4a/K4b)
VIDEO_FRAMES = 9
VIDEO_TOKENS = 3 * 64 * 64
VIDEO_SHAPE = (1, 16, VIDEO_TOKENS, SELF_ATTN_CALLS[128])
# the bf16 kernels' timed shapes: the main ones and, at head_dim 128, the
# video one
TIMED_SHAPES = {64: MAIN_SHAPES[64], 128: MAIN_SHAPES[128] + (VIDEO_SHAPE,)}
# the Anima runs' previews: Euler steps of the DiT without remat, one K4a
# launch a block a step
ANIMA_PREVIEW_STEPS = 16
ANIMA_PREVIEW_K4A = SELF_ATTN_CALLS[128] * ANIMA_PREVIEW_STEPS
# the SD-VAE mid-attention at 1024px: one head of 512 over 128 x 128 tokens,
# fp32 in the preview decoder, bf16 in the encoder's flash route
VAE_TOKENS = 128 * 128
PREVIEW_EVERY, PREVIEW_STEPS = 1, 4

# GUI patterns (the reference GUI's regexes, as tests/test_gui_grammar.py has them)
SDXL_PROGRESS = re.compile(
    r'Training\s*\|.*\|\s*(\d+)/(\d+)\s*\[.*?\]\s*\[Loss:\s*([\d.e+-]+),'
    r'\s*Timestep:\s*(\d+)\]')
ANIMA_PROGRESS = re.compile(
    r'Training\s*\|.*\|\s*(\d+)/(\d+)\s*\[.*?\]\s*\[Loss:\s*([\d.e+-]+),'
    r'\s*Ticket:\s*(\d+),\s*Sigma:\s*([\d.e+-]+)\]')
OPTIM_STEP = re.compile(
    r'--- Optimizer Step:\s*(\d+)\s*\|\s*Loss:\s*([\d.e+-]+)\s*\|'
    r'\s*LR:\s*([\d.e+-]+)\s*---')
GRAD_NORM = re.compile(r'Grad Norm \(Raw/Clipped\):\s*([\d.]+)\s*/\s*([\d.]+)')


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


_PHASES_RUN: list = []       # (name, start) of each phase so far


def phase(name):
    """Starts phase ``name``; prints the time the phase before it took."""
    end_phase()
    _PHASES_RUN.append((name, time.perf_counter()))
    print(f"\n=== phase: {name} ===", flush=True)


# the run's seeded random weight files, written once and read by every
# phase that trains on them (``shared_weights``); main sets the directory
WEIGHTS_DIR: list = []
_WEIGHTS: dict = {}


def shared_weights(torch, name: str, write):
    """The seeded random weight file ``name``: written by ``write(path)``
    into the run's weights directory the first time a phase asks for it
    (the trainers and encoders only read it), then reused. Returns (path,
    what ``write`` returned, the seconds this call spent writing)."""
    t0 = time.perf_counter()
    if name not in _WEIGHTS:
        path = Path(WEIGHTS_DIR[-1]) / name
        _WEIGHTS[name] = (path, write(path))
        torch.cuda.empty_cache()
    return (*_WEIGHTS[name], time.perf_counter() - t0)


def end_phase():
    if _PHASES_RUN and len(_PHASES_RUN[-1]) == 2:
        name, t0 = _PHASES_RUN[-1]
        _PHASES_RUN[-1] = (name, t0, time.perf_counter() - t0)
        print(f"  ({name}: {_PHASES_RUN[-1][2]:.1f} s)", flush=True)


# --------------------------------------------------------------------------
# 1-2: device and build
# --------------------------------------------------------------------------

def device_phase(torch):
    phase("device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"device: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi[0] if smi else 'n/a'}")
    return name, (smi[0] if smi else "n/a")


def build_phase():
    """Builds every source (a current library too, so the ptxas report is
    this run's); returns the wgmma and 3xTF32 kernels' report."""
    phase("build")
    from aozora_sdxl_training_tpu_torch.ops import cuda_build
    results = cuda_build.build_all(SOURCES, force=True)
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    for name, (seconds, output) in results.items():
        print(f"built {name}.cu in {seconds:.1f} s")
        (LOG_DIR / f"nvcc_{name}.log").write_text(output)
        for line in output.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:     # the kernel, its element type and head dim (mangled)
                key = kernel_of(entry.group(1))
                gn = re.search(r"(gn_\w*?_kernel)", entry.group(1))
                print(f"  ptxas: {kernel_label(*key) if key else gn.group(1) if gn else ''}")
            elif ("registers" in line or "spill" in line or "error" in line.lower()
                  or "wgmma" in line):
                print(f"  ptxas: {line.strip()}")
    report = build_report(cuda_build, SM90, results[SM90][1], SM90_KERNELS, "hgmma")
    report.update(build_report(cuda_build, FP32, results[FP32][1], TF32_KERNELS, "hmma_tf32"))
    return report


# the wgmma kernels as their mangled names spell them: (kernel, head dim,
# element type: "bf16" or "f16", the first template argument) and the
# kernel's index in aozora_flash_sm90_attributes (fp16: 3 on); the one
# kernel of each route name
SM90_ROLES = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")
SM90_KERNELS = {**{(kernel, d, elem): i + 3 * (elem == "f16")
                   for i, kernel in enumerate(SM90_ROLES) for d in (64, 128)
                   for elem in ("bf16", "f16")},
                ("flash_fwd_d512_sm90_kernel", 512, ""): 0}
D512_KERNEL = "flash_fwd_d512_sm90_kernel"
SM90_OF = {f"{name}{sfx}{'' if d == 64 else '_d128'}": (kernel, d, elem)
           for name, kernel in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), SM90_ROLES)
           for d in (64, 128) for elem, sfx in (("bf16", ""), ("f16", "_f16"))}
SM90_OF["flash_fwd_d512"] = (D512_KERNEL, 512, "")


def kernel_of(mangled: str):
    """(kernel, head dim, element type: "bf16", "f16" or "") of a mangled
    wgmma or 3xTF32 kernel name, or None."""
    found = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_(?:sm90|3xtf32)_kernel)I(\w*?)Li(\d+)E",
                      mangled)
    if found:
        types = found.group(2)
        elem = "f16" if "half" in types else "bf16" if "bfloat16" in types else ""
        return found.group(1), int(found.group(3)), elem
    for kernel in (D512_KERNEL, F32_D512_KERNEL):
        if kernel in mangled:
            return kernel, 512, ""
    return None


def kernel_label(kernel: str, d: int, elem: str = "") -> str:
    """A kernel's name in the reports: a template's with its element type
    and head dim."""
    if kernel in (D512_KERNEL, F32_D512_KERNEL):
        return kernel
    return f"{kernel}<{elem}, {d}>" if elem else f"{kernel}<{d}>"


def ptxas_usage(log: str) -> dict:
    """{(kernel, head dim, element type): {"registers", "spill_stores",
    "spill_loads"}} from nvcc's -Xptxas -v output."""
    usage, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            current = kernel_of(entry.group(1))
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            usage.setdefault(current, {}).update(spill_stores=int(spill.group(1)),
                                                 spill_loads=int(spill.group(2)))
        if regs:
            usage.setdefault(current, {})["registers"] = int(regs.group(1))
    return usage


def mma_counts(sass: str) -> dict:
    """{(kernel, head dim, element type): {"hgmma": n, "hmma_tf32": n}} from ``cuobjdump
    -sass``: the wgmma instructions and the TF32 mma.sync ones."""
    counts, current = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = kernel_of(fn.group(1))
            if current:
                counts[current] = {"hgmma": 0, "hmma_tf32": 0}
        elif current and "HGMMA" in line:
            counts[current]["hgmma"] += 1
        elif current and "HMMA" in line and "TF32" in line:
            counts[current]["hmma_tf32"] += 1
    return counts


def sass_counts(cuda_build, source: str):
    """``mma_counts`` of a built library, or None without cuobjdump."""
    import shutil
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    cuobjdump = str(cuobjdump) if cuobjdump.exists() else shutil.which("cuobjdump")
    if cuobjdump is None:
        return None
    proc = subprocess.run([cuobjdump, "-sass", str(cuda_build.library_path(source))],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr[-2000:]}")
    return mma_counts(proc.stdout)


def build_report(cuda_build, source: str, log: str, kernels: dict, what: str) -> dict:
    """ptxas's registers and spills, the runtime's registers, shared memory
    and blocks per SM, and the ``what`` instructions ("hgmma": wgmma;
    "hmma_tf32": TF32 mma.sync) that ``cuobjdump -sass`` finds, of each of
    ``kernels`` ({(kernel, head dim, element type): its index in the library's
    aozora_flash_<sm90|fp32>_attributes}) built from ``source``; fails if
    ptxas reported nothing for one, if one spills or if its SASS has none
    of them."""
    import ctypes
    usage = ptxas_usage(log)
    lib = ctypes.CDLL(str(cuda_build.library_path(source)))
    query = getattr(lib, {SM90: "aozora_flash_sm90_attributes",
                          FP32: "aozora_flash_fp32_attributes"}[source])
    query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sass = sass_counts(cuda_build, source)
    instruction = {"hgmma": "HGMMA", "hmma_tf32": "TF32 HMMA"}[what]
    report = {}
    for key, index in kernels.items():
        kernel = kernel_label(*key)
        check(key in usage and "registers" in usage[key], f"ptxas reported nothing for {kernel}")
        attrs = (ctypes.c_int * 5)()
        err = query(index, key[1], ctypes.addressof(attrs))
        check(err == 0, f"cudaFuncGetAttributes({kernel}) failed: {err}")
        regs, local, smem, threads, blocks = list(attrs)
        row = {**usage[key], "runtime_registers": regs, "local_bytes": local,
               "dynamic_smem_bytes": smem, "threads": threads, "blocks_per_sm": blocks,
               what: None if sass is None else sass.get(key, {}).get(what, 0)}
        report[kernel] = row
        print(f"  {kernel}: ptxas {row['registers']} registers, spill {row['spill_stores']} "
              f"B stores / {row['spill_loads']} B loads; runtime {regs} registers, {local} B "
              f"local, {smem} B dynamic shared memory, {threads} threads, {blocks} block(s)/SM; "
              f"{instruction} {'not checked (no cuobjdump)' if sass is None else row[what]}")
        check(row["spill_stores"] == 0 and row["spill_loads"] == 0 and local == 0,
              f"{kernel} spills")
        if sass is not None:
            check(row[what] > 0, f"{kernel}: no {instruction} instruction in its SASS")
    return report


# --------------------------------------------------------------------------
# 3: kernels
# --------------------------------------------------------------------------

def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=10):
    """Device time of one call of ``fn``: the summed duration of the CUDA
    kernels (and copies) that ``iters`` calls launch, over ``iters``
    (torch.profiler). The host's per-call cost does not show, as it does in
    ``cuda_ms`` when a call's launches take longer to issue than to run. A
    trace now and then loses some of its device records, or all of them: a
    trace in which a kernel's records are not a whole multiple of
    ``iters`` is taken again, up to 5 times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        if events and all(e.count % iters == 0 for e in events):
            return sum(e.self_device_time_total for e in events) / iters / 1e3
    raise PhaseError(f"torch.profiler lost device records in 5 traces of {iters} calls")


def kernel_names(fa, d, dtype):
    """The forward, dQ and dK/dV kernels' names at head dim ``d`` and
    ``dtype`` (None: no kernel)."""
    return tuple(kernel and kernel[0] for kernel in fa.ROUTES[d, dtype])


def bound(flops, nbytes, peak=H100_BF16_FLOPS):
    """(least ms the card could take, "operations" or "bytes"), the
    operations at ``peak`` flop/s."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def work(b, h, s, d, elem):
    """(flops, bytes) per kernel for self-attention of length s, by the
    kernel's role (forward, dQ, dK/dV)."""
    bh, row = b * h, b * h * s
    act = row * d * elem
    return ((4 * bh * s * s * d, 4 * act + 4 * row),
            (6 * bh * s * s * d, 6 * act + 8 * row),
            (8 * bh * s * s * d, 6 * act + 8 * row))


def kernel_phase(torch):
    phase("kernels")
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (label, B, H, Sq, Skv, D, dtype); the "S=" cases are the main shapes
    cases = [("S=4096 B*H=10 D=64", 1, 10, 4096, 4096, 64, bf16),
             ("S=1024 B*H=20 D=64", 1, 20, 1024, 1024, 64, bf16),
             ("ragged S=3952 B*H=10 D=64", 1, 10, 3952, 3952, 64, bf16),
             ("Sq=1000 Skv=333 B=2 H=3 D=64", 2, 3, 1000, 333, 64, bf16),
             ("Sq=333 Skv=1000 B=2 H=3 D=64", 2, 3, 333, 1000, 64, bf16),
             ("S=63 B=2 H=3 D=64", 2, 3, 63, 63, 64, bf16),
             ("S=64 B=2 H=3 D=64", 2, 3, 64, 64, 64, bf16),
             ("S=65 B=2 H=3 D=64", 2, 3, 65, 65, 64, bf16),
             ("S=129 B=2 H=3 D=64", 2, 3, 129, 129, 64, bf16),
             ("S=4096 B*H=16 D=128", 1, 16, 4096, 4096, 128, bf16),
             ("ragged S=3952 B*H=16 D=128", 1, 16, 3952, 3952, 128, bf16),
             ("Sq=1000 Skv=333 B=2 H=3 D=128", 2, 3, 1000, 333, 128, bf16),
             ("Sq=333 Skv=1000 B=2 H=3 D=128", 2, 3, 333, 1000, 128, bf16),
             ("S=63 B=2 H=3 D=128", 2, 3, 63, 63, 128, bf16),
             ("S=64 B=2 H=3 D=128", 2, 3, 64, 64, 128, bf16),
             ("S=65 B=2 H=3 D=128", 2, 3, 65, 65, 128, bf16),
             ("S=129 B=2 H=3 D=128", 2, 3, 129, 129, 128, bf16),
             ("S=12288 B*H=16 D=128 (video)", 1, 16, VIDEO_TOKENS, VIDEO_TOKENS, 128, bf16),
             ("S=16384 B*H=1 D=512 bf16", 1, 1, VAE_TOKENS, VAE_TOKENS, 512, bf16),
             ("ragged S=16000 B*H=1 D=512", 1, 1, 16000, 16000, 512, bf16),
             ("fp32 S=1024 B=2 H=2 D=64", 2, 2, 1024, 1024, 64, f32),
             ("fp32 Sq=333 Skv=1000 B=2 H=3 D=64", 2, 3, 333, 1000, 64, f32),
             ("fp32 S=65 B=2 H=3 D=64", 2, 3, 65, 65, 64, f32),
             ("fp32 S=1024 B=2 H=2 D=128", 2, 2, 1024, 1024, 128, f32),
             ("fp32 Sq=1000 Skv=333 B=2 H=3 D=128", 2, 3, 1000, 333, 128, f32),
             ("fp32 S=16384 B*H=1 D=512", 1, 1, VAE_TOKENS, VAE_TOKENS, 512, f32),
             ("fp32 Sq=1000 Skv=3000 B=2 H=2 D=512", 2, 2, 1000, 3000, 512, f32),
             ("fp32 Sq=65 Skv=1000 B=1 H=3 D=512", 1, 3, 65, 1000, 512, f32),
             ("fp32 Sq=40 Skv=40 B=2 H=1 D=512", 2, 1, 40, 40, 512, f32)]
    # the fp16 kernels at every shape and case of the bf16 ones at head_dim
    # 64 and 128 (fp16 has no head_dim-512 kernel)
    cases += [(f"fp16 {label}", b, h, sq, skv, d, f16)
              for label, b, h, sq, skv, d, dtype in cases if dtype == bf16 and d != 512]
    # tolerance of tensor outputs, as a share of the largest reference
    # magnitude: bf16 and fp16 2e-2 (16-bit operands of the tensor-core
    # products, fp32 accumulation, 16-bit outputs), fp32 1e-4 (fp32
    # products summed in another order); lse in absolute terms, bf16 and
    # fp16 1e-3, fp32 1e-4. The fp16 kernels are held to the same 2e-2
    # against float64 too (out, lse, dq, dk, dv)
    rel_tol = {bf16: 2e-2, f16: 2e-2, f32: 1e-4}
    lse_tol = {bf16: 1e-3, f16: 1e-3, f32: 1e-4}
    main = ("S=4096", "S=1024", "S=12288", "S=16384", "fp32 S=1024", "fp32 S=16384",
            "fp16 S=4096", "fp16 S=1024", "fp16 S=12288")
    f64_err: dict = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = dict.fromkeys(KERNELS, 0.0)
    for label, b, h, sq, skv, d, dtype in cases:
        q, do = (torch.randn(b, sq, h, d, device="cuda", dtype=dtype, generator=g)
                 for _ in range(2))
        k, v = (torch.randn(b, skv, h, d, device="cuda", dtype=dtype, generator=g)
                for _ in range(2))
        scale = d ** -0.5
        kf, kdq, kdkv = kernel_names(fa, d, dtype)
        out, lse = fa.flash_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, scale)
        rows = [(kf, "out", out, ref_out, None),
                (kf, "lse", lse, ref_lse, lse_tol[dtype])]
        if kdq is not None:                   # head_dim 512: forward only
            dq, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, scale)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
            torch.cuda.synchronize()
            ref_dq, ref_delta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, scale)
            ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, ref_delta, scale)
            rows += [(kdq, "delta", delta, ref_delta, None),
                     (kdq, "dq", dq, ref_dq, None),
                     (kdkv, "dk", dk, ref_dk, None),
                     (kdkv, "dv", dv, ref_dv, None)]
        for kname, what, got, want, atol in rows:
            got, want = got.float(), want.float()
            check(bool(torch.isfinite(got).all()), f"{label} {what}: non-finite")
            err = (got - want).abs().max().item()
            tol = atol if atol is not None else rel_tol[dtype] * want.abs().max().item()
            print(f"  {label:36s} {what:5s} max_abs_err {err:.3e}  tol {tol:.3e}")
            check(err <= tol, f"{label} {what}: error {err} > tolerance {tol}")
            if what != "lse" and label.startswith(main):
                max_err[kname] = max(max_err[kname], err)
        if dtype == f32:
            check_against_float64(torch, label, q, k, v, scale, out, lse)
        if dtype == f32 and kdq is not None:
            check_grads_against_float64(torch, label, q, k, v, do, scale, (dq, dk, dv))
        if dtype == f16:
            for (kname, what, *_), share in zip(rows, check_fp16_against_float64(
                    torch, label, q, k, v, do, scale, (out, lse, delta, dq, dk, dv),
                    rel_tol[f16])):
                if what != "lse":
                    f64_err[kname] = max(f64_err.get(kname, 0.0), share)
        del q, k, v, do, out, lse, ref_out, ref_lse, rows
        torch.cuda.empty_cache()
    print("  fp16 kernels against float64, the largest error as a share of the largest "
          f"magnitude (bar {rel_tol[f16]}): {f64_err}")
    check_deterministic(torch, fa)
    check_unaligned(torch, fa)
    return max_err, {**time_kernels(torch, fa, bf16), **time_kernels(torch, fa, f16),
                     **time_fp32(torch, fa), **time_d512(torch, fa),
                     "dispatcher_ops": time_ops(torch, fa), "fp16_against_float64": f64_err}


def check_against_float64(torch, label, q, k, v, scale, out, lse, bar=1e-5):
    """A 3xTF32 forward's output and lse against attention in float64, each
    held at ``bar`` of its largest magnitude (the fp32 plain version is held
    at 1e-4 above; 3xTF32 keeps ~2^-22 of each product)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.double())
    want_lse = torch.logsumexp(s, dim=-1).reshape(lse.shape)
    del s
    for name, got, ref in (("out", out, want), ("lse", lse, want_lse)):
        err = (got.double() - ref).abs().max().item()
        tol = bar * ref.abs().max().item()
        print(f"  {label:36s} {name:5s} max_abs_err {err:.3e} against float64 "
              f"({err / tol * bar:.2e} of the largest magnitude)  tol {tol:.3e}")
        check(err <= tol, f"{label} {name}: error {err} against float64 > {tol}")


def check_grads_against_float64(torch, label, q, k, v, do, scale, grads, bar=1e-5):
    """A 3xTF32 backward's dq, dk and dv against attention's gradients in
    float64, each held at ``bar`` of its largest magnitude."""
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vd)
    wants = torch.autograd.grad(out, (qd, kd, vd), do.double())
    del s, out
    for name, got, want in zip(("dq", "dk", "dv"), grads, wants):
        err = (got.double() - want).abs().max().item()
        tol = bar * want.abs().max().item()
        print(f"  {label:36s} {name:5s} max_abs_err {err:.3e} against float64 "
              f"({err / tol * bar:.2e} of the largest magnitude)  tol {tol:.3e}")
        check(err <= tol, f"{label} {name}: error {err} against float64 > {tol}")


def float64_attention(torch, q, k, v, do, scale):
    """Exact attention in float64, head by head (a (Sq, Skv) score matrix at
    a time): out, lse (B*H, Sq), delta = rowsum(dO * O) (B*H, Sq), dq, dk,
    dv."""
    b, sq, h, _ = q.shape
    f64 = torch.float64
    out, dq = (torch.empty(q.shape, dtype=f64, device=q.device) for _ in range(2))
    dk, dv = (torch.empty(k.shape, dtype=f64, device=k.device) for _ in range(2))
    lse, delta = (torch.empty(b * h, sq, dtype=f64, device=q.device) for _ in range(2))
    for bi in range(b):
        for hi in range(h):
            qh, kh, vh, doh = (t[bi, :, hi].to(f64) for t in (q, k, v, do))
            s = qh @ kh.T * scale
            m = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - m[:, None])
            o = p @ vh
            dl = (doh * o).sum(-1)
            ds = p * (doh @ vh.T - dl[:, None]) * scale
            out[bi, :, hi], lse[bi * h + hi], delta[bi * h + hi] = o, m, dl
            dq[bi, :, hi], dk[bi, :, hi], dv[bi, :, hi] = ds @ kh, ds.T @ qh, p.T @ doh
            del s, p, ds
    return out, lse, delta, dq, dk, dv


def check_fp16_against_float64(torch, label, q, k, v, do, scale, got, bar):
    """The fp16 kernels' out, lse, delta, dq, dk and dv (``got``) against
    exact attention in float64 on the same fp16 inputs (``float64_attention``),
    each held at ``bar`` of its largest magnitude (lse in absolute terms, at
    1e-3). P and dS go into the products rounded to fp16, as in the JAX
    kernels, so the error is about an fp16 rounding of them. Returns each
    error as a share of the largest magnitude (lse: absolute)."""
    shares = []
    for name, g, want in zip(("out", "lse", "delta", "dq", "dk", "dv"), got,
                             float64_attention(torch, q, k, v, do, scale)):
        err = (g.double() - want).abs().max().item()
        share = err if name == "lse" else err / want.abs().max().item()
        tol = 1e-3 if name == "lse" else bar
        print(f"  {label:36s} {name:5s} max_abs_err {err:.3e} against float64 "
              f"({share:.2e}{'' if name == 'lse' else ' of the largest magnitude'})  bar {tol}")
        check(share <= tol, f"{label} {name}: error against float64 {share} > {tol}")
        shares.append(share)
    return shares


def check_deterministic(torch, fa):
    """No atomics in the bf16 and fp16 kernels at head_dim 64 and 128, nor
    in the fp32 ones: two launches at each head dim's largest main shape
    (fp32 at the unet and dit phases' shapes) give bitwise-equal out, lse,
    dq, dk and dv."""
    shapes = [(MAIN_SHAPES[d][0][:3], d, dtype) for d in (64, 128)
              for dtype in (torch.bfloat16, torch.float16)]
    shapes += [(FP32_SHAPES[d][0], d, torch.float32) for d in (64, 128)]
    g = torch.Generator(device="cuda").manual_seed(10)
    for (b, h, s), d, dtype in shapes:
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", dtype=dtype, generator=g)
                       for _ in range(4))
        runs = []
        for _ in range(2):
            out, lse = fa.flash_fwd(q, k, v, d ** -0.5)
            runs.append((out, lse, *fa.flash_bwd(q, k, v, out, lse, do, d ** -0.5)))
        torch.cuda.synchronize()
        same = [name for name, a, c in zip(("out", "lse", "dq", "dk", "dv"), *runs)
                if torch.equal(a, c)]
        print(f"  B*H={b * h} S={s} D={d} {str(dtype)[6:]} twice: bitwise equal {same}")
        check(len(same) == 5, f"head_dim-{d} {dtype} kernels differ from run to run")


def check_unaligned(torch, fa):
    """A contiguous view one element into its storage does not start on a
    16-byte boundary: the wrappers raise before any launch, at every head
    dim and dtype."""
    for d, dtype in fa.ROUTES:
        base = torch.zeros(64 * 2 * d + 1, device="cuda", dtype=dtype)
        bad = base[1:].view(1, 64, 2, d)
        counts = dict(fa.LAUNCHES)
        try:
            fa.flash_fwd(bad, bad, bad, 1.0)
        except ValueError as e:
            check("16-byte" in str(e), f"D={d} {dtype}: {e}")
        else:
            raise PhaseError(f"D={d} {dtype}: an unaligned input was launched")
        check(fa.LAUNCHES == counts, f"D={d} {dtype}: launches on an unaligned input")
    print(f"  unaligned inputs refused before any launch at {sorted(set(d for d, _ in fa.ROUTES))}")


def time_kernels(torch, fa, dtype):
    """The bf16 or fp16 (``dtype``) kernels at the main shapes and the video
    shape (head_dim 128, 12288 tokens): device time (torch.profiler; ``ms``)
    and CUDA events over 20 launches (``events_ms``, which read the host's
    time to enqueue where a launch takes longer to enqueue than to run)
    beside the bound (fp16 and bf16 share the tensor cores' 989 TFLOP/s),
    the plain version and scaled_dot_product_attention's device time on the
    same inputs."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    name = {torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    timings = {}
    for d, shapes in TIMED_SHAPES.items():
        kf, kdq, kdkv = kernel_names(fa, d, dtype)
        for b, h, s, calls in shapes:
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda", dtype=dtype,
                                       generator=g) for _ in range(4))
            scale = d ** -0.5
            out, lse = fa.flash_fwd(q, k, v, scale)
            _, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, scale)
            lib, lib_fwd_bwd = sdpa_ms(torch, F, q, k, v, do)
            calls_of = {
                kf: (lambda: fa.flash_fwd(q, k, v, scale),
                     lambda: fa.flash_forward_reference(q, k, v, scale), lib[0]),
                kdq: (lambda: fa.flash_bwd_dq(q, k, v, out, lse, do, scale),
                      lambda: fa.flash_bwd_dq_reference(q, k, v, out, lse, do, scale), lib[1]),
                kdkv: (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale),
                       lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale),
                       lib[1]),
            }
            for (kname, (kernel, plain, lib_ms)), w in zip(calls_of.items(),
                                                            work(b, h, s, d, 2)):
                row = timing_row(torch, kernel, plain, lib_ms, w, H100_BF16_FLOPS)
                row.update(shape=f"B*H={b * h} S={s} D={d} {name}", calls_per_micro_step=calls,
                           library_fwd_bwd_ms=lib_fwd_bwd)
                timings.setdefault(kname, []).append(row)
                print_row(kname, row, "" if kname == kf else
                          f" (dq,dk,dv together; fwd+bwd {lib_fwd_bwd:.4f} ms)")
            del q, k, v, do, out, lse, delta
            torch.cuda.empty_cache()
    return timings


def host_us(torch, fn, n: int = 50) -> float:
    """The host's time to issue one call of ``fn`` (mean over ``n`` calls,
    no sync between them), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def time_ops(torch, fa):
    """At each bf16 main shape, the dispatcher ops (``aozora::flash_fwd``;
    ``aozora::flash_bwd``, the dQ then the dK/dV kernel) against the
    wrappers they call: CUDA events over 20 calls, and the host's time to
    issue a call. Also the host's time to issue the forward of the flash
    entry (``flash_attention`` on inputs that require gradients: the
    autograd Function over the op) against an autograd Function that calls
    the wrapper directly."""

    class Direct(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            out, lse = fa.flash_fwd(q, k, v, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, dout):
            raise AssertionError("forward only")

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for d, shapes in MAIN_SHAPES.items():
        for b, h, s, _ in shapes:
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda", dtype=torch.bfloat16,
                                       generator=g) for _ in range(4))
            scale = d ** -0.5
            out, lse = fa.flash_fwd(q, k, v, scale)
            pairs = {"forward": (lambda: fa.flash_fwd(q, k, v, scale),
                                 lambda: torch.ops.aozora.flash_fwd(q, k, v, scale)),
                     "backward": (lambda: fa.flash_bwd(q, k, v, out, lse, do, scale),
                                  lambda: torch.ops.aozora.flash_bwd(q, k, v, out, lse,
                                                                     do, scale))}
            for role, (wrapper, op) in pairs.items():
                row = {"shape": f"B*H={b * h} S={s} D={d} bf16", "role": role,
                       "wrapper_events_ms": cuda_ms(torch, wrapper),
                       "op_events_ms": cuda_ms(torch, op),
                       "wrapper_host_us": host_us(torch, wrapper),
                       "op_host_us": host_us(torch, op)}
                rows.append(row)
                print(f"  op {role:8s} {row['shape']}: events {row['op_events_ms']:.4f} ms "
                      f"through the op, {row['wrapper_events_ms']:.4f} ms through the "
                      f"wrapper; host {row['op_host_us']:.1f} us a call through the op, "
                      f"{row['wrapper_host_us']:.1f} us through the wrapper")
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
            row = {"shape": f"B*H={b * h} S={s} D={d} bf16", "role": "entry forward",
                   "entry_host_us": host_us(
                       torch, lambda: fa.flash_attention(qg, kg, vg, scale=scale)),
                   "direct_host_us": host_us(
                       torch, lambda: Direct.apply(qg, kg, vg, scale))}
            rows.append(row)
            print(f"  entry forward {row['shape']}: host {row['entry_host_us']:.1f} us a "
                  f"call through flash_attention, {row['direct_host_us']:.1f} us through "
                  f"an autograd Function over the wrapper")
            del q, k, v, do, out, lse, qg, kg, vg
            torch.cuda.empty_cache()
    return rows


def sdpa_ms(torch, F, q, k, v, do):
    """Device ms of scaled_dot_product_attention on (B, S, H, D) inputs:
    ((forward, backward), forward + backward); a yardstick the port never
    calls."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach()))
    bwd = device_ms(torch, lambda: torch.autograd.grad(ref, (qt, kt, vt), dot,
                                                       retain_graph=True))
    fwd_bwd = device_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot))
    return (fwd, bwd), fwd_bwd


def timing_row(torch, kernel, plain, lib_ms, w, peak):
    """Device ms and CUDA-event ms of ``kernel``, the plain version's ms,
    the bound at ``peak`` flop/s for the (flops, bytes) ``w``."""
    ms = device_ms(torch, kernel)
    bms, bound_by = bound(*w, peak)
    return {"ms": ms, "events_ms": cuda_ms(torch, kernel),
            "plain_ms": cuda_ms(torch, plain, 5, 1), "bound_ms": bms, "bound_by": bound_by,
            "library_ms": lib_ms, "tflops": w[0] / ms / 1e9}


def print_row(kname, row, lib_note=""):
    print(f"  {kname:22s} {row['shape']}: kernel {row['ms']:.4f} ms device "
          f"({row['events_ms']:.4f} ms events), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_ms'] / row['ms']:.1%}), plain {row['plain_ms']:.4f} ms, sdpa "
          f"{row['library_ms']:.4f} ms{lib_note}, {row['tflops']:.1f} TFLOP/s")


def time_fp32(torch, fa):
    """The fp32 kernels at head_dim 64 and 128 at ``FP32_SHAPES``, as
    ``time_kernels`` times the bf16 ones. Bound: the flop as the three TF32
    products the kernels run them as, at the TF32 peak (``bound_ms``), and
    beside it as fp32 FMAs at the CUDA cores' peak (``bound_fp32_fma_ms``).
    At each shape out, dq, dk and dv are first held at 1e-4 of the plain
    version's largest magnitude, as in ``kernel_phase`` (which does not
    reach the full-width shapes)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(11)
    timings = {}
    for d, b, h, s in ((d, *shape) for d, shapes in FP32_SHAPES.items() for shape in shapes):
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g) for _ in range(4))
        scale = d ** -0.5
        out, lse = fa.flash_fwd(q, k, v, scale)
        dq, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        ref_out, _ = fa.flash_forward_reference(q, k, v, scale)
        ref_dq, ref_delta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, scale)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, ref_delta, scale)
        for what, got, want in (("out", out, ref_out), ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                                ("dv", dv, ref_dv)):
            err = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item()
            print(f"  fp32 B={b} H={h} S={s} D={d} {what:3s} max_abs_err {err:.3e}  tol {tol:.3e}")
            check(err <= tol, f"fp32 B={b} H={h} S={s} D={d} {what}: error {err} > tolerance {tol}")
        del dq, dk, dv, ref_out, ref_dq, ref_delta, ref_dk, ref_dv
        lib, _ = sdpa_ms(torch, F, q, k, v, do)
        kf, kdq, kdkv = kernel_names(fa, d, torch.float32)
        calls_of = {
            kf: (lambda: fa.flash_fwd(q, k, v, scale),
                 lambda: fa.flash_forward_reference(q, k, v, scale), lib[0]),
            kdq: (lambda: fa.flash_bwd_dq(q, k, v, out, lse, do, scale),
                  lambda: fa.flash_bwd_dq_reference(q, k, v, out, lse, do, scale), lib[1]),
            kdkv: (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale),
                   lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale), lib[1]),
        }
        for (kname, (kernel, plain, lib_ms)), w in zip(calls_of.items(), work(b, h, s, d, 4)):
            row = timing_row(torch, kernel, plain, lib_ms, (3 * w[0], w[1]), H100_TF32_FLOPS)
            row["shape"] = f"B={b} H={h} S={s} D={d} fp32"
            row["tflops"] = w[0] / row["ms"] / 1e9
            row["bound_fp32_fma_ms"] = bound(*w, H100_FP32_FLOPS)[0]
            note = "" if kname == kf else " (dq,dk,dv together)"
            note += (f" (3 TF32 products; as fp32 FMAs {row['bound_fp32_fma_ms']:.4f} ms, "
                     f"{row['bound_fp32_fma_ms'] / row['ms']:.1%})")
            timings.setdefault(kname, []).append(row)
            print_row(kname, row, note)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return timings


def time_d512(torch, fa):
    """The head_dim-512 forward at the SD-VAE mid-attention shape: the fp32
    kernel (the preview decoder's) and the bf16 one (the encoder's flash
    route): kernel, plain version and scaled_dot_product_attention (a
    yardstick the port never calls), by CUDA events over 10 launches.
    Bound: 4 * S^2 * 512 flop against q, k, v read and out and lse written
    once; the bf16 kernel's flop at the bf16 tensor-core peak, the fp32
    kernel's as the three TF32 products it runs them as at the TF32 peak
    (``bound_ms``) and, beside it, as fp32 FMAs at the CUDA cores' peak
    (``bound_fp32_fma_ms``)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    timings = {}
    for dtype, elem, products, peak in ((torch.float32, 4, 3, H100_TF32_FLOPS),
                                        (torch.bfloat16, 2, 1, H100_BF16_FLOPS)):
        q, k, v = (torch.randn(1, VAE_TOKENS, 1, 512, device="cuda", dtype=dtype,
                               generator=g) for _ in range(3))
        scale = 512 ** -0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, scale), 10, 2)
        plain = cuda_ms(torch, lambda: fa.flash_forward_reference(q, k, v, scale), 3, 1)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10, 2)
        flops = 4 * VAE_TOKENS * VAE_TOKENS * 512
        nbytes = 4 * VAE_TOKENS * 512 * elem + 4 * VAE_TOKENS
        bms, bound_by = bound(products * flops, nbytes, peak)
        name = str(dtype).replace("torch.", "")
        kname = fa.route(512, dtype, "forward")[0]
        row = {"shape": f"B*H=1 S={VAE_TOKENS} D=512 {name}",
               "calls_per_preview": 1 if dtype == torch.float32 else 0,
               "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": bound_by,
               "library_ms": lib, "tflops": flops / ms / 1e9}
        note = ""
        if dtype == torch.float32:
            row["bound_fp32_fma_ms"] = bound(flops, nbytes, H100_FP32_FLOPS)[0]
            note = (f" (3 TF32 products; as fp32 FMAs {row['bound_fp32_fma_ms']:.4f} ms, "
                    f"{row['bound_fp32_fma_ms'] / ms:.1%})")
        timings[kname] = [row]
        print(f"  {kname:22s} B*H=1 S={VAE_TOKENS} D=512 {name}: kernel "
              f"{ms:.4f} ms, bound {bms:.4f} ms ({bms / ms:.1%}){note}, plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return timings


def k6_bound(sites, elem=2):
    """K6 at ``sites``, batch 1: a bound by bytes, x read once and y written
    once per site (the NCHW kernel moves just that; the NHWC one reads x a
    second time, mostly from L2)."""
    nbytes = [2 * elem * side * side * c for side, c in sites]
    per_site = [bound(0, b)[0] for b in nbytes]
    largest = max(zip(nbytes, sites))[1]
    return {"sites": len(sites), "largest_site": f"{largest[0]}x{largest[0]}x{largest[1]}",
            "largest_bound_ms": max(per_site), "bound_ms_per_forward": sum(per_site),
            "bytes_per_forward": sum(nbytes)}


def device_ms_by_kernel(torch, fn, prefix: str):
    """Device ms of one call of ``fn`` by kernel, for the kernels whose name
    starts with ``prefix`` (torch.profiler's CUDA activity; {} where the
    profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(rf"\b({prefix}\w*)", e.key)
        if found and e.self_device_time_total > 0:
            out[found.group(1)] = out.get(found.group(1), 0.0) + e.self_device_time_total / 1e3
    return out


# --------------------------------------------------------------------------
# 9: K5, the stats entry points and the one-card ring
# --------------------------------------------------------------------------

def k5_phase(torch):
    """Returns ({kernel: max abs err}, {kernel: timing row}, launches,
    ring timings)."""
    phase("k5")
    import torch.nn.functional as F
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    from aozora_sdxl_training_tpu_torch.ops import ring_attention as ring
    (b, h, s_full, _), = MAIN_SHAPES[128]
    d, bf16 = 128, torch.bfloat16
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(b, s_full, h, d, device="cuda", dtype=bf16, generator=g)
                   for _ in range(4))
    ref_out, ref_lse = fa.flash_fwd_stats_reference(q, k, v, scale)
    ref_grads = fa.flash_bwd_stats_reference(q, k, v, ref_out, ref_lse, do, scale)
    rel_tol = 2e-2       # bf16 kernels, fp32 accumulation; lse 1e-3 absolute

    def held(label, what, got, want, tol=None):
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{label} {what}: non-finite")
        err = (got - want).abs().max().item()
        tol = rel_tol * want.abs().max().item() if tol is None else tol
        print(f"  {label:34s} {what:5s} max_abs_err {err:.3e}  tol {tol:.3e}")
        check(err <= tol, f"{label} {what}: error {err} > tolerance {tol}")
        return err

    max_err = {"flash_fwd_stats": 0.0, "flash_bwd_stats": 0.0}
    for n in (2, 4):
        # rank 0's q rows against rank 1's KV shard (the first hop's pair)
        sh = s_full // n
        q0, do0 = q[:, :sh].contiguous(), do[:, :sh].contiguous()
        k1, v1 = k[:, sh:2 * sh].contiguous(), v[:, sh:2 * sh].contiguous()
        label = f"hop S={sh} B*H={b * h} D={d}"
        out, lse = fa.flash_fwd_stats(q0, k1, v1)
        want_out, want_lse = fa.flash_fwd_stats_reference(q0, k1, v1, scale)
        e = held(label, "out", out, want_out)
        held(label, "lse", lse, want_lse, 1e-3)
        g_out, g_lse = ref_out[:, :sh].contiguous(), ref_lse[:, :sh].contiguous()
        got = fa.flash_bwd_stats(q0, k1, v1, g_out, g_lse, do0)
        want = fa.flash_bwd_stats_reference(q0, k1, v1, g_out, g_lse, do0, scale)
        eb = max(held(label, name, a, w) for name, a, w in zip(("dq", "dk", "dv"), got, want))
        if n == 2:
            max_err = {"flash_fwd_stats": e, "flash_bwd_stats": eb}

    # the ring's hop schedule on one card: K5's main path here, its launches
    # counted from 0
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    composed = {n: ring.ring_on_one_device(q, k, v, do, n) for n in (2, 4)}
    torch.cuda.synchronize()
    launches = dict(fa.STATS_LAUNCHES)
    kernels = {kname: c for kname, c in fa.LAUNCHES.items() if c}
    pairs = sum(n * n for n in composed)
    print(f"  one-card ring, sp 2 and 4: entry point calls {launches}, kernel "
          f"launches {kernels}")
    check(launches == {"flash_fwd_stats": pairs, "flash_bwd_stats": pairs}
          and kernels == {"flash_fwd_d128": pairs, "flash_bwd_dq_d128": pairs,
                          "flash_bwd_dkv_d128": pairs},
          f"one-card ring launches {launches} {kernels}, expected {pairs} each")
    for n, (out, lse, dq, dk, dv) in composed.items():
        label = f"ring sp={n} vs full S={s_full}"
        held(label, "out", out, ref_out)
        held(label, "lse", lse, ref_lse, 1e-3)
        for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_grads):
            held(label, name, a, w)
    del composed, ref_grads
    torch.cuda.empty_cache()

    timings = {"flash_fwd_stats": [], "flash_bwd_stats": []}
    # the image ring's hops at sp 2 and 4, then the video ring's at sp 2: a
    # 3-latent-frame clip's 12288 tokens, 6144 a rank (the anima_sp phase)
    for n, sh, what in ((2, s_full // 2, "sp 2 hop"), (4, s_full // 4, "sp 4 hop"),
                        (SP, VIDEO_TOKENS // SP, "video sp 2 hop")):
        if sh <= s_full:
            qs, ks, vs, dos = (t[:, :sh].contiguous() for t in (q, k, v, do))
        else:
            qs, ks, vs, dos = (torch.randn(b, sh, h, d, device="cuda", dtype=bf16,
                                           generator=g) for _ in range(4))
            label = f"video hop S={sh} B*H={b * h} D={d}"
            out, lse = fa.flash_fwd_stats(qs, ks, vs)
            want_out, want_lse = fa.flash_fwd_stats_reference(qs, ks, vs, scale)
            held(label, "out", out, want_out)
            held(label, "lse", lse, want_lse, 1e-3)
            got = fa.flash_bwd_stats(qs, ks, vs, want_out, want_lse, dos)
            want = fa.flash_bwd_stats_reference(qs, ks, vs, want_out, want_lse, dos, scale)
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                held(label, name, a, w)
            del want_out, want_lse, got, want
        out, lse = fa.flash_fwd_stats(qs, ks, vs)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qs, ks, vs))
        ref = F.scaled_dot_product_attention(qt, kt, vt)
        dot = dos.transpose(1, 2)
        sdpa_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach()))
        sdpa_bwd = device_ms(torch, lambda: torch.autograd.grad(
            ref, (qt, kt, vt), dot, retain_graph=True))
        (wf, wdq, wdkv), act, row = work(b, h, sh, d, 2), b * h * sh * d * 2, b * h * sh
        rows = {
            "flash_fwd_stats": (
                device_ms(torch, lambda: fa.flash_fwd_stats(qs, ks, vs)),
                cuda_ms(torch, lambda: fa.flash_fwd_stats_reference(qs, ks, vs, scale), 5, 1),
                sdpa_fwd, wf[0], 4 * act + 4 * row),
            "flash_bwd_stats": (
                device_ms(torch, lambda: fa.flash_bwd_stats(qs, ks, vs, out, lse, dos)),
                cuda_ms(torch, lambda: fa.flash_bwd_stats_reference(
                    qs, ks, vs, out, lse, dos, scale), 5, 1),
                sdpa_bwd, wdq[0] + wdkv[0], 8 * act + 4 * row)}
        for kname, (ms, plain, lib, flops, nbytes) in rows.items():
            bms, bound_by = bound(flops, nbytes)
            timings[kname].append({
                "shape": f"B*H={b * h} Sq=Skv={sh} D={d} bf16 ({what})",
                # ANIMA_BASE's 28 blocks, n hops each, Full remat: the
                # forward runs again in the recompute
                "calls_per_micro_step_per_rank": (2 if kname == "flash_fwd_stats" else 1)
                * 28 * n,
                "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": bound_by,
                "library_ms": lib, "tflops": flops / ms / 1e9})
            print(f"  {kname:16s} B*H={b * h} S={sh:5d} D={d}: kernel {ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({bms / ms:.1%}), plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s")
        del qs, ks, vs, dos, out, lse, qt, kt, vt, ref
        torch.cuda.empty_cache()

    # the composed ring (forward and backward, all ranks on one card) beside
    # K4a + K4b over the same 4096 tokens
    def full():
        out, lse = fa.flash_fwd(q, k, v, scale)
        fa.flash_bwd(q, k, v, out, lse, do, scale)

    ring_ms = {"k4_fwd_bwd_ms": cuda_ms(torch, full, 5, 1)}
    for n in (2, 4):
        ring_ms[f"ring_sp{n}_fwd_bwd_ms"] = cuda_ms(
            torch, lambda: ring.ring_on_one_device(q, k, v, do, n), 5, 1)
    print(f"  forward + backward over S={s_full}: K4a + K4b {ring_ms['k4_fwd_bwd_ms']:.4f} "
          f"ms; one-card ring sp 2 {ring_ms['ring_sp2_fwd_bwd_ms']:.4f} ms, sp 4 "
          f"{ring_ms['ring_sp4_fwd_bwd_ms']:.4f} ms")
    del q, k, v, do, ref_out, ref_lse
    torch.cuda.empty_cache()
    return max_err, timings, launches, ring_ms


# --------------------------------------------------------------------------
# 10: K6, fused GroupNorm + SiLU
# --------------------------------------------------------------------------

def k6_phase(torch):
    """Returns {layout: (max abs err at the main shapes in bf16, launches of
    the layout's main-path run, timing row)}: "nhwc" (the op, forward and
    backward, over one forward's sites) and "nchw" (the SDXL_BASE UNet with
    fused_gn=True); each timing row holds the same sites in fp16 under
    "fp16" (with its max abs err)."""
    phase("k6")
    import torch.nn.functional as F
    from aozora_sdxl_training_tpu_torch.ops import groupnorm_silu as gn
    from aozora_sdxl_training_tpu_torch.tools.k6_probe import forward_sites, graph_ms
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # the 34 resnet norm1/norm2 sites of one SDXL_BASE forward at 1024px
    # (unet.py::_gn_silu): (side, C)
    sites = forward_sites()
    g = torch.Generator(device="cuda").manual_seed(8)
    forward = {"nhwc": gn.group_norm_silu_forward, "nchw": gn.group_norm_silu_nchw_forward}
    plain = {"nhwc": gn.group_norm_silu_reference, "nchw": gn.group_norm_silu_nchw_reference}

    def inputs(shape, dtype, mean=0.5):
        c = shape[-1]
        x = (torch.randn(shape, device="cuda", generator=g) * 2 + mean).to(dtype)
        return (x, 1 + 0.3 * torch.randn(c, device="cuda", generator=g),
                0.2 * torch.randn(c, device="cuda", generator=g))

    def to_layout(x, layout):
        return x if layout == "nhwc" else x.permute(0, 3, 1, 2).contiguous()

    # tolerance: bf16 2% of the largest reference magnitude (one bf16
    # rounding of the output), fp16 5e-3 (one fp16 rounding, 2^-11, with
    # room), fp32 1e-4 of it (fp32 statistics summed in another order); the
    # large mean 1e-3 in fp32 (E[x^2] - mean^2 would lose it). Each case
    # runs in both layouts (NCHW: the NHWC values transposed).
    tol = {bf16: 2e-2, f16: 5e-3, f32: 1e-4}
    cases = ([(f"{side}x{side}x{c}", (1, side, side, c), 32, 0.5)
              for side, c in sorted(set(sites))]
             + [("ragged B=2 37x53x640", (2, 37, 53, 640), 32, 0.5),
                ("C=320 8x8", (1, 8, 8, 320), 32, 0.5),
                ("C=36 (no 16-byte loads in bf16)", (1, 16, 16, 36), 12, 0.5),
                ("mean 100, 32x32x320", (1, 32, 32, 320), 32, 100.0)])
    max_err = {(layout, dtype): 0.0 for layout in ("nhwc", "nchw") for dtype in (bf16, f16)}
    for label, shape, groups, mean in cases:
        for dtype in (bf16, f16, f32):
            x, scale, bias = inputs(shape, dtype, mean)
            if mean > 1:
                xd = x.double().reshape(shape[0], -1, groups, shape[-1] // groups)
                xd = ((xd - xd.mean(dim=(1, 3), keepdim=True))
                      / (xd.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-5).sqrt())
                z = xd.reshape(shape) * scale.double() + bias.double()
                ref_nhwc, rel = z * torch.sigmoid(z), max(tol[dtype], 1e-3)
            for layout in ("nhwc", "nchw"):
                xl = to_layout(x, layout)
                y = forward[layout](xl, scale, bias, groups)
                torch.cuda.synchronize()
                if mean > 1:
                    ref = to_layout(ref_nhwc, layout)
                else:
                    ref, rel = plain[layout](xl, scale, bias, groups), tol[dtype]
                check(bool(torch.isfinite(y).all()) and y.shape == xl.shape,
                      f"K6 {layout} {label}: non-finite or misshapen")
                err = (y.double() - ref.double()).abs().max().item()
                bar = rel * ref.abs().max().item()
                name = str(dtype).replace("torch.", "")
                print(f"  {layout} {label:34s} {name:8s} max_abs_err {err:.3e}  tol {bar:.3e}")
                check(err <= bar, f"K6 {layout} {label} {name}: error {err} > tolerance {bar}")
                if dtype != f32 and label[0].isdigit():
                    max_err[layout, dtype] = max(max_err[layout, dtype], err)
        torch.cuda.empty_cache()

    # two calls on the same input are bit-identical (fixed fold orders), at
    # the widest site in bf16, fp16 and fp32 (where the NCHW slices outgrow
    # shared memory and their tails are read twice)
    for dtype in (bf16, f16, f32):
        x, scale, bias = inputs((1, 128, 128, 960), dtype)
        for layout in ("nhwc", "nchw"):
            xl = to_layout(x, layout)
            same = torch.equal(forward[layout](xl, scale, bias, 32),
                               forward[layout](xl, scale, bias, 32))
            print(f"  {layout} 128x128x960 {dtype}: two calls bit-identical: {same}")
            check(same, f"K6 {layout} {dtype}: two calls differ")
    del x, xl
    torch.cuda.empty_cache()

    # the NHWC op over one forward's 34 sites, forward and backward: the
    # NHWC entry's main path here, its launches counted from 0
    xs = [inputs((1, side, side, c), bf16) for side, c in sites]
    torch.cuda.synchronize()
    gn.reset_launch_counts()
    for x, scale, bias in xs:
        xg = x.detach().requires_grad_(True)
        y = gn.group_norm_silu(xg, scale, bias, groups=32, use_pallas=True)
        y.float().square().mean().backward()
        check(bool(torch.isfinite(xg.grad.float()).all()), "K6 op: non-finite gradient")
    torch.cuda.synchronize()
    nhwc_launches = gn.LAUNCHES["group_norm_silu"]
    print(f"  the NHWC op over {len(sites)} sites, forward and backward: "
          f"{nhwc_launches} launches")
    check(nhwc_launches == len(sites) and gn.LAUNCHES["group_norm_silu_nchw"] == 0,
          f"K6 op: {gn.LAUNCHES} for {len(sites)} sites")

    # both layouts over the 34 sites as CUDA graphs, beside the bound, the
    # plain versions and F.silu(F.group_norm(...)): on the NCHW view of the
    # NHWC memory (the earlier PRs' yardstick) and on contiguous NCHW; then
    # the same sites in fp16 against the same bytes bound
    def run(fn, args):
        return lambda: [fn(x, scale, bias) for x, scale, bias in args]

    def library(x, s, b):
        return F.silu(F.group_norm(x, 32, s.to(x.dtype), b.to(x.dtype), 1e-5))

    def timed(args, layout, name, lib_nchw, detail):
        kernel = run(lambda x, s, b: forward[layout](x, s, b, 32), args)
        row = {**k6_bound(sites),
               "shape": f"{len(sites)} SDXL_BASE resnet sites at 1024px, B=1, {name}, {layout}",
               "ms": graph_ms(kernel),
               "plain_ms": graph_ms(run(lambda x, s, b: plain[layout](x, s, b, 32), args)),
               "library_ms": lib_nchw, "bound_by": "bytes"}
        row["bound_ms"] = row["bound_ms_per_forward"]
        print(f"  {layout} {name}: {len(sites)} sites a forward "
              f"({row['bytes_per_forward'] / 1e6:.1f} MB in + out): kernel {row['ms']:.4f} ms "
              f"(CUDA graph), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.1%}), plain {row['plain_ms']:.4f} ms, "
              f"F.silu(F.group_norm) {lib_nchw:.4f} ms on contiguous NCHW; largest site "
              f"{row['largest_site']} bound {row['largest_bound_ms']:.4f} ms")
        if not detail:
            return row
        row["ms_eager"] = cuda_ms(torch, kernel, 10, 2)
        row["device_ms_by_kernel"] = device_ms_by_kernel(torch, kernel, "gn_")
        # each distinct site alone: 10 launches of it in a CUDA graph
        by_site = {}
        for side, c in sorted(set(sites)):
            x, s_, b_ = args[sites.index((side, c))]
            ms = graph_ms(lambda: [forward[layout](x, s_, b_, 32) for _ in range(10)])
            by_site[f"{side}x{side}x{c}"] = (1e3 * ms / 10, 1e3 * bound(0, 4 * side * side * c)[0])
        row["us_by_site_and_bound"] = by_site
        print(f"  {layout}: {row['ms_eager']:.4f} ms eager; device time of one such forward by "
              f"kernel (torch.profiler): {row['device_ms_by_kernel']}")
        print(f"  {layout}: us a launch by site (bound): " + ", ".join(
            f"{k} {t:.2f} ({b:.2f})" for k, (t, b) in by_site.items()))
        return row

    rows = {}
    for dtype, name in ((bf16, "bf16"), (f16, "fp16")):
        if dtype != bf16:
            xs = [(x.to(dtype), scale, bias) for x, scale, bias in xs]
        xs_nchw = [(to_layout(x, "nchw"), scale, bias) for x, scale, bias in xs]
        lib_nchw = graph_ms(run(library, xs_nchw))
        for layout, args in (("nhwc", xs), ("nchw", xs_nchw)):
            row = timed(args, layout, name, lib_nchw, dtype == bf16)
            if dtype == bf16:
                row["library_ms_nchw_view_of_nhwc"] = graph_ms(
                    run(lambda x, s, b: library(x.permute(0, 3, 1, 2), s, b), xs))
                print(f"  {layout}: F.silu(F.group_norm) on the NCHW view of NHWC "
                      f"{row['library_ms_nchw_view_of_nhwc']:.4f} ms")
                rows[layout] = row
            else:
                rows[layout]["fp16"] = {**row, "max_abs_err": max_err[layout, f16]}
    del xs, xs_nchw
    torch.cuda.empty_cache()
    nchw_launches = k6_unet(torch, gn)
    return {"nhwc": (max_err["nhwc", bf16], nhwc_launches, rows["nhwc"]),
            "nchw": (max_err["nchw", bf16], nchw_launches, rows["nchw"])}


def k6_unet(torch, gn):
    """One SDXL_BASE UNet forward and backward at 1024px, B=1, bf16 compute,
    flash attention, random fp32 weights (init_params, seed 2024), with
    fused_gn False and then True (a warm-up run of each first); then the
    same in fp16 compute (the fp16 kernels: K6 and K1-K3). Returns the NCHW
    K6 launches of the bf16 True run. The two routes differ by one 16-bit
    rounding per site (the unfused one rounds the norm's output, then the
    SiLU's; the fused one only the SiLU's), 34 sites deep: output and the
    gradient of every parameter, as one vector, are held at 5e-2 relative
    L2 error (1.5e-2 and 2.2e-2 on the TINY UNet in bf16). The loss is the
    output's sum against a unit-normal tangent: its mean over the 65,536
    output elements would start the fp16 backward at ~1e-5, in fp16's
    subnormal range (without loss scaling, as in the JAX package), where
    both routes lose the gradients' small terms differently."""
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE as cfg
    from aozora_sdxl_training_tpu_torch.models.sdxl.unet import init_params
    g = torch.Generator(device="cuda").manual_seed(2024)
    params = init_params(cfg, g)
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    sample = torch.randn(1, 128, 128, 4, device="cuda", generator=g)
    ctx = torch.randn(1, 77, cfg.cross_attention_dim, device="cuda", generator=g)
    pooled = torch.randn(1, cfg.pooled_projection_dim, device="cuda", generator=g)
    tangent = torch.randn(1, 128, 128, 4, device="cuda", generator=g)
    t = torch.tensor([500.0], device="cuda")
    time_ids = torch.tensor([[1024, 1024, 0, 0, 1024, 1024]], device="cuda",
                            dtype=torch.float32)
    for dtype in (torch.bfloat16, torch.float16):
        launches = k6_unet_run(torch, gn, params, names, cfg, dtype, sample, t, ctx, pooled,
                               time_ids, tangent)
        if dtype == torch.bfloat16:
            bf16_launches = launches
    del params
    torch.cuda.empty_cache()
    return bf16_launches


def k6_unet_run(torch, gn, params, names, cfg, dtype, sample, t, ctx, pooled, time_ids,
                tangent):
    """``k6_unet`` at one compute dtype; returns the True run's K6
    launches."""
    from aozora_sdxl_training_tpu_torch.models.sdxl.unet import unet_forward
    results, times, launches = {}, {}, {}
    name = {torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    for fused in (False, True):
        for timed in (False, True):
            for p in params.values():
                p.grad = None
            torch.cuda.synchronize()
            gn.reset_launch_counts()
            t0 = time.perf_counter()
            out = unet_forward(params, sample, t, ctx, pooled, time_ids, cfg=cfg,
                               attn_impl="flash", compute_dtype=dtype, fused_gn=fused)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (out.float() * tangent).sum().backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        times[fused] = (1e3 * (t1 - t0), 1e3 * (t2 - t1))
        launches[fused] = dict(gn.LAUNCHES)
        grads = [params[n].grad for n in names]
        check(bool(torch.isfinite(out.float()).all())
              and all(bool(torch.isfinite(gr).all()) for gr in grads),
              f"SDXL_BASE UNet {name} fused_gn={fused}: non-finite output or gradient")
        results[fused] = (out.detach().float(), grads)
        for p in params.values():
            p.grad = None
        print(f"  SDXL_BASE UNet 1024px B=1 {name}, fused_gn={fused}: forward "
              f"{times[fused][0]:.1f} ms, backward {times[fused][1]:.1f} ms (synced); "
              f"K6 launches {launches[fused]}")
    (o0, g0), (o1, g1) = results[False], results[True]
    out_err = ((o1 - o0).norm() / o0.norm()).item()
    num = sum(((a.double() - b.double()) ** 2).sum() for a, b in zip(g1, g0)).item()
    den = sum((b.double() ** 2).sum() for b in g0).item()
    grad_err = math.sqrt(num / den)
    worst = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(g1, g0))
    print(f"  {name} fused_gn True vs False: out rel L2 {out_err:.3e}, all-parameter "
          f"gradient rel L2 {grad_err:.3e} (tol 5e-2 each); worst single tensor {worst:.3e}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(launches[False] == {"group_norm_silu": 0, "group_norm_silu_nchw": 0}
          and launches[True] == {"group_norm_silu": 0, "group_norm_silu_nchw": 34},
          f"SDXL_BASE UNet {name} K6 launches {launches}, expected 34 NCHW with fused_gn")
    check(out_err <= 5e-2 and grad_err <= 5e-2, f"SDXL_BASE UNet {name}: fused_gn disagrees")
    del results, g0, g1, o0, o1, out, grads
    torch.cuda.empty_cache()
    return launches[True]["group_norm_silu_nchw"]


# --------------------------------------------------------------------------
# 4: small UNet, flash path against the einsum path
# --------------------------------------------------------------------------

def unet_phase(torch):
    """Returns the flash run's launches (the fp32 kernels at head_dim 64)."""
    phase("unet")
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import UNetConfig
    from aozora_sdxl_training_tpu_torch.models.sdxl.unet import init_params, unet_forward
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    cfg = UNetConfig(block_out_channels=(64, 128, 128), transformer_layers=(0, 1, 1),
                     num_heads=(1, 2, 2), mid_transformer_layers=1,
                     cross_attention_dim=64, norm_num_groups=8,
                     addition_time_embed_dim=16, pooled_projection_dim=40)
    g = torch.Generator(device="cuda").manual_seed(3)
    params = init_params(cfg, g)
    for p in params.values():
        p.requires_grad_(True)
    sample = torch.randn(2, 64, 64, 4, device="cuda", generator=g)
    ctx = torch.randn(2, 77, 64, device="cuda", generator=g)
    pooled = torch.randn(2, 40, device="cuda", generator=g)
    t = torch.tensor([10.0, 700.0], device="cuda")
    time_ids = torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2, device="cuda",
                            dtype=torch.float32)
    os.environ["AOZORA_FLASH_MIN_KV"] = "256"     # the 16x16 level too
    try:
        results, counts = {}, {}
        for impl in ("xla", "flash"):
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            out = unet_forward(params, sample, t, ctx, pooled, time_ids, cfg=cfg,
                               attn_impl=impl, compute_dtype=torch.float32)
            grads = torch.autograd.grad((out ** 2).mean(), list(params.values()))
            torch.cuda.synchronize()
            results[impl] = (out.detach(), grads)
            counts[impl] = {k: v for k, v in fa.LAUNCHES.items() if v}
    finally:
        del os.environ["AOZORA_FLASH_MIN_KV"]
    ref_out, ref_g = results["xla"]
    got_out, got_g = results["flash"]
    err = (got_out - ref_out).abs().max().item() / ref_out.abs().max().item()
    gerr = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
               for a, b in zip(got_g, ref_g))
    # each of the 11 self-attention sites (head_dim 64, fp32; 4 down, 1 mid,
    # 6 up) once forward and once backward
    want = {"flash_fwd_f32_d64": 11, "flash_bwd_dq_f32_d64": 11,
            "flash_bwd_dkv_f32_d64": 11}
    print(f"  fp32 UNet, flash vs einsum: out rel err {err:.3e} (tol 2e-2), "
          f"max param-grad rel err {gerr:.3e} (tol 5e-2); launches {counts['flash']}")
    check(counts["xla"] == {} and counts["flash"] == want,
          f"small UNet launches {counts}, expected {want} on the flash path")
    check(err <= 2e-2 and gerr <= 5e-2, "small UNet: flash path disagrees")
    return counts["flash"]


# --------------------------------------------------------------------------
# 5: small DiT, flash path against the einsum path
# --------------------------------------------------------------------------

def dit_phase(torch):
    """Returns the flash run's launches (the fp32 kernels at head_dim 128)."""
    phase("dit")
    from dataclasses import replace
    from aozora_sdxl_training_tpu_torch.models.anima.dit import (
        ANIMA_BASE, dit_forward, init_params)
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    # head_dim 128 like ANIMA_BASE, narrow and shallow; 64 x 64 latents give
    # 1024 self-attention tokens, the default flash threshold
    cfg = replace(ANIMA_BASE, model_channels=256, num_heads=2, num_blocks=2,
                  adaln_lora_dim=32, crossattn_emb_channels=64,
                  adapter_source_dim=64, adapter_target_dim=64, adapter_layers=2,
                  adapter_heads=4, adapter_vocab=1000, context_tokens=64)
    g = torch.Generator(device="cuda").manual_seed(4)
    params = init_params(cfg, g)
    for p in params.values():
        p.requires_grad_(True)
    latents = torch.randn(2, 1, 64, 64, 16, device="cuda", generator=g)
    t = torch.tensor([0.05, 0.9], device="cuda")
    ctx = torch.randn(2, 40, 64, device="cuda", generator=g)
    ids = torch.randint(1, 1000, (2, 40), device="cuda", generator=g)
    results, counts = {}, {}
    for impl in ("xla", "flash"):
        fa.reset_launch_counts()
        out = dit_forward(params, latents, t, ctx, cfg=cfg, t5_ids=ids,
                          attn_impl=impl, compute_dtype=torch.float32, remat="full")
        grads = torch.autograd.grad((out ** 2).mean(), list(params.values()))
        results[impl] = (out.detach(), grads)
        counts[impl] = {k: v for k, v in fa.LAUNCHES.items() if v}
    ref_out, ref_g = results["xla"]
    got_out, got_g = results["flash"]
    err = (got_out - ref_out).abs().max().item() / ref_out.abs().max().item()
    gerr = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
               for a, b in zip(got_g, ref_g))
    want = {"flash_fwd_f32_d128": 4, "flash_bwd_dq_f32_d128": 2,
            "flash_bwd_dkv_f32_d128": 2}
    print(f"  fp32 DiT (head_dim 128, 1024 tokens), flash vs einsum: out rel err "
          f"{err:.3e} (tol 2e-2), max param-grad rel err {gerr:.3e} (tol 5e-2); "
          f"launches {counts['flash']}")
    check(counts["xla"] == {} and counts["flash"] == want,
          f"small DiT launches {counts}, expected {want} on the flash path")
    check(err <= 2e-2 and gerr <= 5e-2, "small DiT: flash path disagrees")
    return counts["flash"]


# --------------------------------------------------------------------------
# 6: full-size SD-VAE, flash path against the einsum path
# --------------------------------------------------------------------------

def vae_phase(torch):
    """Encoder in bf16 (the route of tools_dev/cache_probe.py attn=flash)
    and decoder in fp32 (the preview's) on a random SD-VAE at 1024px: the
    flash path against the einsum path, one head_dim-512 launch each
    (flash_fwd_d512 in bf16, flash_fwd_f32_d512 in fp32). Tolerance: 5e-2
    (encoder, bf16 throughout) and 1e-5 (decoder, fp32 throughout) of the
    einsum output's largest magnitude. Returns (summary, the encoder's
    launches)."""
    phase("vae")
    from aozora_sdxl_training_tpu_torch.data.synthetic import random_vae_sd
    from aozora_sdxl_training_tpu_torch.models.sdxl import vae as vae_mod
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(7)
    params = vae_mod.params_from_sd_state(random_vae_sd(g), include_decoder=True)
    pixels = torch.rand(1, 1024, 1024, 3, device="cuda", generator=g) * 2 - 1
    latents = torch.randn(1, 128, 128, 4, device="cuda", generator=g) / 0.13025
    runs = {"encoder": (lambda impl: vae_mod.encoder_forward(
                params, pixels, compute_dtype=torch.bfloat16, attn_impl=impl), 5e-2,
                "flash_fwd_d512"),
            "decoder": (lambda impl: vae_mod.decoder_forward(
                params, latents, compute_dtype=torch.float32, attn_impl=impl), 1e-5,
                "flash_fwd_f32_d512")}
    summary = {}
    for part, (fn, tol, kname) in runs.items():
        out = {}
        for impl in ("xla", "flash"):
            with torch.inference_mode():
                fn(impl)                           # warm-up (cuDNN plans)
                torch.cuda.synchronize()
                fa.reset_launch_counts()
                t0 = time.perf_counter()
                y = fn(impl).float()
                torch.cuda.synchronize()
            out[impl] = (y, time.perf_counter() - t0,
                         {k: v for k, v in fa.LAUNCHES.items() if v})
        (ref, t_ref, n_ref), (got, t_got, n_got) = out["xla"], out["flash"]
        check(bool(torch.isfinite(got).all()), f"VAE {part}: non-finite output")
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        print(f"  {part} {tuple(got.shape)}: flash vs einsum rel err {err:.3e} (tol "
              f"{tol:g}); {t_got:.4f} s flash, {t_ref:.4f} s einsum; launches "
              f"{n_got} (einsum path: {n_ref})")
        check(n_ref == {} and n_got == {kname: 1},
              f"VAE {part}: launches {n_got}, expected one {kname} launch")
        check(err <= tol, f"VAE {part}: flash path disagrees ({err} > {tol})")
        summary[part] = {"rel_err": err, "flash_s": t_got, "einsum_s": t_ref,
                         "launches": n_got}
    return summary, summary["encoder"]["launches"]


# --------------------------------------------------------------------------
# 7-8: trainers
# --------------------------------------------------------------------------

def timed_steps(torch, module, names, marks: list):
    """Wraps the step factories ``names`` of ``module`` (names with "micro"
    or "apply" in them) so that each step ends in torch.cuda.synchronize()
    and appends (kind, host time) to ``marks``.
    The sync keeps the host from running ahead into the next step, so the
    times are the steps' own, host and device together. Returns a restore
    function."""
    originals = {k: getattr(module, k) for k in names}

    def wrap(kind, make):
        def make_timed(*args, **kwargs):
            fn = make(*args, **kwargs)

            def run(*a, **kw):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                marks.append((kind, time.perf_counter()))
                return out
            return run
        return make_timed

    for name, make in originals.items():
        setattr(module, name, wrap("apply" if "apply" in name else "micro", make))
    return lambda: [setattr(module, k, v) for k, v in originals.items()]


def step_times(marks: list, skip: int):
    """(s per micro step, s per apply step) from ``timed_steps`` marks,
    leaving out the first ``skip`` micro steps (warm-up) and the apply
    steps among them. A micro step runs from the end of the step before it
    (micro or apply) to its own end, so it holds the host's work between
    steps too; a checkpoint save (a "save" mark of ``timed_state_io`` at its
    end), a preview (a "preview" mark of ``timed_previews``) and the QAT
    projection after an apply step (a "project" mark of the repair phase)
    are left out of every step."""
    micro, apply_, n_micro, t_prev = [], [], 0, None
    for kind, t in marks:
        if kind in ("save", "preview", "project"):
            t_prev = t
            continue
        n_micro += kind == "micro"
        if n_micro > skip:
            (micro if kind == "micro" else apply_).append(t - t_prev)
        t_prev = t
    return micro, apply_


class Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def host_moments(state) -> dict:
    """A host copy of an optimizer state's moments: {field: {name: tuple of
    tensors}} (an int8 moment's codes and scales, or a float moment)."""
    return {field: {name: tuple(t.to("cpu", copy=True) for t in (m if isinstance(m, tuple) else (m,)))
                    for name, m in getattr(state, field).items()}
            for field in ("exp_avg", "exp_avg_sq")}


def timed_state_io(torch, module, marks: list, record: dict):
    """Wraps the trainer ``module``'s save_train_state and load_train_state
    and ``opt.adamw.restored_state``, each call synced and timed into
    ``record``: "save" [(s, file bytes)], "load" s, "restore" s (host to
    device). A save appends ("save", its end) to ``marks``, so that
    ``step_times`` leaves the checkpoint (model and state) out of the
    steps. With ``record["snapshot"]`` set, host copies of the saved and of
    the restored moments go into record["saved"] and record["restored"].
    Returns a restore function."""
    from aozora_sdxl_training_tpu_torch.opt import adamw
    save, load, restored = module.save_train_state, module.load_train_state, adamw.restored_state

    def save_train_state(path, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, **kwargs)
        record.setdefault("save", []).append((time.perf_counter() - t0,
                                              Path(path).stat().st_size))
        if record.get("snapshot"):
            record["saved"] = host_moments(kwargs["opt_state"])
        marks.append(("save", time.perf_counter()))

    def load_train_state(path, *args):
        t0 = time.perf_counter()
        out = load(path, *args)
        record["load"] = time.perf_counter() - t0
        return out

    def restored_state(*args, **kwargs):
        t0 = time.perf_counter()
        state = restored(*args, **kwargs)
        torch.cuda.synchronize()
        record["restore"] = time.perf_counter() - t0
        if record.get("snapshot"):
            record["restored"] = host_moments(state)
        return state

    module.save_train_state, module.load_train_state = save_train_state, load_train_state
    adamw.restored_state = restored_state

    def restore():
        module.save_train_state, module.load_train_state = save, load
        adamw.restored_state = restored
    return restore


def skip_final_save(module):
    """Makes the trainer ``module`` skip its end-of-run model save (a step
    save, ``*_step_N.safetensors``, is written): for runs whose final model
    nothing reads, each of which would otherwise write 4-7 GB. Returns a
    restore function."""
    name = ("save_merged_checkpoint" if hasattr(module, "save_merged_checkpoint")
            else "save_dit_model")
    real = getattr(module, name)

    def save(path, *args, **kwargs):
        if "_step_" in Path(path).name:
            return real(path, *args, **kwargs)
        print(f"  (the final model save to {Path(path).name} skipped: nothing reads it)")

    setattr(module, name, save)
    return lambda: setattr(module, name, real)


def run_trainer_cli(torch, cli_main, preset_path: Path, work_dir: Path, module,
                    step_names, log_name: str, state_io: dict | None = None,
                    marks: list | None = None, final_save: bool = True):
    """Runs a training CLI in ``work_dir`` with the flash launch counts set
    to 0 just before and read just after, its steps timed into ``marks``
    (a new list by default), its training state's saves and loads timed
    into ``state_io`` (``timed_state_io``) and its stdout kept; without
    ``final_save``, its end-of-run model save skipped (``skip_final_save``).
    Returns (stdout, marks, launches, peak GB, wall s)."""
    import gc
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    gc.collect()                  # an earlier trainer's weights, held in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    marks = [] if marks is None else marks
    restore = timed_steps(torch, module, step_names, marks)
    restore_io = timed_state_io(torch, module, marks, {} if state_io is None else state_io)
    restore_save = (lambda: None) if final_save else skip_final_save(module)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.chdir(work_dir), contextlib.redirect_stdout(Tee(sys.stdout, log)):
            cli_main(["--config", str(preset_path)])
    finally:
        restore_save()
        restore_io()
        restore()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    raw = log.getvalue()
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    (LOG_DIR / log_name).write_text(raw)
    return raw, marks, launches, peak_gb, wall


def check_progress(raw: str, pattern, steps: int):
    """Losses of the progress lines; checks the GUI grammar, one line per
    step, finite losses and grad norms, one optimizer block per GA steps."""
    segs = [seg.strip() for chunk in raw.split("\n") for seg in chunk.split("\r")]
    progress = [m for m in map(pattern.search, segs) if m]
    optim = [m for m in map(OPTIM_STEP.search, segs) if m]
    norms = [m for m in map(GRAD_NORM.search, segs) if m]
    check(len({int(m.group(1)) for m in progress}) == steps,
          f"{len(progress)} progress lines for {steps} steps")
    losses = [float(m.group(3)) for m in progress]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(len(optim) == steps // GA and len(norms) == steps // GA,
          f"{len(optim)} optimizer blocks, {len(norms)} grad-norm lines")
    check(all(math.isfinite(float(m.group(1))) for m in norms), "non-finite grad norm")
    return losses


def step_summary(marks, steps: int, fwd_flops: float, peak_gb: float,
                 wall: float, launches: dict, losses, **extra):
    """Step times after the first two micro steps; the model rate counts a
    micro step as 3 forwards (forward + backward, recompute not counted)."""
    import numpy as np
    micro, apply_ = step_times(marks, skip=2)
    check(len(micro) == steps - 2 and len(apply_) == steps // GA,
          f"step marks {marks}")
    s_micro, s_apply = float(np.median(micro)), float(np.mean(apply_))
    s_optim = GA * s_micro + s_apply
    tflops = 3 * fwd_flops / s_micro / 1e12
    summary = {"steps": steps, "losses": losses, **extra,
               "s_per_micro_step": micro, "s_per_apply_step": apply_,
               "median_s_per_micro_step": s_micro, "mean_s_per_apply_step": s_apply,
               "s_per_optimizer_step_ga4": s_optim, "model_tflops_per_s": tflops,
               "max_memory_allocated_gb": peak_gb, "wall_s": wall,
               "launches": {k: v for k, v in launches.items() if v}}
    print(f"  losses {losses}")
    print(f"  after the first two micro steps: {s_micro:.4f} s/micro-step (median "
          f"of {len(micro)}), {s_apply:.4f} s/apply step (mean of {len(apply_)}), "
          f"{s_optim:.4f} s per optimizer step at GA {GA} "
          f"({GA / s_optim:.3f} images/s); model {tflops:.1f} TFLOP/s in a micro "
          f"step ({tflops * 1e12 / H100_BF16_FLOPS:.1%} of the bf16 peak)")
    print(f"  max_memory_allocated {peak_gb:.2f} GB; trainer run {wall:.1f} s "
          f"(load and save included)")
    return summary


def check_launches(launches: dict, want: dict):
    """Exact counts for the kernels of the path, zero for every other."""
    full = {k: want.get(k, 0) for k in launches}
    print(f"  launches {launches}, expected {full}")
    check(launches == full, f"flash launches {launches} != {full}")


def timed_cache_encoders(torch, cache_builder, record: dict):
    """Wraps ``SdxlCacheEncoders.from_checkpoint`` so that each encoder call
    ends in torch.cuda.synchronize() and adds its host time and item count
    to ``record`` ("text", "latents"). Returns a restore function."""
    cls = cache_builder.SdxlCacheEncoders
    original = cls.from_checkpoint

    def timed(kind, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            s, n = record.get(kind, (0.0, 0))
            record[kind] = (s + time.perf_counter() - t0, n + len(args[0]))
            return out
        return run

    def from_checkpoint(*args, **kwargs):
        enc = original(*args, **kwargs)
        enc.encode_text = timed("text", enc.encode_text)
        enc.encode_latents = timed("latents", enc.encode_latents)
        return enc

    cls.from_checkpoint = from_checkpoint
    return lambda: setattr(cls, "from_checkpoint", original)


def cache_phase(torch, preset_path: Path, work_dir: Path, config):
    """The port's cache_datasets CLI on the images: builds the cache (no
    flash launch: the encoder's mid attention takes the einsum path), then
    a second run finds it current. Returns the cache pass's numbers."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.cli import cache_datasets
    from aozora_sdxl_training_tpu_torch.data import cache_builder
    from aozora_sdxl_training_tpu_torch.data import cache_store as cs
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa

    record: dict = {}
    restore = timed_cache_encoders(torch, cache_builder, record)
    logs = []
    for attempt in range(2):
        log = io.StringIO()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.chdir(work_dir), contextlib.redirect_stdout(Tee(sys.stdout, log)):
                cache_datasets.main(["--config", str(preset_path)])
        finally:
            if attempt == 1:
                restore()
        logs.append((log.getvalue(), time.perf_counter() - t0,
                     {k: v for k, v in fa.LAUNCHES.items() if v}))
    (first, wall, launches), (second, _, _) = logs
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    (LOG_DIR / "chip_smoke_cache.log").write_text(first + second)
    check(launches == {}, f"the cache pass launched flash kernels: {launches}")
    check("Encoding 2 caption payloads" in first and "Encoding 2 latents" in first,
          "the first cache run did not encode 2 captions and 2 latents")
    check("Encoding" not in second and "already cached" in second,
          "the second cache run encoded again")
    check(not cache_builder.check_if_caching_needed(config),
          "the cache check rejects the cache the CLI built")
    cache_dir = work_dir / "data" / cs.sdxl_cache_dir_name(False)
    index = cs.load_index(cache_dir)
    check(len(index["files"]) == 2, f"{len(index['files'])} items in the index")
    for item in index["files"]:
        te, te_meta = cs.load_payload(item["te_path"])
        lat, _ = cs.load_payload(item["lat_path"])
        shapes = {k: (v.shape, v.dtype.name) for k, v in {**te, **lat}.items()}
        check(shapes == {"embeds": ((77, 2048), "bfloat16"),
                         "pooled": ((1280,), "bfloat16"),
                         "latents": ((128, 128, 4), "bfloat16")},
              f"payload shapes {shapes}")
        check(all(np.isfinite(np.asarray(v, np.float32)).all()
                  for v in (*te.values(), *lat.values())), "non-finite payload")
        check(te_meta.get("caption", "").startswith("synthetic image"),
              f"caption metadata {te_meta.get('caption')}")
    (t_text, n_text), (t_lat, n_lat) = record["text"], record["latents"]
    print(f"  cache pass: {n_lat} latents at 1024x1024 in {t_lat:.4f} s "
          f"({t_lat / n_lat:.4f} s/latent), {n_text} captions in {t_text:.4f} s "
          f"({t_text / n_text:.4f} s/caption), CLI {wall:.1f} s (encoder load "
          f"included); second run encoded nothing")
    return {"s_per_latent_1024": t_lat / n_lat, "s_per_caption": t_text / n_text,
            "latents": n_lat, "captions": n_text, "cli_wall_s": wall}


def timed_previews(torch, cls, record: list, marks: list | None = None,
                   peaks: dict | None = None):
    """Wraps the renderer ``cls``'s ``maybe_render`` (``PreviewRenderer`` of
    SDXL, ``AnimaPreviewRenderer``) so that each call that renders is
    synced, its host time appended to ``record`` and a "preview" mark at its
    end to ``marks`` (``step_times`` then leaves it out of the steps). With
    ``peaks``, the peak memory before each preview (since the run's start
    or the last preview) goes to peaks["train"] and the preview's own to
    peaks["preview"]: the peak statistics are reset around each preview,
    so the run's last reading covers only what came after the last one."""
    original = cls.maybe_render

    def maybe_render(self, optimizer_step, *args, **kwargs):
        rendering = (self.enabled and self._cond is not None
                     and optimizer_step % self.every == 0)
        torch.cuda.synchronize()
        if rendering and peaks is not None:
            peaks.setdefault("train", []).append(torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = original(self, optimizer_step, *args, **kwargs)
        torch.cuda.synchronize()
        if rendering:
            record.append(time.perf_counter() - t0)
            if marks is not None:
                marks.append(("preview", time.perf_counter()))
            if peaks is not None:
                peaks.setdefault("preview", []).append(torch.cuda.max_memory_allocated() / 1e9)
                torch.cuda.reset_peak_memory_stats()
        return out

    cls.maybe_render = maybe_render
    return lambda: setattr(cls, "maybe_render", original)


def trainer_phase(torch, work_dir: Path, steps: int, smi: str, resume: bool):
    phase("trainer")
    from PIL import Image
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import read_header
    from aozora_sdxl_training_tpu_torch.cli import train_sdxl
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import (
        write_image_dataset, write_random_sd_checkpoint)
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE, hf_param_names
    from aozora_sdxl_training_tpu_torch.train import sampler as sampler_module
    from aozora_sdxl_training_tpu_torch.train import trainer as trainer_module

    ckpt, counts, secs = shared_weights(torch, "sdxl_random.safetensors", lambda path: (
        write_random_sd_checkpoint(path, seed=1234, device="cuda")))
    print(f"  {ckpt.name}: {counts} parameters ({ckpt.stat().st_size / 1e9:.2f} GB, bf16), "
          f"{f'written in {secs:.1f} s' if secs > 0.1 else 'written by an earlier phase'}")
    # SDXL_BASE; CLIP ViT-L/14 and OpenCLIP ViT-bigG/14 text towers; SD-VAE
    check(counts == {"unet": 2_567_463_684, "clip_l": 123_060_480,
                     "clip_g": 694_659_840, "vae": 83_653_863},
          f"parameter counts {counts}")
    write_image_dataset(work_dir / "data", n_images=2, image_size=(1024, 1024), seed=5)

    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    sdxl = preset["sdxl"]
    sdxl.update({"sdxl_base_model_path": str(ckpt),
                 "sdxl_output_dir": str(work_dir / "out"),
                 "sdxl_output_name": "smoke",
                 "sdxl_instance_datasets": [{"path": str(work_dir / "data"), "repeats": 1}],
                 "sdxl_max_train_steps": steps,
                 "sdxl_preview_every_n_steps": PREVIEW_EVERY,
                 "sdxl_preview_sample_steps": PREVIEW_STEPS})
    preset_path = work_dir / "preset.json"
    preset_path.write_text(json.dumps(preset, indent=1))
    config = RuntimeConfig(schema.flatten_preset(preset))
    check(config.PREVIEW_EVERY_N_STEPS == PREVIEW_EVERY
          and config.PREVIEW_SAMPLE_STEPS == PREVIEW_STEPS,
          "the preset's preview keys did not reach the config")
    cache = cache_phase(torch, preset_path, work_dir, config)

    remat = trainer_module.sdxl_remat_mode()
    if resume:
        # the GUI's emergency save, taken at optimizer step 1: the resume
        # phase resumes from its files
        check_disk(work_dir, RESUME_FREE_GB["sdxl"], smi)
        (work_dir / "force_save.flag").write_text("")
    previews: list = []
    state_io: dict = {"snapshot": resume}
    restore = timed_previews(torch, sampler_module.PreviewRenderer, previews)
    try:
        raw, marks, launches, peak_gb, wall = run_trainer_cli(
            torch, train_sdxl.main, preset_path, work_dir, trainer_module,
            ("make_micro_step", "make_apply_step"), "chip_smoke_trainer.log", state_io)
    finally:
        restore()
    check(("Emergency checkpoint requested at optimizer step 1" in raw) == resume
          and len(state_io.get("save", ())) == resume,
          "the emergency save at optimizer step 1 did not happen as asked")
    losses = check_progress(raw, SDXL_PROGRESS, steps)
    check("preview sampling disabled" not in raw, "preview sampling was disabled")
    calls = SELF_ATTN_CALLS[64]
    n_previews = steps // GA // PREVIEW_EVERY
    check_launches(launches, {
        "flash_fwd": calls * (2 if remat else 1) * steps + calls * PREVIEW_STEPS * n_previews,
        "flash_bwd_dq": calls * steps,
        "flash_bwd_dkv": calls * steps,
        "flash_fwd_f32_d512": n_previews})
    png = work_dir / "out" / "previews" / f"step_{PREVIEW_EVERY}.png"
    check(png.exists(), f"no preview {png.name}")
    with Image.open(png) as im:
        check(im.size == (1024, 1024) and im.mode == "RGB", f"preview {im.size} {im.mode}")
    check(len(previews) == n_previews, f"{len(previews)} previews rendered")
    print(f"  preview at optimizer step {PREVIEW_EVERY}: {PREVIEW_STEPS} DDIM steps "
          f"+ fp32 decode to 1024x1024 in {previews[0]:.4f} s")

    final = work_dir / "out" / "smoke.safetensors"
    check(final.exists(), "no merged checkpoint")
    header = read_header(final)
    unet = {k: v for k, v in header.items() if k.startswith("model.diffusion_model.")}
    check(len(unet) == len(hf_param_names(SDXL_BASE)), f"{len(unet)} UNet tensors saved")
    check(all(v["dtype"] == "BF16" for v in unet.values()), "UNet tensors not BF16")
    passthrough = [k for k in header if not k.startswith("model.diffusion_model.")]
    check(len(passthrough) == len(read_header(ckpt)) - len(unet),
          "the text encoders' and VAE's tensors did not pass through")
    summary = step_summary(marks, steps, SDXL_FWD_FLOPS_1024, peak_gb, wall,
                           launches, losses, remat=remat or "off",
                           cache=cache, preview_s=previews)
    if resume:
        final.unlink()            # checked; the resumed runs write their own
        summary["resume"] = sdxl_resume_phase(torch, work_dir, preset, raw, summary,
                                              state_io, smi)
    return summary, launches


def anima_forward_flops(cfg, tokens: int) -> int:
    """Multiply-add flops (2 per MAC) of one DiT forward at batch 1 and one
    frame: the 28 blocks (self-attention projections and QK^T/PV over
    ``tokens``, cross-attention over the 512-token adapter context, the 4x
    MLP, the AdaLN-LoRA modulation), the 6 adapter layers (512 T5 queries
    against 512 Qwen states) and the patch embed, time embed and final
    layer. Elementwise work is left out."""
    d, lora = cfg.model_channels, cfg.adaln_lora_dim
    ff, dc = int(d * cfg.mlp_ratio), cfg.crossattn_emb_channels
    n, c, t = tokens, cfg.context_tokens, cfg.context_tokens
    block = (2 * n * d * d * 4 + 4 * n * n * d          # self-attention
             + 2 * n * d * d * 2 + 2 * c * dc * d * 2   # cross q, out; k, v
             + 4 * n * c * d                            # cross QK^T, PV
             + 2 * n * d * ff * 2                       # MLP
             + 3 * (2 * d * lora + 2 * lora * 3 * d))   # AdaLN-LoRA
    td, sd = cfg.adapter_target_dim, cfg.adapter_source_dim
    adapter = (2 * t * td * td * 4 + 4 * t * t * td
               + 2 * t * td * td * 2 + 2 * c * sd * td * 2 + 4 * t * c * td
               + 2 * t * td * 4 * td * 2)
    patch = cfg.patch_temporal * cfg.patch_spatial ** 2
    edges = (2 * n * (cfg.in_channels + 1) * patch * d        # patch embed
             + 2 * n * d * cfg.out_channels * patch           # final linear
             + 2 * d * d + 2 * d * 3 * d                      # t_embedder
             + 2 * d * lora + 2 * lora * 2 * d + 2 * t * td * td)
    return cfg.num_blocks * block + cfg.adapter_layers * adapter + edges


def anima_env(torch, work_dir: Path, steps: int, synthetic_cache: bool = True,
              blocks: int | None = None, **preset_overrides):
    """A random ANIMA_BASE checkpoint (seed 4321; with ``blocks``, a random
    DiT of its widths and ``blocks`` blocks, written into ``work_dir``), the default preset
    pointed at it and at ``work_dir``/data, and there (with
    ``synthetic_cache``) a synthetic cache of 2 images at 1024px. Returns
    (cfg, preset path, config)."""
    from dataclasses import replace
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import (
        write_random_dit_checkpoint, write_synthetic_anima_dataset)
    from aozora_sdxl_training_tpu_torch.models.anima.dit import ANIMA_BASE, param_shapes

    cfg = ANIMA_BASE if blocks is None else replace(ANIMA_BASE, num_blocks=blocks)
    n_want = sum(math.prod(s) for s in param_shapes(cfg).values())
    if blocks is None:
        ckpt, n_params, secs = shared_weights(torch, "anima_random.safetensors", lambda path: (
            write_random_dit_checkpoint(path, cfg, seed=4321, device="cuda")))
        check(2.08e9 < n_params < 2.10e9, f"ANIMA_BASE has {n_params} parameters")
    else:
        t0 = time.perf_counter()
        ckpt = work_dir / f"anima_random_{blocks}_blocks.safetensors"
        n_params = write_random_dit_checkpoint(ckpt, cfg, seed=4321, device="cuda")
        secs = time.perf_counter() - t0
    print(f"  {ckpt.name}: {n_params:,} DiT parameters ({ckpt.stat().st_size / 1e9:.2f} GB, "
          f"bf16, pipe.dit.), "
          f"{f'written in {secs:.1f} s' if secs > 0.1 else 'written by an earlier phase'}")
    check(n_params == n_want, f"the DiT has {n_params} parameters, not {n_want}")

    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    preset["active_mode"] = "anima"
    anima = preset["anima"]
    anima.update({"anima_dit_model_path": str(ckpt),
                  "anima_output_dir": str(work_dir / "out"),
                  "anima_output_name": "smoke_anima",
                  "anima_instance_datasets": [{"path": str(work_dir / "data"),
                                               "repeats": 1}],
                  "anima_max_train_steps": steps})
    config = RuntimeConfig(schema.flatten_preset(preset))
    check(config.GRADIENT_ACCUMULATION_STEPS == GA and config.BATCH_SIZE == 1
          and config.ANIMA_GRADIENT_CHECKPOINTING_MODE == "Full",
          "the default Anima preset is not batch 1, GA 4, Full checkpointing")
    anima.update(preset_overrides)
    preset_path = work_dir / "preset.json"
    preset_path.write_text(json.dumps(preset, indent=1))
    config = RuntimeConfig(schema.flatten_preset(preset))
    if not synthetic_cache:
        return cfg, preset_path, config
    # with no VAE path in the preset, the cache options name the VAE source
    # by a relative path, resolved in the working directory: write the cache
    # from the directory the CLI runs in
    with contextlib.chdir(work_dir):
        write_synthetic_anima_dataset(work_dir / "data", config, n_images=2,
                                      image_size=(1024, 1024),
                                      source_dim=cfg.adapter_source_dim,
                                      vocab=cfg.adapter_vocab,
                                      latent_channels=cfg.in_channels, seed=6)
    return cfg, preset_path, config


def check_saved_dit(final: Path, cfg, dtype: str = "BF16"):
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import read_header
    from aozora_sdxl_training_tpu_torch.models.anima.dit import param_shapes
    check(final.exists(), "no saved DiT")
    header = read_header(final)
    check(len(header) == len(param_shapes(cfg))
          and all(k.startswith("pipe.dit.") for k in header),
          f"{len(header)} DiT tensors saved, not all under pipe.dit.")
    check(all(v["dtype"] == dtype for v in header.values()), f"DiT tensors not {dtype}")


ANIMA_PEAK_GB = 27.8          # the anima phase's peak on a synthetic cache (PERF.md §5)


def anima_cache_inputs(torch, work_dir: Path, clips: bool = False) -> dict:
    """Random full-width Qwen3-0.6B (seed 2468) and full Wan VAE (encoder
    and decoder, seed 1357) files in bf16, and 2 captioned 1024px images
    or, with ``clips``, 2 captioned 1024px animated-WEBP clips of
    VIDEO_FRAMES frames. Returns the preset's keys for the files."""
    from aozora_sdxl_training_tpu_torch.data.synthetic import (
        write_clip_dataset, write_image_dataset, write_random_qwen3_checkpoint,
        write_random_wan_vae_checkpoint)
    from aozora_sdxl_training_tpu_torch.models.anima import qwen3, wan_vae

    t0 = time.perf_counter()
    te, n_te, _ = shared_weights(torch, "qwen3_random.safetensors", lambda path: (
        write_random_qwen3_checkpoint(path, qwen3.QWEN3_0_6B, seed=2468, device="cuda")))
    vae, n_vae, _ = shared_weights(torch, "wan_vae_random.safetensors", lambda path: (
        write_random_wan_vae_checkpoint(path, wan_vae.WAN_VAE, seed=1357, device="cuda",
                                        decoder=True)))
    if clips:
        write_clip_dataset(work_dir / "data", n_clips=2, frames=VIDEO_FRAMES,
                           image_size=(1024, 1024), seed=3)
        what = f"clips of {VIDEO_FRAMES} frames"
    else:
        write_image_dataset(work_dir / "data", n_images=2, image_size=(1024, 1024), seed=3)
        what = "images"
    print(f"  {te.name}: {n_te:,} parameters, {vae.name}: {n_vae:,} (bf16, encoder and "
          f"decoder; written once a run), 2 captioned 1024x1024 {what}: "
          f"{time.perf_counter() - t0:.1f} s")
    check(5.9e8 < n_te < 6.0e8, f"Qwen3-0.6B has {n_te} parameters")
    return {"anima_text_encoder_path": str(te), "anima_vae_path": str(vae)}


def timed_anima_encoders(torch, anima_cache, record: dict):
    """Wraps ``AnimaCacheEncoders.from_config`` so that each encoder call
    ends in torch.cuda.synchronize() and adds (host s, calls, items) to
    ``record`` ("text": caption batches, "latents": images, "clips":
    clips), and the most it allocated above what was held before it to
    "<kind>_peak_gb"; "peak_gb"
    is the largest allocation at any call's peak and "loads" counts the
    encoder loads. Returns a restore function."""
    cls = anima_cache.AnimaCacheEncoders
    original = cls.from_config

    def timed(kind, fn, items):
        def run(arg):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(arg)
            torch.cuda.synchronize()
            s, n, k = record.get(kind, (0.0, 0, 0))
            record[kind] = (s + time.perf_counter() - t0, n + 1, k + items(arg))
            peak = torch.cuda.max_memory_allocated()
            record[f"{kind}_peak_gb"] = max(record.get(f"{kind}_peak_gb", 0.0),
                                            (peak - base) / 1e9)
            record["peak_gb"] = max(record.get("peak_gb", 0.0), peak / 1e9)
            return out
        return run

    def from_config(*args, **kwargs):
        record["loads"] = record.get("loads", 0) + 1
        enc = original(*args, **kwargs)
        enc.encode_prompt = timed("text", enc.encode_prompt, len)
        enc.encode_image = timed("latents", enc.encode_image, lambda px: 1)
        enc.encode_clip = timed("clips", enc.encode_clip, lambda px: 1)
        return enc

    cls.from_config = from_config
    return lambda: setattr(cls, "from_config", original)


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def top_kernels(torch, fn, n: int = 4):
    """(name, device ms, launches) of the ``n`` kernels that took the most
    device time in one warm call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return [(e.key[:120], e.self_device_time_total / 1e3, e.count) for e in kernels[:n]]


def anima_encoders_against_float64(torch, config, work_dir: Path) -> dict:
    """One caption through Qwen3-0.6B and one 96x96-latent tile (768 px of
    the first image) through the Wan VAE encoder on the card, each in fp32
    (timed, warm) and in float64: the port's own functions, weights from the
    files the cache was built from."""
    import numpy as np
    from PIL import Image
    from aozora_sdxl_training_tpu_torch.ckpt.anima_checkpoint import (
        load_text_encoder_state, load_vae_state)
    from aozora_sdxl_training_tpu_torch.data.anima_cache import CONTEXT_TOKENS
    from aozora_sdxl_training_tpu_torch.data.tokenization import HashTokenizer
    from aozora_sdxl_training_tpu_torch.models.anima import qwen3, wan_vae

    caption = (work_dir / "data" / "img0.txt").read_text()
    tok = HashTokenizer(model_max_length=CONTEXT_TOKENS)
    row = tok(caption, padding="max_length", max_length=CONTEXT_TOKENS,
              truncation=True).input_ids
    ids = torch.tensor([row], device="cuda")
    mask = (ids != tok.pad_token_id).int()
    with Image.open(work_dir / "data" / "img0.png") as im:
        image = np.asarray(im.convert("RGB"), np.float32)[None] / 127.5 - 1.0
    tile = torch.from_numpy(np.ascontiguousarray(image[:, :768, :768])).cuda()
    tile_shapes = sorted({(min(b, 1024) - t, min(r, 1024) - l) for t, b, l, r in
                          wan_vae.tile_tasks(1024, 1024, 768, 768, 576, 576)}, reverse=True)
    smallest = "tile {}x{}".format(*tile_shapes[-1])
    te_state = load_text_encoder_state(config.TEXT_ENCODER_PATH)
    q_cfg = qwen3.detect_config(te_state)
    vae_state = load_vae_state(config.DIT_VAE_PATH)
    out, times, peaks = {}, {}, {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.float64):
            qp = qwen3.params_from_torch_state(te_state, q_cfg, dtype=dtype, device="cuda")
            vp = wan_vae.params_from_torch_state(vae_state, dtype=dtype, device="cuda")
            v_cfg = wan_vae.detect_config(vp)
            calls = [("qwen3", lambda: qwen3.qwen3_forward(qp, ids, mask, q_cfg,
                                                           compute_dtype=dtype)),
                     ("vae", lambda: wan_vae.encode_image(vp, tile, cfg=v_cfg,
                                                          compute_dtype=dtype))]
            if dtype == torch.float32:
                # each tile shape of a 1024 px image alone, then the whole
                # tiled encode, and these again with cuDNN's benchmark mode
                for h, w in tile_shapes:
                    px = torch.from_numpy(np.ascontiguousarray(image[:, :h, :w])).cuda()
                    calls.append((f"tile {h}x{w}", lambda px=px: wan_vae.encode_image(
                        vp, px, cfg=v_cfg)))
                calls.append(("latent", lambda: wan_vae.encode_image_tiled(vp, image,
                                                                           cfg=v_cfg)))
                calls += [(f"{name} benchmark", fn) for name, fn in calls[2:]]
            for name, fn in calls:
                torch.backends.cudnn.benchmark = name.endswith("benchmark")
                try:
                    result = fn()
                    if dtype == torch.float32:
                        torch.cuda.synchronize()
                        base = torch.cuda.memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        times[name] = time.perf_counter() - t0
                        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
                finally:
                    torch.backends.cudnn.benchmark = False
                if name in ("qwen3", "vae"):
                    out[name, dtype] = result
            if dtype == torch.float32:
                top = top_kernels(torch, dict(calls)[smallest])
            del qp, vp, calls
    errs = {name: rel_err(out[name, torch.float32], out[name, torch.float64])
            for name in ("qwen3", "vae")}
    check(tuple(out["qwen3", torch.float32].shape) == (1, CONTEXT_TOKENS, q_cfg.hidden_size)
          and tuple(out["vae", torch.float32].shape) == (1, 96, 96, v_cfg.z_dim),
          "encoder output shapes")
    print(f"  fp32 against float64 on the card: Qwen3 one caption {errs['qwen3']:.3e}, "
          f"VAE one 96x96-latent tile {errs['vae']:.3e} of the largest magnitude "
          f"(bar 1e-4); warm fp32: Qwen3 {times['qwen3']:.4f} s a caption, VAE "
          f"{times['vae']:.4f} s a 768 px tile; allocated above the weights at the "
          f"peak: Qwen3 {peaks['qwen3']:.3f} GB, VAE tile {peaks['vae']:.3f} GB")
    print("  warm fp32 VAE by input (the latent: the 4 tiles of a 1024 px image, "
          "blended; benchmark: with torch.backends.cudnn.benchmark):")
    for name in times:
        if name.startswith(("tile", "latent")):
            print(f"    {name}: {times[name]:.4f} s, {peaks[name]:.3f} GB above the weights")
    print(f"  the {smallest}'s kernels by device time (torch.profiler): "
          + "; ".join(f"{ms:.2f} ms x{n} {k}" for k, ms, n in top))
    check(all(e <= 1e-4 for e in errs.values()), f"fp32 against float64: {errs}")
    return {"max_abs_err_of_max": errs, "warm_s": times, "peak_above_weights_gb": peaks,
            f"kernels {smallest}": top}


def anima_cache_phase(torch, preset_path: Path, work_dir: Path, config, smi: str,
                      video: bool = False, lineart: bool = False):
    """The port's cache_datasets CLI in Anima mode on the images: builds the
    cache (Qwen3-0.6B in batches of 8 captions, then the Wan VAE over 4
    tiles an image), then a second run finds it current and loads no
    encoder. With ``video`` the data are clips of VIDEO_FRAMES frames, each
    encoded whole by ``encode_video`` into 3 latent frames. With
    ``lineart`` (the repair phase) each latent payload carries its line-art
    mask and the float64 checks are left to the anima phase. Returns the
    cache pass's numbers."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.cli import cache_datasets
    from aozora_sdxl_training_tpu_torch.data import anima_cache
    from aozora_sdxl_training_tpu_torch.data import cache_store as cs
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa

    record: dict = {}
    restore = timed_anima_encoders(torch, anima_cache, record)
    logs = []
    try:
        for attempt in range(2):
            log = io.StringIO()
            fa.reset_launch_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.chdir(work_dir), contextlib.redirect_stdout(Tee(sys.stdout, log)):
                cache_datasets.main(["--config", str(preset_path)])
            logs.append((log.getvalue(), time.perf_counter() - t0,
                         {k: v for k, v in fa.LAUNCHES.items() if v},
                         max(torch.cuda.max_memory_allocated() / 1e9,
                             record.get("peak_gb", 0.0)),
                         record.get("loads", 0)))
    finally:
        restore()
    (first, wall, launches, peak_gb, loads), (second, _, _, _, loads2) = logs
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    tag = "_video" if video else "_repair" if lineart else ""
    (LOG_DIR / f"chip_smoke_anima{tag}_cache.log").write_text(first + second)
    check(launches == {}, f"the Anima cache pass launched flash kernels: {launches}")
    check("phase 1/2: encoding 2 captions" in first and "phase 2/2: encoding 2 latents" in first,
          "the first cache run did not encode 2 captions and 2 latents")
    check("Cached 2 Anima DiT items" in first, "no 'Cached 2 Anima DiT items' line")
    check(loads == 1 and loads2 == 1, f"encoder loads: {loads} in the first run, "
          f"{loads2 - loads} in the second")
    check("encoding" not in second and "already cached" in second,
          "the second cache run encoded again")
    check(not anima_cache.check_if_anima_caching_needed(config),
          "the cache check rejects the cache the CLI built")
    index = cs.load_index(work_dir / "data" / anima_cache.anima_cache_dir_name(config))
    check(len(index["files"]) == 2, f"{len(index['files'])} items in the index")
    kind, latent_shape = (("clips", (1 + (VIDEO_FRAMES - 1) // 4, 128, 128, 16)) if video
                          else ("latents", (128, 128, 16)))
    max_id = 0
    for item in index["files"]:
        te, _ = cs.load_payload(item["te_path"])
        lat, _ = cs.load_payload(item["lat_path"])
        shapes = {k: (v.shape[1:] if k == "t5xxl_ids" else v.shape, v.dtype.name)
                  for k, v in {**te, **lat}.items()}
        check(shapes == {"prompt_emb": ((512, 1024), "bfloat16"),
                         "t5xxl_ids": ((), "int32"),
                         "latents": (latent_shape, "bfloat16"),
                         **({"lineart_mask": ((128, 128), "float32")} if lineart else {})},
              f"payload shapes {shapes}")
        if lineart:
            mask = lat["lineart_mask"]
            check(0.0 <= mask.min() and mask.max() <= 1.0 and mask.max() > 0.0,
                  f"line-art mask in [{mask.min()}, {mask.max()}]")
        check(all(np.isfinite(np.asarray(v, np.float32)).all()
                  for v in (te["prompt_emb"], lat["latents"])), "non-finite payload")
        max_id = max(max_id, int(te["t5xxl_ids"].max()))
    (t_text, n_batches, n_text), (t_lat, _, n_lat) = record["text"], record[kind]
    what = (f"clips of {VIDEO_FRAMES} frames at 1024x1024 (untiled encode_video), "
            f"{t_lat / n_lat:.4f} s a clip" if video else
            f"latents at 1024x1024 (4 tiles each), {t_lat / n_lat:.4f} s a latent")
    print(f"  cache pass ({smi}): {n_text} captions in {n_batches} batch(es), "
          f"{t_text / n_batches:.4f} s a caption batch; {n_lat} {what}; peak "
          f"{peak_gb:.2f} GB allocated (above what was held before the call: "
          f"{record['text_peak_gb']:.3f} GB in a caption batch, "
          f"{record[kind + '_peak_gb']:.3f} GB in a {kind[:-1]}); CLI {wall:.1f} s "
          "(encoder load included); "
          f"T5 ids up to {max_id} (the DiT's vocabulary: 32128); the second run "
          "loaded no encoder and encoded nothing")
    f64 = (None if lineart else wan_video_against_float64(torch, config, work_dir) if video
           else anima_encoders_against_float64(torch, config, work_dir))
    return {"s_per_caption_batch": t_text / n_batches, "caption_batches": n_batches,
            "captions": n_text, f"s_per_{kind[:-1]}_1024": t_lat / n_lat, kind: n_lat,
            "max_memory_allocated_gb": peak_gb, "cli_wall_s": wall, "max_t5_id": max_id,
            "peak_above_held_gb": {k: record[f"{k}_peak_gb"] for k in ("text", kind)},
            "float64": f64, "card": smi}


def check_anima_previews(raw: str, out_dir: Path, n_previews: int, previews: list,
                         size: tuple, what: str):
    """The Anima run rendered a decoded preview of ``size`` (w, h) after
    each optimizer step, with the decoder of the run's full Wan file: no
    latent-RGB fallback and no preview that disabled itself."""
    from PIL import Image
    check("INFO: preview sampling (decoded pixels) every 1 optimizer step(s)" in raw,
          "the Anima run did not preview decoded pixels every optimizer step")
    check("latent-RGB" not in raw and not list(out_dir.glob("*_latent.png")),
          "the preview fell back to latent-RGB with a decoder in the Wan file")
    check("preview sampling disabled" not in raw, "preview sampling was disabled")
    check(len(previews) == n_previews, f"{len(previews)} previews rendered, not {n_previews}")
    for step in range(1, n_previews + 1):
        png = out_dir / f"step_{step}.png"
        check(png.exists(), f"no preview {png.name}")
        with Image.open(png) as im:
            check(im.size == size and im.mode == "RGB", f"preview {png.name}: {im.size} {im.mode}")
    print(f"  previews ({ANIMA_PREVIEW_STEPS} Euler steps, then the fp32 Wan decoder; {what} "
          f"{size[0]}x{size[1]}): {', '.join(f'{t:.4f}' for t in previews)} s")


def run_anima_cli(torch, preset_path: Path, work_dir: Path, log_name: str,
                  state_io: dict | None = None):
    """The Anima CLI through ``run_trainer_cli`` with its previews timed and
    left out of the steps. Returns (stdout, marks, launches, training peak
    GB, preview peak GB, wall s, previews' s)."""
    from aozora_sdxl_training_tpu_torch.cli import train_anima
    from aozora_sdxl_training_tpu_torch.train import anima_sampler, anima_trainer
    previews, marks, peaks = [], [], {}
    restore = timed_previews(torch, anima_sampler.AnimaPreviewRenderer, previews, marks,
                             peaks)
    try:
        raw, marks, launches, last_gb, wall = run_trainer_cli(
            torch, train_anima.main, preset_path, work_dir, anima_trainer,
            ("make_anima_micro_step", "make_apply_step"), log_name, state_io, marks)
    finally:
        restore()
    return (raw, marks, launches, max([last_gb, *peaks.get("train", ())]),
            max(peaks.get("preview", [0.0])), wall, previews)


def anima_phase(torch, work_dir: Path, steps: int, smi: str, resume: bool):
    phase("anima_cache")
    inputs = anima_cache_inputs(torch, work_dir)
    cfg, preset_path, config = anima_env(
        torch, work_dir, steps, synthetic_cache=False, anima_preview_every_n_steps=1,
        anima_preview_sample_steps=ANIMA_PREVIEW_STEPS, **inputs)
    check(config.ANIMA_PREVIEW_EVERY_N_STEPS == 1
          and config.ANIMA_PREVIEW_SAMPLE_STEPS == ANIMA_PREVIEW_STEPS,
          "the preset's preview keys did not reach the config")
    cache = anima_cache_phase(torch, preset_path, work_dir, config, smi)
    phase("anima")
    if resume:
        check_disk(work_dir, RESUME_FREE_GB["anima"], smi)
        (work_dir / "force_save.flag").write_text("")
    state_io: dict = {"snapshot": resume}
    raw, marks, launches, peak_gb, preview_gb, wall, previews = run_anima_cli(
        torch, preset_path, work_dir, "chip_smoke_anima.log", state_io)
    check("encoding" not in raw, "the trainer encoded the cache again")
    check(("Emergency checkpoint requested at optimizer step 1" in raw) == resume
          and len(state_io.get("save", ())) == resume,
          "the emergency save at optimizer step 1 did not happen as asked")
    losses = check_progress(raw, ANIMA_PROGRESS, steps)
    calls = SELF_ATTN_CALLS[128]
    n_previews = steps // GA
    check_launches(launches, {"flash_fwd_d128": 2 * calls * steps + ANIMA_PREVIEW_K4A * n_previews,
                              "flash_bwd_dq_d128": calls * steps,
                              "flash_bwd_dkv_d128": calls * steps})
    check_anima_previews(raw, work_dir / "out" / "previews", n_previews, previews,
                         (1024, 1024), "decode_image of the first latent frame,")
    check_saved_dit(work_dir / "out" / "smoke_anima.safetensors", cfg)
    tokens = (1024 // 8 // cfg.patch_spatial) ** 2
    fwd = anima_forward_flops(cfg, tokens)
    print(f"  analytic forward at {tokens} tokens: {fwd:.4e} flop; a micro step "
          f"counts 3x (forward + backward; the Full recompute is not counted)")
    summary = step_summary(marks, steps, fwd, max(peak_gb, preview_gb), wall, launches,
                           losses, remat="full", forward_flops=fwd, cache=cache,
                           preview_s=previews, train_peak_gb=peak_gb,
                           preview_peak_gb=preview_gb)
    print(f"  peak in training {peak_gb:.2f} GB, in a preview {preview_gb:.2f} GB")
    check(peak_gb <= ANIMA_PEAK_GB + 0.5,
          f"peak {peak_gb:.2f} GB, above {ANIMA_PEAK_GB} GB (a synthetic cache's) + 0.5 GB")
    if resume:
        (work_dir / "out" / "smoke_anima.safetensors").unlink()
        summary["resume"] = anima_resume_phase(
            torch, work_dir, json.loads(preset_path.read_text()), raw, summary, state_io, smi)
    return summary, launches


def wan_video_against_float64(torch, config, work_dir: Path) -> dict:
    """The full Wan file's ``encode_video`` on a 5-frame 256 px clip (the
    top-left corner of the first clip's first 5 frames), then
    ``decode_video`` and ``decode_image`` (its first latent frame) of the
    float64 latents, each in fp32 (timed, warm) against float64 on the
    card, held at 1e-4 of the largest magnitude as the image encoder is."""
    import numpy as np
    from PIL import Image
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all
    from aozora_sdxl_training_tpu_torch.models.anima import wan_vae

    with Image.open(work_dir / "data" / "clip0.webp") as im:
        frames = []
        for i in range(5):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB"), np.float32)[:256, :256])
    clip = torch.from_numpy(np.stack(frames)[None] / 127.5 - 1.0).cuda()
    state = load_all(config.DIT_VAE_PATH)
    f32, f64 = torch.float32, torch.float64
    params = {dtype: wan_vae.params_from_torch_state(state, dtype=dtype, device="cuda",
                                                     include_decoder=True)
              for dtype in (f64, f32)}
    v_cfg = wan_vae.detect_config(params[f32])
    errs, times, shapes = {}, {}, {}
    with torch.inference_mode():
        lat64 = wan_vae.encode_video(params[f64], clip, cfg=v_cfg, compute_dtype=f64)
        calls = {"encode_video": lambda p, dt: wan_vae.encode_video(
                     p, clip, cfg=v_cfg, compute_dtype=dt),
                 "decode_video": lambda p, dt: wan_vae.decode_video(
                     p, lat64, cfg=v_cfg, compute_dtype=dt),
                 "decode_image": lambda p, dt: wan_vae.decode_image(
                     p, lat64[:, 0], cfg=v_cfg, compute_dtype=dt)}
        for name, fn in calls.items():
            want = lat64 if name == "encode_video" else fn(params[f64], f64)
            fn(params[f32], f32)                   # warm-up (cuDNN plans)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(params[f32], f32)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            errs[name], shapes[name] = rel_err(got, want), tuple(got.shape)
    del params
    check(shapes == {"encode_video": (1, 2, 32, 32, 16), "decode_video": (1, 5, 256, 256, 3),
                     "decode_image": (1, 256, 256, 3)}, f"Wan video shapes {shapes}")
    print("  Wan VAE fp32 against float64 on the card, a 5-frame 256 px clip: "
          + ", ".join(f"{name} {errs[name]:.3e} ({times[name]:.4f} s warm)" for name in errs)
          + " of the largest magnitude (bar 1e-4)")
    check(all(e <= 1e-4 for e in errs.values()), f"Wan video fp32 against float64: {errs}")
    return {"max_abs_err_of_max": errs, "warm_s": times}


def anima_video_phase(torch, work_dir: Path, steps: int, smi: str):
    """Anima video mode at ANIMA_BASE: 2 captioned 1024px clips of
    VIDEO_FRAMES frames through the cache CLI (``encode_video``: 3 latent
    frames of 128 x 128 a clip), the Wan VAE's video encode and decode
    against float64, then the Anima CLI on the clips' cache (12288 tokens a
    sample) with a decoded filmstrip preview every optimizer step."""
    phase("anima_video")
    inputs = anima_cache_inputs(torch, work_dir, clips=True)
    cfg, preset_path, config = anima_env(
        torch, work_dir, steps, synthetic_cache=False, anima_video_frames=VIDEO_FRAMES,
        anima_preview_every_n_steps=1, anima_preview_sample_steps=ANIMA_PREVIEW_STEPS,
        **inputs)
    check(config.ANIMA_VIDEO_FRAMES == VIDEO_FRAMES, "the preset's video frames did not "
          "reach the config")
    cache = anima_cache_phase(torch, preset_path, work_dir, config, smi, video=True)
    raw, marks, launches, peak_gb, preview_gb, wall, previews = run_anima_cli(
        torch, preset_path, work_dir, "chip_smoke_anima_video.log")
    check("encoding" not in raw, "the trainer encoded the cache again")
    losses = check_progress(raw, ANIMA_PROGRESS, steps)
    calls = SELF_ATTN_CALLS[128]
    n_previews = steps // GA
    check_launches(launches, {"flash_fwd_d128": 2 * calls * steps + ANIMA_PREVIEW_K4A * n_previews,
                              "flash_bwd_dq_d128": calls * steps,
                              "flash_bwd_dkv_d128": calls * steps})
    check_anima_previews(raw, work_dir / "out" / "previews", n_previews, previews,
                         (5 * 1024, 1024), "decode_video of the clip, a filmstrip of 5 frames,")
    check_saved_dit(work_dir / "out" / "smoke_anima.safetensors", cfg)
    plan = PLAN_EST.search(raw)
    check(plan is not None, "no memory plan line")
    estimate = float(plan.group(2))
    fwd = anima_forward_flops(cfg, VIDEO_TOKENS)
    print(f"  analytic forward at {VIDEO_TOKENS} tokens: {fwd:.4e} flop")
    summary = step_summary(marks, steps, fwd, max(peak_gb, preview_gb), wall, launches,
                           losses, remat="full", forward_flops=fwd, cache=cache,
                           preview_s=previews, train_peak_gb=peak_gb,
                           preview_peak_gb=preview_gb, plan_estimate_gb=estimate)
    print(f"  [{smi}] plan estimate {estimate:.2f} GB (as describe_plan prints it) against "
          f"the measured training peak {peak_gb:.2f} GB; peak in a preview {preview_gb:.2f} GB")
    return summary, launches


# --------------------------------------------------------------------------
# 16: MIXED_PRECISION float16 through both trainers (the fp16 kernels)
# --------------------------------------------------------------------------

FP16_STEPS = 4                # one optimizer step at GA 4
FP16_PREVIEW_STEPS = 2        # the SDXL preview's DDIM steps, the Anima one's Euler steps


def check_float16_file(path: Path, label: str) -> dict:
    """Every float tensor of a saved safetensors file is F16; returns the
    dtype counts."""
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import read_header
    check(path.exists(), f"{label}: no saved model {path.name}")
    counts: dict = {}
    for spec in read_header(path).values():
        counts[spec["dtype"]] = counts.get(spec["dtype"], 0) + 1
    check(set(counts) & {"BF16", "F32", "F64"} == set() and counts.get("F16", 0) > 0,
          f"{label}: saved dtypes {counts}, not F16")
    return counts


def precision_run(torch, cli_main, module, micro_name: str, renderer, preset: dict,
                  mode: str, work_dir: Path, precision: str, pattern, want: dict,
                  fwd_flops: float, final: Path | None, smi: str) -> dict:
    """One training CLI run of ``preset`` under MIXED_PRECISION
    ``precision`` for FP16_STEPS micro steps with a preview after the
    optimizer step: finite losses, exactly the launches ``want`` (every
    other flash kernel 0), a preview that did not disable itself and, with
    ``final``, a model file whose float tensors are all F16 (without, the
    final save is skipped); s per micro and optimizer step (steps 3-4,
    synced) and the peak."""
    label = f"{'fp16' if precision == 'float16' else 'bf16'}_{mode}"
    preset = {**preset, mode: {**preset[mode], f"{mode}_mixed_precision": precision,
                               f"{mode}_max_train_steps": FP16_STEPS,
                               f"{mode}_preview_every_n_steps": 1,
                               f"{mode}_preview_sample_steps": FP16_PREVIEW_STEPS}}
    preset_path = work_dir / f"{label}.json"
    preset_path.write_text(json.dumps(preset, indent=1))
    previews, marks, peaks = [], [], {}
    restore = timed_previews(torch, renderer, previews, marks, peaks)
    try:
        raw, marks, launches, last_gb, wall = run_trainer_cli(
            torch, cli_main, preset_path, work_dir, module, (micro_name, "make_apply_step"),
            f"chip_smoke_{label}.log", marks=marks, final_save=final is not None)
    finally:
        restore()
    check("preview sampling disabled" not in raw, f"{label}: the preview disabled itself")
    check(len(previews) == FP16_STEPS // GA, f"{label}: {len(previews)} previews rendered")
    losses = check_progress(raw, pattern, FP16_STEPS)
    check_launches(launches, want)
    dtypes = check_float16_file(final, label) if final is not None else None
    peak_gb = max([last_gb, *peaks.get("train", ())])
    summary = step_summary(marks, FP16_STEPS, fwd_flops, peak_gb, wall, launches, losses,
                           preview_s=previews, saved_dtypes=dtypes,
                           preview_peak_gb=max(peaks.get("preview", [0.0])))
    print(f"  [{smi}] {label}: MIXED_PRECISION {precision}, "
          f"{summary['s_per_optimizer_step_ga4']:.4f} s per optimizer step at GA {GA}, peak "
          f"{peak_gb:.2f} GB in training; preview {previews[0]:.4f} s ({FP16_PREVIEW_STEPS} "
          f"steps)" + (f"; saved {final.name}: {dtypes}" if final is not None else ""))
    return summary


def precision_pair(torch, cli_main, module, micro_name, renderer, preset, mode, work_dir,
                   pattern, d: int, calls: int, fwd, fwd_flops, final: Path,
                   smi: str) -> dict:
    """A bfloat16 run of ``preset`` (the control, its final save skipped),
    then the float16 run (``precision_run``), back to back on the same
    weights and cache. Each launches the head_dim-``d`` kernels of its
    dtype: the forward's (and any other kernel's) counts from ``fwd(the
    forward kernel's name)``, each backward kernel's FP16_STEPS times the
    model's ``calls`` self-attention calls. Returns the float16 run's
    summary with the control's under "bf16_control"."""
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    runs = {}
    for precision, dtype in (("bfloat16", torch.bfloat16), ("float16", torch.float16)):
        kf, kdq, kdkv = kernel_names(fa, d, dtype)
        want = {**fwd(kf), kdq: calls * FP16_STEPS, kdkv: calls * FP16_STEPS}
        runs[precision] = precision_run(
            torch, cli_main, module, micro_name, renderer, preset, mode, work_dir, precision,
            pattern, want, fwd_flops, final if precision == "float16" else None, smi)
    f16, b16 = runs["float16"], runs["bfloat16"]
    print(f"  [{smi}] {mode}: float16 against bfloat16, back to back: "
          f"{f16['s_per_optimizer_step_ga4']:.4f} / {b16['s_per_optimizer_step_ga4']:.4f} s per "
          f"optimizer step "
          f"({f16['s_per_optimizer_step_ga4'] / b16['s_per_optimizer_step_ga4']:.3f}x), "
          f"micro step {f16['median_s_per_micro_step']:.4f} / "
          f"{b16['median_s_per_micro_step']:.4f} s, peak {f16['max_memory_allocated_gb']:.2f} / "
          f"{b16['max_memory_allocated_gb']:.2f} GB")
    return {**f16, "bf16_control": b16}


def fp16_phase(torch, work_dir: Path, smi: str):
    """MIXED_PRECISION float16 on the flash route through both training
    CLIs, each on seeded random weights and a synthetic cache of 2 images at
    1024px: SDXL_BASE (GA 4, FP16_STEPS micro steps, a DDIM preview of
    FP16_PREVIEW_STEPS steps, the decoder in fp32), then ANIMA_BASE's
    widths with CUT_BLOCKS blocks under Full remat (the same, an Euler
    preview; latent-RGB, no VAE file); each
    after a bfloat16 run of the same preset as its control
    (``precision_pair``). Returns the summaries and the float16 runs'
    launches."""
    phase("fp16")
    from aozora_sdxl_training_tpu_torch.cli import train_anima, train_sdxl
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import (
        write_random_sd_checkpoint, write_synthetic_dataset)
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE
    from aozora_sdxl_training_tpu_torch.train import anima_sampler, anima_trainer
    from aozora_sdxl_training_tpu_torch.train import sampler as sampler_module
    from aozora_sdxl_training_tpu_torch.train import trainer as trainer_module
    out = {}

    sdxl_dir = work_dir / "sdxl"
    sdxl_dir.mkdir()
    ckpt, _, _ = shared_weights(torch, "sdxl_random.safetensors", lambda path: (
        write_random_sd_checkpoint(path, seed=1234, device="cuda")))
    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    preset["sdxl"].update({
        "sdxl_base_model_path": str(ckpt), "sdxl_output_dir": str(sdxl_dir / "out"),
        "sdxl_output_name": "fp16",
        "sdxl_instance_datasets": [{"path": str(sdxl_dir / "data"), "repeats": 1}]})
    write_synthetic_dataset(sdxl_dir / "data", RuntimeConfig(schema.flatten_preset(preset)),
                            n_images=2, image_size=(1024, 1024), seq_len=77,
                            embed_dim=SDXL_BASE.cross_attention_dim,
                            pooled_dim=SDXL_BASE.pooled_projection_dim, seed=7)
    calls = SELF_ATTN_CALLS[64]
    per_step = calls * (2 if trainer_module.sdxl_remat_mode() else 1)
    out["sdxl"] = precision_pair(
        torch, train_sdxl.main, trainer_module, "make_micro_step",
        sampler_module.PreviewRenderer, preset, "sdxl", sdxl_dir, SDXL_PROGRESS, 64, calls,
        lambda kf: {kf: per_step * FP16_STEPS + calls * FP16_PREVIEW_STEPS,
                    "flash_fwd_f32_d512": FP16_STEPS // GA},
        SDXL_FWD_FLOPS_1024, sdxl_dir / "out" / "fp16.safetensors", smi)
    launches = dict(out["sdxl"]["launches"])
    shutil_rmtree(sdxl_dir)

    anima_dir = work_dir / "anima"
    anima_dir.mkdir()
    cfg, preset_path, _ = anima_env(torch, anima_dir, FP16_STEPS, blocks=CUT_BLOCKS)
    calls = cfg.num_blocks
    tokens = (1024 // 8 // cfg.patch_spatial) ** 2
    out["anima"] = precision_pair(
        torch, train_anima.main, anima_trainer, "make_anima_micro_step",
        anima_sampler.AnimaPreviewRenderer, json.loads(preset_path.read_text()), "anima",
        anima_dir, ANIMA_PROGRESS, 128, calls,
        lambda kf: {kf: 2 * calls * FP16_STEPS + calls * FP16_PREVIEW_STEPS},
        anima_forward_flops(cfg, tokens), anima_dir / "out" / "smoke_anima.safetensors", smi)
    check_saved_dit(anima_dir / "out" / "smoke_anima.safetensors", cfg, "F16")
    for k, v in out["anima"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    shutil_rmtree(anima_dir)
    return out, launches


# --------------------------------------------------------------------------
# 15: the QAT repair trainer and the quant tools
# --------------------------------------------------------------------------

QUANT_FORMATS = ("float8_e4m3fn", "float8_e5m2", "int8_tensorwise", "nvfp4", "ternary_1_58")
# ANIMA_BASE's MLP up-projection (8192 x 2048): the full-width tensor each
# format is projected at on the card and on the host
PROJECTED_KEY = "blocks.0.mlp.layer1.weight"
PROFILE_LATENT_HW = 64        # 1024 tokens: the smallest the flash kernels take
PROFILE_LAYERS = 8


def projection_against_host(torch, smi: str) -> dict:
    """A random full-width ``PROJECTED_KEY`` (rows at very different scales,
    a zero row, -0.0 entries) projected on the card in each format
    (``train/qat_project.project_weight``), against the numpy quantizer's
    round trip (quantize, then dequantize) bit for bit; device ms (CUDA
    events, warm) and the host's s for the round trip."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.tools import quantize as q
    from aozora_sdxl_training_tpu_torch.train import qat_project
    rng = np.random.default_rng(15)
    w = (rng.normal(size=(8192, 2048)) * rng.uniform(0.01, 2.0, size=(8192, 1))
         ).astype(np.float32) * 0.02
    w[::7] *= 1e-4
    w[1] = 0.0
    w[2, :3] = -0.0
    dev = torch.from_numpy(w).cuda()
    out = {}
    for fmt in QUANT_FORMATS:
        t0 = time.perf_counter()
        records = dict(q.quant_records_for_weight(PROJECTED_KEY, w, fmt))
        want = np.asarray(q.dequantize_records(PROJECTED_KEY, records, out_shape=w.shape),
                          np.float32)
        host_s = time.perf_counter() - t0
        got = qat_project.project_weight(fmt, dev).cpu().numpy()
        differ = int(np.sum(got.view(np.int32) != want.view(np.int32)))
        ms = cuda_ms(torch, lambda: qat_project.project_weight(fmt, dev), iters=5, warmup=1)
        out[fmt] = {"bits_differing": differ, "device_ms": ms, "host_round_trip_s": host_s}
        print(f"  projection of {PROJECTED_KEY} (8192 x 2048) in {fmt} on the card: "
              f"{differ} of {w.size} values differ from the numpy round trip bit for bit; "
              f"{ms:.3f} ms on the card [{smi}], {host_s:.3f} s on the host")
    bad = {f: r["bits_differing"] for f, r in out.items() if r["bits_differing"]}
    check(not bad, f"device projection differs from the numpy quantizer: {bad}")
    return out


def e4m3_step(x, scale):
    """One step of the scaled e4m3 grid at each |x|: scale * 2^(e - 3) with e
    the exponent of |x| / scale, floored at e4m3's smallest normal exponent,
    -6 (its subnormals' step)."""
    import numpy as np
    return scale * np.exp2(np.floor(np.log2(np.maximum(np.abs(x) / scale, 2.0 ** -6))) - 3)


def timed_repair(torch, record: dict, marks: list):
    """Wraps the repair path for the phase: the device projector's
    ``project`` synced and timed (ms into record["project_ms"], a "project"
    mark at its end so the steps leave it out), its residuals' bytes, the
    controller's host passes (``dequantized_params`` at load,
    ``project`` at save, s), and ``run_anima_training``'s result: host fp32
    copies of the final weights and residuals of ``record["sample"]``'s
    keys. Returns a restore function."""
    from aozora_sdxl_training_tpu_torch.train import anima_trainer, qat_project, qat_repair
    make, run = qat_project.make_device_projector, anima_trainer.run_anima_training
    ctl = qat_repair.ProjectedQuantController
    dequantized, project_host = ctl.dequantized_params, ctl.project

    def make_timed(*args, **kwargs):
        init, project = make(*args, **kwargs)

        def init_timed(trainable):
            res = init(trainable)
            record["residual_gb"] = sum(r.numel() * r.element_size() for r in res.values()) / 1e9
            return res

        def project_timed(trainable, residuals):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            project(trainable, residuals)
            torch.cuda.synchronize()
            record.setdefault("project_ms", []).append((time.perf_counter() - t0) * 1e3)
            marks.append(("project", time.perf_counter()))
        return init_timed, project_timed

    def run_kept(*args, **kwargs):
        result = run(*args, **kwargs)
        record["final"], record["residual"], record["device_projected"] = {}, {}, {}
        for k in record["sample"]:
            final = result["trainable"][k].detach().float()
            residual = result["qat_residuals"][k].float()
            record["final"][k] = final.cpu().numpy()
            record["residual"][k] = residual.cpu().numpy()
            # the trained effective weight projected on the card, to hold
            # against the file the host packs from the same values
            record["device_projected"][k] = qat_project.project_weight(
                record["formats"][k], final + residual).cpu().numpy()
        return result

    def dequantized_kept(self, *args):
        record["formats"] = dict(self.formats)
        return dequantized(self, *args)

    def host_timed(name, fn):
        def timed(self, *args):
            t0 = time.perf_counter()
            out = fn(self, *args)
            record[name] = time.perf_counter() - t0
            return out
        return timed

    qat_project.make_device_projector = make_timed
    anima_trainer.run_anima_training = run_kept
    ctl.dequantized_params = host_timed("dequantize_s", dequantized_kept)
    ctl.project = host_timed("pack_s", project_host)

    def restore():
        qat_project.make_device_projector, anima_trainer.run_anima_training = make, run
        ctl.dequantized_params, ctl.project = dequantized, project_host
    return restore


def check_repaired(work_dir: Path, quant_ckpt: Path, record: dict, smi: str) -> dict:
    """The packed file: every controlled key reloads in the port's
    controller with its format, and its codes' shape and dtype, unchanged;
    the share of codes that changed from the input (reported); for the
    sampled keys, the dequantized file bit for bit the card's projection of
    the trained (final + residual), and within half an e4m3 step of it."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.ckpt.anima_checkpoint import DIT_PREFIXES, strip_prefix
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import load_all
    from aozora_sdxl_training_tpu_torch.tools import quantize as q
    from aozora_sdxl_training_tpu_torch.train.qat_repair import ProjectedQuantController
    packed_path = work_dir / "out" / "repaired_quantized.safetensors"
    check(packed_path.exists(), "no repaired_quantized.safetensors")
    packed, prefix = strip_prefix(load_all(packed_path), DIT_PREFIXES)
    inp, in_prefix = strip_prefix(load_all(quant_ckpt), DIT_PREFIXES)
    check(prefix == in_prefix == "pipe.dit.", f"prefixes {prefix!r}, {in_prefix!r}")
    ctl, ctl_in = ProjectedQuantController(packed), ProjectedQuantController(inp)
    check(ctl.formats == ctl_in.formats, "the packed file's formats differ from the input's")
    changed, total = 0, 0
    for key in ctl.formats:
        a, b = packed[key], inp[key]
        check(a.shape == b.shape and a.dtype == b.dtype, f"{key}: {a.shape} {a.dtype} "
              f"against the input's {b.shape} {b.dtype}")
        changed += int(np.sum(a.view(np.uint8) != b.view(np.uint8)))
        total += a.size
    worst, differ = {}, {}
    for key in record["sample"]:
        check(ctl.formats[key] == "float8_e4m3fn", f"{key} is {ctl.formats[key]}")
        eff = (record["final"][key] + record["residual"][key]).astype(np.float64)
        deq = np.asarray(q.dequantize_records(key, packed), np.float32)
        differ[key] = int(np.sum(deq.view(np.int32)
                                 != record["device_projected"][key].view(np.int32)))
        scale = float(np.asarray(packed[q.comfy_scale_key(key)]))
        err = np.abs(deq.astype(np.float64) - eff) / e4m3_step(eff, scale)
        worst[key] = float(err.max())
    print(f"  packed file [{smi}]: {len(ctl.formats)} controlled tensors, formats and shapes "
          f"unchanged; {changed / total:.4%} of {total:,} codes changed from the input; "
          "values differing bit for bit from the card's projection of final + residual: "
          + ", ".join(f"{k} {v}" for k, v in differ.items())
          + "; dequantized against final + residual, in e4m3 steps at each value: "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    check(not any(differ.values()),
          f"the packed file differs from the card's projection of final + residual: {differ}")
    # round to nearest: half a step, up to the fp32 rounding of the scale's
    # quotient and product (about 2^-21 of a step)
    check(all(v <= 0.5 + 1e-5 for v in worst.values()),
          f"the packed file is more than half an e4m3 step from final + residual: {worst}")
    return {"controlled": len(ctl.formats), "codes_changed_share": changed / total,
            "codes": total, "max_err_in_steps": worst, "bits_differing_from_card": differ}


def profile_quants_on_card(torch, ckpt: Path, work_dir: Path, smi: str,
                           blocks: int) -> tuple[dict, dict]:
    """``tools/profile_quants --mode dynamic`` on the DiT ``ckpt`` (of
    ``blocks`` blocks) at the card: int8 trials of PROFILE_LAYERS layers
    at --latent-hw PROFILE_LATENT_HW (synthetic calibration), its forwards
    (fp32, no remat) timed and its flash launches counted
    (flash_fwd_f32_d128, one a block a forward). Returns (summary,
    launches)."""
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    from aozora_sdxl_training_tpu_torch.tools import profile_quants
    build, forwards = profile_quants.build_forward_fn, []

    def build_timed(*args, **kwargs):
        fwd = build(*args, **kwargs)

        def timed(state):
            t0 = time.perf_counter()
            out = fwd(state)          # returns host numpy: synced
            forwards.append(time.perf_counter() - t0)
            return out
        return timed

    out_path = work_dir / "anima_profiled.safetensors"
    log = io.StringIO()
    profile_quants.build_forward_fn = build_timed
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(Tee(sys.stdout, log)):
            profile_quants.main([str(ckpt), str(out_path), "--mode", "dynamic",
                                 "--format", "int8", "--preset", "target",
                                 "--max-layers", str(PROFILE_LAYERS),
                                 "--latent-hw", str(PROFILE_LATENT_HW)])
    finally:
        profile_quants.build_forward_fn = build
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    report = json.loads(log.getvalue()[log.getvalue().index("{"):])
    check(sum(report["assignment_counts"].values()) == PROFILE_LAYERS,
          f"profile_quants assigned {report['assignment_counts']}")
    check(len(forwards) == PROFILE_LAYERS + 1, f"{len(forwards)} forwards")
    check_launches(launches, {"flash_fwd_f32_d128": blocks * (PROFILE_LAYERS + 1)})
    out_path.unlink()
    print(f"  profile_quants --mode dynamic [{smi}]: {len(forwards)} fp32 forwards at "
          f"{(PROFILE_LATENT_HW // 2) ** 2} tokens, {forwards[0]:.3f} s the first (the "
          f"state's upload), then {min(forwards[1:]):.3f}-{max(forwards[1:]):.3f} s; "
          f"CLI {wall:.1f} s")
    return ({"forward_s": forwards, "wall_s": wall, "report": report,
             "launches": launches}, launches)


def repair_phase(torch, work_dir: Path, steps: int, smi: str):
    """The QAT repair flow at ANIMA_BASE's widths (CUT_BLOCKS blocks):
    the device projection against the host in five formats; the random DiT
    quantized by the port's
    convert_quants CLI (e4m3, target preset); random Qwen3 and Wan VAE
    files and 2 captioned 1024px images cached with line-art masks; the
    repair CLI (1024px, batch 1, GA 4, Full remat, SHORT_STEPS micro steps) with its
    projection, host passes, steps and peak timed; the packed file checked;
    then profile_quants' dynamic mode on the card."""
    phase("repair")
    from aozora_sdxl_training_tpu_torch.cli import train_anima_repair
    from aozora_sdxl_training_tpu_torch.tools import convert_quants
    from aozora_sdxl_training_tpu_torch.train import anima_trainer
    projection = projection_against_host(torch, smi)

    inputs = anima_cache_inputs(torch, work_dir)
    cfg, preset_path, config = anima_env(torch, work_dir, steps, synthetic_cache=False,
                                         blocks=CUT_BLOCKS,
                                         anima_repair_lineart_loss_enabled=True, **inputs)
    check(config.ANIMA_REPAIR_LINEART_LOSS_ENABLED, "the preset's line-art key did not "
          "reach the config")
    base = Path(config.DIT_PATH)
    quant = work_dir / "anima_e4m3.safetensors"
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, log)):
        convert_quants.main([str(base), str(quant), "--format", "e4m3", "--preset", "target"])
    convert_s = time.perf_counter() - t0
    report = json.loads(log.getvalue())
    print(f"  convert_quants e4m3 target [{smi}]: {report['quantized']} tensors quantized, "
          f"{report['kept']} kept, {quant.stat().st_size / 1e9:.2f} GB in {convert_s:.1f} s")
    preset = json.loads(preset_path.read_text())
    preset["anima"]["anima_dit_model_path"] = str(quant)
    preset_path.write_text(json.dumps(preset, indent=1))
    cache = anima_cache_phase(torch, preset_path, work_dir, config, smi, lineart=True)

    record: dict = {"sample": [PROJECTED_KEY,
                               f"blocks.{cfg.num_blocks - 1}.self_attn.q_proj.weight",
                               f"blocks.{cfg.num_blocks // 2 - 1}.mlp.layer2.weight",
                               "llm_adapter.blocks.5.cross_attn.k_proj.weight"]}
    marks: list = []
    restore = timed_repair(torch, record, marks)
    try:
        raw, marks, launches, peak_gb, wall = run_trainer_cli(
            torch, train_anima_repair.main, preset_path, work_dir, anima_trainer,
            ("make_anima_micro_step", "make_apply_step"), "chip_smoke_repair.log",
            marks=marks)
    finally:
        restore()
    check(f"INFO: QAT repair: {report['quantized']} quantized tensors under prefix "
          "'pipe.dit.'" in raw, "no 'QAT repair: N quantized tensors' line")
    check("INFO: Cached line-art loss: enabled=True" in raw, "the line-art loss is off")
    check("encoding" not in raw, "the trainer encoded the cache again")
    losses = check_progress(raw, ANIMA_PROGRESS, steps)
    calls = cfg.num_blocks
    check_launches(launches, {"flash_fwd_d128": 2 * calls * steps,
                              "flash_bwd_dq_d128": calls * steps,
                              "flash_bwd_dkv_d128": calls * steps})
    check(len(record.get("project_ms", ())) == steps // GA,
          f"{len(record.get('project_ms', ()))} projections in {steps // GA} optimizer steps")
    plan = PLAN_EST.search(raw)
    check(plan is not None, "no memory plan line")
    packed = check_repaired(work_dir, quant, record, smi)
    tokens = (1024 // 8 // cfg.patch_spatial) ** 2
    fwd = anima_forward_flops(cfg, tokens)
    summary = step_summary(marks, steps, fwd, peak_gb, wall, launches, losses, remat="full",
                           forward_flops=fwd, cache=cache, plan_estimate_gb=float(plan.group(2)))
    project_ms = record["project_ms"]
    s_optim = summary["s_per_optimizer_step_ga4"] + sum(project_ms) / len(project_ms) / 1e3
    print(f"  [{smi}] projection {', '.join(f'{x:.1f}' for x in project_ms)} ms an optimizer "
          f"step (synced), residuals {record['residual_gb']:.3f} GB (fp16); host: dequantize "
          f"at load {record['dequantize_s']:.1f} s, pack at save {record['pack_s']:.1f} s; "
          f"{s_optim:.4f} s an optimizer step with the projection; peak {peak_gb:.2f} GB "
          f"against the plan's estimate {float(plan.group(2)):.2f} GB (which leaves out "
          "the residuals)")
    for path in (quant, work_dir / "out" / "smoke_anima.safetensors",
                 work_dir / "out" / "repaired_quantized.safetensors"):
        path.unlink()
    profile, profile_launches = profile_quants_on_card(torch, base, work_dir, smi,
                                                       cfg.num_blocks)
    summary.update(projection=projection, convert_s=convert_s, convert_report=report,
                   project_ms=project_ms, residual_gb=record["residual_gb"],
                   dequantize_s=record["dequantize_s"], pack_s=record["pack_s"],
                   s_per_optimizer_step_with_projection=s_optim, packed=packed,
                   profile_quants=profile)
    return summary, launches, profile_launches


# --------------------------------------------------------------------------
# 13: the memory plan on the card's budget
# --------------------------------------------------------------------------

PLAN_STEPS = 4                # one optimizer step at GA 4, or 4 at GA 1
RUNG_STEPS = 4                # optimizer steps of a low-memory rung's run (GA 1)
GUI_TIMEOUT_S = 420           # the GUI launch's trainer process, then killed
PLAN_EST = re.compile(r"INFO: Memory plan \(budget ([\d.]+) GB, est peak ([\d.]+) GB\)")


def plan_lines(raw: str) -> list:
    """``describe_plan``'s lines in a trainer's output."""
    out = lines(raw)
    start = next(i for i, line in enumerate(out) if line.startswith("INFO: Memory plan"))
    end = start + 1
    while end < len(out) and out[end].startswith("INFO:   "):
        end += 1
    return out[start:end]


def plan_run(torch, cli_main, module, step_names, preset: dict, mode: str,
             work_dir: Path, label: str, pattern, env: dict | None = None,
             steps: int = PLAN_STEPS) -> dict:
    """One training CLI run of ``steps`` micro steps on ``preset`` (its
    max_train_steps; its final model, which nothing reads, not written):
    its plan (printed), s per micro step after the first, peak memory
    beside the plan's estimate, launches per micro step, losses."""
    import numpy as np
    preset = {**preset, mode: {**preset[mode], f"{mode}_max_train_steps": steps}}
    preset_path = work_dir / f"{label}.json"
    preset_path.write_text(json.dumps(preset, indent=1))
    env = dict(env or {})
    traced = os.environ.get("CHIP_SMOKE_TRACE", "")
    traced = bool(traced) and (traced == "1" or label in traced.split(","))
    if traced:
        # micro steps 3-8 traced (train/profiling.py): not a timing run
        env["AOZORA_PROFILE_DIR"] = str((LOG_DIR / f"trace_plan_{label}").resolve())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        raw, marks, launches, peak_gb, wall = run_trainer_cli(
            torch, cli_main, preset_path, work_dir, module, step_names,
            f"chip_smoke_plan_{label}.log", final_save=False)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    plan = plan_lines(raw)
    budget, est = (float(x) for x in PLAN_EST.search(plan[0]).groups())
    segs = [seg.strip() for chunk in raw.split("\n") for seg in chunk.split("\r")]
    losses = [float(m.group(3)) for m in map(pattern.search, segs) if m]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"{label}: losses {losses}")
    micro, apply_ = step_times(marks, skip=1)
    per_step = {k: v / steps for k, v in launches.items() if v}
    out = {"plan": plan, "budget_gib": budget, "est_peak_gib": est,
           "est_peak_gb": est * 2 ** 30 / 1e9, "max_memory_allocated_gb": peak_gb,
           "s_per_micro_step": micro, "median_s_per_micro_step": float(np.median(micro)),
           "s_per_apply_step": apply_, "launches_per_micro_step": per_step,
           "losses": losses, "wall_s": wall}
    if traced:
        for trace in (LOG_DIR / f"trace_plan_{label}").resolve().glob("*/trace.json.gz"):
            trace.unlink()        # too large to keep; summary.json and kernels.txt stay
    print(f"  {label}: " + "\n    ".join(plan))
    print(f"  {label}: {out['median_s_per_micro_step']:.4f} s/micro step (median of "
          f"{len(micro)} after the first)"
          + (f", {float(np.mean(apply_)):.4f} s/apply step" if apply_ else "")
          + f"; peak {peak_gb:.2f} GB (max_memory_allocated) against the plan's "
          f"estimate {est:.2f} GiB = {out['est_peak_gb']:.2f} GB; launches a micro "
          f"step {per_step}")
    return out


def copy_overlap(prof, path: Path) -> dict:
    """The host-moment copies of a traced apply step, by direction (HtoD,
    DtoH): count, bytes, busy ms, GB/s while busy, and the share of their
    time that a kernel runs beside them (any stream); the window from the
    first device event to the last, and the kernels' busy ms (their
    union)."""
    import bisect
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy") and "dur" in e]
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device
                       if e["cat"] == "kernel"):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]

    def covered(a, b):
        i, total = max(bisect.bisect_right(starts, a) - 1, 0), 0.0
        while i < len(merged) and merged[i][0] < b:
            total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
        return total

    out = {}
    for direction in ("HtoD", "DtoH"):
        copies = [e for e in device if e["cat"] == "gpu_memcpy" and direction in e["name"]]
        busy = sum(e["dur"] for e in copies)
        nbytes = sum(int(e.get("args", {}).get("bytes", 0)) for e in copies)
        over = sum(covered(e["ts"], e["ts"] + e["dur"]) for e in copies)
        out[direction] = {"copies": len(copies), "bytes": nbytes, "busy_ms": busy / 1e3,
                          "gb_per_s": nbytes / busy / 1e3 if busy else 0.0,
                          "overlap_share": over / busy if busy else 0.0}
    if device:
        out["window_ms"] = (max(e["ts"] + e["dur"] for e in device)
                            - min(e["ts"] for e in device)) / 1e3
    out["kernel_busy_ms"] = sum(b - a for a, b in merged) / 1e3
    return out


def traced_host_apply(torch, record: dict, traced_call: int):
    """Wraps ``opt.adamw.apply_updates`` for a run whose moments live on
    the host: each call's bytes each way go into record["bytes"], the
    ``traced_call``-th call runs under torch.profiler (``copy_overlap``
    into record["trace"], its synced ms into record["traced_ms"]), and
    record["pinned"] says whether every moment is still pinned after it.
    Returns a restore function."""
    from aozora_sdxl_training_tpu_torch.opt import adamw
    real = adamw.apply_updates

    def apply_updates(params, grads, state, cfg, **kw):
        host = state.host
        check(host is not None, "moments_host: the optimizer's moments are on the card")
        record["calls"] = record.get("calls", 0) + 1
        record["chunks"] = len(host.chunks)
        before = (host.bytes_h2d, host.bytes_d2h)
        if record["calls"] != traced_call:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(params, grads, state, cfg, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            # the host's time to issue the step, and the step's to end
            record.setdefault("issue_done_ms", []).append(
                ((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
        else:
            torch.cuda.synchronize()
            # device activity only: a host-op trace of ~50,000 launches
            # takes tens of seconds to export
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = real(params, grads, state, cfg, **kw)
                host.synchronize()
                torch.cuda.synchronize()
                record["traced_ms"] = (time.perf_counter() - t0) * 1e3
            record["trace"] = copy_overlap(prof, LOG_DIR / "host_apply_trace.json")
            record["pinned"] = all(
                t.device.type == "cpu" and t.is_pinned()
                for field in (state.exp_avg, state.exp_avg_sq) for m in field.values()
                for t in (m if isinstance(m, tuple) else (m,)))
        record.setdefault("bytes", []).append(
            (host.bytes_h2d - before[0], host.bytes_d2h - before[1]))
        return out

    LOG_DIR.mkdir(parents=True, exist_ok=True)
    adamw.apply_updates = apply_updates
    return lambda: setattr(adamw, "apply_updates", real)


def rung_run(torch, cli_main, module, micro_name: str, rung: str, preset: dict,
             mode: str, work_dir: Path, label: str, pattern, fused_launches: dict) -> dict:
    """A ``plan_run`` at GA 1 with AOZORA_LOWMEM_RUNG=``rung``: RUNG_STEPS
    optimizer steps (moments_host one more, whose apply step is traced:
    ``traced_host_apply``). Checks the plan's lines for the rung, bf16
    masters and int8 moments, and the flash launches an optimizer step:
    twice ``fused_launches`` (the fused step's at the same remat mode) for
    the two-pass step, once for the host moments. Adds the s per optimizer
    step of steps 2-4 and their median."""
    import numpy as np
    two_pass = rung == "two_pass"
    steps = RUNG_STEPS + (not two_pass)
    record: dict = {}
    restore = (lambda: None) if two_pass else traced_host_apply(torch, record, steps)
    try:
        run = plan_run(torch, cli_main, module,
                       ("make_two_pass_step",) if two_pass else (micro_name, "make_apply_step"),
                       preset, mode, work_dir, label, pattern,
                       env={"AOZORA_LOWMEM_RUNG": rung}, steps=steps)
    finally:
        restore()
    text = "\n".join(run["plan"])
    check(("two-pass step" in text) if two_pass else ("OFFLOADED to pinned host memory" in text),
          f"{label}: the plan does not name the {rung} rung")
    check("master weights: bfloat16" in text and "moments: int8_blockwise" in text,
          f"{label}: the forced rung's plan is not bf16 masters with int8 moments")
    per_step = (run["s_per_micro_step"] if two_pass else
                [a + b for a, b in zip(run["s_per_micro_step"], run["s_per_apply_step"])])
    run["s_per_optimizer_step"] = per_step[:RUNG_STEPS - 1]
    run["median_s_per_optimizer_step"] = float(np.median(run["s_per_optimizer_step"]))
    want = {k: v * (2 if two_pass else 1) for k, v in fused_launches.items()}
    check(run["launches_per_micro_step"] == want,
          f"{label}: flash launches an optimizer step {run['launches_per_micro_step']}, "
          f"expected {want}")
    print(f"  {label}: {run['median_s_per_optimizer_step']:.4f} s/optimizer step (median "
          f"of steps 2-{RUNG_STEPS}: {run['s_per_optimizer_step']}); flash launches an "
          f"optimizer step {run['launches_per_micro_step']} = "
          f"{2 if two_pass else 1} x the fused step's")
    if not two_pass:
        check(record.get("pinned") is True, f"{label}: a moment is not pinned after a step")
        trace = record["trace"]
        h2d, d2h = record["bytes"][-1]
        run.update(host_bytes_per_step={"h2d": h2d, "d2h": d2h}, host_apply_trace=trace,
                   traced_apply_ms=record["traced_ms"], host_chunks=record["chunks"])
        check(all(b == (h2d, d2h) for b in record["bytes"]) and h2d == d2h > 0,
              f"{label}: bytes each way by step {record['bytes']}")
        # the trace keeps most copy records but not always all (it has lost
        # the first few H2D chunks of a step): GB/s and overlap are those
        # of the copies it holds
        check(0.75 * h2d <= trace["HtoD"]["bytes"] <= h2d
              and 0.75 * d2h <= trace["DtoH"]["bytes"] <= d2h,
              f"{label}: the trace's copies {trace} against {h2d} / {d2h} B issued")
        run["apply_issue_done_ms"] = record.get("issue_done_ms", [])
        print(f"  {label}: apply steps, host issue / done ms: {run['apply_issue_done_ms']}")
        print(f"  {label}: {h2d / 1e9:.3f} GB in and {d2h / 1e9:.3f} GB out a step, "
              f"{record['chunks']} chunks; the trace holds {trace['HtoD']['copies']} "
              f"H2D and {trace['DtoH']['copies']} D2H copies, {trace['HtoD']['bytes'] / 1e9:.3f} "
              f"and {trace['DtoH']['bytes'] / 1e9:.3f} GB; traced "
              f"apply step {record['traced_ms']:.1f} ms (device window "
              f"{trace.get('window_ms', 0):.1f} ms, kernels busy "
              f"{trace['kernel_busy_ms']:.1f} ms); H2D {trace['HtoD']['gb_per_s']:.2f} GB/s "
              f"over {trace['HtoD']['busy_ms']:.1f} ms, {trace['HtoD']['overlap_share']:.1%} "
              f"beside a kernel; D2H {trace['DtoH']['gb_per_s']:.2f} GB/s over "
              f"{trace['DtoH']['busy_ms']:.1f} ms, {trace['DtoH']['overlap_share']:.1%} "
              f"beside a kernel")
    return run


def gui_launch_run(torch, preset: dict, work_dir: Path, fused_launches: dict) -> dict:
    """The GUI's launch of the SDXL CLI, headless: the port's
    ``gui.process_runner.launch_trainer`` starts the app's command
    (``gui.app.trainer_command``: ``python -u -m ...cli.train_sdxl --config
    <preset>``) on ``preset`` with AOZORA_LOWMEM_RUNG=two_pass, for
    RUNG_STEPS optimizer steps at GA 1, and its stdout goes line by line
    into the port's ``LiveMetrics``; ``request_force_save`` drops the flag
    once the first optimizer block is read. Checks the exit code, one
    finite loss per optimizer step in the parsed series, the plan's two-pass
    line, the emergency checkpoint, and (from the trainer's step log,
    AOZORA_STEP_LOG) twice the fused step's flash launches an optimizer
    step. Returns s per optimizer step (steps 2-4, synced; their median),
    the peak memory and the launches."""
    import gc
    import threading

    import numpy as np
    from aozora_sdxl_training_tpu_torch.gui.app import trainer_command, trainer_module
    from aozora_sdxl_training_tpu_torch.gui.metrics import LiveMetrics
    from aozora_sdxl_training_tpu_torch.gui.process_runner import (launch_trainer,
                                                                  request_force_save)
    out_dir = work_dir / "out_gui"
    preset = {**preset, "sdxl": {**preset["sdxl"], "sdxl_output_dir": str(out_dir),
                                 "sdxl_output_name": "gui",
                                 "sdxl_max_train_steps": RUNG_STEPS}}
    preset_path = work_dir / "gui_two_pass.json"
    preset_path.write_text(json.dumps(preset, indent=1))
    step_log = work_dir / "gui_steps.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "AOZORA_PROFILE_DIR"}
    env.update(AOZORA_LOWMEM_RUNG="two_pass", AOZORA_STEP_LOG=str(step_log))
    metrics, kept, flags = LiveMetrics(), [], []
    exited, codes = threading.Event(), []

    def on_line(line):
        kept.append(line)
        metrics.parse_line(line)
        if not flags and OPTIM_STEP.search(line):
            flags.append(request_force_save(work_dir))

    def on_exit(code):
        codes.append(code)
        exited.set()

    gc.collect()                  # the parent's cached blocks go back to the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runner = launch_trainer(trainer_module("SDXL"), preset_path, module=True,
                            cwd=work_dir, env=env, on_line=on_line,
                            on_progress=metrics.parse_line, on_exit=on_exit)
    print(f"  gui launch: {' '.join(runner.args)} (cwd {work_dir})", flush=True)
    if not exited.wait(GUI_TIMEOUT_S):
        runner.stop()
        raise PhaseError(f"gui launch: the trainer ran past {GUI_TIMEOUT_S} s; its "
                         "process group was killed")
    wall = time.perf_counter() - t0
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    (LOG_DIR / "chip_smoke_gui_launch.log").write_text("\n".join(kept))
    check(codes == [0], f"gui launch: the trainer exited {codes}")
    check(runner.args == trainer_command("SDXL", preset_path)
          and runner.args[2:4] == ["-m", f"{PACKAGE}.cli.train_sdxl"],
          f"gui launch: the command {runner.args}")
    optim = list(zip(metrics.optim_loss.xs, metrics.optim_loss.ys))
    check([s for s, _ in optim] == list(range(1, RUNG_STEPS + 1))
          and all(math.isfinite(x) for _, x in optim)
          and len(metrics.step_loss.xs) == RUNG_STEPS,
          f"gui launch: parsed optimizer steps {optim}, progress steps "
          f"{list(metrics.step_loss.xs)}")
    check(not metrics.failures, f"gui launch: failure lines {metrics.failures}")
    plan = plan_lines("\n".join(kept))
    check(any("two-pass step" in line for line in plan),
          f"gui launch: the plan {plan} does not name the two-pass rung")
    saved = [int(m.group(1)) for m in map(
        re.compile(r"Emergency checkpoint requested at optimizer step (\d+)").search, kept) if m]
    check(flags and len(saved) == 1, f"gui launch: emergency checkpoints {saved}")
    files = [out_dir / f"gui_step_{saved[0]}.safetensors",
             out_dir / f"gui_training_state_step_{saved[0]}.safetensors"]
    check(all(f.exists() and f.stat().st_size > 0 for f in files),
          f"gui launch: no checkpoint at optimizer step {saved[0]}")
    for f in files:
        f.unlink()                # disk room for the final save of later runs
    log = [json.loads(line) for line in step_log.read_text().splitlines()]
    check([e["micro_step"] for e in log] == list(range(1, RUNG_STEPS + 1)),
          f"gui launch: step log {log}")
    times = [b["t"] - a["t"] for a, b in zip(log, log[1:])]
    launches = {k: v / RUNG_STEPS for k, v in log[-1]["flash_launches"].items()}
    want = {k: 2 * v for k, v in fused_launches.items()}
    check(launches == want, f"gui launch: flash launches an optimizer step {launches}, "
          f"expected {want}")
    est = float(PLAN_EST.search(plan[0]).group(2))
    out = {"command": runner.args, "plan": plan, "exit_code": codes[0],
           "optimizer_losses": [x for _, x in optim], "checkpoint_step": saved[0],
           "s_per_optimizer_step": times, "median_s_per_optimizer_step": float(np.median(times)),
           "max_memory_allocated_gb": max(e["max_memory_allocated"] for e in log) / 1e9,
           "est_peak_gib": est, "est_peak_gb": est * 2 ** 30 / 1e9,
           "launches_per_optimizer_step": launches, "wall_s": wall}
    print(f"  gui launch: exit 0 in {wall:.1f} s; optimizer losses {out['optimizer_losses']}; "
          f"emergency checkpoint at step {saved[0]}; {out['median_s_per_optimizer_step']:.4f} "
          f"s/optimizer step (median of steps 2-{RUNG_STEPS}: {times}); peak "
          f"{out['max_memory_allocated_gb']:.2f} GB against the plan's {est:.2f} GiB = "
          f"{out['est_peak_gb']:.2f} GB; flash launches an optimizer step {launches} = "
          f"2 x the fused step's")
    return out


def default_plans(torch) -> dict:
    """Each trainer's plan for its default preset (1024px, batch 1, GA 4,
    raven with bf16 moments, the default freeze lists) on this card's
    budget, without a run."""
    from aozora_sdxl_training_tpu_torch.models.anima import dit
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE, param_shapes
    from aozora_sdxl_training_tpu_torch.train import memory_policy as mp
    from aozora_sdxl_training_tpu_torch.train.train_step import split_trainable
    budget = mp.device_budget_bytes(torch.device("cuda", 0))
    sizes = {n: math.prod(s) for n, (s, _) in param_shapes(SDXL_BASE).items()}
    t = sum(split_trainable(sizes, ["conv1", "conv2"])[0].values())
    sdxl = mp.plan_sdxl_training(
        trainable_elems=t, frozen_elems=sum(sizes.values()) - t, batch_per_device=1,
        max_latent_pixels=128 * 128, ga_steps=GA, budget_bytes=budget)
    n = sum(math.prod(s) for s in dit.param_shapes(dit.ANIMA_BASE).values())
    anima = mp.plan_anima_training(
        trainable_elems=n, frozen_elems=0, batch_per_device=1, tokens=64 * 64,
        ga_steps=GA, remat=True, budget_bytes=budget)
    out = {}
    for name, plan in (("sdxl", sdxl), ("anima", anima)):
        text = mp.describe_plan(plan)
        print(f"  default {name} plan on this card ({budget / 2 ** 30:.2f} GiB):\n    "
              + text.replace("\n", "\n    "))
        out[name] = {"describe_plan": text, "est_peak_gb": plan.est_bytes / 1e9,
                     "budget_bytes": budget}
    return out


def plan_phase(torch, work_dir: Path, smi: str) -> dict:
    """ANIMA_BASE under Conservative against Full; SDXL with bf16 masters
    at GA 1 (the fused step) and under AOZORA_SDXL_REMAT=
    dots_no_logits_hires (PLAN_STEPS micro steps each; the default plan's
    run is the trainer phase's); each trainer's default plan. Then the
    low-memory rungs, forced at GA 1 (RUNG_STEPS optimizer steps each):
    ANIMA_BASE (Full) under two_pass and moments_host, SDXL_BASE under
    moments_host, and SDXL under two_pass as the GUI launches it
    (``gui_launch_run``). The SDXL runs but the host moments' take the
    dp phase's cut UNet (``cut_sdxl``: SDXL_BASE's widths, one transformer
    layer a block) for the script's time; the host moments keep SDXL_BASE
    whole, so that its traced apply step holds enough copies to measure.
    CHIP_SMOKE_TRACE traces micro steps 3-8 of all runs ("1") or of the
    runs it names."""
    phase("plan")
    import numpy as np
    from aozora_sdxl_training_tpu_torch.cli import train_anima, train_sdxl
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import (
        write_random_sd_checkpoint, write_synthetic_dataset)
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE
    from aozora_sdxl_training_tpu_torch.train import anima_trainer
    from aozora_sdxl_training_tpu_torch.train import trainer as trainer_module
    print(f"  card: {smi}")
    out = {"default": default_plans(torch)}

    # ANIMA_BASE: Full, then Conservative, on one random checkpoint and cache
    anima_dir = work_dir / "anima"
    anima_dir.mkdir()
    cfg, preset_path, _ = anima_env(torch, anima_dir, PLAN_STEPS)
    preset = json.loads(preset_path.read_text())
    calls = cfg.num_blocks
    steps = ("make_anima_micro_step", "make_apply_step")
    for mode, fwd in (("Full", 2), ("Conservative", 1)):
        preset["anima"]["anima_gradient_checkpointing_mode"] = mode
        run = plan_run(torch, train_anima.main, anima_trainer, steps, preset, "anima",
                       anima_dir, f"anima_{mode.lower()}", ANIMA_PROGRESS)
        check(f"remat: {True if mode == 'Full' else 'conservative'}" in "\n".join(run["plan"]),
              f"anima {mode}: the plan's remat")
        check(run["launches_per_micro_step"] == {
            "flash_fwd_d128": fwd * calls, "flash_bwd_dq_d128": calls,
            "flash_bwd_dkv_d128": calls},
            f"anima {mode}: launches a micro step {run['launches_per_micro_step']}")
        out[f"anima_{mode.lower()}"] = run
    full, cons = out["anima_full"]["losses"], out["anima_conservative"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(cons, full))
    print(f"  anima: Conservative's losses against Full's: largest relative "
          f"difference {rel:.3e}")
    check(rel <= 1e-3, f"Conservative's losses {cons} against Full's {full}")
    out["anima_conservative"]["loss_rel_to_full"] = rel
    # the low-memory rungs, forced at GA 1 under Full remat
    preset["anima"].update(anima_gradient_checkpointing_mode="Full",
                           anima_gradient_accumulation_steps=1)
    for rung in ("two_pass", "moments_host"):
        out[f"anima_{rung}"] = rung_run(
            torch, train_anima.main, anima_trainer, "make_anima_micro_step", rung, preset,
            "anima", anima_dir, f"anima_{rung}", ANIMA_PROGRESS,
            out["anima_full"]["launches_per_micro_step"])
    shutil_rmtree(anima_dir)

    # the cut SDXL on a synthetic cache: bf16 masters at GA 1 (fused), then
    # dots_no_logits_hires at GA 4
    sdxl_dir = work_dir / "sdxl"
    sdxl_dir.mkdir()
    full_ckpt, _, _ = shared_weights(torch, "sdxl_random.safetensors", lambda path: (
        write_random_sd_checkpoint(path, seed=1234, device="cuda")))
    unet_cfg, ckpt, _ = cut_sdxl(torch)
    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    preset["sdxl"].update({
        "sdxl_base_model_path": str(ckpt), "sdxl_output_dir": str(sdxl_dir / "out"),
        "sdxl_output_name": "plan", "sdxl_max_train_steps": PLAN_STEPS,
        "sdxl_instance_datasets": [{"path": str(sdxl_dir / "data"), "repeats": 1}]})
    config = RuntimeConfig(schema.flatten_preset(preset))
    write_synthetic_dataset(sdxl_dir / "data", config, n_images=2,
                            image_size=(1024, 1024), seq_len=77,
                            embed_dim=SDXL_BASE.cross_attention_dim,
                            pooled_dim=SDXL_BASE.pooled_projection_dim, seed=7)
    calls = sdxl_self_attn_calls(unet_cfg)
    steps = ("make_micro_step", "make_apply_step")
    once = {"flash_fwd": calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
    calls = SELF_ATTN_CALLS[64]
    once_full = {"flash_fwd": calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
    # the default preset's plan (fp32 masters, GA 4, no remat) is the
    # trainer phase's run; the plan phase runs the others
    bf16 = {**preset, "sdxl": {**preset["sdxl"], "sdxl_master_dtype": "bfloat16",
                               "sdxl_gradient_accumulation_steps": 1}}
    run = plan_run(torch, train_sdxl.main, trainer_module, steps, bf16, "sdxl",
                   sdxl_dir, "sdxl_bf16_ga1", SDXL_PROGRESS)
    text = "\n".join(run["plan"])
    check("master weights: bfloat16" in text and "fused into the train step" in text,
          "SDXL bf16 GA 1: the plan is not bf16 masters with the fused step")
    # GA 1: an apply step after every micro step; a step is the two
    check(len(run["s_per_apply_step"]) == len(run["s_per_micro_step"]),
          "SDXL bf16 GA 1: not one apply step a micro step")
    run["median_s_per_step"] = float(np.median(
        [a + b for a, b in zip(run["s_per_micro_step"], run["s_per_apply_step"])]))
    print(f"  sdxl_bf16_ga1: {run['median_s_per_step']:.4f} s/step (micro + apply, median)")
    check(run["launches_per_micro_step"] == once,
          f"SDXL bf16: launches {run['launches_per_micro_step']}")
    out["sdxl_bf16_ga1"] = run
    run = plan_run(torch, train_sdxl.main, trainer_module, steps, preset, "sdxl", sdxl_dir,
                   "sdxl_dots_no_logits_hires", SDXL_PROGRESS,
                   env={"AOZORA_SDXL_REMAT": "dots_no_logits_hires"})
    check("remat: dots_no_logits_hires" in "\n".join(run["plan"]),
          "SDXL: the pinned remat mode is not the plan's")
    # every attention unit of SDXL at 1024px sits below the default
    # 4160-token tier: no flash forward runs again
    check(run["launches_per_micro_step"] == once,
          f"SDXL dots_no_logits_hires: launches {run['launches_per_micro_step']}")
    out["sdxl_dots_no_logits_hires"] = run
    # the low-memory rungs at GA 1: the host moments in this process, the
    # two-pass step through the GUI's launch of the CLI
    out["sdxl_two_pass_gui"] = gui_launch_run(torch, bf16, sdxl_dir, once)
    rung = "sdxl_two_pass_gui"
    print(f"  {rung}: {out[rung]['median_s_per_optimizer_step']:.4f} s/optimizer step "
          f"against the fused step's {out['sdxl_bf16_ga1']['median_s_per_step']:.4f} "
          f"(sdxl_bf16_ga1); peak {out[rung]['max_memory_allocated_gb']:.2f} GB against "
          f"its {out['sdxl_bf16_ga1']['max_memory_allocated_gb']:.2f} GB")
    full = {**bf16, "sdxl": {**bf16["sdxl"], "sdxl_base_model_path": str(full_ckpt)}}
    out["sdxl_moments_host"] = rung_run(
        torch, train_sdxl.main, trainer_module, "make_micro_step", "moments_host", full,
        "sdxl", sdxl_dir, "sdxl_moments_host", SDXL_PROGRESS, once_full)
    shutil_rmtree(sdxl_dir)
    return out


def shutil_rmtree(path: Path):
    import shutil
    shutil.rmtree(path, ignore_errors=True)


# --------------------------------------------------------------------------
# 12 (within 7 and 8): resume, the training-state file and int8 moments at
# full width
# --------------------------------------------------------------------------

# free disk each part needs at its peak, with room: SDXL the 6.94 GB random
# checkpoint, a 6.94 GB merged model at optimizer step 1 beside its 9.1 GB
# state, and a final model with its temporary copy; Anima 4.2 GB DiT
# files and an 8.4 GB state
RESUME_FREE_GB = {"sdxl": 40.0, "anima": 30.0}
# The trainer phases run one optimizer step (TRAIN_STEPS micro steps) and
# save at its end; a resumed run goes on from those files to micro step
# RESUME_TO. No unbroken run covers micro steps 5-8, so the resumed run is
# held to what resuming must give exactly (the sampler's tickets, the
# moments, the counters) and to the unbroken run's peak; its losses are
# printed. The CPU tests hold resumed runs against unbroken ones at TINY
# size (tests/test_torch_port_trainer.py, tests/test_torch_port_anima_trainer.py).
UPDATE_MAGNITUDE = re.compile(r"Update Magnitude\s*:\s*([\d.e+-]+)")


def check_disk(work_dir: Path, need_gb: float, smi: str):
    import shutil
    free = shutil.disk_usage(work_dir).free / 1e9
    print(f"  resume: [{smi}] {free:.1f} GB free at {work_dir} (needs {need_gb:.0f} GB)")
    check(free >= need_gb, f"{free:.1f} GB free at {work_dir}: the resume phase "
          f"writes up to {need_gb:.0f} GB there")


def state_saved(label: str, state_io: dict, smi: str) -> dict:
    ((save_s, nbytes),) = state_io["save"]
    print(f"  [{smi}] {label}: training state {nbytes} B ({nbytes / 1e9:.3f} GB) "
          f"saved in {save_s:.3f} s ({nbytes / 1e9 / save_s:.3f} GB/s)")
    return {"state_bytes": nbytes, "save_s": save_s, "save_gb_per_s": nbytes / 1e9 / save_s}


def resume_from_step_1(torch, cli_main, module, step_names, preset: dict, mode: str,
                       out_dir: Path, stem: str, work_dir: Path, name: str, **overrides):
    """The ``mode`` training CLI resumed from ``out_dir``'s files of
    optimizer step 1 to micro step RESUME_TO (``preset`` with the resume
    keys and ``overrides``; its final model, which nothing reads, is not
    written); checks that it resumes, restores the optimizer state and goes
    on at optimizer step 2, then deletes the step-1 files. Returns (stdout,
    marks, launches, peak GB, wall s, state_io with host copies of the
    restored moments)."""
    import copy
    model, state = (out_dir / f"{stem}{kind}_step_1.safetensors"
                    for kind in ("", "_training_state"))
    check(model.exists() and state.exists(), f"{name}: no step-1 files in {out_dir}")
    resumed = copy.deepcopy(preset)
    resumed[mode].update({f"{mode}_resume_training": True,
                          f"{mode}_resume_model_path": str(model),
                          f"{mode}_resume_state_path": str(state),
                          f"{mode}_max_train_steps": RESUME_TO, **overrides})
    path = work_dir / f"preset_{name}.json"
    path.write_text(json.dumps(resumed, indent=1))
    state_io = {"snapshot": True}
    raw, marks, launches, peak_gb, wall = run_trainer_cli(
        torch, cli_main, path, work_dir, module, step_names,
        f"chip_smoke_{name}.log", state_io, final_save=False)
    check("--- RESUMING TRAINING SESSION ---" in raw
          and "INFO: Restored optimizer state from resume checkpoint." in raw,
          f"{name}: the run did not resume and restore its optimizer state")
    check(optimizer_steps(raw) == [2], f"{name}: optimizer steps {optimizer_steps(raw)}, not [2]")
    model.unlink()
    state.unlink()
    return raw, marks, launches, peak_gb, wall, state_io


def lines(raw: str):
    return [seg.strip() for chunk in raw.split("\n") for seg in chunk.split("\r")]


def optimizer_steps(raw: str) -> list:
    return [int(m.group(1)) for m in map(OPTIM_STEP.search, lines(raw)) if m]


def progress_tickets(raw: str, pattern) -> dict:
    """{micro step: its ticket} from the progress lines."""
    return {int(m.group(1)): int(m.group(4)) for m in map(pattern.search, lines(raw)) if m}


def same_moments(label: str, saved: dict, restored: dict) -> dict:
    """Checks that the moments restored on the card equal the saved ones
    bit for bit (host copies); returns the count of int8 and float moment
    tensors."""
    kinds = {"int8": 0, "float": 0}
    for field, moments in saved.items():
        for name, held in moments.items():
            got = restored[field][name]
            check(len(got) == len(held) and all(
                a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
                for a, b in zip(got, held)),
                f"{label}: the restored {field} of {name} differs from the saved one")
            kinds["int8" if len(held) == 2 else "float"] += 1
    return kinds


def scheduled_tickets(preset: dict, mode: str, steps: int) -> dict:
    """{micro step: its ticket} of a fresh run of ``preset`` for ``steps``
    micro steps at batch 1: the trainer's ticket pool (data/schedule.py,
    which sizes it by the run's max_train_steps), drawn in order."""
    import copy
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.schedule import TimestepTicketSampler
    fresh = copy.deepcopy(preset)
    fresh[mode][f"{mode}_max_train_steps"] = steps
    sampler = TimestepTicketSampler(RuntimeConfig(schema.flatten_preset(fresh)), batch_size=1)
    return {i: int(sampler.sample(1)[0]) for i in range(1, steps + 1)}


def resumed_run_checks(label: str, raw: str, pattern, launches: dict, want: dict,
                       preset: dict, mode: str, unbroken_raw: str, unbroken: dict,
                       peak_gb: float, saved_io: dict, state_io: dict, smi: str) -> dict:
    """Holds a resumed run (micro steps TRAIN_STEPS + 1 to RESUME_TO) to
    what resuming must give: finite losses and optimizer step 2, the
    launches ``want``, the tickets a fresh run at RESUME_TO steps draws for
    those micro steps (the unbroken run's own, micro steps 1 to
    TRAIN_STEPS, checked against a fresh run at its length), the saved
    moments restored bit for bit and the peak memory at most 0.5 GB above
    the unbroken run's; prints the losses, the step-2 update magnitude and
    the load and restore times."""
    n = RESUME_TO - TRAIN_STEPS
    losses = check_progress(raw, pattern, n)
    check_launches(launches, want)
    tickets, ref_tickets = progress_tickets(raw, pattern), progress_tickets(unbroken_raw, pattern)
    check(ref_tickets == scheduled_tickets(preset, mode, TRAIN_STEPS),
          f"{label}: the unbroken run's tickets {ref_tickets} are not its schedule's")
    scheduled = scheduled_tickets(preset, mode, RESUME_TO)
    check(tickets == {k: scheduled[k] for k in range(TRAIN_STEPS + 1, RESUME_TO + 1)},
          f"{label}: tickets {tickets} against the schedule's {scheduled}")
    kinds = same_moments(label, saved_io["saved"], state_io["restored"])
    update = float(UPDATE_MAGNITUDE.findall("\n".join(lines(raw)))[-1])
    print(f"  [{smi}] {label}: tickets of micro steps {TRAIN_STEPS + 1}-{RESUME_TO} "
          f"{list(tickets.values())}, the schedule's; {kinds['int8']} int8 and "
          f"{kinds['float']} float moment tensors restored bit for bit")
    print(f"  [{smi}] {label}: resumed losses (micro steps {TRAIN_STEPS + 1}-{RESUME_TO}) "
          f"{losses}; the unbroken run's (1-{TRAIN_STEPS}) {unbroken['losses']}; optimizer "
          f"step 2 update magnitude {update:.4e}")
    print(f"  [{smi}] {label}: state loaded in {state_io['load']:.3f} s, restored to the "
          f"card in {state_io['restore']:.3f} s; peak {peak_gb:.2f} GB resumed against "
          f"{unbroken['max_memory_allocated_gb']:.2f} GB unbroken")
    check(peak_gb <= unbroken["max_memory_allocated_gb"] + 0.5,
          f"{label}: resumed peak {peak_gb:.2f} GB, more than 0.5 GB above "
          f"{unbroken['max_memory_allocated_gb']:.2f} GB")
    return {"losses": losses, "unbroken_losses": unbroken["losses"], "tickets": tickets,
            "update_magnitude": update, "moments": kinds,
            "load_s": state_io["load"], "restore_s": state_io["restore"],
            "max_memory_allocated_gb": peak_gb}


def sdxl_resume_phase(torch, work_dir: Path, preset: dict, unbroken_raw: str,
                      unbroken: dict, state_io: dict, smi: str) -> dict:
    """SDXL_BASE resumed from the trainer phase's emergency save at optimizer
    step 1 (bf16 moments) for micro steps 5-8 (``resumed_run_checks``); then
    paged_adamw_8bit (int8 moments): one optimizer step with a save, and a
    one-step resume that must restore the saved codes and scales bit for
    bit."""
    import copy
    from aozora_sdxl_training_tpu_torch.cli import train_sdxl
    from aozora_sdxl_training_tpu_torch.train import trainer as trainer_module
    phase("resume")
    steps = ("make_micro_step", "make_apply_step")
    calls = SELF_ATTN_CALLS[64]
    remat = trainer_module.sdxl_remat_mode()
    # micro steps 5-8, and the preview at optimizer step 2
    n = RESUME_TO - TRAIN_STEPS
    want = {"flash_fwd": calls * (2 if remat else 1) * n + calls * PREVIEW_STEPS,
            "flash_bwd_dq": calls * n, "flash_bwd_dkv": calls * n, "flash_fwd_f32_d512": 1}
    out = {"sdxl_bf16": state_saved("SDXL_BASE, bf16 moments", state_io, smi)}
    raw, _, launches, peak_gb, _, io = resume_from_step_1(
        torch, train_sdxl.main, trainer_module, steps, preset, "sdxl", work_dir / "out",
        "smoke", work_dir, "resume_sdxl")
    out["sdxl_bf16"].update(resumed_run_checks(
        "SDXL_BASE resumed", raw, SDXL_PROGRESS, launches, want, preset, "sdxl", unbroken_raw,
        unbroken, peak_gb, state_io, io, smi))
    del io, state_io

    # paged_adamw_8bit: micro steps 1-4 and a save at optimizer step 1
    int8 = copy.deepcopy(preset)
    int8["sdxl"].update({"sdxl_optimizer_type": "paged_adamw_8bit",
                         "sdxl_max_train_steps": GA,
                         "sdxl_output_dir": str(work_dir / "out_int8")})
    int8_path = work_dir / "preset_int8.json"
    int8_path.write_text(json.dumps(int8, indent=1))
    (work_dir / "force_save.flag").write_text("")
    saved_io = {"snapshot": True}
    raw, marks, _, peak_gb, _ = run_trainer_cli(
        torch, train_sdxl.main, int8_path, work_dir, trainer_module, steps,
        "chip_smoke_int8.log", saved_io, final_save=False)
    check("Min 8-bit size" in raw and "Emergency checkpoint requested at optimizer step 1" in raw,
          "the paged_adamw_8bit run did not take int8 moments and save at step 1")
    losses = check_progress(raw, SDXL_PROGRESS, GA)
    _, (apply_s,) = step_times(marks, skip=2)
    row = state_saved("SDXL_BASE, paged_adamw_8bit (int8 moments)", saved_io, smi)
    raw, marks, launches, peak2, _, io = resume_from_step_1(
        torch, train_sdxl.main, trainer_module, steps, int8, "sdxl", work_dir / "out_int8",
        "smoke", work_dir, "resume_int8")
    resumed_losses = check_progress(raw, SDXL_PROGRESS, RESUME_TO - TRAIN_STEPS)
    check_launches(launches, want)
    _, (apply2_s,) = step_times(marks, skip=2)
    kinds = same_moments("SDXL_BASE, paged_adamw_8bit", saved_io["saved"], io["restored"])
    check(kinds["int8"] > 0, "no int8 moment")
    print(f"  [{smi}] SDXL_BASE, paged_adamw_8bit: restored codes and scales equal the "
          f"saved ones bit for bit ({kinds['int8']} int8 and {kinds['float']} fp32 moment "
          f"tensors); state loaded in {io['load']:.3f} s, restored to the card in "
          f"{io['restore']:.3f} s")
    bf16_apply = unbroken["mean_s_per_apply_step"]
    print(f"  [{smi}] SDXL_BASE apply step (synced): int8 moments {apply_s:.4f} s (optimizer "
          f"step 1), {apply2_s:.4f} s (step 2, resumed); bf16 moments {bf16_apply:.4f} s "
          f"(mean of the trainer phase's two); peak {peak_gb:.2f} / {peak2:.2f} GB "
          f"(bf16 moments: {unbroken['max_memory_allocated_gb']:.2f} GB); losses "
          f"{losses} then {resumed_losses}")
    out["sdxl_int8"] = {**row, "apply_s": [apply_s, apply2_s], "bf16_apply_s": bf16_apply,
                        "losses": losses + resumed_losses, "moments": kinds,
                        "max_memory_allocated_gb": [peak_gb, peak2],
                        "load_s": io["load"], "restore_s": io["restore"]}
    return out


def anima_resume_phase(torch, work_dir: Path, preset: dict, unbroken_raw: str,
                       unbroken: dict, state_io: dict, smi: str) -> dict:
    """ANIMA_BASE resumed from the anima phase's emergency save at optimizer
    step 1 (bf16 moments) for micro steps 5-8."""
    from aozora_sdxl_training_tpu_torch.cli import train_anima
    from aozora_sdxl_training_tpu_torch.train import anima_trainer
    phase("resume (anima)")
    calls = SELF_ATTN_CALLS[128]
    n = RESUME_TO - TRAIN_STEPS
    out = state_saved("ANIMA_BASE, bf16 moments", state_io, smi)
    raw, _, launches, peak_gb, _, io = resume_from_step_1(
        torch, train_anima.main, anima_trainer, ("make_anima_micro_step", "make_apply_step"),
        preset, "anima", work_dir / "out", "smoke_anima", work_dir, "resume_anima")
    # micro steps 5-8, and the preview at optimizer step 2
    out.update(resumed_run_checks(
        "ANIMA_BASE resumed", raw, ANIMA_PROGRESS, launches,
        {"flash_fwd_d128": 2 * calls * n + ANIMA_PREVIEW_K4A, "flash_bwd_dq_d128": calls * n,
         "flash_bwd_dkv_d128": calls * n}, preset, "anima", unbroken_raw, unbroken, peak_gb,
        state_io, io, smi))
    return out


# --------------------------------------------------------------------------
# 11: the sequence-parallel Anima CLI: images on 2 cards, a clip on 2 ranks
# --------------------------------------------------------------------------

SP = 2
SP_TIMEOUT_S = 900
# the video run's DiT: ANIMA_BASE's widths, its depth cut to 4 blocks (each
# block's ring moves ~0.45 GB a rank a micro step; gloo on one card, staged
# through host memory, ~0.6 GB/s)
SP_VIDEO_BLOCKS = 4


def anima_sp_phase(torch, work_dir: Path, steps: int, smi: str):
    """With SP cards or more, torchrun runs ``anima_sp_rank`` (the Anima
    CLI's main with its launch counts written out) on SP ranks, one card
    each, at ANIMA_BASE (the image run); then, on any card count, the
    video run (``sp_video_run``). Returns (summary, rank 0's launches in
    the video run)."""
    phase("anima_sp")
    out = {}
    n_dev = torch.cuda.device_count()
    if n_dev >= SP:
        image_dir = work_dir / "image"
        image_dir.mkdir()
        out["image"] = anima_sp_image(torch, image_dir, steps)
    else:
        print(f"anima_sp: the image run at full depth needs {SP} cards ({n_dev} CUDA "
              "device); the video run takes 2 gloo ranks on cuda:0", flush=True)
    video_dir = work_dir / "video"
    video_dir.mkdir()
    out["video"] = sp_video_run(torch, video_dir, steps, smi)
    return out, {**out["video"]["launches_per_rank"], **out["video"]["stats_launches_per_rank"]}


def sp_video_run(torch, work_dir: Path, steps: int, smi: str) -> dict:
    """Video mode under sequence parallelism: random weights of
    ANIMA_BASE's widths and SP_VIDEO_BLOCKS blocks, a synthetic cache of 2
    clips of VIDEO_FRAMES frames at 1024px (3 latent frames: 12288 tokens,
    6144 a rank), Full remat, batch 1, ``steps`` micro steps on SP ranks
    (``dp_launch``: one card, gloo on cuda:0; more, torchrun and NCCL),
    held against one process at the same depth (this process): losses
    (rtol 2e-2) and the saved DiT (max relative difference < 0.05). Per
    rank: the exact launches of K5's entry points and of K4a/K4b, the
    hops' path and bytes a micro step, the peak and the step times."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.cli import train_anima
    from aozora_sdxl_training_tpu_torch.train import anima_trainer
    from aozora_sdxl_training_tpu_torch.train.memory_policy import GB
    t_phase = time.perf_counter()
    cfg, preset_path, config = anima_env(
        torch, work_dir, steps, blocks=SP_VIDEO_BLOCKS, anima_video_frames=VIDEO_FRAMES,
        anima_sequence_parallel_size=SP)
    check(config.SEQUENCE_PARALLEL_SIZE == SP and config.ANIMA_VIDEO_FRAMES == VIDEO_FRAMES,
          "the preset's SP size or video frames did not reach the config")
    raw, ranks, wall, one_card = dp_launch(torch, work_dir, "anima_sp", preset_path,
                                           "sp_video")
    losses = check_progress(raw, ANIMA_PROGRESS, steps)
    check("Sequence parallelism: DiT self-attention tokens shard over sp=2" in raw,
          "sp_video: the trainer did not take the sequence-parallel path")
    calls = cfg.num_blocks
    want = {"flash_fwd_d128": 2 * SP * calls * steps, "flash_bwd_dq_d128": SP * calls * steps,
            "flash_bwd_dkv_d128": SP * calls * steps}
    want_stats = {"flash_fwd_stats": 2 * SP * calls * steps,
                  "flash_bwd_stats": SP * calls * steps}
    # a micro step's ring hops a rank, each block: the forward's K/V hop
    # twice (Full remat), the backward's K/V + dK/dV (fp32) hop and their
    # last dK/dV hop home
    shard = VIDEO_TOKENS // SP * cfg.model_channels
    want_bytes = calls * (2 * 2 * shard * 2 + (2 * shard * 2 + 2 * shard * 4)
                          + 2 * shard * 4) * steps
    rows = []
    for r, rec in enumerate(ranks):
        hops = rec["hops"].get("ring", {})
        check(rec["launches"] == want and rec["stats_launches"] == want_stats,
              f"sp_video rank {r}: launches {rec['launches']} {rec['stats_launches']}, "
              f"expected {want} and {want_stats}")
        check(hops.get("bytes_sent") == want_bytes and hops.get("staged") == one_card,
              f"sp_video rank {r}: hops {hops}, expected {want_bytes} bytes")
        t = [s["t"] for s in rec["steps"]]
        micro = [t[i] - t[i - 1] for i in range(1, steps - 1)]
        rows.append({"rank": r, "launches": rec["launches"],
                     "stats_launches": rec["stats_launches"],
                     "hop_path": "gloo, staged through pinned host buffers" if one_card
                     else "nccl, direct",
                     "hops_per_micro_step": hops["hops"] / steps,
                     "hop_gb_per_micro_step": hops["bytes_sent"] / steps / 1e9,
                     "peak_gib": rec["max_memory_allocated_bytes"] / GB,
                     "s_micro_steps_2_3": micro, "s_micro_step_4_with_apply": t[-1] - t[-2],
                     "s_per_optimizer_step_ga4": statistics.median(micro) * (GA - 1)
                     + t[-1] - t[-2], "wall_s": rec["wall_s"]})
        print(f"  [{smi}] sp_video rank {r} ({rows[-1]['hop_path']}): K5 "
              f"{rec['stats_launches']}, kernels {rec['launches']}; ring hops "
              f"{rows[-1]['hops_per_micro_step']:.0f} and "
              f"{rows[-1]['hop_gb_per_micro_step']:.4f} GB sent a micro step; peak "
              f"{rows[-1]['peak_gib']:.2f} GiB; micro steps 2-3 "
              f"{[round(x, 4) for x in micro]} s, micro step 4 with the apply step "
              f"{rows[-1]['s_micro_step_4_with_apply']:.4f} s, "
              f"{rows[-1]['s_per_optimizer_step_ga4']:.4f} s an optimizer step at GA {GA}")
    check_saved_dit(work_dir / "out" / "smoke_anima.safetensors", cfg)
    one = one_process_control(torch, work_dir, preset_path, "sp_video", {
        "anima_sequence_parallel_size": 1})
    one_want = {"flash_fwd_d128": 2 * calls * steps, "flash_bwd_dq_d128": calls * steps,
                "flash_bwd_dkv_d128": calls * steps}
    check({k: v for k, v in one["launches"].items() if v} == one_want,
          f"sp_video one process: launches {one['launches']}, expected {one_want}")
    held_against_one(torch, "sp_video", losses, one, work_dir, smi)
    secs = time.perf_counter() - t_phase
    print(f"  [{smi}] sp_video: {secs:.1f} s (checkpoint, cache, the ranks' run "
          f"{wall:.1f} s, one process {one['wall_s']:.1f} s)")
    return {"one_card_gloo": one_card, "blocks": cfg.num_blocks, "tokens": VIDEO_TOKENS,
            "tokens_per_rank": VIDEO_TOKENS // SP, "losses": losses, "ranks": rows,
            "launches_per_rank": want, "stats_launches_per_rank": want_stats,
            "one_process": one, "wall_s": wall, "s": secs}


def one_process_control(torch, work_dir: Path, preset_path: Path, label: str,
                        overrides: dict, mode: str = "anima") -> dict:
    """The ``mode`` CLI ("anima" or "sdxl") in this process on
    ``preset_path`` with ``overrides`` of its section (the layout's sizes
    back to 1, or the batch), writing into ``work_dir``/out_one: its
    stdout, launches, memory allocated after setup, peak, step times."""
    from aozora_sdxl_training_tpu_torch.cli import train_anima, train_sdxl
    from aozora_sdxl_training_tpu_torch.train import anima_trainer
    from aozora_sdxl_training_tpu_torch.train import trainer as sdxl_trainer
    from aozora_sdxl_training_tpu_torch.train.memory_policy import GB
    cli_main, module, micro = ((train_anima.main, anima_trainer, "make_anima_micro_step")
                               if mode == "anima" else
                               (train_sdxl.main, sdxl_trainer, "make_micro_step"))
    preset = json.loads(preset_path.read_text())
    preset[mode].update({f"{mode}_output_dir": str(work_dir / "out_one"), **overrides})
    one_preset = work_dir / "one.json"
    one_preset.write_text(json.dumps(preset, indent=1))
    allocated = {}
    summary_fn = module.print_optimizer_summary

    def setup_allocated(*args, **kwargs):
        torch.cuda.synchronize()
        allocated["bytes"] = torch.cuda.memory_allocated()
        return summary_fn(*args, **kwargs)

    module.print_optimizer_summary = setup_allocated
    try:
        raw, marks, launches, peak_gb, wall = run_trainer_cli(
            torch, cli_main, one_preset, work_dir, module, (micro, "make_apply_step"),
            f"chip_smoke_{label}_one.log")
    finally:
        module.print_optimizer_summary = summary_fn
    micro, apply_ = step_times(marks, skip=1)
    return {"raw": raw, "launches": {k: v for k, v in launches.items() if v},
            "allocated_after_setup_gib": allocated["bytes"] / GB, "peak_gb": peak_gb,
            "s_micro_steps": micro, "s_apply": apply_, "wall_s": wall}


def held_against_one(torch, label: str, losses: list, one: dict, work_dir: Path, smi: str,
                     mode: str = "anima", stem: str = "smoke_anima"):
    """The ranks' losses and saved model (``work_dir``/out/``stem``, the DiT
    or, with ``mode`` "sdxl", the UNet) against the one-process run's:
    losses rtol DP_LOSS_RTOL, the model's max relative difference under
    DP_MODEL_BAR."""
    import numpy as np
    pattern, prefix, model = ((ANIMA_PROGRESS, "pipe.dit.", "DiT") if mode == "anima" else
                              (SDXL_PROGRESS, "model.diffusion_model.", "UNet"))
    losses_one = check_progress(one["raw"], pattern, len(losses))
    check(np.allclose(losses, losses_one, rtol=DP_LOSS_RTOL, atol=2e-4),
          f"{label}: losses {losses} against one process {losses_one}")
    diff, n = unet_max_rel_diff(torch, work_dir / "out" / f"{stem}.safetensors",
                                work_dir / "out_one" / f"{stem}.safetensors", prefix=prefix)
    check(n > 0 and diff < DP_MODEL_BAR, f"{label}: the saved {model} is {diff:.4f} (max "
          f"relative) off the one-process run's over {n} tensors (bar {DP_MODEL_BAR})")
    one.pop("raw")
    one.update(losses=losses_one, tensors_compared=n,
               **{f"saved_{model.lower()}_max_rel_diff": diff})
    print(f"  [{smi}] {label}: losses {losses}, one process {losses_one}; saved {model} max "
          f"relative difference {diff:.5f} over {n} tensors (bar {DP_MODEL_BAR}); one "
          f"process: allocated after setup {one['allocated_after_setup_gib']:.2f} GiB, "
          f"peak {one['peak_gb']:.2f} GB, micro steps "
          f"{[round(x, 4) for x in one['s_micro_steps']]} s")


def anima_sp_image(torch, work_dir: Path, steps: int):
    """The image run on SP cards (torchrun, NCCL) at ANIMA_BASE."""
    import signal
    cfg, preset_path, config = anima_env(torch, work_dir, steps,
                                         anima_sequence_parallel_size=SP)
    check(config.SEQUENCE_PARALLEL_SIZE == SP, "the preset's SP size did not reach the config")
    out_dir = work_dir / "ranks"
    out_dir.mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(SP), str(REPO / "chip_smoke.py"),
           "--anima-sp-rank", str(preset_path), str(out_dir)]
    # torchrun --standalone serves the ranks' store on localhost (env://);
    # NCCL's and gloo's own sockets stay on the loopback device too
    env = {**os.environ, "PYTHONPATH": str(REPO), "NCCL_SOCKET_IFNAME": "lo",
           "GLOO_SOCKET_IFNAME": "lo"}
    env.pop("AOZORA_DIST_INIT", None)
    print(f"  {' '.join(cmd[2:])}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=work_dir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        raw, _ = proc.communicate(timeout=SP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raw, _ = proc.communicate()
        raise PhaseError(f"anima_sp: torchrun did not end in {SP_TIMEOUT_S} s:\n{raw[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    wall = time.perf_counter() - t0
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    (LOG_DIR / "chip_smoke_anima_sp.log").write_text(raw)
    check(proc.returncode == 0, f"anima_sp: torchrun exited {proc.returncode}:\n{raw[-4000:]}")
    check("Sequence parallelism: DiT self-attention tokens shard over sp=2" in raw,
          "anima_sp: the trainer did not take the sequence-parallel path")
    losses = check_progress(raw, ANIMA_PROGRESS, steps)   # one set of lines: rank 0's
    calls = SELF_ATTN_CALLS[128]
    want = {"flash_fwd_d128": 2 * SP * calls * steps, "flash_bwd_dq_d128": SP * calls * steps,
            "flash_bwd_dkv_d128": SP * calls * steps}
    want_stats = {"flash_fwd_stats": 2 * SP * calls * steps,
                  "flash_bwd_stats": SP * calls * steps}
    ranks = []
    for r in range(SP):
        path = out_dir / f"rank{r}.json"
        check(path.exists(), f"anima_sp: rank {r} wrote no launch counts")
        ranks.append(json.loads(path.read_text()))
        print(f"  rank {r}: {ranks[-1]}")
        check({k: v for k, v in ranks[-1]["launches"].items() if v} == want
              and ranks[-1]["stats_launches"] == want_stats,
              f"anima_sp rank {r}: launches {ranks[-1]}, expected {want} and {want_stats}")
    check_saved_dit(work_dir / "out" / "smoke_anima.safetensors", cfg)
    print(f"  losses {losses}; torchrun {wall:.1f} s (load, {steps} micro steps and "
          f"save); per rank {[round(x['wall_s'], 1) for x in ranks]} s, peak "
          f"{[round(x['max_memory_allocated_gb'], 2) for x in ranks]} GB")
    return {"sp": SP, "steps": steps, "losses": losses, "wall_s": wall, "ranks": ranks}


def anima_sp_rank(preset: str, out_dir: str) -> int:
    """One rank of the anima_sp phase: the Anima CLI, then this rank's
    launch counts, wall time and peak memory into ``out_dir``."""
    sys.path.insert(0, str(REPO))
    import torch
    from aozora_sdxl_training_tpu_torch.cli import train_anima
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    train_anima.main(["--config", preset])
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps({
        "launches": dict(fa.LAUNCHES), "stats_launches": dict(fa.STATS_LAUNCHES),
        "wall_s": time.perf_counter() - t0,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return 0


# --------------------------------------------------------------------------
# 17: data parallelism with FSDP (both trainers on two ranks)
# --------------------------------------------------------------------------

DP = 2
DP_TIMEOUT_S = 900
# the dp phase's models: the widths of SDXL_BASE and ANIMA_BASE, their depth
# cut (gloo between two ranks on one card moves about 0.6 GB/s, and a
# full-depth micro step moves 7.1 GB a rank: 12-15 s; PERF.md section 5): the
# UNet's 640- and 1280-wide levels keep 1 of their 2 and 10 transformer
# layers (0.69e9 of 2.57e9 parameters), the DiT 4 of its 28 blocks (0.43e9
# of 2.09e9)
DP_SDXL_LAYERS = 1
DP_ANIMA_BLOCKS = 4
# the JAX end-to-end test's bar for a dp run against one process at the
# global batch (tests/test_end_to_end.py): max |a - b| / max(|b|, 1e-3)
DP_MODEL_BAR = 0.05
# the bf16 losses of the two runs: their sums run in other orders
DP_LOSS_RTOL = 2e-2


def dp_launch(torch, work_dir: Path, cli: str, preset_path: Path, label: str):
    """Runs ``dp_rank`` (the ``cli`` run: "sdxl" or "anima" for the dp
    phase, "anima_pp", "anima_sp" or "anima_tp" for the pp, anima_sp and
    tp phases; the tp phase's SDXL run is "sdxl") on DP
    ranks: with one card, DP processes on it over gloo (each rank starts
    the gloo group before the CLI, which takes it as it is); with DP cards
    or more, torchrun over NCCL, one rank a card. Returns (global rank 0's
    stdout, each rank's record, wall s, one_card)."""
    import signal
    one_card = torch.cuda.device_count() < DP
    out_dir = work_dir / f"{label}_ranks"
    out_dir.mkdir()
    env = {**os.environ, "PYTHONPATH": str(REPO), "NCCL_SOCKET_IFNAME": "lo",
           "GLOO_SOCKET_IFNAME": "lo"}
    env.pop("AOZORA_DIST_INIT", None)
    rank_cmd = [str(REPO / "chip_smoke.py"), "--dp-rank", cli, str(preset_path), str(out_dir)]
    if one_card:
        store = f"file://{out_dir / 'store'}"
        cmds = [[sys.executable, *rank_cmd] for _ in range(DP)]
        envs = [{**env, "WORLD_SIZE": str(DP), "RANK": str(r), "LOCAL_RANK": "0",
                 "CHIP_SMOKE_DP_STORE": store} for r in range(DP)]
    else:
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(DP), *rank_cmd]]
        envs = [env]
    print(f"  {label}: {'2 ranks on cuda:0 over gloo' if one_card else 'torchrun, NCCL'}: "
          f"{' '.join(rank_cmd[1:])}", flush=True)
    import gc
    gc.collect()
    torch.cuda.empty_cache()          # the ranks share the card with this process
    t0 = time.perf_counter()
    logs = [open(out_dir / f"stdout_{i}.log", "w+") for i in range(len(cmds))]
    errs = [open(out_dir / f"stderr_{i}.log", "w+") for i in range(len(cmds))]
    procs = [subprocess.Popen(c, cwd=work_dir, env=e, stdout=f, stderr=g,
                              text=True, start_new_session=True)
             for c, e, f, g in zip(cmds, envs, logs, errs)]
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        raise PhaseError(f"{label}: the ranks did not end in {DP_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        raws, stderr = [], []
        for f, g in zip(logs, errs):
            for handle, into in ((f, raws), (g, stderr)):
                handle.seek(0)
                into.append(handle.read())
                handle.close()
    wall = time.perf_counter() - t0
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    for i, (raw, err) in enumerate(zip(raws, stderr)):
        (LOG_DIR / f"chip_smoke_{label}_{i}.log").write_text(raw + "\n--- stderr ---\n" + err)
    for proc, raw, err in zip(procs, raws, stderr):
        check(proc.returncode == 0,
              f"{label}: a rank exited {proc.returncode}:\n{raw[-3000:]}\n{err[-3000:]}")
    ranks = []
    for r in range(DP):
        path = out_dir / f"rank{r}.json"
        check(path.exists(), f"{label}: rank {r} wrote no record")
        ranks.append(json.loads(path.read_text()))
    if one_card:
        check(raws[1].strip() == "", f"{label}: rank 1 printed:\n{raws[1][-2000:]}")
    return raws[0], ranks, wall, one_card


def dp_rank(cli: str, preset: str, out_dir: str) -> int:
    """One rank of the dp, pp, anima_sp and tp phases: under
    CHIP_SMOKE_DP_STORE (one card) it starts the gloo group on cuda:0
    first; then the training CLI (``cli``: "sdxl", or the Anima CLI for
    "anima", "anima_pp", "anima_sp" and "anima_tp") with its step log
    (``AOZORA_STEP_LOG``), the launches and the point-to-point hops
    counted from 0 just before; then this rank's record: launches (the
    kernels' and the K5 entry points') and the B·H of each flash forward,
    wall time, peak memory, what FSDP holds after setup (elements, tp-split
    elements, device bytes allocated), the bytes each collective moved (the
    tp collectives' too) and the hops. The dp phase's Anima run skips its
    final model save (nothing reads it) on every rank alike; the pp,
    anima_sp and tp runs keep it (it is held against one process)."""
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    from aozora_sdxl_training_tpu_torch.parallel import p2p, sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    store = os.environ.get("CHIP_SMOKE_DP_STORE")
    if store:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=store, rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]))
    os.environ["AOZORA_STEP_LOG"] = str(Path(out_dir, f"steps{rank}.jsonl"))
    if cli == "sdxl":
        from aozora_sdxl_training_tpu_torch.cli import train_sdxl as cli_module
    else:
        from aozora_sdxl_training_tpu_torch.cli import train_anima as cli_module
        from aozora_sdxl_training_tpu_torch.train import anima_trainer
        if cli == "anima":
            skip_final_save(anima_trainer)
    made, setup, heads = [], {}, set()
    init, report = sharding.FSDP.__init__, sharding.FSDP.report
    flash_fwd = fa.flash_fwd

    def counted_heads(q, k, v, scale):
        # B·H of each flash forward launch (the heads each rank runs)
        heads.add(int(q.shape[0]) * int(q.shape[2]))
        return flash_fwd(q, k, v, scale)

    fa.flash_fwd = counted_heads

    def kept(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    def reported(self, trainable, frozen, opt_state):
        torch.cuda.synchronize()
        setup["allocated_bytes"] = torch.cuda.memory_allocated()
        setup["held"] = self.held({**trainable, **frozen}, opt_state)
        setup["sharded_elements"] = sum(s.numel for n, s in self.specs.items()
                                        if n in trainable or n in frozen)
        setup["tp_elements"] = sum(s.numel for n, s in self.tps.items()
                                   if n in trainable or n in frozen)
        return report(self, trainable, frozen, opt_state)

    sharding.FSDP.__init__, sharding.FSDP.report = kept, reported
    fa.reset_launch_counts()
    p2p.reset_stats()
    t0 = time.perf_counter()
    cli_module.main(["--config", preset])
    fsdp = made[-1]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps({
        "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
        "stats_launches": {k: v for k, v in fa.STATS_LAUNCHES.items() if v},
        "hops": p2p.STATS, "stages": len(fsdp.stages),
        "wall_s": time.perf_counter() - t0,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "device": str(torch.cuda.current_device()), "backend": fsdp.backend,
        "micro_steps": fsdp.micro_steps, "optimizer_steps": fsdp.optimizer_steps,
        "collective_bytes": fsdp.stats, "setup": setup,
        "tp_bytes": fsdp.tp_config.stats if fsdp.tp_config else {},
        "flash_heads": sorted(heads),
        "steps": [json.loads(line) for line in
                  Path(out_dir, f"steps{rank}.jsonl").read_text().splitlines()]}))
    return 0


def dp_rank_summary(label: str, ranks: list, raw: str, smi: str) -> dict:
    """Per rank: the collectives and their GB a micro step (an optimizer
    step for the apply step's), the share of the sharded elements held,
    memory allocated after setup, the peak beside the plan's estimate (its
    dp_shard=2 plan, from rank 0's lines) and s a micro and an optimizer
    step (synced step log; micro steps 2-3 and micro step 4 with the apply
    step). The two ranks' peaks must fit the card together."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.train.memory_policy import GB
    est = re.search(r"Memory plan \(budget [^,]*, est peak ([\d.]+) GB\)", raw)
    check(est is not None, f"{label}: no memory plan line")
    est_gib = float(est.group(1))
    total_bytes = None
    rows = []
    for r, rec in enumerate(ranks):
        setup = rec["setup"]
        held = setup["held"][r]
        share = held[0] / max(setup["sharded_elements"], 1)
        check(abs(share - 1 / DP) < 0.01, f"{label} rank {r}: holds {share:.4f} of the "
              "sharded elements, not 1/2")
        t = [s["t"] for s in rec["steps"]]
        check(len(t) == TRAIN_STEPS, f"{label} rank {r}: {len(t)} step-log lines")
        micro = [t[i] - t[i - 1] for i in range(1, TRAIN_STEPS - 1)]
        last = t[-1] - t[-2]                      # micro step 4 and the apply step
        per_micro = {k: v / max(rec["micro_steps"], 1) / 1e9
                     for k, v in rec["collective_bytes"].items() if k.startswith("step.")}
        per_optim = {k: v / max(rec["optimizer_steps"], 1) / 1e9
                     for k, v in rec["collective_bytes"].items() if k.startswith("apply.")}
        peak = rec["max_memory_allocated_bytes"]
        rows.append({"rank": r, "backend": rec["backend"], "share_of_sharded": share,
                     "held_elements": held[0], "moment_bytes": held[2],
                     "allocated_after_setup_gib": setup["allocated_bytes"] / GB,
                     "peak_gib": peak / GB, "plan_est_gib": est_gib,
                     "s_micro_steps_2_3": micro, "s_micro_step_4_with_apply": last,
                     "s_per_optimizer_step_ga4": float(np.median(micro)) * (GA - 1) + last,
                     "gb_per_micro_step": per_micro, "gb_per_optimizer_step": per_optim,
                     "launches": rec["launches"], "wall_s": rec["wall_s"]})
        print(f"  [{smi}] {label} rank {r} ({rec['backend']}): holds {share:.4f} of the "
              f"{setup['sharded_elements']:,} sharded elements, moments {held[2] / GB:.2f} GiB; "
              f"allocated after setup {setup['allocated_bytes'] / GB:.2f} GiB; peak "
              f"{peak / GB:.2f} GiB against the plan's {est_gib:.2f} GiB at dp_shard=2; "
              f"micro steps 2-3 {[round(x, 4) for x in micro]} s, micro step 4 with the "
              f"apply step {last:.4f} s, {rows[-1]['s_per_optimizer_step_ga4']:.4f} s an "
              f"optimizer step at GA {GA}; GB a micro step "
              f"{ {k: round(v, 4) for k, v in per_micro.items()} }, an optimizer step "
              f"{ {k: round(v, 4) for k, v in per_optim.items()} }")
    if len(set(r["device"] for r in ranks)) == 1:
        total_bytes = torch_total_memory()
        both = sum(r["max_memory_allocated_bytes"] for r in ranks)
        print(f"  {label}: both ranks' peaks {both / GB:.2f} GiB on the one card of "
              f"{total_bytes / GB:.2f} GiB")
        check(both < total_bytes, f"{label}: the ranks' peaks exceed the card")
    return {"ranks": rows}


def torch_total_memory() -> int:
    import torch
    return int(torch.cuda.get_device_properties(0).total_memory)


def unet_max_rel_diff(torch, got: Path, want: Path,
                      prefix: str = "model.diffusion_model.") -> tuple:
    """max |a - b| / max(|b|, 1e-3) over the tensors under ``prefix`` (the
    UNet's by default) of two saved checkpoints (each file's header read
    once, the tensors compared on the card), and the number of tensors."""
    import struct

    def index(path):
        f = open(path, "rb")
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        return f, 8 + n, header

    def read(f, base, spec):
        start, end = spec["data_offsets"]
        f.seek(base + start)
        raw = bytearray(f.read(end - start))
        dtype = {"BF16": torch.bfloat16, "F32": torch.float32, "F16": torch.float16}[spec["dtype"]]
        return torch.frombuffer(raw, dtype=dtype).to("cuda", torch.float32)

    (fa_, ba, ha), (fb, bb, hb) = index(got), index(want)
    worst, n = 0.0, 0
    try:
        keys = [k for k in hb if k.startswith(prefix)]
        check(keys and set(keys) == {k for k in ha if k.startswith(prefix)},
              f"the two checkpoints hold other {prefix} tensors")
        for k in keys:
            a, b = read(fa_, ba, ha[k]), read(fb, bb, hb[k])
            worst = max(worst, float(((a - b).abs() / b.abs().clamp(min=1e-3)).max()))
            n += 1
    finally:
        fa_.close()
        fb.close()
    return worst, n


def dp_phase(torch, work_dir: Path, smi: str):
    """Both trainers under data parallelism with FSDP on DP ranks
    (``dp_launch``), on random weights of the full widths and cut depth
    (DP_SDXL_LAYERS, DP_ANIMA_BLOCKS): the SDXL UNet at the default preset
    (1024px, BATCH_SIZE 1 a rank, GA 4, raven, bf16, flash), TRAIN_STEPS
    micro steps, held against one process at BATCH_SIZE 2 over the same
    steps (losses; the saved UNet within the JAX end-to-end test's bar),
    then the DiT (Full remat), TRAIN_STEPS micro steps: finite losses. Each
    rank's flash launches exact, the state half on each rank, and
    ``dp_rank_summary``'s numbers. Returns the summary."""
    phase("dp")
    import numpy as np
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import write_synthetic_dataset
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE, hf_param_names
    out = {}

    sdxl_dir = work_dir / "sdxl"
    sdxl_dir.mkdir()
    unet_cfg, ckpt, _ = cut_sdxl(torch)
    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    preset["sdxl"].update({
        "sdxl_base_model_path": str(ckpt), "sdxl_output_dir": str(sdxl_dir / "out_dp"),
        "sdxl_output_name": "dp", "sdxl_max_train_steps": TRAIN_STEPS,
        "sdxl_instance_datasets": [{"path": str(sdxl_dir / "data"), "repeats": 1}]})
    config = RuntimeConfig(schema.flatten_preset(preset))
    check(config.BATCH_SIZE == 1 and config.GRADIENT_ACCUMULATION_STEPS == GA
          and config.MIXED_PRECISION == "bfloat16", "the default SDXL preset changed")
    write_synthetic_dataset(sdxl_dir / "data", config, n_images=2, image_size=(1024, 1024),
                            seq_len=77, embed_dim=SDXL_BASE.cross_attention_dim,
                            pooled_dim=SDXL_BASE.pooled_projection_dim, seed=7)
    dp_preset = sdxl_dir / "dp.json"
    dp_preset.write_text(json.dumps(preset, indent=1))
    raw, ranks, wall, one_card = dp_launch(torch, sdxl_dir, "sdxl", dp_preset, "dp_sdxl")
    losses = check_progress(raw, SDXL_PROGRESS, TRAIN_STEPS)
    check(f"INFO: FSDP over dp={DP} ({'gloo' if one_card else 'nccl'})" in raw,
          "dp_sdxl: no FSDP line")
    check(f"sharded over {DP} device(s) (ZeRO)" in raw, "dp_sdxl: the optimizer summary "
          "does not say the moments are sharded")
    remat = re.search(r"INFO:   attention: (\S+), remat: (\S+)", raw)
    check(remat is not None and remat.group(1) == "flash"
          and remat.group(2) in ("True", "False"), f"dp_sdxl: plan {remat and remat.group(0)}")
    calls = sdxl_self_attn_calls(unet_cfg)
    fwd = calls * (2 if remat.group(2) == "True" else 1) * TRAIN_STEPS
    want = {"flash_fwd": fwd, "flash_bwd_dq": calls * TRAIN_STEPS,
            "flash_bwd_dkv": calls * TRAIN_STEPS}
    for r, rec in enumerate(ranks):
        check(rec["launches"] == want, f"dp_sdxl rank {r}: launches {rec['launches']}, "
              f"expected {want}")
    out["sdxl"] = {"one_card_gloo": one_card, "losses": losses, "wall_s": wall,
                   "launches_per_rank": want, **dp_rank_summary("dp_sdxl", ranks, raw, smi)}

    # the control: one process at the global batch
    one = one_process_control(torch, sdxl_dir, dp_preset, "dp_sdxl", {"sdxl_batch_size": DP},
                              mode="sdxl")
    check(RuntimeConfig(schema.flatten_preset(json.loads(
        (sdxl_dir / "one.json").read_text()))).BATCH_SIZE == DP, "batch 2 not set")
    losses_one = check_progress(one["raw"], SDXL_PROGRESS, TRAIN_STEPS)
    check(np.allclose(losses, losses_one, rtol=DP_LOSS_RTOL, atol=2e-4),
          f"dp_sdxl: losses {losses} against one process at batch {DP} {losses_one}")
    diff, n = unet_max_rel_diff(torch, sdxl_dir / "out_dp" / "dp.safetensors",
                                sdxl_dir / "out_one" / "dp.safetensors")
    check(n == len(hf_param_names(unet_cfg)), f"{n} UNet tensors compared")
    check(diff < DP_MODEL_BAR, f"dp_sdxl: the saved UNet is {diff:.4f} (max relative) off "
          f"the one-process run's (bar {DP_MODEL_BAR})")
    one.pop("raw")
    print(f"  [{smi}] dp_sdxl: losses {losses}, one process at batch {DP} {losses_one}; saved "
          f"UNet max relative difference {diff:.5f} over {n} tensors (bar {DP_MODEL_BAR}); "
          f"one process: allocated after setup {one['allocated_after_setup_gib']:.2f} GiB, "
          f"peak {one['peak_gb']:.2f} GB, micro steps 2-4 "
          f"{[round(x, 4) for x in one['s_micro_steps']]} s, apply "
          f"{[round(x, 4) for x in one['s_apply']]} s; the ranks' run {wall:.1f} s, one "
          f"process {one['wall_s']:.1f} s (load and save included)")
    out["sdxl"].update(one_process={**one, "losses": losses_one},
                       saved_unet_max_rel_diff=diff)
    shutil_rmtree(sdxl_dir)

    anima_dir = work_dir / "anima"
    anima_dir.mkdir()
    cfg, preset_path, _ = anima_env(torch, anima_dir, TRAIN_STEPS, blocks=DP_ANIMA_BLOCKS)
    raw, ranks, wall, one_card = dp_launch(torch, anima_dir, "anima", preset_path, "dp_anima")
    losses = check_progress(raw, ANIMA_PROGRESS, TRAIN_STEPS)
    check(f"INFO: FSDP over dp={DP}" in raw, "dp_anima: no FSDP line")
    calls = cfg.num_blocks
    want = {"flash_fwd_d128": 2 * calls * TRAIN_STEPS, "flash_bwd_dq_d128": calls * TRAIN_STEPS,
            "flash_bwd_dkv_d128": calls * TRAIN_STEPS}
    for r, rec in enumerate(ranks):
        check(rec["launches"] == want, f"dp_anima rank {r}: launches {rec['launches']}, "
              f"expected {want}")
    out["anima"] = {"one_card_gloo": one_card, "losses": losses, "wall_s": wall,
                    "launches_per_rank": want, **dp_rank_summary("dp_anima", ranks, raw, smi)}
    print(f"  [{smi}] dp_anima: losses {losses}; the ranks' run {wall:.1f} s (load included)")
    shutil_rmtree(anima_dir)
    return out


# --------------------------------------------------------------------------
# 18: pipeline parallelism (GPipe) of the Anima DiT on two ranks
# --------------------------------------------------------------------------

PP = 2
# the pp run's DiT: ANIMA_BASE's widths, its depth cut to 4 blocks, 2 a
# stage (as the dp phase cuts it); batch 2 in 2 microbatches of one sample
PP_BLOCKS = 4
PP_BATCH = PP_MICROBATCHES = 2


def pp_phase(torch, work_dir: Path, smi: str):
    """The Anima CLI with PIPELINE_PARALLEL_SIZE 2 on PP ranks
    (``dp_launch``: one card, gloo on cuda:0; more, torchrun and NCCL) at
    ANIMA_BASE's widths with PP_BLOCKS blocks, 1024px images, BATCH_SIZE 2
    in 2 microbatches, Full remat, TRAIN_STEPS micro steps, held against
    one process at the same depth and batch (this process): losses (rtol
    2e-2) and the saved DiT (max relative difference < 0.05, flat
    reference names). Per rank: the exact K4a/K4b launches (its stage's
    blocks x 2 under Full remat x the microbatches, and the blocks x the
    microbatches), the hops' path, count and bytes a micro step, half the
    stacked block elements held, memory allocated after setup beside the
    one-process run's, the peak, and s a micro and an optimizer step from
    its step log. Returns (summary, rank 0's launches)."""
    phase("pp")
    from aozora_sdxl_training_tpu_torch.train.memory_policy import GB
    t_phase = time.perf_counter()
    steps = TRAIN_STEPS
    cfg, preset_path, config = anima_env(
        torch, work_dir, steps, blocks=PP_BLOCKS, anima_pipeline_parallel_size=PP,
        anima_pipeline_microbatches=PP_MICROBATCHES, anima_batch_size=PP_BATCH)
    check(config.PIPELINE_PARALLEL_SIZE == PP and config.BATCH_SIZE == PP_BATCH
          and config.ANIMA_PIPELINE_MICROBATCHES == PP_MICROBATCHES,
          "the preset's pipeline settings did not reach the config")
    raw, ranks, wall, one_card = dp_launch(torch, work_dir, "anima_pp", preset_path, "pp")
    losses = check_progress(raw, ANIMA_PROGRESS, steps)
    check(f"INFO: Pipeline parallelism: {cfg.num_blocks} DiT blocks in {PP} GPipe stages x "
          f"{PP_MICROBATCHES} microbatch(es)" in raw, "pp: no pipeline line")
    check_saved_dit(work_dir / "out" / "smoke_anima.safetensors", cfg)
    per_stage = cfg.num_blocks // PP
    want = {"flash_fwd_d128": 2 * per_stage * PP_MICROBATCHES * steps,
            "flash_bwd_dq_d128": per_stage * PP_MICROBATCHES * steps,
            "flash_bwd_dkv_d128": per_stage * PP_MICROBATCHES * steps}
    # a microbatch's activation between the stages: 64 x 64 patches of
    # model_channels in bf16; a micro step sends M of them a rank (stage 0
    # forward, stage 1 backward) and takes part in 2 M hops
    act_bytes = (PP_BATCH // PP_MICROBATCHES) * 64 * 64 * cfg.model_channels * 2
    rows = []
    stacked_total = None
    for r, rec in enumerate(ranks):
        hops = rec["hops"].get("pipeline", {})
        check(rec["launches"] == want, f"pp rank {r}: launches {rec['launches']}, "
              f"expected {want}")
        check(hops.get("hops") == 2 * PP_MICROBATCHES * steps
              and hops.get("bytes_sent") == PP_MICROBATCHES * act_bytes * steps
              and hops.get("staged") == one_card,
              f"pp rank {r}: hops {hops}, expected {2 * PP_MICROBATCHES * steps} hops and "
              f"{PP_MICROBATCHES * act_bytes * steps} bytes")
        setup = rec["setup"]
        held = setup["held"][r]
        stacked_total = sum(h[4] for h in setup["held"])
        check(rec["stages"] > 0 and 2 * held[4] == stacked_total,
              f"pp rank {r}: holds {held[4]} of {stacked_total} stacked block elements")
        t = [s["t"] for s in rec["steps"]]
        check(len(t) == steps, f"pp rank {r}: {len(t)} step-log lines")
        micro = [t[i] - t[i - 1] for i in range(1, steps - 1)]
        rows.append({"rank": r, "backend": rec["backend"], "launches": rec["launches"],
                     "hop_path": "gloo, staged through pinned host buffers" if one_card
                     else "nccl, direct",
                     "hops_per_micro_step": hops["hops"] / steps,
                     "hop_gb_per_micro_step": hops["bytes_sent"] / steps / 1e9,
                     "stacked_elements_held": held[4], "stacked_elements": stacked_total,
                     "all_parameter_elements_held": held[1],
                     "allocated_after_setup_gib": setup["allocated_bytes"] / GB,
                     "peak_gib": rec["max_memory_allocated_bytes"] / GB,
                     "s_micro_steps_2_3": micro, "s_micro_step_4_with_apply": t[-1] - t[-2],
                     "s_per_optimizer_step_ga4": statistics.median(micro) * (GA - 1)
                     + t[-1] - t[-2], "wall_s": rec["wall_s"]})
        print(f"  [{smi}] pp rank {r} ({rows[-1]['hop_path']}): launches {rec['launches']}; "
              f"hops {rows[-1]['hops_per_micro_step']:.0f} and "
              f"{rows[-1]['hop_gb_per_micro_step']:.4f} GB sent a micro step; holds "
              f"{held[4]:,} of {stacked_total:,} stacked block elements ({held[1]:,} "
              f"parameter elements in all); allocated after setup "
              f"{rows[-1]['allocated_after_setup_gib']:.2f} GiB, peak "
              f"{rows[-1]['peak_gib']:.2f} GiB; micro steps 2-3 {[round(x, 4) for x in micro]} "
              f"s, micro step 4 with the apply step {rows[-1]['s_micro_step_4_with_apply']:.4f} s, "
              f"{rows[-1]['s_per_optimizer_step_ga4']:.4f} s an optimizer step at GA {GA}")
    one = one_process_control(torch, work_dir, preset_path, "pp", {
        "anima_pipeline_parallel_size": 1})
    one_want = {"flash_fwd_d128": 2 * cfg.num_blocks * steps,
                "flash_bwd_dq_d128": cfg.num_blocks * steps,
                "flash_bwd_dkv_d128": cfg.num_blocks * steps}
    check(one["launches"] == one_want,
          f"pp one process: launches {one['launches']}, expected {one_want}")
    held_against_one(torch, "pp", losses, one, work_dir, smi)
    secs = time.perf_counter() - t_phase
    print(f"  [{smi}] pp: {secs:.1f} s (checkpoint, cache, the ranks' run {wall:.1f} s, one "
          f"process {one['wall_s']:.1f} s)")
    return ({"one_card_gloo": one_card, "blocks": cfg.num_blocks, "pp": PP,
             "microbatches": PP_MICROBATCHES, "batch": PP_BATCH, "losses": losses,
             "ranks": rows, "launches_per_rank": want, "one_process": one, "wall_s": wall,
             "s": secs}, want)


# --------------------------------------------------------------------------
# 20: tensor parallelism of both trainers on two ranks
# --------------------------------------------------------------------------

TP = 2


def cut_sdxl(torch):
    """The SDXL_BASE UNet at its widths with DP_SDXL_LAYERS transformer
    layers a block at 640 and 1280 (and in the mid block): its config and
    the seeded random checkpoint (tiny text encoders and VAE, which pass
    through the saves only), written once a run (``shared_weights``) for
    the dp, tp and plan phases. Returns (unet_cfg, path, UNet parameters)."""
    from dataclasses import replace
    from aozora_sdxl_training_tpu_torch.data.synthetic import write_random_sd_checkpoint
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE
    from aozora_sdxl_training_tpu_torch.models.sdxl.clip import ClipTextConfig
    layers = DP_SDXL_LAYERS
    unet_cfg = replace(SDXL_BASE, transformer_layers=(0, layers, layers),
                       mid_transformer_layers=layers)
    ckpt, counts, secs = shared_weights(torch, "sdxl_cut.safetensors", lambda path: (
        write_random_sd_checkpoint(
            path, seed=1234, unet_cfg=unet_cfg, device="cuda",
            clip_l=ClipTextConfig(width=16, num_layers=1, num_heads=1),
            clip_g=ClipTextConfig(width=32, num_layers=1, num_heads=1, activation="gelu",
                                  projection_dim=40), vae_channels=(8, 8, 16, 16))))
    print(f"  {ckpt.name}: UNet of SDXL_BASE's widths with {layers} transformer layer(s) a "
          f"block at 640 and 1280: {counts['unet']:,} parameters, "
          f"{f'written in {secs:.1f} s' if secs > 0.1 else 'written by an earlier phase'}")
    return unet_cfg, ckpt, counts["unet"]


def sdxl_self_attn_calls(unet_cfg) -> int:
    """Self-attention calls of one SDXL forward: 2 down and 3 up attention
    blocks at each transformer level, and the mid block's layers."""
    return 5 * sum(unet_cfg.transformer_layers) + unet_cfg.mid_transformer_layers


def tp_rank_summary(label: str, ranks: list, raw: str, one_card: bool, want: dict,
                    heads: set, one: dict, smi: str) -> list:
    """Per rank of a tp run: the exact flash launches, each at heads/TP
    (B·H a launch, batch 1), the tp line, half the tp-split elements held,
    memory allocated after setup beside one process's, the bytes put into
    tp collectives a micro step, and s a micro step (synced step log)."""
    from aozora_sdxl_training_tpu_torch.train.memory_policy import GB
    check(f"INFO: Tensor parallelism over tp={TP} ({'gloo' if one_card else 'nccl'}, dp=1)"
          in raw, f"{label}: no tp line (did the run fall back to tp 1?)")
    rows = []
    for r, rec in enumerate(ranks):
        check(rec["launches"] == want, f"{label} rank {r}: launches {rec['launches']}, "
              f"expected {want}")
        check(set(rec["flash_heads"]) == heads, f"{label} rank {r}: the flash launches ran "
              f"B·H {sorted(rec['flash_heads'])}, expected {sorted(heads)}")
        setup = rec["setup"]
        held = setup["held"][r]
        total = setup["tp_elements"]
        check(total > 0 and 2 * held[5] == total, f"{label} rank {r}: holds {held[5]} of "
              f"{total} tp-split elements, not half")
        t = [s["t"] for s in rec["steps"]]
        check(len(t) == TRAIN_STEPS, f"{label} rank {r}: {len(t)} step-log lines")
        micro = [t[i] - t[i - 1] for i in range(1, TRAIN_STEPS - 1)]
        per_micro = {k: v / max(rec["micro_steps"], 1) / 1e9 for k, v in rec["tp_bytes"].items()}
        check(per_micro.get("reduce", 0) > 0 and per_micro.get("copy", 0) > 0,
              f"{label} rank {r}: no tp collective ran ({rec['tp_bytes']})")
        rows.append({"rank": r, "backend": rec["backend"], "launches": rec["launches"],
                     "flash_heads": rec["flash_heads"], "tp_elements_held": held[5],
                     "tp_elements": total, "all_parameter_elements_held": held[1],
                     "moment_bytes": held[2],
                     "allocated_after_setup_gib": setup["allocated_bytes"] / GB,
                     "one_process_allocated_after_setup_gib": one["allocated_after_setup_gib"],
                     "peak_gib": rec["max_memory_allocated_bytes"] / GB,
                     "tp_gb_per_micro_step": per_micro,
                     "tp_gb_per_micro_step_total": sum(per_micro.values()),
                     "s_micro_steps_2_3": micro, "s_micro_step_4_with_apply": t[-1] - t[-2],
                     "s_per_optimizer_step_ga4": statistics.median(micro) * (GA - 1)
                     + t[-1] - t[-2], "wall_s": rec["wall_s"]})
        print(f"  [{smi}] {label} rank {r} ({rec['backend']}): launches {rec['launches']} at "
              f"B·H {sorted(rec['flash_heads'])}; holds {held[5]:,} of {total:,} tp-split "
              f"elements ({held[1]:,} parameter elements in all); allocated after setup "
              f"{rows[-1]['allocated_after_setup_gib']:.2f} GiB (one process "
              f"{one['allocated_after_setup_gib']:.2f}), peak {rows[-1]['peak_gib']:.2f} GiB; "
              f"tp collectives {rows[-1]['tp_gb_per_micro_step_total']:.4f} GB a micro step "
              f"{ {k: round(v, 4) for k, v in per_micro.items()} }; micro steps 2-3 "
              f"{[round(x, 4) for x in micro]} s, micro step 4 with the apply step "
              f"{rows[-1]['s_micro_step_4_with_apply']:.4f} s")
    return rows


def tp_phase(torch, work_dir: Path, smi: str):
    """Both trainers with TENSOR_PARALLEL_SIZE TP on TP ranks (``dp_launch``:
    one card, gloo on cuda:0; more, torchrun and NCCL), dp 1, at the full
    widths and the dp phase's cut depth, TRAIN_STEPS micro steps each:
    the SDXL UNet at the default preset (1024px, batch 1, GA 4, raven,
    bf16, flash), then the DiT (Full remat); each held against one
    process on the same preset (losses rtol DP_LOSS_RTOL, the saved model
    within DP_MODEL_BAR), each rank with ``tp_rank_summary``'s checks and
    numbers. Returns (summary, rank 0's launches of both runs)."""
    phase("tp")
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import write_synthetic_dataset
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE
    t_phase = time.perf_counter()
    out, launches = {}, {}

    sdxl_dir = work_dir / "sdxl"
    sdxl_dir.mkdir()
    unet_cfg, ckpt, _ = cut_sdxl(torch)
    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    preset["sdxl"].update({
        "sdxl_base_model_path": str(ckpt), "sdxl_output_dir": str(sdxl_dir / "out"),
        "sdxl_output_name": "tp", "sdxl_max_train_steps": TRAIN_STEPS,
        "sdxl_tensor_parallel_size": TP,
        "sdxl_instance_datasets": [{"path": str(sdxl_dir / "data"), "repeats": 1}]})
    config = RuntimeConfig(schema.flatten_preset(preset))
    check(config.BATCH_SIZE == 1 and config.GRADIENT_ACCUMULATION_STEPS == GA
          and config.MIXED_PRECISION == "bfloat16" and config.TENSOR_PARALLEL_SIZE == TP,
          "the SDXL tp preset is not batch 1, GA 4, bf16, tp 2")
    write_synthetic_dataset(sdxl_dir / "data", config, n_images=2, image_size=(1024, 1024),
                            seq_len=77, embed_dim=SDXL_BASE.cross_attention_dim,
                            pooled_dim=SDXL_BASE.pooled_projection_dim, seed=7)
    tp_preset = sdxl_dir / "tp.json"
    tp_preset.write_text(json.dumps(preset, indent=1))
    raw, ranks, wall, one_card = dp_launch(torch, sdxl_dir, "sdxl", tp_preset, "tp_sdxl")
    losses = check_progress(raw, SDXL_PROGRESS, TRAIN_STEPS)
    remat = re.search(r"INFO:   attention: (\S+), remat: (\S+)", raw)
    check(remat is not None and remat.group(1) == "flash"
          and remat.group(2) in ("True", "False"), f"tp_sdxl: plan {remat and remat.group(0)}")
    calls = sdxl_self_attn_calls(unet_cfg)
    fwd = calls * (2 if remat.group(2) == "True" else 1) * TRAIN_STEPS
    want = {"flash_fwd": fwd, "flash_bwd_dq": calls * TRAIN_STEPS,
            "flash_bwd_dkv": calls * TRAIN_STEPS}
    one = one_process_control(torch, sdxl_dir, tp_preset, "tp_sdxl",
                              {"sdxl_tensor_parallel_size": 1}, mode="sdxl")
    one_want = {**want, "flash_fwd": calls * TRAIN_STEPS * (
        2 if "remat: True" in one["raw"] else 1)}
    check(one["launches"] == one_want, f"tp_sdxl one process: launches {one['launches']}")
    # the 640-wide level's 10 heads and the 1280-wide level's 20, halved
    rows = tp_rank_summary("tp_sdxl", ranks, raw, one_card, want,
                           {h // TP for h in unet_cfg.num_heads[1:]}, one, smi)
    held_against_one(torch, "tp_sdxl", losses, one, sdxl_dir, smi, mode="sdxl", stem="tp")
    out["sdxl"] = {"one_card_gloo": one_card, "losses": losses, "ranks": rows,
                   "launches_per_rank": want, "one_process": one, "wall_s": wall}
    launches.update(want)
    shutil_rmtree(sdxl_dir)

    anima_dir = work_dir / "anima"
    anima_dir.mkdir()
    cfg, preset_path, config = anima_env(torch, anima_dir, TRAIN_STEPS, blocks=DP_ANIMA_BLOCKS,
                                         anima_tensor_parallel_size=TP)
    check(config.TENSOR_PARALLEL_SIZE == TP, "the preset's tp size did not reach the config")
    raw, ranks, wall, one_card = dp_launch(torch, anima_dir, "anima_tp", preset_path,
                                           "tp_anima")
    losses = check_progress(raw, ANIMA_PROGRESS, TRAIN_STEPS)
    check_saved_dit(anima_dir / "out" / "smoke_anima.safetensors", cfg)
    calls = cfg.num_blocks
    want = {"flash_fwd_d128": 2 * calls * TRAIN_STEPS, "flash_bwd_dq_d128": calls * TRAIN_STEPS,
            "flash_bwd_dkv_d128": calls * TRAIN_STEPS}
    one = one_process_control(torch, anima_dir, preset_path, "tp_anima",
                              {"anima_tensor_parallel_size": 1})
    check(one["launches"] == want, f"tp_anima one process: launches {one['launches']}")
    rows = tp_rank_summary("tp_anima", ranks, raw, one_card, want, {cfg.num_heads // TP},
                           one, smi)
    held_against_one(torch, "tp_anima", losses, one, anima_dir, smi)
    out["anima"] = {"one_card_gloo": one_card, "losses": losses, "ranks": rows,
                    "launches_per_rank": want, "one_process": one, "wall_s": wall}
    launches.update(want)
    shutil_rmtree(anima_dir)
    out["s"] = time.perf_counter() - t_phase
    print(f"  [{smi}] tp: {out['s']:.1f} s")
    return out, launches


# --------------------------------------------------------------------------

PHASES = ("kernels", "k5", "k6", "unet", "dit", "vae", "trainer", "anima", "anima_video",
          "repair", "fp16", "anima_sp", "dp", "pp", "tp", "resume", "plan")
DP_RANK_CLIS = ("sdxl", "anima", "anima_pp", "anima_sp", "anima_tp")
USAGE = ("usage: chip_smoke.py [--only PHASE[,PHASE...]]   phases: " + ", ".join(PHASES)
         + "\n       chip_smoke.py --anima-sp-rank PRESET OUT_DIR   (one torchrun rank)"
         + "\n       chip_smoke.py --dp-rank " + "|".join(DP_RANK_CLIS) + " PRESET OUT_DIR"
         + "   (one rank of dp, pp, anima_sp or tp)")


def kernels_json(timings, max_err, launches, k5, k6, sm90):
    """One entry per kernel; ``launches`` counts the phase named in
    ``phase`` ({phase: launches}), where the counts were set to 0 just
    before."""
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    kernels = []
    for kname, (replaces, d, ph, cuda_kernel) in KERNELS.items():
        head = timings[kname][0]      # the largest main shape of its head dim
        build = {}
        if kname in SM90_OF:
            build["build"] = sm90[kernel_label(*SM90_OF[kname])]
        elif cuda_kernel in sm90:
            build["build"] = sm90[cuda_kernel]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PACKAGE}/csrc/{fa.SOURCES[kname]}.cu", "kernel": cuda_kernel,
            "replaces": replaces, "head_dim": d, "phase": ph,
            "launches": launches[ph].get(kname, 0),
            "max_abs_err": max_err[kname], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": timings[kname], **build,
            **({"launches_tp_per_rank": launches["tp"][kname]}
               if kname in launches["tp"] else {}),
            **({"max_err_against_float64": timings["fp16_against_float64"][kname]}
               if kname in timings["fp16_against_float64"] else {}),
            **({"launches_anima_video": launches["anima_video"].get(kname, 0),
                "launches_repair": launches["repair"].get(kname, 0),
                "launches_pp_per_rank": launches["pp"].get(kname, 0),
                "launches_sp_video_per_rank": launches["anima_sp"].get(kname, 0)}
               if ph == "anima" else {}),
            **({"launches_profile_quants": launches["profile_quants"].get(kname, 0)}
               if kname == "flash_fwd_f32_d128" else {})})
    k5_err, k5_timings, k5_launches, ring_ms = k5
    for kname, line, kernel_names in (
            ("flash_fwd_stats", 503, "flash_fwd_d128"),
            ("flash_bwd_stats", 523, "flash_bwd_dq_d128 + flash_bwd_dkv_d128")):
        head = k5_timings[kname][0]   # the sp-2 hop, 2048 tokens a shard
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PACKAGE}/ops/flash_attention.py",
            "kernels": f"{kernel_names} in {PACKAGE}/csrc/{SM90}.cu",
            "replaces": f"{FA}:{line}",
            "phase": "k5 (the ring's hop schedule for sp 2 and 4 on one card)",
            "launches": k5_launches[kname], "max_abs_err": k5_err[kname],
            "launches_sp_video_per_rank": launches["anima_sp"].get(kname, 0),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": k5_timings[kname], "ring_one_card": ring_ms})
    for layout, kname, ph in (
            ("nhwc", "group_norm_silu",
             "k6 (the NHWC op, forward and backward, over one SDXL_BASE forward's sites)"),
            ("nchw", "group_norm_silu_nchw",
             "k6 (the SDXL_BASE UNet forward and backward with fused_gn=True)")):
        k6_err, k6_launches, k6_row = k6[layout]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PACKAGE}/csrc/groupnorm_silu.cu", "replaces": f"{GN}:60",
            "phase": ph, "launches": k6_launches, "max_abs_err": k6_err, "ms": k6_row["ms"],
            "plain_ms": k6_row["plain_ms"], "bound_ms": k6_row["bound_ms"],
            "bound_by": k6_row["bound_by"], "library_ms": k6_row["library_ms"],
            "shapes": [k6_row]})
    return kernels


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if args[:1] == ["--anima-sp-rank"] and len(args) == 3:
        return anima_sp_rank(args[1], args[2])
    if args[:1] == ["--dp-rank"] and len(args) == 4 and args[1] in DP_RANK_CLIS:
        return dp_rank(args[1], args[2], args[3])
    only = set(PHASES)
    if args[:1] == ["--only"] and len(args) == 2 and set(args[1].split(",")) <= only:
        only = set(args[1].split(","))
    elif args:
        print(USAGE, flush=True)
        return 2
    if "resume" in only:          # resumes the trainer phases' runs
        only |= {"trainer", "anima"}
    if not (REPO / PACKAGE / "csrc" / f"{SM90}.cu").exists():
        print(f"FAIL: {PACKAGE} not found beside chip_smoke.py; run it from "
              "the root of a checkout", flush=True)
        return 1
    sys.path.insert(0, str(REPO))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    summary = {}
    weights = tempfile.TemporaryDirectory(prefix="chip_smoke_weights_")
    WEIGHTS_DIR.append(weights.name)
    try:
        name, smi = device_phase(torch)
        sm90 = build_phase()
        summary.update(device=name, nvidia_smi=smi, sm90_build=sm90)
        if "kernels" in only:
            max_err, timings = kernel_phase(torch)
            summary["timings"] = timings
        if "k5" in only:
            k5 = k5_phase(torch)
            summary["k5"] = k5[1:]
        if "k6" in only:
            k6 = k6_phase(torch)
            summary["k6"] = {layout: v[1:] for layout, v in k6.items()}
        launches = {}
        if "unet" in only:
            launches["unet"] = unet_phase(torch)
        if "dit" in only:
            launches["dit"] = dit_phase(torch)
        if "vae" in only:
            summary["vae"], launches["vae"] = vae_phase(torch)
        if "trainer" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                summary["trainer"], launches["trainer"] = trainer_phase(
                    torch, Path(tmp), TRAIN_STEPS, smi, "resume" in only)
        if "anima" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_anima_") as tmp:
                summary["anima"], launches["anima"] = anima_phase(
                    torch, Path(tmp), TRAIN_STEPS, smi, "resume" in only)
        if "anima_video" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_anima_video_") as tmp:
                summary["anima_video"], launches["anima_video"] = anima_video_phase(
                    torch, Path(tmp), SHORT_STEPS, smi)
        if "repair" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_repair_") as tmp:
                (summary["repair"], launches["repair"],
                 launches["profile_quants"]) = repair_phase(torch, Path(tmp), SHORT_STEPS, smi)
        if "fp16" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_fp16_") as tmp:
                summary["fp16"], launches["fp16"] = fp16_phase(torch, Path(tmp), smi)
        if "anima_sp" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_anima_sp_") as tmp:
                summary["anima_sp"], launches["anima_sp"] = anima_sp_phase(
                    torch, Path(tmp), TRAIN_STEPS, smi)
        if "dp" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
                summary["dp"] = dp_phase(torch, Path(tmp), smi)
        if "pp" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
                summary["pp"], launches["pp"] = pp_phase(torch, Path(tmp), smi)
        if "tp" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
                summary["tp"], launches["tp"] = tp_phase(torch, Path(tmp), smi)
        if "plan" in only:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
                summary["plan"] = plan_phase(torch, Path(tmp), smi)
        end_phase()
        summary["phase_s"] = {name: t for name, _, t in _PHASES_RUN}
        LOG_DIR.mkdir(parents=True, exist_ok=True)
        (LOG_DIR / "chip_smoke_summary.json").write_text(json.dumps(summary, indent=1))
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        weights.cleanup()
    print(f"\ntotal {time.perf_counter() - t_start:.1f} s")
    if only == set(PHASES):
        print(json.dumps({"kernels": kernels_json(timings, max_err, launches, k5, k6, sm90)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
