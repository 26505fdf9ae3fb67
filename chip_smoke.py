#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (aozora_sdxl_training_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: CUDA present; the card's name and power limit.
2. build: compiles every CUDA source of the port (one nvcc each, all at once).
3. kernels: each flash-attention kernel against its plain PyTorch version:
   K1 forward, K2 dQ, K3 dK/dV (head_dim 64) at the SDXL shapes, K4a forward
   and K4b dQ, dK/dV (head_dim 128) at the Anima shape, with ragged and
   unequal lengths and fp32; then each timed with CUDA events beside its
   bound, its plain version and scaled_dot_product_attention (a yardstick
   only: its forward beside the forward kernels, its backward, and its
   forward plus backward, beside the backward kernels).
4. unet: a small UNet with head_dim 64, flash path against the einsum path,
   forward and parameter gradients.
5. dit: a small Anima DiT with head_dim 128, the same comparison.
6. trainer: the port's SDXL training CLI at SDXL_BASE width, 1024px, batch 1,
   8 micro steps (2 optimizer steps at GA 4) on a random UNet written as an
   SD checkpoint and a synthetic cache; checks the GUI grammar, finite
   losses, the flash launch counts (70 of each of K1-K3 per micro step, 140
   forward launches under full remat, no K4) and the merged checkpoint.
7. anima: the port's Anima training CLI at ANIMA_BASE width and depth,
   1024px, batch 1, GA 4, Full gradient checkpointing, 8 micro steps, on a
   random DiT checkpoint and a synthetic cache; checks the GUI grammar,
   finite losses, the flash launch counts (per micro step 56 K4a: 28
   forward + 28 recompute, 28 of each K4b kernel, no K1-K3) and the saved
   bf16 DiT under the detected key prefix.

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
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "aozora_sdxl_training_tpu_torch"
# the trainer's full output and a JSON summary go here
LOG_DIR = Path(os.environ.get("CHIP_SMOKE_LOG_DIR", REPO / "chip_smoke_out"))
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM
SOURCES = ("flash_attention",)
FA = "aozora_sdxl_training_tpu/ops/flash_attention.py"
# each kernel, the Pallas kernel it replaces (K1 _fwd_kernel, K2
# _bwd_dq_kernel, K3 _bwd_dkv_kernel; K4a _flash_forward_folded, K4b the dq
# and dk/dv pallas_calls of _flash_backward_folded) and its head dim
KERNELS = {
    "flash_fwd": (f"{FA}:65", 64),
    "flash_bwd_dq": (f"{FA}:153", 64),
    "flash_bwd_dkv": (f"{FA}:186", 64),
    "flash_fwd_d128": (f"{FA}:302", 128),
    "flash_bwd_dq_d128": (f"{FA}:355", 128),
    "flash_bwd_dkv_d128": (f"{FA}:378", 128),
}
TRAIN_STEPS = 8               # two optimizer steps at the presets' GA 4
GA = 4
# one SDXL_BASE forward at 128x128 latents, batch 1, as bench.py counts it;
# a training micro step does three times this work (forward + backward)
SDXL_FWD_FLOPS_1024 = 6.779495251968e12
# self-attention at 1024px per micro step, by head dim: (B, H, S, calls);
# SDXL at head_dim 64, the Anima DiT (28 blocks, 16 heads) at 128
MAIN_SHAPES = {64: ((1, 10, 4096, 10), (1, 20, 1024, 60)),
               128: ((1, 16, 4096, 28),)}
SELF_ATTN_CALLS = {d: sum(c for *_, c in shapes) for d, shapes in MAIN_SHAPES.items()}

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


def phase(name):
    print(f"\n=== phase: {name} ===", flush=True)


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
    phase("build")
    from aozora_sdxl_training_tpu_torch.ops import cuda_build
    results = cuda_build.build_all(SOURCES)
    for name, (seconds, output) in results.items():
        print(f"built {name}.cu in {seconds:.1f} s")
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas: {line.strip()}")


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


def bound(flops, nbytes):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
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
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, H, Sq, Skv, D, dtype); the "S=" cases are the main shapes
    cases = [("S=4096 B*H=10 D=64", 1, 10, 4096, 4096, 64, bf16),
             ("S=1024 B*H=20 D=64", 1, 20, 1024, 1024, 64, bf16),
             ("ragged S=3952 B*H=10 D=64", 1, 10, 3952, 3952, 64, bf16),
             ("Sq=1000 Skv=333 B=2 H=3 D=64", 2, 3, 1000, 333, 64, bf16),
             ("fp32 S=1000 B=2 H=2 D=64", 2, 2, 1000, 1000, 64, f32),
             ("S=4096 B*H=16 D=128", 1, 16, 4096, 4096, 128, bf16),
             ("ragged S=3952 B*H=16 D=128", 1, 16, 3952, 3952, 128, bf16),
             ("Sq=1000 Skv=333 B=2 H=3 D=128", 2, 3, 1000, 333, 128, bf16),
             ("fp32 S=1000 B=2 H=2 D=128", 2, 2, 1000, 1000, 128, f32)]
    # tolerance: 2% of the largest reference magnitude for tensor outputs
    # (bf16 operands of the tensor-core products, fp32 accumulation); lse in
    # absolute terms (exact bf16 products for bf16 inputs; fp32 inputs are
    # rounded to bf16 when staged, which moves logits by up to ~2^-8 |s|)
    rel_tol = 2e-2
    lse_tol = {bf16: 1e-3, f32: 5e-2}
    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = {k: 0.0 for k in KERNELS}
    for label, b, h, sq, skv, d, dtype in cases:
        q, do = (torch.randn(b, sq, h, d, device="cuda", dtype=dtype, generator=g)
                 for _ in range(2))
        k, v = (torch.randn(b, skv, h, d, device="cuda", dtype=dtype, generator=g)
                for _ in range(2))
        scale = d ** -0.5
        out, lse = fa.flash_fwd(q, k, v, scale)
        dq, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, scale)
        ref_dq, ref_delta = fa.flash_bwd_dq_reference(q, k, v, out, lse, do, scale)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, ref_delta, scale)
        kf, kdq, kdkv = fa.KERNEL_NAMES[d]
        rows = [(kf, "out", out, ref_out, None),
                (kf, "lse", lse, ref_lse, lse_tol[dtype]),
                (kdq, "delta", delta, ref_delta, None),
                (kdq, "dq", dq, ref_dq, None),
                (kdkv, "dk", dk, ref_dk, None),
                (kdkv, "dv", dv, ref_dv, None)]
        for kname, what, got, want, atol in rows:
            got, want = got.float(), want.float()
            check(bool(torch.isfinite(got).all()), f"{label} {what}: non-finite")
            err = (got - want).abs().max().item()
            tol = atol if atol is not None else rel_tol * want.abs().max().item()
            print(f"  {label:30s} {what:5s} max_abs_err {err:.3e}  tol {tol:.3e}")
            check(err <= tol, f"{label} {what}: error {err} > tolerance {tol}")
            if what != "lse" and label.startswith("S="):
                max_err[kname] = max(max_err[kname], err)
        del q, k, v, do, out, lse, dq, dk, dv, ref_out, ref_dq, ref_dk, ref_dv
        torch.cuda.empty_cache()
    return max_err, time_kernels(torch, fa)


def time_kernels(torch, fa):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    timings = {}
    for d, shapes in MAIN_SHAPES.items():
        kf, kdq, kdkv = fa.KERNEL_NAMES[d]
        for b, h, s, calls in shapes:
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda", dtype=torch.bfloat16,
                                       generator=g) for _ in range(4))
            scale = d ** -0.5
            out, lse = fa.flash_fwd(q, k, v, scale)
            _, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, scale)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            ref = F.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2)
            sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach()))
            sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                ref, (qt, kt, vt), dot, retain_graph=True))
            sdpa_fwd_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot))
            shape = {
                kf: (cuda_ms(torch, lambda: fa.flash_fwd(q, k, v, scale)),
                     cuda_ms(torch, lambda: fa.flash_forward_reference(q, k, v, scale), 5, 1),
                     sdpa_fwd),
                kdq: (cuda_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, out, lse, do, scale)),
                      cuda_ms(torch, lambda: fa.flash_bwd_dq_reference(
                          q, k, v, out, lse, do, scale), 5, 1),
                      sdpa_bwd),
                kdkv: (cuda_ms(torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)),
                       cuda_ms(torch, lambda: fa.flash_bwd_dkv_reference(
                           q, k, v, do, lse, delta, scale), 5, 1),
                       sdpa_bwd),
            }
            for (kname, (ms, plain, lib)), w in zip(shape.items(), work(b, h, s, d, 2)):
                bms, bound_by = bound(*w)
                timings.setdefault(kname, []).append({
                    "shape": f"B*H={b * h} S={s} D={d} bf16",
                    "calls_per_micro_step": calls,
                    "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": bound_by,
                    "library_ms": lib, "library_fwd_bwd_ms": sdpa_fwd_bwd,
                    "tflops": w[0] / ms / 1e9})
                print(f"  {kname:18s} B*H={b * h:3d} S={s:5d} D={d}: kernel {ms:.4f} ms, "
                      f"bound {bms:.4f} ms ({bms / ms:.1%}), plain {plain:.4f} ms, "
                      f"sdpa {lib:.4f} ms{' (dq,dk,dv together)' if kname != kf else ''}"
                      f"{f' (fwd+bwd {sdpa_fwd_bwd:.4f} ms)' if kname != kf else ''}, "
                      f"{w[0] / ms / 1e9:.1f} TFLOP/s")
            del q, k, v, do, out, lse, delta, qt, kt, vt, ref
            torch.cuda.empty_cache()
    return timings


# --------------------------------------------------------------------------
# 4: small UNet, flash path against the einsum path
# --------------------------------------------------------------------------

def unet_phase(torch):
    phase("unet")
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import UNetConfig
    from aozora_sdxl_training_tpu_torch.models.sdxl.unet import init_params, unet_forward
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
        results = {}
        for impl in ("xla", "flash"):
            out = unet_forward(params, sample, t, ctx, pooled, time_ids, cfg=cfg,
                               attn_impl=impl, compute_dtype=torch.float32)
            grads = torch.autograd.grad((out ** 2).mean(), list(params.values()))
            results[impl] = (out.detach(), grads)
    finally:
        del os.environ["AOZORA_FLASH_MIN_KV"]
    ref_out, ref_g = results["xla"]
    got_out, got_g = results["flash"]
    err = (got_out - ref_out).abs().max().item() / ref_out.abs().max().item()
    gerr = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
               for a, b in zip(got_g, ref_g))
    print(f"  fp32 UNet, flash vs einsum: out rel err {err:.3e} (tol 2e-2), "
          f"max param-grad rel err {gerr:.3e} (tol 5e-2)")
    check(err <= 2e-2 and gerr <= 5e-2, "small UNet: flash path disagrees")


# --------------------------------------------------------------------------
# 5: small DiT, flash path against the einsum path
# --------------------------------------------------------------------------

def dit_phase(torch):
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
    want = {"flash_fwd_d128": 4, "flash_bwd_dq_d128": 2, "flash_bwd_dkv_d128": 2}
    print(f"  fp32 DiT (head_dim 128, 1024 tokens), flash vs einsum: out rel err "
          f"{err:.3e} (tol 2e-2), max param-grad rel err {gerr:.3e} (tol 5e-2); "
          f"launches {counts['flash']}")
    check(counts["xla"] == {} and counts["flash"] == want,
          f"small DiT launches {counts}, expected {want} on the flash path")
    check(err <= 2e-2 and gerr <= 5e-2, "small DiT: flash path disagrees")


# --------------------------------------------------------------------------
# 6-7: trainers
# --------------------------------------------------------------------------

def timed_steps(torch, module, names, marks: list):
    """Wraps the step factories ``names`` of ``module`` (one name with
    "micro" in it, one with "apply") so that each step ends in
    torch.cuda.synchronize() and appends (kind, host time) to ``marks``.
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
        setattr(module, name, wrap("micro" if "micro" in name else "apply", make))
    return lambda: [setattr(module, k, v) for k, v in originals.items()]


def step_times(marks: list, skip: int):
    """(s per micro step, s per apply step) from ``timed_steps`` marks,
    leaving out the first ``skip`` micro steps (warm-up) and the apply
    steps among them. A micro step runs from the end of the step before it
    (micro or apply) to its own end, so it holds the host's work between
    steps too."""
    micro, apply_, n_micro, t_prev = [], [], 0, None
    for kind, t in marks:
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


def write_checkpoint(torch, path: Path, seed: int):
    """SDXL_BASE UNet from init_params (fixed seed) in bf16 SD keys, plus a
    non-UNet passthrough tensor, written tensor by tensor."""
    import numpy as np
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import write_streaming
    from aozora_sdxl_training_tpu_torch.ckpt.sd_checkpoint import tensor_to_numpy
    from aozora_sdxl_training_tpu_torch.ckpt.sd_keys import unet_key_mapping
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE
    from aozora_sdxl_training_tpu_torch.models.sdxl.unet import init_params
    import ml_dtypes
    params = init_params(SDXL_BASE, torch.Generator(device="cuda").manual_seed(seed),
                         dtype=torch.bfloat16)
    mapping = unet_key_mapping(list(params))
    bf = np.dtype(ml_dtypes.bfloat16)
    tensors = {mapping[n]: (tuple(t.shape), bf, lambda t=t: tensor_to_numpy(t, bf))
               for n, t in params.items()}
    tensors["first_stage_model.passthrough"] = np.ones((3,), np.float32)
    write_streaming(path, tensors)
    n = sum(t.numel() for t in params.values())
    del params, tensors
    torch.cuda.empty_cache()
    return n


def run_trainer_cli(torch, cli_main, preset_path: Path, work_dir: Path, module,
                    step_names, log_name: str):
    """Runs a training CLI in ``work_dir`` with the flash launch counts set
    to 0 just before and read just after, its steps timed and its stdout
    kept. Returns (stdout, marks, launches, peak GB, wall s)."""
    import gc
    from aozora_sdxl_training_tpu_torch.ops import flash_attention as fa
    gc.collect()                  # an earlier trainer's weights, held in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    marks = []
    restore = timed_steps(torch, module, step_names, marks)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.chdir(work_dir), contextlib.redirect_stdout(Tee(sys.stdout, log)):
            cli_main(["--config", str(preset_path)])
    finally:
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


def trainer_phase(torch, work_dir: Path, steps: int):
    phase("trainer")
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import read_header
    from aozora_sdxl_training_tpu_torch.cli import train_sdxl
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import write_synthetic_dataset
    from aozora_sdxl_training_tpu_torch.models.sdxl.arch import SDXL_BASE, hf_param_names
    from aozora_sdxl_training_tpu_torch.train import trainer as trainer_module

    t0 = time.perf_counter()
    ckpt = work_dir / "sdxl_random.safetensors"
    n_params = write_checkpoint(torch, ckpt, seed=1234)
    print(f"  wrote {ckpt.name}: {n_params:,} UNet parameters "
          f"({ckpt.stat().st_size / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    check(n_params == 2_567_463_684, f"SDXL_BASE has {n_params} parameters")

    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    sdxl = preset["sdxl"]
    sdxl.update({"sdxl_base_model_path": str(ckpt),
                 "sdxl_output_dir": str(work_dir / "out"),
                 "sdxl_output_name": "smoke",
                 "sdxl_instance_datasets": [{"path": str(work_dir / "data"), "repeats": 1}],
                 "sdxl_max_train_steps": steps})
    preset_path = work_dir / "preset.json"
    preset_path.write_text(json.dumps(preset, indent=1))
    config = RuntimeConfig(schema.flatten_preset(preset))
    cfg = SDXL_BASE
    write_synthetic_dataset(work_dir / "data", config, n_images=2,
                            image_size=(1024, 1024), seq_len=77,
                            embed_dim=cfg.cross_attention_dim,
                            pooled_dim=cfg.pooled_projection_dim, seed=5)

    remat = trainer_module.sdxl_remat_mode()
    raw, marks, launches, peak_gb, wall = run_trainer_cli(
        torch, train_sdxl.main, preset_path, work_dir, trainer_module,
        ("make_micro_step", "make_apply_step"), "chip_smoke_trainer.log")
    losses = check_progress(raw, SDXL_PROGRESS, steps)
    calls = SELF_ATTN_CALLS[64]
    check_launches(launches, {"flash_fwd": calls * (2 if remat else 1) * steps,
                              "flash_bwd_dq": calls * steps,
                              "flash_bwd_dkv": calls * steps})

    final = work_dir / "out" / "smoke.safetensors"
    check(final.exists(), "no merged checkpoint")
    header = read_header(final)
    unet = {k: v for k, v in header.items() if k.startswith("model.diffusion_model.")}
    check(len(unet) == len(hf_param_names(cfg)), f"{len(unet)} UNet tensors saved")
    check(all(v["dtype"] == "BF16" for v in unet.values()), "UNet tensors not BF16")
    check("first_stage_model.passthrough" in header, "passthrough tensor lost")
    summary = step_summary(marks, steps, SDXL_FWD_FLOPS_1024, peak_gb, wall,
                           launches, losses, remat=remat or "off")
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


def anima_phase(torch, work_dir: Path, steps: int):
    phase("anima")
    from aozora_sdxl_training_tpu_torch.ckpt.safetensors_io import read_header
    from aozora_sdxl_training_tpu_torch.cli import train_anima
    from aozora_sdxl_training_tpu_torch.config import schema
    from aozora_sdxl_training_tpu_torch.config.runtime import RuntimeConfig
    from aozora_sdxl_training_tpu_torch.data.synthetic import (
        write_random_dit_checkpoint, write_synthetic_anima_dataset)
    from aozora_sdxl_training_tpu_torch.models.anima.dit import ANIMA_BASE, param_shapes
    from aozora_sdxl_training_tpu_torch.train import anima_trainer

    cfg = ANIMA_BASE
    t0 = time.perf_counter()
    ckpt = work_dir / "anima_random.safetensors"
    n_params = write_random_dit_checkpoint(ckpt, cfg, seed=4321, device="cuda")
    torch.cuda.empty_cache()
    n_want = sum(math.prod(s) for s in param_shapes(cfg).values())
    print(f"  wrote {ckpt.name}: {n_params:,} DiT parameters "
          f"({ckpt.stat().st_size / 1e9:.2f} GB, bf16, pipe.dit.) in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_params == n_want and 2.08e9 < n_params < 2.10e9,
          f"ANIMA_BASE has {n_params} parameters")

    preset = json.loads((REPO / "configs" / "default_config.json").read_text())
    preset["active_mode"] = "anima"
    anima = preset["anima"]
    anima.update({"anima_dit_model_path": str(ckpt),
                  "anima_output_dir": str(work_dir / "out"),
                  "anima_output_name": "smoke_anima",
                  "anima_instance_datasets": [{"path": str(work_dir / "data"),
                                               "repeats": 1}],
                  "anima_max_train_steps": steps})
    preset_path = work_dir / "preset.json"
    preset_path.write_text(json.dumps(preset, indent=1))
    config = RuntimeConfig(schema.flatten_preset(preset))
    check(config.GRADIENT_ACCUMULATION_STEPS == GA and config.BATCH_SIZE == 1
          and config.ANIMA_GRADIENT_CHECKPOINTING_MODE == "Full",
          "the default Anima preset is not batch 1, GA 4, Full checkpointing")
    # with no VAE path in the preset, the cache options name the VAE source
    # by a relative path, resolved in the working directory: write the cache
    # from the directory the CLI runs in
    with contextlib.chdir(work_dir):
        write_synthetic_anima_dataset(work_dir / "data", config, n_images=2,
                                      image_size=(1024, 1024),
                                      source_dim=cfg.adapter_source_dim,
                                      vocab=cfg.adapter_vocab,
                                      latent_channels=cfg.in_channels, seed=6)

    raw, marks, launches, peak_gb, wall = run_trainer_cli(
        torch, train_anima.main, preset_path, work_dir, anima_trainer,
        ("make_anima_micro_step", "make_apply_step"), "chip_smoke_anima.log")
    losses = check_progress(raw, ANIMA_PROGRESS, steps)
    calls = SELF_ATTN_CALLS[128]
    check_launches(launches, {"flash_fwd_d128": 2 * calls * steps,
                              "flash_bwd_dq_d128": calls * steps,
                              "flash_bwd_dkv_d128": calls * steps})

    final = work_dir / "out" / "smoke_anima.safetensors"
    check(final.exists(), "no saved DiT")
    header = read_header(final)
    check(len(header) == len(param_shapes(cfg))
          and all(k.startswith("pipe.dit.") for k in header),
          f"{len(header)} DiT tensors saved, not all under pipe.dit.")
    check(all(v["dtype"] == "BF16" for v in header.values()), "DiT tensors not BF16")
    tokens = (1024 // 8 // cfg.patch_spatial) ** 2
    fwd = anima_forward_flops(cfg, tokens)
    print(f"  analytic forward at {tokens} tokens: {fwd:.4e} flop; a micro step "
          f"counts 3x (forward + backward; the Full recompute is not counted)")
    summary = step_summary(marks, steps, fwd, peak_gb, wall, launches, losses,
                           remat="full", forward_flops=fwd)
    return summary, launches


# --------------------------------------------------------------------------

def main() -> int:
    if not (REPO / PACKAGE / "csrc" / "flash_attention.cu").exists():
        print(f"FAIL: {PACKAGE} not found beside chip_smoke.py; run it from "
              "the root of a checkout", flush=True)
        return 1
    sys.path.insert(0, str(REPO))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        name, smi = device_phase(torch)
        build_phase()
        max_err, timings = kernel_phase(torch)
        unet_phase(torch)
        dit_phase(torch)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            sdxl, sdxl_launches = trainer_phase(torch, Path(tmp), TRAIN_STEPS)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_anima_") as tmp:
            anima, anima_launches = anima_phase(torch, Path(tmp), TRAIN_STEPS)
        (LOG_DIR / "chip_smoke_summary.json").write_text(json.dumps(
            {"device": name, "nvidia_smi": smi, "trainer": sdxl, "anima": anima,
             "timings": timings}, indent=1))
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    kernels = []
    for kname, (replaces, d) in KERNELS.items():
        head = timings[kname][0]      # the largest main shape of its head dim
        launches = (sdxl_launches if d == 64 else anima_launches)[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"{PACKAGE}/csrc/flash_attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err[kname], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": timings[kname]})
    print(f"\ntotal {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
