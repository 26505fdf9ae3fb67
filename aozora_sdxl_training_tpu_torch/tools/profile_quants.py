"""CLI: dynamic mixed-precision quantization of an Anima DiT checkpoint.

Counterpart of ``aozora_sdxl_training_tpu/tools/profile_quants.py``: the
converter's dynamic modes (reference ``convert_anima_to_quants``
fast_dynamic / dynamic / compression_first) against the real model. The
global modes run actual DiT forwards (teacher vs simulated-quantized) on
calibration inputs (cached latents/text payloads when a cache directory is
given, synthetic inputs otherwise), then write a per-layer mixed-precision
comfy_quant checkpoint. The forwards are the port's DiT in fp32 without
remat on ``core.platform.resolve_device()``: on CUDA its self-attention
takes the flash kernels from ``ops/attention.FLASH_MIN_KV`` tokens on
(``flash_fwd_f32_d128``; ``--latent-hw 64`` is the smallest size that
reaches them), on the CPU the einsum path.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..ckpt.anima_checkpoint import load_dit_state
from ..ckpt.safetensors_io import write_streaming
from . import quant_profile as qp


def load_calibration_batch(cache_dir, *, max_samples: int = 4,
                           context_tokens: int = 512) -> dict | None:
    """Load (latents, prompt_emb, t5_ids) from a trainer cache directory —
    the reference calibrates its dynamic profiles on the trainer's own
    cached dataset (convert_anima_to_quants.py:1073-1110) rather than
    synthetic noise.  Takes up to ``max_samples`` items sharing the first
    item's bucket shape."""
    from ..data import cache_store as cs
    import random

    cache_dir = Path(cache_dir)
    if not cs.index_exists(cache_dir):
        print(f"WARNING: no cache index at {cache_dir}; "
              "falling back to synthetic calibration inputs")
        return None
    items = sorted(cs.load_index(cache_dir)["files"],
                   key=cs.stable_cache_item_key)
    rng = random.Random(0)
    lats, embs, ids = [], [], []
    want_shape = None
    for item in items:
        te_path = cs.selected_te_path(item, rng, {}, enabled=False)
        lat_path = item.get("lat_path")
        if not te_path or not lat_path:
            continue
        try:
            te, _ = cs.load_payload(te_path)
            lat, _ = cs.load_payload(lat_path)
        except Exception:  # noqa: BLE001 — skip unreadable items
            continue
        latents = np.asarray(lat["latents"], np.float32)
        if want_shape is None:
            want_shape = latents.shape
        elif latents.shape != want_shape:
            continue
        t5 = np.asarray(te["t5xxl_ids"], np.int32).reshape(-1)
        padded = np.zeros(context_tokens, np.int32)
        padded[: min(len(t5), context_tokens)] = t5[:context_tokens]
        lats.append(latents)
        embs.append(np.asarray(te["prompt_emb"], np.float32))
        ids.append(padded)
        if len(lats) >= max_samples:
            break
    if not lats:
        print(f"WARNING: no loadable cached items under {cache_dir}; "
              "falling back to synthetic calibration inputs")
        return None
    batch = {"latents": np.stack(lats), "prompt_emb": np.stack(embs),
             "t5xxl_ids": np.stack(ids)}
    print(f"INFO: calibration batch from cache: {len(lats)} item(s), "
          f"latents {batch['latents'].shape}")
    return batch


def build_forward_fn(state: dict, *, latent_hw: int = 16, seed: int = 0,
                     calib_batch: dict | None = None, device=None):
    """A DiT forward over fixed calibration inputs, parameterized by a
    (torch-layout) state dict: the teacher/simulated-quant comparator. It
    runs in fp32 without remat on ``device`` (``resolve_device()`` by
    default); a tensor reaches the device once and again only when a trial
    state holds another array under its name.

    ``calib_batch`` (from :func:`load_calibration_batch`) switches the
    comparator from synthetic noise to the trainer's own cached
    latents/text payloads, matching the reference's dataset-calibrated
    dynamic modes."""
    import torch

    from ..core.platform import resolve_device
    from ..models.anima import dit as dit_mod
    from ..train.anima_trainer import _dit_config_for_state

    device = resolve_device() if device is None else torch.device(device)
    cfg = _dit_config_for_state(state)
    if calib_batch is not None:
        latents = np.asarray(calib_batch["latents"], np.float32)
        if latents.ndim == 4:          # image mode: (B,H,W,C) -> (B,1,H,W,C)
            latents = latents[:, None]
        context = np.asarray(calib_batch["prompt_emb"], np.float32)
        t5 = np.asarray(calib_batch["t5xxl_ids"], np.int32)
        timesteps = np.full((latents.shape[0],), 500.0, np.float32)
    else:
        rng = np.random.default_rng(seed)
        latents = rng.normal(size=(1, 1, latent_hw, latent_hw,
                                   cfg.in_channels)).astype(np.float32)
        context = rng.normal(size=(1, 16, cfg.adapter_source_dim)).astype(np.float32)
        t5 = rng.integers(1, cfg.adapter_vocab, (1, 16)).astype(np.int32)
        timesteps = np.asarray([500.0], np.float32)
    latents, timesteps, context, t5 = (torch.as_tensor(a, device=device)
                                       for a in (latents, timesteps, context, t5))
    attn_impl = "flash" if device.type == "cuda" else "xla"
    on_device: dict = {}           # name -> (host array, its device tensor)

    @torch.no_grad()
    def forward(torch_state):
        if not on_device:          # the whole state once, shapes checked
            on_device.update((name, (torch_state[name], t)) for name, t in
                             dit_mod.params_from_torch_state(torch_state, cfg,
                                                             device=device).items())
        for name, (held, _) in list(on_device.items()):
            host = torch_state[name]
            if host is not held:
                on_device[name] = (host, torch.as_tensor(np.asarray(host, np.float32),
                                                         device=device))
        params = {name: t for name, (_, t) in on_device.items()}
        out = dit_mod.dit_forward(params, latents, timesteps, context,
                                  cfg=cfg, t5_ids=t5, attn_impl=attn_impl,
                                  compute_dtype=torch.float32, remat=False)
        return out.float().cpu().numpy()

    return forward


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Profile + quantize a DiT checkpoint with per-layer formats.")
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--mode", default="fast_dynamic",
                        choices=["fast_dynamic", "dynamic", "compression_first"])
    parser.add_argument("--format", default="nvfp4",
                        help="base quant format for fast_dynamic/dynamic")
    parser.add_argument("--preset", default="broad",
                        choices=["target", "broad", "all"])
    parser.add_argument("--promote-threshold", type=float, default=0.05)
    parser.add_argument("--error-budget", type=float, default=0.05)
    parser.add_argument("--max-layers", type=int, default=None,
                        help="cap layers evaluated by the global mode")
    parser.add_argument("--latent-hw", type=int, default=16,
                        help="calibration latent size for global modes")
    parser.add_argument("--cache-dir", default=None,
                        help="trainer cache directory; global modes then "
                             "calibrate on real cached latents/text payloads "
                             "(reference convert_anima_to_quants.py:1073-1110)")
    parser.add_argument("--calib-samples", type=int, default=4,
                        help="cached items to calibrate on (--cache-dir)")
    args = parser.parse_args(argv)

    from .quantize import FORMAT_CHOICES
    fmt = FORMAT_CHOICES.get(args.format, args.format)
    state, prefix = load_dit_state(args.input)
    state = {k: np.asarray(v) for k, v in state.items()}

    if args.mode == "fast_dynamic":
        assignment = qp.fast_dynamic_profile(
            state, format_name=fmt, preset=args.preset,
            promote_threshold=args.promote_threshold)
    else:
        calib = (load_calibration_batch(args.cache_dir,
                                        max_samples=args.calib_samples)
                 if args.cache_dir else None)
        forward = build_forward_fn(state, latent_hw=args.latent_hw,
                                   calib_batch=calib)
        if args.mode == "dynamic":
            assignment = qp.global_dynamic_profile(
                state, forward, format_name=fmt, preset=args.preset,
                promote_threshold=args.promote_threshold,
                max_layers=args.max_layers)
        else:
            assignment = qp.compression_first_profile(
                state, forward, preset=args.preset,
                error_budget=args.error_budget)

    tensors, report = qp.apply_profile(state, assignment)
    write_streaming(Path(args.output),
                    {f"{prefix}{k}": v for k, v in tensors.items()},
                    metadata={"aozora_quant_profile": json.dumps(
                        {"mode": args.mode, **report})})
    by_format: dict = {}
    for fmt_name in assignment.values():
        by_format[fmt_name] = by_format.get(fmt_name, 0) + 1
    print(json.dumps({"mode": args.mode, "assignment_counts": by_format,
                      **report}, indent=2))


if __name__ == "__main__":
    main()
