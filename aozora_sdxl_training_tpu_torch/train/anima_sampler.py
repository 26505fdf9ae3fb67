"""Anima DiT in-training preview sampling.

Counterpart of ``aozora_sdxl_training_tpu/train/anima_sampler.py``: Euler
integration of the flow-matching ODE over the DiT. The model predicts
``noise - x0`` at state ``x_t = (1-t) x0 + t noise`` with conditioning
``t`` (the trainer feeds sigma in [0, 1]), so

    x_{t-dt} = x_t - dt * pred.

A plain Python loop over the steps takes the place of ``lax.scan``; the
DiT runs without remat under ``torch.no_grad()``, so on the card each step
launches the head_dim-128 flash forward (K4a) once a block.

With a full Wan VAE file (one that carries the decoder) previews are real
pixels: ``decode_image`` of the first latent frame, or, when the file has
the temporal upsamples' ``time_conv`` and the sample is a clip,
``decode_video`` of the whole clip as a filmstrip of up to 5 evenly spaced
frames. Otherwise, as with the reference's encode-only file, they are a
latent-RGB picture: the first three latent channels, each min/max
normalized, nearest-upscaled 8x.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.anima import dit as dit_mod
from .sampler import preview_noise, save_preview_png


def make_anima_preview_sampler(cfg: dit_mod.AnimaDiTConfig, steps: int, *,
                               attn_impl: str = "xla",
                               compute_dtype=torch.bfloat16):
    """``sample(params, noise, prompt_emb, t5_ids) -> x0`` (fp32).

    ``noise``: (B, T, H, W, C), the training latent space."""
    n = max(int(steps), 1)
    ts = np.linspace(1.0, 0.0, n + 1).astype(np.float32)

    @torch.no_grad()
    def sample(params, noise, prompt_emb, t5_ids):
        x = noise.float()
        for i in range(n):
            t = torch.full((x.shape[0],), float(ts[i]), dtype=torch.float32,
                           device=x.device)
            pred = dit_mod.dit_forward(
                params, x.to(compute_dtype), t, prompt_emb.to(compute_dtype), cfg=cfg,
                t5_ids=t5_ids, attn_impl=attn_impl, compute_dtype=compute_dtype,
                remat=False)
            x = x - float(ts[i] - ts[i + 1]) * pred.float()
        return x

    return sample


def latents_to_rgb(latents, upscale: int = 8) -> np.ndarray:
    """(B, T, H, W, C) latents -> (H*u, W*u, 3) float in [0, 1] for the
    first batch item / first frame (per-channel min-max normalized)."""
    lat = (latents.detach().float().cpu().numpy() if isinstance(latents, torch.Tensor)
           else np.asarray(latents, np.float32))
    frame = lat[0, 0] if lat.ndim == 5 else lat[0]
    rgb = frame[..., :3]
    if rgb.shape[-1] < 3:
        rgb = np.repeat(frame[..., :1], 3, axis=-1)
    lo = rgb.min(axis=(0, 1), keepdims=True)
    hi = rgb.max(axis=(0, 1), keepdims=True)
    rgb = (rgb - lo) / np.maximum(hi - lo, 1e-6)
    return np.repeat(np.repeat(rgb, upscale, axis=0), upscale, axis=1)


def load_decoder_for_preview(config, device=None):
    """(decoder params on ``device``, WanVaeConfig) from the configured VAE
    file (``DIT_VAE_PATH``), or None.

    Full Wan files carry the decoder half; the reference's encode-only files
    do not, and previews then fall back to latent-RGB."""
    from ..ckpt.safetensors_io import load_all
    from ..models.anima import wan_vae
    path = str(getattr(config, "DIT_VAE_PATH", "") or "")
    if not path:
        return None
    try:
        dec = wan_vae.params_from_torch_state(load_all(path), include_decoder=True,
                                              device=device)
        if not any(k.startswith("decoder.") for k in dec):
            print("INFO: VAE file has no decoder tensors; previews render "
                  "latent-RGB")
            return None
        cfg = wan_vae.detect_config(dec)
        dec = {k: v for k, v in dec.items() if k.startswith(("decoder.", "conv2."))}
        return dec, cfg
    except Exception as e:  # noqa: BLE001 - a preview is a diagnostic
        print(f"INFO: preview decoder unavailable ({type(e).__name__}: {e}); "
              "rendering latent-RGB")
        return None


class AnimaPreviewRenderer:
    """Owns the sampler, the decoder weights (if any) and the conditioning
    taken from the first training batch, so that successive previews show
    the same subject as training goes on."""

    def __init__(self, config, dit_cfg, *, attn_impl: str, compute_dtype,
                 decoder=None):
        self.every = int(getattr(config, "ANIMA_PREVIEW_EVERY_N_STEPS", 0) or 0)
        steps = int(getattr(config, "ANIMA_PREVIEW_SAMPLE_STEPS", 16) or 16)
        self.enabled = self.every > 0
        if not self.enabled:
            return
        self.seed = int(config.SEED)
        self._sample = make_anima_preview_sampler(
            dit_cfg, steps, attn_impl=attn_impl, compute_dtype=compute_dtype)
        self._decode = self._decode_video = None
        if decoder is not None:
            from ..models.anima import wan_vae
            dec_params, vae_cfg = decoder

            def decode(lat_bhwc):
                px = wan_vae.decode_image(dec_params, lat_bhwc, cfg=vae_cfg)
                return torch.clamp(px * 0.5 + 0.5, 0.0, 1.0)

            self._decode = decode
            # a file with the temporal upsamples' kernels decodes a clip
            # whole: the preview is a filmstrip
            if any(".time_conv." in k for k in dec_params):
                def decode_clip(lat_bthwc):
                    px = wan_vae.decode_video(dec_params, lat_bthwc, cfg=vae_cfg)
                    return torch.clamp(px * 0.5 + 0.5, 0.0, 1.0)

                self._decode_video = decode_clip
        self._cond = None

    def capture_conditioning(self, latents, prompt_emb, t5_ids) -> None:
        if not self.enabled or self._cond is not None:
            return
        shape = tuple(latents.shape[1:])
        if len(shape) == 3:  # image mode (H, W, C) -> (T=1, H, W, C)
            shape = (1,) + shape
        self._cond = (shape, prompt_emb[:1].clone(), t5_ids[:1].clone())

    def due(self, optimizer_step: int) -> bool:
        """Whether ``maybe_render`` renders after ``optimizer_step``."""
        return (self.enabled and self._cond is not None
                and optimizer_step % self.every == 0)

    def maybe_render(self, optimizer_step: int, params, output_dir) -> None:
        if not self.due(optimizer_step):
            return
        try:
            shape, prompt_emb, t5_ids = self._cond
            noise = preview_noise(self.seed, optimizer_step, (1,) + shape,
                                  prompt_emb.device)
            out = Path(output_dir) / "previews"
            out.mkdir(parents=True, exist_ok=True)
            with torch.no_grad():
                lat = self._sample(params, noise, prompt_emb, t5_ids)
                if self._decode_video is not None and lat.shape[1] > 1:
                    px = self._decode_video(lat).cpu().numpy()   # (B, T, H, W, 3)
                    # filmstrip: up to 5 evenly spaced frames side by side
                    t = px.shape[1]
                    picks = sorted({0, t // 4, t // 2, 3 * t // 4, t - 1})
                    strip = np.concatenate([px[0, i] for i in picks], axis=1)
                    path = out / f"step_{optimizer_step}.png"
                    save_preview_png(path, strip[None])
                elif self._decode is not None:
                    path = out / f"step_{optimizer_step}.png"
                    save_preview_png(path, self._decode(lat[:, 0]))   # first frame
                else:
                    path = out / f"step_{optimizer_step}_latent.png"
                    save_preview_png(path, latents_to_rgb(lat)[None])
            print(f"INFO: preview image saved -> {path}")
        except Exception as e:  # noqa: BLE001 - as in the JAX package, a
            # preview never kills the training run
            self.enabled = False
            print(f"WARNING: preview sampling disabled after failure: "
                  f"{type(e).__name__}: {e}")
