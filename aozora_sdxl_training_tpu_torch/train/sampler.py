"""In-training preview sampling for SDXL.

Counterpart of ``aozora_sdxl_training_tpu/train/sampler.py``: a
deterministic DDIM sampler for the eps / v-prediction objectives and an
Euler integrator for rectified flow, then the VAE decoder
(``models/sdxl/vae.decoder_forward``), so that periodic preview PNGs show
drift or divergence mid-run. A plain Python loop over the steps takes the
place of ``lax.scan``.

Timestep schedule: ``steps`` evenly spaced DDPM timesteps from 999 down to
0. DDIM eta=0:

    x0_hat  = (x_t - s_t * eps) / a_t            (eps objective)
    x0_hat  = a_t * x_t - s_t * v                (v objective)
    eps_hat = a_t * v + s_t * x_t                (v objective)
    x_prev  = a_prev * x0_hat + s_prev * eps_hat

with a_t = sqrt(alphas_cumprod[t]), s_t = sqrt(1 - alphas_cumprod[t]).
Rectified flow integrates dx/dt = v_pred from t=1 to 0 in equal steps (the
model predicts ``noise - x0``; conditioning is t*1000, as in training).

On the card the sampler's UNet forwards take the flash kernels at head_dim
64 (K1) and the fp32 decoder's mid-attention the head_dim-512 kernel (K4a),
whenever the trainer's ``attn_impl`` is ``"flash"``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.latent_norm import denormalize_scalar
from ..models.sdxl import vae as vae_mod
from ..models.sdxl.arch import UNetConfig
from ..models.sdxl.unet import unet_forward
from . import objectives


def ddim_schedule(steps: int) -> np.ndarray:
    """``steps`` timesteps from 999 to 0 inclusive (int32)."""
    return np.linspace(999.0, 0.0, max(int(steps), 2)).round().astype(np.int32)


def make_preview_sampler(cfg: UNetConfig, prediction_type: str, steps: int, *,
                         attn_impl: str = "xla", compute_dtype=torch.bfloat16):
    """Returns ``sample(params, noise, embeds, pooled, time_ids) -> x0
    latents`` (fp32, the normalization space the UNet was trained in)."""

    def predict(params, x, t, embeds, pooled, time_ids):
        timesteps = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                               device=x.device)
        return unet_forward(params, x.to(compute_dtype), timesteps, embeds,
                            pooled, time_ids, cfg=cfg, attn_impl=attn_impl,
                            compute_dtype=compute_dtype).float()

    if prediction_type == "rectified_flow":
        ts = np.linspace(1.0, 0.0, max(int(steps), 1) + 1).astype(np.float32)

        def sample(params, noise, embeds, pooled, time_ids):
            x = noise.float()
            for i in range(len(ts) - 1):
                pred = predict(params, x, float(ts[i]) * 1000.0, embeds, pooled,
                               time_ids)
                x = x - float(ts[i] - ts[i + 1]) * pred
            return x

        return sample

    acp = objectives.ddpm_alphas_cumprod()
    a_tab = np.sqrt(acp).astype(np.float32)
    s_tab = np.sqrt(1.0 - acp).astype(np.float32)
    tsched = ddim_schedule(steps)
    # a/s at the *previous* (next-to-integrate) timestep; final step -> x0
    a_prev = np.concatenate([a_tab[tsched[1:]], [1.0]]).astype(np.float32)
    s_prev = np.concatenate([s_tab[tsched[1:]], [0.0]]).astype(np.float32)

    def sample(params, noise, embeds, pooled, time_ids):
        x = noise.float()
        for t, a_t, s_t, a_p, s_p in zip(tsched.tolist(), a_tab[tsched].tolist(),
                                          s_tab[tsched].tolist(), a_prev.tolist(),
                                          s_prev.tolist()):
            pred = predict(params, x, t, embeds, pooled, time_ids)
            if prediction_type == "v_prediction":
                x0 = a_t * x - s_t * pred
                eps = a_t * pred + s_t * x
            else:  # epsilon
                eps = pred
                x0 = (x - s_t * eps) / max(a_t, 1e-4)
            x = a_p * x0 + s_p * eps
        return x

    return sample


def latents_to_pixels(decoder_params, latents, *, shift: float, scale: float,
                      compute_dtype=torch.float32, attn_impl: str = "xla"):
    """Normalized-latent space -> pixels in [0, 1], NHWC."""
    raw = denormalize_scalar(latents.float(), shift, scale)
    px = vae_mod.decoder_forward(decoder_params, raw, compute_dtype=compute_dtype,
                                 attn_impl=attn_impl)
    return torch.clamp(px.float() * 0.5 + 0.5, 0.0, 1.0)


def save_preview_png(path, pixels01) -> None:
    from PIL import Image
    arr = (pixels01.detach().float().cpu().numpy()
           if isinstance(pixels01, torch.Tensor) else np.asarray(pixels01))
    if arr.ndim == 4:
        arr = arr[0]
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def preview_noise(seed: int, optimizer_step: int, shape, device) -> torch.Tensor:
    """The preview's starting noise: a generator on ``device`` seeded from the
    run's seed and the optimizer step, so every preview of a run is
    reproducible and each step's differs."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 1_000_000 + int(optimizer_step)) % (2 ** 63))
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32, device=device)


class PreviewRenderer:
    """Owns the sampler, the decoder weights and the (fixed) conditioning
    taken from the first training batch, so successive previews show the
    same subject as training progresses."""

    def __init__(self, config, unet_cfg: UNetConfig, *, attn_impl: str,
                 compute_dtype, decoder_params):
        self.every = int(getattr(config, "PREVIEW_EVERY_N_STEPS", 0) or 0)
        steps = int(getattr(config, "PREVIEW_SAMPLE_STEPS", 20) or 20)
        norm_mode = str(getattr(config, "VAE_NORMALIZATION_MODE", "scalar")).lower()
        if self.every > 0 and norm_mode != "scalar":
            # flux_bn32 latents are 32-channel (Flux-family VAE): the SD
            # decoder cannot render them; say so rather than decode noise
            print(f"WARNING: preview sampling disabled: latent normalization "
                  f"mode '{norm_mode}' has no matching decoder path")
            decoder_params = None
        self.enabled = self.every > 0 and decoder_params is not None
        if not self.enabled:
            return
        self.shift = float(getattr(config, "VAE_SHIFT_FACTOR", None) or 0.0)
        self.scale = float(getattr(config, "VAE_SCALING_FACTOR", None) or 0.13025)
        self.seed = int(config.SEED)
        self.attn_impl = attn_impl
        self._decoder = decoder_params
        self._sample = make_preview_sampler(unet_cfg, config.PREDICTION_TYPE, steps,
                                            attn_impl=attn_impl,
                                            compute_dtype=compute_dtype)
        self._cond = None

    def capture_conditioning(self, latents, embeds, pooled, time_ids) -> None:
        """Remember the first sample's conditioning and latent shape."""
        if not self.enabled or self._cond is not None:
            return
        self._cond = (tuple(latents.shape[1:]), embeds[:1].clone(),
                      pooled[:1].clone(), time_ids[:1].clone())

    def due(self, optimizer_step: int) -> bool:
        """Whether ``maybe_render`` renders after ``optimizer_step``."""
        return (self.enabled and self._cond is not None
                and optimizer_step % self.every == 0)

    def maybe_render(self, optimizer_step: int, trainable, frozen, output_dir) -> None:
        if not self.due(optimizer_step):
            return
        try:
            shape, embeds, pooled, time_ids = self._cond
            noise = preview_noise(self.seed, optimizer_step, (1,) + shape,
                                  embeds.device)
            with torch.no_grad():
                lat = self._sample({**frozen, **trainable}, noise, embeds,
                                   pooled, time_ids)
                px = latents_to_pixels(self._decoder, lat, shift=self.shift,
                                       scale=self.scale, attn_impl=self.attn_impl)
            out = Path(output_dir) / "previews"
            out.mkdir(parents=True, exist_ok=True)
            path = out / f"step_{optimizer_step}.png"
            save_preview_png(path, px)
            print(f"INFO: preview image saved -> {path}")
        except Exception as e:  # noqa: BLE001 - as in the JAX package, a
            # preview never kills the training run
            self.enabled = False
            print(f"WARNING: preview sampling disabled after failure: "
                  f"{type(e).__name__}: {e}")
