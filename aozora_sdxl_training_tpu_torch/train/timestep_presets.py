"""Timestep-distribution authoring: Wave / Logit-Normal / Beta / Odds-Scaled.

Copy of ``aozora_sdxl_training_tpu/train/timestep_presets.py``, kept in the port so that the
port imports nothing of the JAX package.

The reference authors ``TIMESTEP_ALLOCATION`` histograms in its GUI
(the reference's gui/gui.py:5518-5616 ``_apply_timestep_preset`` /
``_update_timestep_distribution``; gui/gui_math.py:30-46 odds-scaled math).
This module provides the same distribution math headless, so CLI users can
generate allocation blocks without the GUI, plus the GUI's planning helpers
(optimizer-steps/epochs calculation, epoch markers).
"""

from __future__ import annotations

import math

TOTAL_TIMESTEPS = 1000

# Named presets -> (mode, params); gui.py:5521-5551
PRESETS: dict[str, tuple[str, dict]] = {
    "Uniform": ("Wave", dict(wave_amp=0.0, wave_freq=1.0, wave_phase=0.0)),
    "Peak Ends": ("Wave", dict(wave_freq=1.0, wave_phase=0.0, wave_amp=0.8)),
    "Peak Middle": ("Wave", dict(wave_freq=1.0, wave_phase=3.14, wave_amp=0.6)),
    "Bell Curve": ("Logit-Normal", dict(ln_mu=0.0, ln_sigma=1.0)),
    "Detail": ("Logit-Normal", dict(ln_mu=-1.0, ln_sigma=0.8)),
    "Structure": ("Logit-Normal", dict(ln_mu=1.0, ln_sigma=0.8)),
    "Logit-Normal (RF/SD3 Recommended)": ("Logit-Normal",
                                          dict(ln_mu=-0.5, ln_sigma=1.0)),
    "Anima Logit Default": ("Logit-Normal", dict(ln_mu=0.0, ln_sigma=1.0)),
    "Anima Logit Style LoRA": ("Logit-Normal", dict(ln_mu=0.0, ln_sigma=1.3)),
    "Beta Symmetric": ("Beta", dict(beta_alpha=3.0, beta_beta=3.0)),
    "Beta Right Skew": ("Beta", dict(beta_alpha=2.0, beta_beta=5.0)),
    "Beta Left Skew": ("Beta", dict(beta_alpha=5.0, beta_beta=2.0)),
    "Beta U-Shape": ("Beta", dict(beta_alpha=0.5, beta_beta=0.5)),
}


def wave_weights(bin_size: int, *, wave_freq=1.0, wave_phase=0.0,
                 wave_amp=0.0, total=TOTAL_TIMESTEPS) -> list[float]:
    n = max(math.ceil(total / max(1, int(bin_size))), 1)
    return [max(0.0, 1.0 + wave_amp * math.cos(
        2 * math.pi * wave_freq * (i / max(1, n - 1)) + wave_phase))
            for i in range(n)]


def logit_normal_weights(bin_size: int, *, ln_mu=0.0, ln_sigma=1.0,
                         total=TOTAL_TIMESTEPS) -> list[float]:
    bin_size = max(1, int(bin_size))
    n = max(math.ceil(total / bin_size), 1)

    def logit(p):
        return math.log(p / (1 - p))

    def ncdf(x):
        return 0.5 * (1 + math.erf(x / math.sqrt(2)))

    eps = 1e-6
    weights = []
    for i in range(n):
        t_s, t_e = i * bin_size, min((i + 1) * bin_size, total)
        w = (ncdf((logit(min(t_e / total, 1 - eps)) - ln_mu) / ln_sigma)
             - ncdf((logit(max(t_s / total, eps)) - ln_mu) / ln_sigma))
        weights.append(max(0.0, w))
    return weights


def beta_weights(bin_size: int, *, beta_alpha=3.0, beta_beta=3.0,
                 total=TOTAL_TIMESTEPS) -> list[float]:
    bin_size = max(1, int(bin_size))
    n = max(math.ceil(total / bin_size), 1)
    weights = []
    for i in range(n):
        x = max(1e-4, min(1 - 1e-4, ((i * bin_size) + bin_size / 2) / total))
        weights.append(max(0.0, x ** (beta_alpha - 1) * (1 - x) ** (beta_beta - 1)))
    return weights


def odds_scaled_weights(bin_size: int, scale: float,
                        total=TOTAL_TIMESTEPS) -> list[float]:
    """Z-Image-style directional log-odds scaling (gui_math.py:30-46)."""
    bin_size = max(1, int(bin_size))
    total = max(1, int(total))
    signed = float(scale)
    magnitude = max(1.0, abs(signed))
    scale = magnitude if signed >= 0.0 else 1.0 / magnitude

    def inverse_odds(y):
        return y / (scale - (scale - 1.0) * y)

    weights = []
    for start in range(0, total, bin_size):
        y0 = start / total
        y1 = min(start + bin_size, total) / total
        weights.append(max(0.0, inverse_odds(y1) - inverse_odds(y0)))
    return weights


def distribution_weights(mode: str, bin_size: int, *, odds_scale=3.0,
                         total=TOTAL_TIMESTEPS, **params) -> list[float]:
    mode = str(mode)
    if mode == "Wave":
        return wave_weights(bin_size, total=total, **params)
    if mode == "Logit-Normal":
        return logit_normal_weights(bin_size, total=total, **params)
    if mode == "Beta":
        return beta_weights(bin_size, total=total, **params)
    if mode in ("Odds-Scaled (Z-Image)", "Shift"):
        return odds_scaled_weights(bin_size, odds_scale, total=total)
    raise ValueError(f"Unknown timestep mode: {mode}")


def allocation_from_preset(name: str, bin_size: int = 100,
                           resolution: int = 10_000) -> dict:
    """Named preset -> a TIMESTEP_ALLOCATION block for the config JSON."""
    if name not in PRESETS:
        raise ValueError(f"Unknown preset '{name}'. "
                         f"Choices: {sorted(PRESETS)}")
    mode, params = PRESETS[name]
    weights = distribution_weights(mode, bin_size, **params)
    total = sum(weights) or 1.0
    counts = [int(round(w / total * resolution)) for w in weights]
    return {"bin_size": int(bin_size), "counts": counts}


# -- GUI planning helpers (gui_math.py:4-28) --------------------------------

def repeated_image_count(datasets) -> int:
    return sum(int(d.get("image_count", 0)) * int(d.get("repeats", 1))
               for d in datasets)


def training_calculations(max_steps, gradient_accumulation_steps, batch_size,
                          total_images):
    """(optimizer_steps, steps_per_epoch, epochs) with micro-step semantics."""
    max_steps = int(max_steps)
    ga = int(gradient_accumulation_steps)
    batch_size = int(batch_size)
    total_images = int(total_images)
    optimizer_steps = max_steps // ga if ga > 0 else 0
    steps_per_epoch = (math.ceil(total_images / batch_size)
                       if total_images > 0 and batch_size > 0 else 0)
    epochs = max_steps / steps_per_epoch if steps_per_epoch else math.inf
    return optimizer_steps, steps_per_epoch, epochs


def epoch_marker_interval(max_steps, batch_size, total_images):
    _, steps_per_epoch, _ = training_calculations(max_steps, 1, batch_size,
                                                  total_images)
    markers = ((int(max_steps) - 1) // steps_per_epoch
               if max_steps > 0 and steps_per_epoch else 0)
    return steps_per_epoch, markers
