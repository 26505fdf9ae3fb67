"""Anima checkpoint IO: prefix handling, component loading, streaming save.

Counterpart of ``aozora_sdxl_training_tpu/ckpt/anima_checkpoint.py``:

* the >=80% prefix-stripping rule over (``pipe.dit.``,
  ``model.diffusion_model.``, ``diffusion_model.``, ``dit.``, ``net.``);
* the Qwen3 text encoder's prefixes stripped and ``lm_head`` dropped; the
  Wan VAE's keys remapped under ``model.*``;
* save-prefix auto-detection from the source checkpoint;
* a streaming save through the port's safetensors writer, one tensor on the
  host at a time, cast to the compute dtype.
"""

from __future__ import annotations

from pathlib import Path

from .safetensors_io import load_all, write_streaming
from .sd_checkpoint import numpy_dtype_for_torch, tensor_to_numpy

DIT_PREFIXES = ("pipe.dit.", "model.diffusion_model.", "diffusion_model.",
                "dit.", "net.")
TEXT_PREFIXES = ("text_encoder.", "model.text_encoder.")
VAE_PREFIXES = ("pipe.vae.", "vae.")


def strip_prefix(state: dict, prefixes) -> tuple[dict, str]:
    """Strip the first prefix covering >=80% of keys; returns (state, prefix)."""
    keys = tuple(state)
    for prefix in prefixes:
        if keys and sum(k.startswith(prefix) for k in keys) / len(keys) >= 0.8:
            return ({k[len(prefix):]: v for k, v in state.items()}, prefix)
    return state, ""


def load_dit_state(path) -> tuple[dict, str]:
    """Load (numpy, bf16 via ml_dtypes) + prefix-strip a DiT checkpoint;
    returns (state, detected_prefix)."""
    return strip_prefix(load_all(path), DIT_PREFIXES)


def load_text_encoder_state(path) -> dict:
    """The Qwen3 tensors (numpy) under HF names, ``lm_head`` dropped."""
    state, _ = strip_prefix(load_all(path), TEXT_PREFIXES)
    state.pop("lm_head.weight", None)
    return state


def load_vae_state(path) -> dict:
    """The Wan VAE tensors (numpy) remapped under ``model.*``."""
    out = {}
    for key, value in load_all(path).items():
        for prefix in VAE_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if not key.startswith("model."):
            key = f"model.{key}"
        out[key] = value
    return out


def resolve_save_prefix(config, detected_prefix: str) -> str:
    requested = str(getattr(config, "ANIMA_DIT_SAVE_PREFIX", "auto") or "auto")
    if requested.lower() == "auto":
        return detected_prefix
    if requested and not requested.endswith("."):
        requested += "."
    return requested


def save_dit_model(output_path, torch_state: dict, *, prefix: str = "",
                   dtype=None) -> None:
    """Write the DiT state (float tensors on any device) under ``prefix``,
    cast to ``dtype`` (a torch float dtype; by default each tensor's own),
    one tensor on the host at a time."""
    tensors = {}
    counts: dict = {}
    for name, t in torch_state.items():
        dt = numpy_dtype_for_torch(t.dtype if dtype is None else dtype)
        tensors[f"{prefix}{name}"] = (tuple(t.shape), dt,
                                      lambda t=t, dt=dt: tensor_to_numpy(t, dt))
        counts[str(dt)] = counts.get(str(dt), 0) + 1
    write_streaming(Path(output_path), tensors)
    summary = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
    print(f"INFO: Saved DiT ({len(tensors)} tensors; {summary}) -> "
          f"{Path(output_path).name}")
