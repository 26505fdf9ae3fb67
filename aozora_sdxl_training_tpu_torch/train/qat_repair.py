"""Quantization-aware "repair" training: projected updates on packed weights.

Re-design of the reference's experimental repair trainer
(reference scripts/experimental/train_anima_repair.py:1497-1676):
a checkpoint that was already quantized for ComfyUI (comfy_quant records)
is fine-tuned while *staying* quantized — after every optimizer step each
controlled weight is re-projected into its quantized representation, with
an error-feedback residual carrying the rounding error into the next step
(the reference keeps FP16 residuals on CPU; here they are fp32 numpy host
buffers updated at optimizer-step cadence).

The controller is trainer-agnostic: the repair CLI trains with the
device projector (``train.qat_project``), packs (final + residual) on the
host through :meth:`project` and saves with :meth:`save_quantized`, which
writes the exact packed codes+scales back out (so the exported file is
bit-identical in format to the input quantization).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..tools import quantize as q


class ProjectedQuantController:
    """Tracks quantized weights, dequantizes for training, re-projects after
    updates with error feedback."""

    def __init__(self, quantized_state: dict):
        self.formats: dict[str, str] = {}
        self.shapes: dict[str, tuple[int, int]] = {}
        self.residuals: dict[str, np.ndarray] = {}
        self.nvfp4_multipliers: dict[str, float] = {}
        self.passthrough: dict[str, np.ndarray] = {}

        for key, value in quantized_state.items():
            if key.endswith(".comfy_quant"):
                base = key[: -len(".comfy_quant")] + ".weight"
                info = json.loads(bytes(np.asarray(value, np.uint8)))
                self.formats[base] = info["format"]
                if "original_shape" in info:
                    self.shapes[base] = tuple(info["original_shape"])
        for key, value in quantized_state.items():
            if (key.endswith((".comfy_quant", ".weight_scale",
                              ".weight_scale_2"))):
                continue
            if key in self.formats:
                continue
            self.passthrough[key] = np.asarray(value)
        self._state = dict(quantized_state)

    # -- dequantize for training -------------------------------------------
    def dequantized_params(self) -> dict[str, np.ndarray]:
        """Full torch-layout fp32 state dict (quantized weights expanded)."""
        params = dict(self.passthrough)
        for key, fmt in self.formats.items():
            out_shape = self.shapes.get(key)
            w = q.dequantize_records(key, self._state, out_shape=out_shape)
            params[key] = np.asarray(w, np.float32)
            self.shapes.setdefault(key, tuple(w.shape))
            self.residuals[key] = np.zeros_like(w, np.float32)
        return params

    # -- projection ---------------------------------------------------------
    def project(self, params: dict) -> dict:
        """Project updated weights back into their quantized representation.

        Error feedback: effective = updated + residual; quantize; the new
        residual is (effective - dequant(quantized)).  Returns the projected
        (dequantized) weights to continue training with.
        """
        out = dict(params)
        for key, fmt in self.formats.items():
            if key not in params:
                continue
            w = np.asarray(params[key], np.float32)
            eff = w + self.residuals.get(key, 0.0)
            records = dict(q.quant_records_for_weight(
                key, eff, fmt, self.nvfp4_multipliers.get(key, 1.0)))
            self._state.update(records)
            projected = np.asarray(
                q.dequantize_records(key, self._state,
                                     out_shape=self.shapes.get(key)),
                np.float32)
            self.residuals[key] = eff - projected
            out[key] = projected
        return out

    # -- save ---------------------------------------------------------------
    def save_quantized(self, output_path, extra_state: dict | None = None,
                       metadata: dict | None = None) -> None:
        """Write the exact packed representation (codes + scales + info)."""
        from ..ckpt.safetensors_io import write_streaming
        tensors = dict(self._state)
        if extra_state:
            tensors.update({k: np.asarray(v) for k, v in extra_state.items()})
        write_streaming(Path(output_path), tensors, metadata=metadata)

    @property
    def controlled_keys(self) -> list[str]:
        return sorted(self.formats)


def load_quantized_checkpoint(path) -> ProjectedQuantController:
    from ..ckpt.safetensors_io import load_all
    return ProjectedQuantController(load_all(path))
