"""Dynamic mixed-precision quantization profiles.

Library re-design of the reference converter's dynamic modes
(reference scripts/convert_anima_to_quants.py:1073-3413): instead of
quantizing every eligible layer at one format, run *teacher vs simulated-
quantized* forwards and assign per-layer formats so that layers whose
quantization hurts the output most are promoted to higher precision.

Three strategies, mirroring the reference's:
* ``fast_dynamic``  — local (per-layer) simulated-quant error on the layer's
  own output activations; cheap, no full forwards;
* ``dynamic``       — global: full teacher forward vs forward with one layer
  quantized at a time; per-layer output MSE ranks sensitivity;
* ``compression_first`` — start from the most compressed format everywhere
  and promote the worst offenders until an error budget is met.

The caller supplies ``forward_fn(params) -> output`` (any model
forward on calibration inputs) and the torch-layout ``state``; results are a
``{key: format}`` assignment consumable by ``convert_state_dict`` via
per-key include patterns, or directly by :func:`apply_profile`.
"""

from __future__ import annotations

import numpy as np

from ..ckpt.safetensors_io import is_requantizable_dtype

from . import quantize as q

# promotion ladder, most->least compressed
LADDER = ("ternary_1_58", "nvfp4", "int8_tensorwise", "float8_e4m3fn", "keep")


def simulated_quant_weight(weight: np.ndarray, format_name: str) -> np.ndarray:
    """Quantize+dequantize one weight (the simulated-quant forward path)."""
    if format_name == "keep":
        return np.asarray(weight, np.float32)
    records = dict(q.quant_records_for_weight("w.weight", weight, format_name))
    return q.dequantize_records("w.weight", records,
                                out_shape=np.asarray(weight).shape)


def layer_local_error(weight: np.ndarray, format_name: str,
                      calib: np.ndarray | None = None) -> float:
    """Relative output error of one linear layer under quantization.

    With calibration activations (N, in): error of ``calib @ W^T``; without,
    the weight-space relative error (fast_dynamic's local proxy).
    """
    w = np.asarray(weight, np.float32)
    wq = simulated_quant_weight(w, format_name)
    if calib is not None and w.ndim == 2:
        ref = calib @ w.T
        got = calib @ wq.T
        return float(np.linalg.norm(got - ref)
                     / max(np.linalg.norm(ref), 1e-12))
    return float(np.linalg.norm(wq - w) / max(np.linalg.norm(w), 1e-12))


def fast_dynamic_profile(state: dict, format_name: str = "nvfp4",
                         preset: str = "broad",
                         promote_threshold: float = 0.05,
                         promote_format: str = "float8_e4m3fn",
                         calib: dict | None = None) -> dict[str, str]:
    """Per-layer local errors; layers above threshold promote to
    ``promote_format`` (reference fast_dynamic, :1686)."""
    assignment: dict[str, str] = {}
    for key, tensor in state.items():
        tensor = np.asarray(tensor)
        if not q.should_quantize(key, tensor, preset):
            continue
        if not q.format_compatible(format_name, key, tensor):
            assignment[key] = promote_format if q.format_compatible(
                promote_format, key, tensor) else "keep"
            continue
        err = layer_local_error(tensor, format_name,
                                None if calib is None else calib.get(key))
        assignment[key] = (promote_format if err > promote_threshold
                           else format_name)
    return assignment


def global_dynamic_profile(state: dict, forward_fn, *,
                           format_name: str = "nvfp4", preset: str = "broad",
                           promote_threshold: float = 0.02,
                           promote_format: str = "float8_e4m3fn",
                           max_layers: int | None = None) -> dict[str, str]:
    """Teacher vs one-layer-quantized full forwards (reference dynamic mode,
    :1073-1110): each candidate layer's end-to-end output MSE decides its
    format."""
    teacher = np.asarray(forward_fn(state), np.float32)
    t_norm = max(float(np.linalg.norm(teacher)), 1e-12)
    candidates = [k for k, t in state.items()
                  if q.should_quantize(k, np.asarray(t), preset)
                  and q.format_compatible(format_name, k, np.asarray(t))]
    if max_layers:
        candidates = candidates[:max_layers]
    assignment: dict[str, str] = {}
    for key in candidates:
        trial = dict(state)
        trial[key] = simulated_quant_weight(np.asarray(state[key]), format_name)
        out = np.asarray(forward_fn(trial), np.float32)
        rel = float(np.linalg.norm(out - teacher) / t_norm)
        assignment[key] = promote_format if rel > promote_threshold else format_name
    return assignment


def compression_first_profile(state: dict, forward_fn, *,
                              preset: str = "broad",
                              error_budget: float = 0.05,
                              max_rounds: int = 32) -> dict[str, str]:
    """Start everything at the most compressed compatible format; promote the
    single worst offender up the ladder until the full simulated-quant
    forward fits the error budget (reference compression-first, :2814)."""
    teacher = np.asarray(forward_fn(state), np.float32)
    t_norm = max(float(np.linalg.norm(teacher)), 1e-12)

    def most_compressed(key, tensor):
        for fmt in LADDER[:-1]:
            if q.format_compatible(fmt, key, tensor):
                return fmt
        return "keep"

    assignment = {
        k: most_compressed(k, np.asarray(t)) for k, t in state.items()
        if q.should_quantize(k, np.asarray(t), preset)
    }

    def simulate():
        trial = dict(state)
        for k, fmt in assignment.items():
            trial[k] = simulated_quant_weight(np.asarray(state[k]), fmt)
        out = np.asarray(forward_fn(trial), np.float32)
        return float(np.linalg.norm(out - teacher) / t_norm)

    for _ in range(max_rounds):
        if simulate() <= error_budget:
            break
        # promote the layer with the worst local error one ladder rung
        worst_key, worst_err = None, -1.0
        for k, fmt in assignment.items():
            if fmt == "keep":
                continue
            err = layer_local_error(np.asarray(state[k]), fmt)
            if err > worst_err:
                worst_key, worst_err = k, err
        if worst_key is None:
            break
        idx = LADDER.index(assignment[worst_key])
        nxt = next((f for f in LADDER[idx + 1:]
                    if f == "keep" or q.format_compatible(
                        f, worst_key, np.asarray(state[worst_key]))), "keep")
        assignment[worst_key] = nxt
    return assignment


def apply_profile(state: dict, assignment: dict[str, str],
                  keep_dtype=None) -> tuple[dict, dict]:
    """Quantize per the profile; returns (tensors, report)."""
    out: dict = {}
    report = {"quantized": 0, "kept": 0, "formats": {}}
    for key, tensor in state.items():
        tensor = np.asarray(tensor)
        fmt = assignment.get(key, "keep")
        if fmt != "keep" and q.format_compatible(fmt, key, tensor):
            for name, arr in q.quant_records_for_weight(key, tensor, fmt):
                out[name] = arr
            report["quantized"] += 1
            report["formats"][fmt] = report["formats"].get(fmt, 0) + 1
        else:
            if keep_dtype is not None and is_requantizable_dtype(tensor.dtype):
                tensor = tensor.astype(keep_dtype)
            out[key] = tensor
            report["kept"] += 1
    return out, report
