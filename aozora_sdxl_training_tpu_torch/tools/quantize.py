"""Quantized checkpoint export formats (ComfyUI ``comfy_quant`` convention).

Numpy re-implementation of the reference converter's core math
(reference scripts/convert_anima_to_quants.py):

* scaled FP8 (e4m3fn / e5m2): per-tensor absmax scale (:658-663);
* INT8 tensorwise: per-output-row absmax/127 scales (:643-657);
* NVFP4: block-16 two-level scales — fp8-e4m3 per-block scales in the
  128x4 "to_blocked" swizzle layout plus an fp32 per-tensor scale, weights
  packed as e2m1 nibbles with round-half-to-even (:396-545);
* ternary 1.58-bit: per-output-row absmean scale, four 2-bit codes per byte
  (:547-563);
* ``.comfy_quant`` JSON info tensors and ``.weight_scale`` /
  ``.weight_scale_2`` key conventions (:352-363, 598-640);
* layer-selection presets (target / broad / all) with protected-name hints
  (:102-119, 238-268).

Each format has an exact dequantizer, used by the QAT repair trainer, the
diff checker, and round-trip tests.  fp8 storage uses ml_dtypes.
"""

from __future__ import annotations

import json
import math
import re

import ml_dtypes
import numpy as np

from ..ckpt.safetensors_io import is_requantizable_dtype

F8_E4M3 = np.dtype(ml_dtypes.float8_e4m3fn)
F8_E5M2 = np.dtype(ml_dtypes.float8_e5m2)

NVFP4_BLOCK_SIZE = 16
NVFP4_F4_E2M1_MAX = 6.0
NVFP4_F8_E4M3_MAX = 448.0
E2M1_VALUES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], np.float32)

FORMAT_CHOICES = {
    "e4m3": "float8_e4m3fn",
    "e5m2": "float8_e5m2",
    "int8": "int8_tensorwise",
    "nvfp4": "nvfp4",
    "ternary": "ternary_1_58",
}

TARGET_HINTS = (
    "q_proj.weight", "k_proj.weight", "v_proj.weight", "o_proj.weight",
    "output_proj.weight", "to_q.weight", "to_k.weight", "to_v.weight",
    "to_out", "mlp.0.weight", "mlp.2.weight", "mlp.layer1.weight",
    "mlp.layer2.weight", "linear", "proj", "ffn",
)
PROTECTED_HINTS = (
    ".bias", "bias", "norm", "ln", "embed", "embedding", "patch_embed",
    "pos_embed", "t_embedder", "time_embed", "final_layer", "adaln",
)
FULL_QUANT_BLOCKED = (
    "norm", "embed", "embedding", "patch_embed", "pos_embed", "t_embedder",
    "time_embed", "final_layer", ".bias",
)


def is_protected_name(key: str) -> bool:
    k = key.lower()
    return any(h in k for h in PROTECTED_HINTS)


def is_target_name(key: str) -> bool:
    k = key.lower()
    return any(h in k for h in TARGET_HINTS)


def is_full_quant_compatible_name(key: str) -> bool:
    k = key.lower()
    return not any(h in k for h in FULL_QUANT_BLOCKED)


def should_quantize(key: str, tensor: np.ndarray, preset: str = "target",
                    min_elements: int = 4096) -> bool:
    """Layer-selection policy (choose_save_dtype semantics, :238-268)."""
    if not is_requantizable_dtype(tensor.dtype) or not key.endswith(".weight"):
        return False
    if preset == "all":
        return tensor.ndim >= 2 and is_full_quant_compatible_name(key)
    if tensor.size < min_elements:
        return False
    if preset == "broad":
        return tensor.ndim >= 2 and not is_protected_name(key)
    return tensor.ndim >= 2 and is_target_name(key) and not is_protected_name(key)


# --------------------------------------------------------------------------
# Swizzle layout for NVFP4 block scales
# --------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def to_blocked(matrix: np.ndarray) -> np.ndarray:
    """128x4 block swizzle of the per-block scale matrix (:365-381)."""
    rows, cols = matrix.shape
    pr, pc = _ceil_div(rows, 128) * 128, _ceil_div(cols, 4) * 4
    padded = matrix
    if (rows, cols) != (pr, pc):
        padded = np.zeros((pr, pc), matrix.dtype)
        padded[:rows, :cols] = matrix
    blocks = padded.reshape(pr // 128, 128, pc // 4, 4).transpose(0, 2, 1, 3)
    step = blocks.reshape(-1, 4, 32, 4).transpose(0, 2, 1, 3).reshape(-1, 32, 16)
    return step.reshape(pr, pc)


def from_blocked(blocked: np.ndarray, num_rows: int, num_cols: int) -> np.ndarray:
    pr, pc = _ceil_div(num_rows, 128) * 128, _ceil_div(num_cols, 4) * 4
    step = blocked.reshape(-1, 32, 16).reshape(-1, 32, 4, 4).transpose(0, 2, 1, 3)
    step = step.reshape(pr // 128, pc // 4, 128, 4).transpose(0, 2, 1, 3)
    return step.reshape(pr, pc)[:num_rows, :num_cols].copy()


# --------------------------------------------------------------------------
# e2m1 conversion (round-half-to-even) and nibble packing
# --------------------------------------------------------------------------

_EBITS_F32, _MBITS_F32 = 8, 23
_F32_EXP_BIAS = 127


def f32_to_e2m1_codes(x: np.ndarray) -> np.ndarray:
    """float32 -> 4-bit e2m1 codes (sign + 2 exp + 1 mantissa), RNE."""
    ebits, mbits = 2, 1
    exp_bias = (1 << (ebits - 1)) - 1
    max_int = (1 << (ebits + mbits)) - 1
    sign_mask = 1 << (ebits + mbits)
    magic_adder = (1 << (_MBITS_F32 - mbits - 1)) - 1
    max_normal = 2.0 ** ((1 << ebits) - 1 - exp_bias) * (
        ((1 << (mbits + 1)) - 1) / (1 << mbits))
    min_normal = 2.0 ** (1 - exp_bias)
    denorm_exp = (_F32_EXP_BIAS - exp_bias) + (_MBITS_F32 - mbits) + 1
    denorm_mask_int = np.int32(denorm_exp << _MBITS_F32)
    denorm_mask_float = denorm_mask_int.view(np.float32)

    x = np.ascontiguousarray(x, np.float32)
    x_int = x.view(np.int32)
    sign = x_int & np.int32(-2147483648)
    x_abs = (x_int ^ sign).view(np.float32)

    saturate = x_abs >= max_normal
    denormal = (~saturate) & (x_abs < min_normal)
    normal = ~(saturate | denormal)

    denormal_x = ((x_abs + denorm_mask_float).view(np.int32)
                  - denorm_mask_int).astype(np.uint8)

    normal_i = x_abs.view(np.int32).astype(np.int64)
    mant_odd = (normal_i >> (_MBITS_F32 - mbits)) & 1
    val_to_add = ((exp_bias - _F32_EXP_BIAS) << _MBITS_F32) + magic_adder
    normal_i = normal_i + val_to_add + mant_odd
    normal_x = (normal_i >> (_MBITS_F32 - mbits)).astype(np.uint8)

    out = np.full(x_abs.shape, max_int, np.uint8)
    out = np.where(denormal, denormal_x, out)
    out = np.where(normal, normal_x, out)
    sign_lp = ((sign >> (_MBITS_F32 + _EBITS_F32 - mbits - ebits))
               .astype(np.int64) & sign_mask).astype(np.uint8)
    return out | sign_lp


def e2m1_to_f32(codes: np.ndarray) -> np.ndarray:
    return E2M1_VALUES[codes.astype(np.int64)]


def pack_uint4(nibbles: np.ndarray) -> np.ndarray:
    if nibbles.shape[-1] % 2:
        raise ValueError("pack_uint4 requires an even last dimension")
    flat = np.ascontiguousarray(nibbles).reshape(-1)
    packed = (flat[::2] << 4) | flat[1::2]
    return packed.reshape(*nibbles.shape[:-1], nibbles.shape[-1] // 2)


def unpack_uint4(packed: np.ndarray) -> np.ndarray:
    hi = (packed >> 4).astype(np.uint8)
    lo = (packed & 0x0F).astype(np.uint8)
    return np.stack([hi, lo], axis=-1).reshape(*packed.shape[:-1],
                                               packed.shape[-1] * 2)


# --------------------------------------------------------------------------
# Quantizers
# --------------------------------------------------------------------------

def quantize_scaled_fp8(tensor: np.ndarray, fp8_dtype=F8_E4M3):
    """Per-tensor absmax scaling into fp8; returns (codes, fp32 scale)."""
    data = np.asarray(tensor, np.float32)
    quant_max = float(ml_dtypes.finfo(fp8_dtype).max)
    max_value = float(np.abs(data).max()) if data.size else 0.0
    scale = max(max_value / quant_max, 1e-12)
    return (data / scale).astype(fp8_dtype), np.float32(scale)


def dequantize_scaled_fp8(codes: np.ndarray, scale) -> np.ndarray:
    return codes.astype(np.float32) * np.float32(scale)


def quantize_int8_tensorwise(tensor: np.ndarray):
    """Per-output-row absmax/127 (ndim>=2) or per-tensor (1-D)."""
    data = np.asarray(tensor, np.float32)
    if data.ndim >= 2:
        scale = np.maximum(np.abs(data).max(axis=1, keepdims=True) / 127.0,
                           1e-30).astype(np.float32)
    else:
        scale = np.float32(max(np.abs(data).max() / 127.0, 1e-30))
    q = np.clip(np.round(data / scale), -128, 127).astype(np.int8)
    return q, scale


def dequantize_int8_tensorwise(codes: np.ndarray, scale) -> np.ndarray:
    return codes.astype(np.float32) * np.asarray(scale, np.float32)


def quantize_nvfp4(weight: np.ndarray, scale_multiplier: float = 1.0):
    """(codes_u8 [O, I/2], block_scales_fp8 swizzled, per_tensor_scale_f32)."""
    if not math.isfinite(scale_multiplier) or scale_multiplier <= 0:
        raise ValueError(f"NVFP4 scale_multiplier must be positive finite, "
                         f"got {scale_multiplier!r}")
    w = np.asarray(weight, np.float32)
    if w.ndim != 2:
        raise ValueError("NVFP4 export requires a rank-2 weight tensor")
    out_f, in_f = w.shape
    if in_f % NVFP4_BLOCK_SIZE:
        raise ValueError(f"NVFP4 in_features {in_f} must be a multiple of "
                         f"{NVFP4_BLOCK_SIZE}")
    base = np.abs(w).max() / (NVFP4_F8_E4M3_MAX * NVFP4_F4_E2M1_MAX)
    per_tensor = np.float32(base * scale_multiplier)
    per_tensor_div = max(float(per_tensor), 2.0 ** -126)

    xb = w.reshape(out_f, in_f // NVFP4_BLOCK_SIZE, NVFP4_BLOCK_SIZE)
    block_amax = np.abs(xb).max(axis=-1)
    scaled_fp8 = np.minimum(block_amax / NVFP4_F4_E2M1_MAX / per_tensor_div,
                            NVFP4_F8_E4M3_MAX)
    fp8_rounded = scaled_fp8.astype(F8_E4M3).astype(np.float32)
    total = per_tensor_div * fp8_rounded
    total_safe = np.where(total == 0, 1.0, total)
    data_scaled = np.where((total == 0)[..., None], 0.0,
                           xb / total_safe[..., None])
    data_scaled = np.clip(data_scaled.reshape(out_f, in_f),
                          -NVFP4_F4_E2M1_MAX, NVFP4_F4_E2M1_MAX)
    codes = pack_uint4(f32_to_e2m1_codes(data_scaled))
    block_scale = to_blocked(scaled_fp8.astype(F8_E4M3))
    return codes, block_scale, per_tensor


def dequantize_nvfp4(codes: np.ndarray, block_scale: np.ndarray,
                     per_tensor_scale, out_f: int, in_f: int) -> np.ndarray:
    nibbles = unpack_uint4(codes)[:, :in_f]
    block_cols = in_f // NVFP4_BLOCK_SIZE
    bs = from_blocked(block_scale, out_f, block_cols).astype(np.float32)
    total = bs * np.float32(per_tensor_scale)
    values = e2m1_to_f32(nibbles).reshape(out_f, block_cols, NVFP4_BLOCK_SIZE)
    return (values * total[..., None]).reshape(out_f, in_f)


def quantize_ternary(weight: np.ndarray):
    """Per-output-row absmean ternary; four 2-bit codes per byte."""
    w = np.asarray(weight, np.float32)
    if w.ndim != 2:
        raise ValueError("Ternary export requires a rank-2 weight tensor")
    scale = np.maximum(np.abs(w).mean(axis=1, keepdims=True), 1e-12).astype(np.float32)
    ternary = np.clip(np.round(w / scale), -1, 1).astype(np.int8)
    codes = (ternary + 1).astype(np.uint8)
    out_f, in_f = codes.shape
    padded_in = _ceil_div(in_f, 4) * 4
    if padded_in != in_f:
        padded = np.ones((out_f, padded_in), np.uint8)
        padded[:, :in_f] = codes
        codes = padded
    c = codes.reshape(out_f, padded_in // 4, 4)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    return packed.astype(np.uint8), scale


def dequantize_ternary(packed: np.ndarray, scale: np.ndarray, out_f: int,
                       in_f: int) -> np.ndarray:
    codes = np.stack([(packed >> s) & 0x03 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(out_f, -1)[:, :in_f]
    if np.any(codes > 2):
        raise ValueError("Invalid reserved 2-bit code in ternary weight tensor")
    return (codes.astype(np.float32) - 1.0) * scale.reshape(out_f, 1)


# --------------------------------------------------------------------------
# ComfyUI record assembly
# --------------------------------------------------------------------------

def comfy_quant_key(key: str) -> str:
    return key[:-7] + ".comfy_quant" if key.endswith(".weight") else key + ".comfy_quant"


def comfy_scale_key(key: str) -> str:
    return key[:-7] + ".weight_scale" if key.endswith(".weight") else key + "_scale"


def comfy_scale2_key(key: str) -> str:
    return key[:-7] + ".weight_scale_2" if key.endswith(".weight") else key + "_scale_2"


def quant_info_tensor(format_name: str, **metadata) -> np.ndarray:
    payload = json.dumps({"format": format_name, **metadata},
                         separators=(",", ":")).encode("utf-8")
    return np.frombuffer(payload, np.uint8).copy()


def format_compatible(format_name: str, key: str, tensor: np.ndarray) -> bool:
    if not key.endswith(".weight") or not is_requantizable_dtype(tensor.dtype):
        return False
    if format_name == "ternary_1_58":
        return tensor.ndim == 2
    if format_name == "nvfp4":
        return tensor.ndim == 2 and tensor.shape[1] % NVFP4_BLOCK_SIZE == 0
    return tensor.ndim >= 2


def quant_records_for_weight(key: str, tensor: np.ndarray, format_name: str,
                             nvfp4_scale_multiplier: float = 1.0):
    """[(name, array)] records for one weight (:598-640)."""
    if format_name == "ternary_1_58":
        packed, scale = quantize_ternary(tensor)
        info = quant_info_tensor(
            format_name, logical_bits_per_weight=math.log2(3.0),
            storage_bits_per_weight=2, packing="ternary_2bit_four_per_byte",
            original_shape=[int(tensor.shape[0]), int(tensor.shape[1])],
            scale="per_output_absmean")
        return [(key, packed), (comfy_scale_key(key), scale),
                (comfy_quant_key(key), info)]
    if format_name == "nvfp4":
        codes, block_scale, per_tensor = quantize_nvfp4(
            tensor, nvfp4_scale_multiplier)
        return [(key, codes), (comfy_scale_key(key), block_scale),
                (comfy_scale2_key(key), np.asarray(per_tensor, np.float32)),
                (comfy_quant_key(key), quant_info_tensor(format_name))]
    if format_name == "int8_tensorwise":
        codes, scale = quantize_int8_tensorwise(tensor)
        return [(key, codes), (comfy_scale_key(key), scale),
                (comfy_quant_key(key), quant_info_tensor(format_name))]
    fp8 = F8_E4M3 if format_name == "float8_e4m3fn" else F8_E5M2
    codes, scale = quantize_scaled_fp8(tensor, fp8)
    return [(key, codes), (comfy_scale_key(key), np.asarray(scale, np.float32)),
            (comfy_quant_key(key), quant_info_tensor(format_name))]


def dequantize_records(key: str, tensors: dict, out_shape=None) -> np.ndarray:
    """Inverse of :func:`quant_records_for_weight` given the full tensor dict."""
    info_raw = tensors[comfy_quant_key(key)]
    info = json.loads(bytes(np.asarray(info_raw, np.uint8)).decode("utf-8"))
    fmt = info["format"]
    codes = tensors[key]
    if fmt == "ternary_1_58":
        out_f, in_f = info["original_shape"]
        return dequantize_ternary(codes, np.asarray(tensors[comfy_scale_key(key)]),
                                  out_f, in_f)
    if fmt == "nvfp4":
        out_f = codes.shape[0]
        in_f = out_shape[1] if out_shape else codes.shape[1] * 2
        return dequantize_nvfp4(codes, np.asarray(tensors[comfy_scale_key(key)]),
                                np.asarray(tensors[comfy_scale2_key(key)]),
                                out_f, in_f)
    if fmt == "int8_tensorwise":
        return dequantize_int8_tensorwise(codes,
                                          np.asarray(tensors[comfy_scale_key(key)]))
    return dequantize_scaled_fp8(codes, np.asarray(tensors[comfy_scale_key(key)]))


def convert_state_dict(state: dict, format_choice: str = "e4m3",
                       preset: str = "target", keep_dtype=None,
                       min_elements: int = 4096,
                       include_patterns=(), exclude_patterns=(),
                       nvfp4_scale_multiplier: float = 1.0) -> tuple[dict, dict]:
    """Quantize a whole (torch-layout) state dict; returns (tensors, report)."""
    format_name = FORMAT_CHOICES.get(format_choice, format_choice)
    inc = [re.compile(p) for p in include_patterns]
    exc = [re.compile(p) for p in exclude_patterns]
    out: dict = {}
    report = {"quantized": 0, "kept": 0, "formats": {}}
    for key, tensor in state.items():
        tensor = np.asarray(tensor)
        excluded = any(p.search(key) for p in exc)
        included = any(p.search(key) for p in inc)
        do_quant = (not excluded) and (
            included or should_quantize(key, tensor, preset, min_elements))
        if do_quant and format_compatible(format_name, key, tensor):
            for name, arr in quant_records_for_weight(
                    key, tensor, format_name, nvfp4_scale_multiplier):
                out[name] = arr
            report["quantized"] += 1
            report["formats"][format_name] = report["formats"].get(format_name, 0) + 1
        else:
            if keep_dtype is not None and is_requantizable_dtype(tensor.dtype):
                tensor = tensor.astype(keep_dtype)
            out[key] = tensor
            report["kept"] += 1
    return out, report
