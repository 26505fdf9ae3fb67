"""On-device QAT projection: quantize -> dequantize round trips in torch.

Counterpart of ``aozora_sdxl_training_tpu/train/qat_project_jax.py``:
value-space mirrors of the packed quantizers in ``tools/quantize.py``, run
on the parameters' own device. The error-feedback residuals live beside
their parameters (fp16 by default), and the whole project step (effective
= w + residual in fp32, quantize onto the format's value grid, residual =
effective - projected, the parameter = projected in its own dtype) runs in
place right after each optimizer step. No weight byte reaches the host
until save time.

The numerics are the numpy quantizers' bit for bit, so that re-quantizing
the final weights on the host reproduces the device's codes:

* the same scale clamps (1e-12, 1e-30, 2^-126) and the same float32
  operations in the same order;
* the fp8 round trip through ``torch.float8_e4m3fn`` / ``float8_e5m2``;
* e2m1 round-half-to-even (``_round_e2m1_magnitude``: up at 0.75, 1.75 and
  3.5, down at the other midpoints);
* NVFP4 block scales rounded through real e4m3, and the *unclamped*
  per-tensor scale in the reconstruction, as the host dequantizer has it;
* the ternary row mean summed in numpy's own order (``_numpy_row_sum``:
  pairwise, 8 accumulators; past 8192 elements numpy 2.0 restarts the sum
  at each 8192-element buffer and numpy 2.3 does not, so the installed
  numpy's order is read off one probe sum), where XLA's sums in another
  and the JAX projector differs from numpy by an ulp of the scale;
* every division by a tensor on the device: CUDA torch divides by a host
  scalar as a multiplication by its reciprocal, which is not correctly
  rounded.

The port holds torch layout, linear weights (out, in), so unlike the JAX
projector nothing is transposed: a residual has its parameter's shape.
"""

from __future__ import annotations

from functools import lru_cache

import torch

F8_E4M3_MAX = 448.0
F8_E5M2_MAX = 57344.0
NVFP4_BLOCK = 16
E2M1_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
NUMPY_BUFSIZE = 8192          # numpy's reduction buffer, in elements
_FP8 = {"e4m3": (torch.float8_e4m3fn, F8_E4M3_MAX),
        "e5m2": (torch.float8_e5m2, F8_E5M2_MAX)}


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 tensor on ``like``'s device (a divisor there)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of numpy's float32 pairwise sum."""
    n = x.shape[-1]
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        r, m = x[..., 0:8], n - n % 8
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    left, right = x[..., :n2], x[..., n2:]
    if left.shape[-1] == right.shape[-1]:     # both halves in one pass
        s = _pairwise_sum(torch.stack((left, right), dim=-2))
        return s[..., 0] + s[..., 1]
    return _pairwise_sum(left) + _pairwise_sum(right)


def _buffered_sum(x: torch.Tensor, buffer: int | None) -> torch.Tensor:
    """The pairwise sum restarted every ``buffer`` elements, the parts added
    in turn (``None``: one pairwise sum over the whole row)."""
    if buffer is None or x.shape[-1] <= buffer:
        return _pairwise_sum(x)
    res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for start in range(0, x.shape[-1], buffer):
        res = res + _pairwise_sum(x[..., start:start + buffer])
    return res


@lru_cache(maxsize=None)
def _numpy_buffer() -> int | None:
    """How the installed numpy sums a float32 row past NUMPY_BUFSIZE
    elements: NUMPY_BUFSIZE where it restarts the pairwise sum at each of
    its iterator's buffers (numpy 2.0), None where it sums the whole row
    (numpy 2.3); read off one probe sum."""
    import numpy as np
    probe = np.random.default_rng(0).uniform(size=(4, 3 * NUMPY_BUFSIZE + 77)).astype(np.float32)
    want = torch.from_numpy(probe.sum(axis=1))
    for buffer in (NUMPY_BUFSIZE, None):
        if torch.equal(_buffered_sum(torch.from_numpy(probe), buffer), want):
            return buffer
    raise RuntimeError(f"numpy {np.__version__} sums a float32 row in an order the "
                       "device projection does not know")


def _numpy_row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last dim, bit for bit the installed numpy's
    ``np.sum(x, axis=-1)`` of a C-contiguous array."""
    return _buffered_sum(x, _numpy_buffer() if x.shape[-1] > NUMPY_BUFSIZE else None)


def _round_e2m1_magnitude(m: torch.Tensor) -> torch.Tensor:
    """RNE rounding of magnitudes in [0, 6] onto the e2m1 value grid.

    At each midpoint the neighbour whose code is even wins
    (``quantize.f32_to_e2m1_codes``), which is 'up' at 0.75 / 1.75 / 3.5 and
    'down' elsewhere.
    """
    idx = ((m > 0.25).long() + (m >= 0.75) + (m > 1.25) + (m >= 1.75)
           + (m > 2.5) + (m >= 3.5) + (m > 5.0))
    return torch.tensor(E2M1_GRID, dtype=torch.float32, device=m.device)[idx]


def project_fp8(w: torch.Tensor, fp8: str = "e4m3") -> torch.Tensor:
    """Per-tensor absmax fp8 (``quantize.quantize_scaled_fp8`` round trip)."""
    dtype, fmax = _FP8[fp8]
    scale = torch.clamp(w.abs().amax() / _const(fmax, w), min=1e-12)
    return (w / scale).to(dtype).float() * scale


def project_int8(w: torch.Tensor) -> torch.Tensor:
    """Per-output-row absmax/127 int8 (``quantize.quantize_int8_tensorwise``)."""
    absmax = w.abs().amax(dim=1, keepdim=True) if w.dim() >= 2 else w.abs().amax()
    scale = torch.clamp(absmax / _const(127.0, w), min=1e-30)
    codes = torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8)
    return codes.float() * scale


def project_ternary(w: torch.Tensor) -> torch.Tensor:
    """Per-output-row absmean ternary (``quantize.quantize_ternary``)."""
    mean = _numpy_row_sum(w.abs()) / _const(float(w.shape[1]), w)
    scale = torch.clamp(mean, min=1e-12)[:, None]
    codes = torch.clamp(torch.round(w / scale), -1, 1).to(torch.int8)
    return codes.float() * scale


def project_nvfp4(w: torch.Tensor, scale_multiplier: float = 1.0) -> torch.Tensor:
    """Block-16 two-level NVFP4 (``quantize_nvfp4`` -> ``dequantize_nvfp4``)."""
    out_f, in_f = w.shape
    per_tensor = (w.abs().amax() / _const(F8_E4M3_MAX * 6.0, w)
                  * _const(scale_multiplier, w))
    per_tensor_div = torch.clamp(per_tensor, min=2.0 ** -126)
    xb = w.reshape(out_f, in_f // NVFP4_BLOCK, NVFP4_BLOCK)
    block_amax = xb.abs().amax(dim=-1)
    scaled_fp8 = torch.clamp(block_amax / _const(6.0, w) / per_tensor_div, max=F8_E4M3_MAX)
    fp8_rounded = scaled_fp8.to(torch.float8_e4m3fn).float()
    total = per_tensor_div * fp8_rounded
    total_safe = torch.where(total == 0, _const(1.0, w), total)
    data = torch.where((total == 0)[..., None], _const(0.0, w), xb / total_safe[..., None])
    data = torch.clamp(data, -6.0, 6.0)
    # the code's sign bit is the scaled value's, -0.0 included
    vals = torch.copysign(_round_e2m1_magnitude(data.abs()), data)
    # the host dequantizer multiplies by fp8_rounded * per_tensor (unclamped)
    return (vals * (fp8_rounded * per_tensor)[..., None]).reshape(out_f, in_f)


def project_weight(fmt: str, w: torch.Tensor, scale_multiplier: float = 1.0) -> torch.Tensor:
    """The projected (dequantized) fp32 values of the float32 tensor ``w``."""
    if fmt in ("float8_e4m3fn", "e4m3", "fp8_e4m3"):
        return project_fp8(w, "e4m3")
    if fmt in ("float8_e5m2", "e5m2", "fp8_e5m2"):
        return project_fp8(w, "e5m2")
    if fmt in ("int8_tensorwise", "int8"):
        return project_int8(w)
    if fmt in ("nvfp4", "fp4"):
        return project_nvfp4(w, scale_multiplier)
    if fmt in ("ternary_1_58", "ternary"):
        return project_ternary(w)
    raise ValueError(f"Unsupported quant format for the device projection: {fmt}")


def make_device_projector(formats: dict[str, str],
                          multipliers: dict[str, float] | None = None,
                          residual_dtype=torch.float16):
    """(init_residuals, project) for error-feedback projection on the device.

    ``formats`` maps state names (the port's parameter names) to quant
    format strings.

    * ``init_residuals(trainable) -> residuals``: zero buffers in
      ``residual_dtype`` beside each controlled parameter present in
      ``trainable``, with its shape.
    * ``project(trainable, residuals)``: updates both in place under
      ``torch.no_grad()``; all math in fp32 on the parameters' device.
    """
    multipliers = multipliers or {}

    def init_residuals(trainable):
        return {key: torch.zeros(trainable[key].shape, dtype=residual_dtype,
                                 device=trainable[key].device)
                for key in formats if key in trainable}

    @torch.no_grad()
    def project(trainable, residuals):
        for key, res in residuals.items():
            w = trainable[key]
            eff = w.float() + res.float()
            proj = project_weight(formats[key], eff, multipliers.get(key, 1.0))
            res.copy_(eff - proj)
            w.copy_(proj)

    return init_residuals, project
