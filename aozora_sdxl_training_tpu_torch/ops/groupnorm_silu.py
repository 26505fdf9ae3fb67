"""Fused GroupNorm + SiLU (NHWC): a CUDA forward kernel and its plain version.

Counterpart of ``aozora_sdxl_training_tpu/ops/groupnorm_silu.py``. The
Pallas kernel there (``group_norm_silu_pallas``) becomes the hand-written
CUDA kernel in ``csrc/groupnorm_silu.cu`` (K6), bound with ``ctypes``; the
backward stays plain PyTorch, as the JAX package's ``_fused_bwd`` is plain
XLA (it has no backward kernel).

``group_norm_silu(..., use_pallas=True)`` is the only route to the kernel,
as in the JAX package: no model calls it (the port's UNet normalises in
NCHW with ``F.group_norm``). The wrapper launches the kernel for CUDA
tensors and runs the plain version only for CPU tensors. ``LAUNCHES``
counts the wrapper's calls that launched the kernel (each call is three
launches: statistics, their fold, the normalise-and-SiLU pass).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

LAUNCHES = {"group_norm_silu": 0}
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# statistics blocks per batch element, at most: enough to spread any site
# over the card's 132 SMs, few enough for one warp to fold their partials
_MAX_CHUNKS = 512
_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("groupnorm_silu")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.aozora_group_norm_silu.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.aozora_group_norm_silu.restype = i
        lib.aozora_gn_error_string.argtypes = [i]
        lib.aozora_gn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rows_per_chunk(hw: int) -> int:
    """Rows of (B, HW, C) that one statistics block reduces."""
    return max(1, -(-hw // _MAX_CHUNKS))


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, the kernel's oracle, the backward)
# --------------------------------------------------------------------------

def _stats(x, groups: int, eps: float):
    """(xhat (B, HW, G, C/G) fp32, rstd (B, 1, G, 1))."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (xf - mean) * inv, inv


def group_norm_silu_reference(x, scale, bias, groups: int, eps: float = 1e-5):
    """silu(affine(group_norm(x))) in fp32, returned in x's dtype: the JAX
    package's ``_xla_reference``."""
    xhat, _ = _stats(x, groups, eps)
    y = xhat.reshape(x.shape) * scale.float() + bias.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def group_norm_silu_backward_reference(x, scale, bias, g, groups: int,
                                       eps: float = 1e-5):
    """(dx, dscale, dbias): the JAX package's ``_fused_bwd``."""
    b, h, w, c = x.shape
    xhat, inv = _stats(x, groups, eps)
    xhat_c = xhat.reshape(b, h, w, c)
    z = xhat_c * scale.float() + bias.float()
    sig = torch.sigmoid(z)
    dz = g.float() * sig * (1.0 + z * (1.0 - sig))
    dscale = (dz * xhat_c).sum(dim=(0, 1, 2))
    dbias = dz.sum(dim=(0, 1, 2))
    dxhat = (dz * scale.float()).reshape(xhat.shape)
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 3), keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * inv
    return (dx.reshape(b, h, w, c).to(x.dtype), dscale.to(scale.dtype),
            dbias.to(bias.dtype))


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

def _check_cuda_inputs(x, scale, bias, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"group_norm_silu: x has shape {tuple(x.shape)}; "
                         "expected (B, H, W, C)")
    c = x.shape[-1]
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm_silu: {c} channels in {groups} groups")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm_silu: x has dtype {x.dtype}; the kernel "
                        "takes bfloat16 or float32")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be contiguous")
    if x.numel() == 0:
        raise ValueError("group_norm_silu: empty input")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"group_norm_silu: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.shape != (c,):
            raise ValueError(f"group_norm_silu: {name} has shape "
                             f"{tuple(t.shape)}; expected ({c},)")


def group_norm_silu_forward(x, scale, bias, groups: int, eps: float = 1e-5):
    """K6: the kernel for CUDA tensors, the plain version on the CPU."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, groups, eps)
    _check_cuda_inputs(x, scale, bias, groups)
    b, h, w, c = x.shape
    hw = h * w
    rows = rows_per_chunk(hw)
    nchunks = -(-hw // rows)
    scale32 = scale.float().contiguous()
    bias32 = bias.float().contiguous()
    y = torch.empty_like(x)
    partial = torch.empty(b * nchunks * groups * 3, dtype=torch.float32,
                          device=x.device)
    coef = torch.empty(b * c * 2, dtype=torch.float32, device=x.device)
    lib = _library()
    code = lib.aozora_group_norm_silu(
        _DTYPE_CODES[x.dtype], x.data_ptr(), scale32.data_ptr(),
        bias32.data_ptr(), y.data_ptr(), partial.data_ptr(), coef.data_ptr(),
        b, hw, c, groups, rows, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.aozora_gn_error_string(code).decode()
        raise RuntimeError(f"group_norm_silu launch failed: {msg} (cudaError {code})")
    LAUNCHES["group_norm_silu"] += 1
    return y


class _Fused(torch.autograd.Function):
    """Forward: the kernel (or its plain version on the CPU); backward: the
    plain ``_fused_bwd`` counterpart."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        return group_norm_silu_forward(x, scale, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = group_norm_silu_backward_reference(
            x, scale, bias, g, ctx.groups, ctx.eps)
        return dx, dscale, dbias, None, None


def group_norm_silu(x, scale, bias, *, groups: int, eps: float = 1e-5,
                    use_pallas: bool | None = None):
    """silu(affine(group_norm(x))) for NHWC ``x`` (B, H, W, C); differentiable.

    ``use_pallas`` keeps the JAX package's name: here it selects the CUDA
    kernel (K6) for the forward. Otherwise, as by default there, the plain
    composition runs.
    """
    if use_pallas:
        return _Fused.apply(x, scale, bias, groups, eps)
    return group_norm_silu_reference(x, scale, bias, groups, eps)
