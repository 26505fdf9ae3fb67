"""Fused GroupNorm + SiLU: a CUDA forward kernel in two layouts, and the
plain versions.

Counterpart of ``aozora_sdxl_training_tpu/ops/groupnorm_silu.py``. The
Pallas kernel there (``group_norm_silu_pallas``) becomes the hand-written
CUDA kernel in ``csrc/groupnorm_silu.cu`` (K6), bound with ``ctypes``; the
backward stays plain PyTorch, as the JAX package's ``_fused_bwd`` is plain
XLA (it has no backward kernel).

Two entry points compute the same function:

* ``group_norm_silu`` (NHWC, the op's own layout, as in the JAX package):
  with ``use_pallas=True`` the kernel's forward (two launches: the
  statistics with their fold in the last block, then the
  normalise-and-SiLU pass); otherwise the plain composition.
* ``group_norm_silu_nchw`` (NCHW, contiguous, the port's UNet layout): with
  ``use_pallas=True`` one launch, a thread-block cluster per (batch,
  group). The UNet's ``fused_gn`` route calls it.

The wrappers launch the kernel for CUDA tensors and run the plain version
only for CPU tensors. ``LAUNCHES`` counts the wrappers' calls that launched
the kernel, by entry point.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

LAUNCHES = {"group_norm_silu": 0, "group_norm_silu_nchw": 0}
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# NHWC statistics blocks per batch element, at most: enough to spread any
# site over the card's 132 SMs, few enough for the last block to fold
# their partials quickly
_MAX_CHUNKS = 256
# NCHW: CTAs in a cluster, at most (the portable limit); the bytes of a
# span one CTA should hold before the span is split further; the fewest
# 16-byte vectors a CTA should get; dynamic shared memory a CTA may take
# (the card's 227 KB less room for the kernel's static arrays); the shared
# memory of an SM, and what the runtime and the static arrays take of it a
# CTA; the most 512-thread CTAs an SM holds
MAX_CLUSTER = 8
_SLICE_BYTES = 64 * 1024
_MIN_SLICE_VECTORS = 1024
NCHW_SMEM_LIMIT = 232448 - 1024
_SM_SMEM = 233472
_CTA_SMEM_RESERVE = 2048
_CTAS_PER_SM = 4
_lib = None
_sms: dict[int, int] = {}
_plans: dict[tuple, tuple[int, int, int]] = {}


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
        lib.aozora_group_norm_silu_nchw.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, f, p]
        lib.aozora_group_norm_silu_nchw.restype = i
        lib.aozora_group_norm_silu_nchw_max_clusters.argtypes = [i, i, i, i, i, i]
        lib.aozora_group_norm_silu_nchw_max_clusters.restype = i
        lib.aozora_gn_error_string.argtypes = [i]
        lib.aozora_gn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _num_sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def rows_per_chunk(hw: int) -> int:
    """Rows of (B, HW, C) that one NHWC statistics block reduces."""
    return max(1, -(-hw // _MAX_CHUNKS))


def nchw_plan(b: int, c: int, hw: int, groups: int, elem: int, vec: bool,
              sms: int = 132, clusters_held=None) -> tuple[int, int, int]:
    """The NCHW kernel's (cluster size, slice, cached) for ``b`` batches of
    ``c`` channels and ``hw`` pixels in ``elem``-byte elements: a cluster
    per (batch, group) span of ``c / groups * hw`` elements, CTA r owning
    elements [r * slice, (r + 1) * slice), the first ``cached`` of them in
    shared memory (the rest is read twice).

    The cluster grows (up to ``MAX_CLUSTER``) while the CTAs do not yet
    cover twice the ``sms`` SMs or a slice is above ``_SLICE_BYTES``, as
    long as each CTA keeps ``_MIN_SLICE_VECTORS`` vectors. Where the card
    cannot hold every cluster at once with the whole slice in shared
    memory, ``cached`` shrinks to an SM's share for 2, 3 or 4 CTAs, the
    first share at which it can: two waves of CTAs that each load, then
    store, cost more than re-reading a slice's tail, which mostly hits L2.
    ``clusters_held(csize, cached)`` is how many clusters the card holds at
    once (the runtime's count on the card; by default a model of ``sms``
    SMs that each hold as many CTAs as their 228 KB of shared memory fit).
    ``vec`` is the 16-byte-vector route, whose slices are whole vectors."""
    cpg = c // groups
    span = cpg * hw
    v = 16 // elem if vec else 1
    nvec = span // v
    csize = 1
    while (csize < MAX_CLUSTER and nvec >= 2 * csize * _MIN_SLICE_VECTORS
           and (span * elem > csize * _SLICE_BYTES or b * groups * csize < 2 * sms)):
        csize *= 2
    slice_ = -(-nvec // csize) * v

    def room(smem_bytes):
        return min(slice_, (smem_bytes - 8 * cpg) // elem // v * v)

    if clusters_held is None:
        def clusters_held(cs, cached):
            per_sm = _SM_SMEM // (cached * elem + 8 * cpg + _CTA_SMEM_RESERVE)
            return sms // cs * min(per_sm, _CTAS_PER_SM)

    cached = room(NCHW_SMEM_LIMIT)
    if cached <= 0:
        raise ValueError(f"group_norm_silu_nchw: {cpg} channels a group leave no "
                         "shared memory for the slice")
    if b * groups > clusters_held(csize, cached):
        for per_sm in range(2, _CTAS_PER_SM + 1):
            share = room(_SM_SMEM // per_sm - _CTA_SMEM_RESERVE)
            if share <= 0:
                break
            if b * groups <= clusters_held(csize, share):
                cached = share
                break
    return csize, slice_, cached


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


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


def group_norm_silu_nchw_reference(x, scale, bias, groups: int, eps: float = 1e-5):
    """The plain version on NCHW ``x`` (B, C, H, W): the NHWC one on the
    transposed tensor, returned contiguous in NCHW."""
    return _nchw(group_norm_silu_reference(_nhwc(x), scale, bias, groups, eps))


def group_norm_silu_nchw_backward_reference(x, scale, bias, g, groups: int,
                                            eps: float = 1e-5):
    """(dx, dscale, dbias) on NCHW ``x`` and ``g``: ``_fused_bwd`` on the
    transposed tensors."""
    dx, dscale, dbias = group_norm_silu_backward_reference(
        _nhwc(x), scale, bias, _nhwc(g), groups, eps)
    return _nchw(dx), dscale, dbias


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check_cuda_inputs(x, scale, bias, groups: int, layout: str = "nhwc") -> None:
    name = "group_norm_silu" if layout == "nhwc" else "group_norm_silu_nchw"
    if x.dim() != 4:
        expected = "(B, H, W, C)" if layout == "nhwc" else "(B, C, H, W)"
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; expected {expected}")
    c = x.shape[-1] if layout == "nhwc" else x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{name}: {c} channels in {groups} groups")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x has dtype {x.dtype}; the kernel "
                        "takes bfloat16, float16 or float32")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input")
    for what, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {x.device}")
        if t.shape != (c,):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}; "
                             f"expected ({c},)")


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _library().aozora_gn_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def group_norm_silu_forward(x, scale, bias, groups: int, eps: float = 1e-5):
    """K6 on NHWC ``x``: the kernel for CUDA tensors, the plain version on
    the CPU."""
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
    partial = torch.empty(2 * b * groups * nchunks, dtype=torch.float32,
                          device=x.device)
    gstat = torch.empty(b * groups * 2, dtype=torch.float32, device=x.device)
    code = _library().aozora_group_norm_silu(
        _DTYPE_CODES[x.dtype], x.data_ptr(), scale32.data_ptr(),
        bias32.data_ptr(), y.data_ptr(), partial.data_ptr(), gstat.data_ptr(),
        b, hw, c, groups, rows, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(code, "group_norm_silu")
    LAUNCHES["group_norm_silu"] += 1
    return y


def _plan_on_card(x, b: int, c: int, hw: int, groups: int, vec: bool):
    """``nchw_plan`` for ``x``'s card, with the runtime's count of the
    clusters it holds at once; cached by shape."""
    key = (x.device, x.dtype, b, c, hw, groups, vec)
    plan = _plans.get(key)
    if plan is None:
        code = _DTYPE_CODES[x.dtype]

        def clusters_held(csize, cached):
            n = _library().aozora_group_norm_silu_nchw_max_clusters(
                code, int(vec), c, groups, csize, cached)
            if n < 0:
                _raise_on(-n, "group_norm_silu_nchw occupancy query")
            return n

        with torch.cuda.device(x.device):
            plan = nchw_plan(b, c, hw, groups, x.element_size(), vec, _num_sms(x.device),
                             clusters_held)
        _plans[key] = plan
    return plan


def group_norm_silu_nchw_forward(x, scale, bias, groups: int, eps: float = 1e-5):
    """K6 on contiguous NCHW ``x``: the kernel (one launch) for CUDA
    tensors, the plain version on the CPU."""
    if x.device.type == "cpu":
        return group_norm_silu_nchw_reference(x, scale, bias, groups, eps)
    _check_cuda_inputs(x, scale, bias, groups, layout="nchw")
    b, c, h, w = x.shape
    hw = h * w
    elem = x.element_size()
    y = torch.empty_like(x)
    vec = (x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
           and (c // groups * hw) % (16 // elem) == 0)
    csize, slice_, cached = _plan_on_card(x, b, c, hw, groups, vec)
    scale32 = scale.float().contiguous()
    bias32 = bias.float().contiguous()
    code = _library().aozora_group_norm_silu_nchw(
        _DTYPE_CODES[x.dtype], int(vec), x.data_ptr(), scale32.data_ptr(),
        bias32.data_ptr(), y.data_ptr(), b, c, hw, groups, csize, slice_, cached,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(code, "group_norm_silu_nchw")
    LAUNCHES["group_norm_silu_nchw"] += 1
    return y


class _Fused(torch.autograd.Function):
    """Forward: the kernel (or its plain version on the CPU); backward: the
    plain ``_fused_bwd`` counterpart. ``forward_fn`` and ``backward_fn``
    pick the layout."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, forward_fn, backward_fn):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps, ctx.backward_fn = groups, eps, backward_fn
        return forward_fn(x, scale, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = ctx.backward_fn(x, scale, bias, g, ctx.groups, ctx.eps)
        return dx, dscale, dbias, None, None, None, None


def group_norm_silu(x, scale, bias, *, groups: int, eps: float = 1e-5,
                    use_pallas: bool | None = None):
    """silu(affine(group_norm(x))) for NHWC ``x`` (B, H, W, C); differentiable.

    ``use_pallas`` keeps the JAX package's name: here it selects the CUDA
    kernel (K6) for the forward. Otherwise, as by default there, the plain
    composition runs.
    """
    if use_pallas:
        return _Fused.apply(x, scale, bias, groups, eps, group_norm_silu_forward,
                            group_norm_silu_backward_reference)
    return group_norm_silu_reference(x, scale, bias, groups, eps)


def group_norm_silu_nchw(x, scale, bias, *, groups: int, eps: float = 1e-5,
                         use_pallas: bool | None = None):
    """``group_norm_silu`` for contiguous NCHW ``x`` (B, C, H, W);
    differentiable. ``use_pallas=True`` runs the NCHW kernel's forward."""
    if use_pallas:
        return _Fused.apply(x, scale, bias, groups, eps, group_norm_silu_nchw_forward,
                            group_norm_silu_nchw_backward_reference)
    return group_norm_silu_nchw_reference(x, scale, bias, groups, eps)
