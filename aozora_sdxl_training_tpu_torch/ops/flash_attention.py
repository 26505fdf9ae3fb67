"""Flash attention (forward + backward): CUDA kernels and their plain version.

Counterpart of ``aozora_sdxl_training_tpu/ops/flash_attention.py``. The
Pallas kernels there become hand-written CUDA kernels in
``csrc/flash_attention.cu``, one set per head dim, bound with ``ctypes`` and
wrapped in a ``torch.autograd.Function``:

* head_dim 64 (the SDXL UNet): K1 forward, K2 dQ, K3 dK/dV, for
  ``_flash_forward`` / ``_flash_backward``;
* head_dim 128 (the Anima DiT): K4a forward, K4b dQ and dK/dV, for
  ``_flash_forward_folded`` / ``_flash_backward_folded``.

Layout: q (B, Sq, H, D), k and v (B, Skv, H, D), as the callers hold them;
the kernels index that layout directly, so nothing is transposed or padded
(the TPU's "folded" (B, S, H*D) layout is the same memory). The row
logsumexp is (B*H, Sq) fp32. No gradient flows through it.

A wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take (any other head dim among them: head_dim 512, the
SD-VAE mid-attention case of K4a, is not ported yet); it runs the plain
PyTorch version only for CPU tensors. ``LAUNCHES`` counts kernel launches
per kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel names (and C entry points "aozora_<name>") by head dim: forward, dQ,
# dK/dV
KERNEL_NAMES = {
    64: ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),                 # K1-K3
    128: ("flash_fwd_d128", "flash_bwd_dq_d128", "flash_bwd_dkv_d128"),  # K4a/K4b
}
LAUNCHES = {name: 0 for names in KERNEL_NAMES.values() for name in names}
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        argtypes = ([i, p, p, p, p, p, i, i, i, i, f, p],
                    [i, p, p, p, p, p, p, p, p, i, i, i, i, f, p],
                    [i, p, p, p, p, p, p, p, p, i, i, i, i, f, p])
        for names in KERNEL_NAMES.values():
            for name, types in zip(names, argtypes):
                fn = getattr(lib, f"aozora_{name}")
                fn.argtypes = types
                fn.restype = i
        lib.aozora_flash_error_string.argtypes = [i]
        lib.aozora_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(name: str, *args) -> None:
    lib = _library()
    code = getattr(lib, f"aozora_{name}")(*args)
    if code != 0:
        msg = lib.aozora_flash_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")
    LAUNCHES[name] += 1


def kernel_names(head_dim: int) -> tuple[str, str, str]:
    """(forward, dQ, dK/dV) kernel names for ``head_dim``; raises for a head
    dim that has no kernel."""
    if head_dim in KERNEL_NAMES:
        return KERNEL_NAMES[head_dim]
    if head_dim == 512:
        raise NotImplementedError(
            "flash attention at head_dim 512 (the SD-VAE mid-attention case "
            "of the folded TPU kernel) is not ported yet; it comes with the "
            "caching encoders")
    raise ValueError(f"flash attention: head_dim {head_dim}; expected one "
                     f"of {sorted(KERNEL_NAMES)}")


def _check_cuda_inputs(q, k, v) -> tuple[str, str, str]:
    """Checks what the kernels take; returns the kernel names for q's head
    dim."""
    if q.dim() != 4:
        raise ValueError(f"flash attention: q has shape {tuple(q.shape)}; "
                         "expected (B, S, H, D)")
    names = kernel_names(q.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash attention: {name} is on {t.device}, "
                             "expected the CUDA device of q")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash attention: {name} has dtype {t.dtype}; "
                            "the kernels take bfloat16 or float32")
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: q, k, v on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash attention: q, k, v dtypes differ")
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:]):
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree; "
                         "expected (B, S, H, D) with the same B, H and D")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash attention: empty sequence")
    return names


def _check_rows(q, lse, **tensors) -> None:
    """Backward inputs: out/dout like q, lse/delta contiguous fp32 (B*H, Sq)."""
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), *tensors.items()):
        if name in ("lse", "delta"):
            ok = (t.shape == (b * h, sq) and t.dtype == torch.float32)
        else:
            ok = t.shape == q.shape and t.dtype == q.dtype
        if not ok or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash backward: {name} has shape "
                             f"{tuple(t.shape)}, dtype {t.dtype}, device "
                             f"{t.device}; not what the kernel takes")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# --------------------------------------------------------------------------

def flash_forward_reference(q, k, v, scale: float):
    """(out (B,Sq,H,D) in q's dtype, lse (B*H, Sq) fp32), fp32 math."""
    b, sq, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse.reshape(b * h, sq)


def _probs(q, k, lse, scale: float):
    b, sq, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.exp(s - lse.reshape(b, h, sq, 1))


def flash_bwd_dq_reference(q, k, v, out, lse, dout, scale: float):
    """(dq, delta (B*H, Sq) fp32) with delta = rowsum(dO * O)."""
    b, sq, h, _ = q.shape
    dof = dout.float()
    p = _probs(q, k, lse, scale)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)      # (B, H, Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), delta.reshape(b * h, sq)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale: float):
    """(dk, dv) from the saved lse and delta."""
    b, sq, h, _ = q.shape
    dof = dout.float()
    p = _probs(q, k, lse, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def flash_fwd(q, k, v, scale: float):
    """K1 / K4a: (out, lse). Kernel for CUDA tensors, plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale)
    name = _check_cuda_inputs(q, k, v)[0]
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    _launch(name, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, sq,
            k.shape[1], float(scale), _stream(q))
    return out, lse


def flash_bwd_dq(q, k, v, out, lse, dout, scale: float):
    """K2 / K4b dq: (dq, delta). The kernel also writes delta =
    rowsum(dO * O)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, out, lse, dout, scale)
    name = _check_cuda_inputs(q, k, v)[1]
    _check_rows(q, lse, out=out, dout=dout)
    b, sq, h, _ = q.shape
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    _launch(name, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, sq, k.shape[1],
            float(scale), _stream(q))
    return dq, delta


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale: float):
    """K3 / K4b dkv: (dk, dv) from the saved lse and the dq kernel's
    delta."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale)
    name = _check_cuda_inputs(q, k, v)[2]
    _check_rows(q, lse, delta=delta, dout=dout)
    b, sq, h, _ = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(name, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[1], float(scale),
            _stream(q))
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, scale: float):
    """The dq kernel then the dk/dv kernel: (dq, dk, dv)."""
    dq, delta = flash_bwd_dq(q, k, v, out, lse, dout, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(out, lse) = attention(q, k, v); lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention_lse(q, k, v, *, scale: float | None = None):
    """(out (B,Sq,H,D), lse (B,Sq,H) fp32) — the layout of the JAX
    package's ``flash_fwd_stats``."""
    b, sq, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    out, lse = FlashAttention.apply(q, k, v, scale)
    return out, lse.reshape(b, h, sq).permute(0, 2, 1)


def flash_attention(q, k, v, *, scale: float | None = None):
    """Exact attention. q: (B, Sq, H, D); k, v: (B, Skv, H, D)."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return FlashAttention.apply(q, k, v, scale)[0]
