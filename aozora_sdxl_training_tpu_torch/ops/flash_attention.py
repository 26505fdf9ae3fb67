"""Flash attention (forward + backward): CUDA kernels and their plain version.

Counterpart of ``aozora_sdxl_training_tpu/ops/flash_attention.py``. The
Pallas kernels there become hand-written CUDA kernels, bound with
``ctypes``. The forward and the backward are dispatcher ops,
``aozora::flash_fwd`` (q, k, v, scale) -> (out, lse) and
``aozora::flash_bwd`` (q, k, v, out, lse, dout, scale) -> (dq, dk, dv),
called from the forward and the backward of ``_Flash``, so that a
selective remat policy (``ops/remat.py``) sees them: ``FlashAttention.apply``
names the forward's outputs "flash_out" and "flash_lse" as the JAX
package's ``_flash_core`` does, and a policy that saves those names keeps
them, so the backward goes straight to the dQ and dK/dV kernels. Which kernel a
call launches depends on the head dim, the dtype and the role (forward,
dQ, dK/dV), as ``route`` decides::

  route name              CUDA kernel (csrc/)                       replaces (Pallas)
  bf16, flash_attention_sm90.cu: wgmma, fp32 accumulators in registers
    flash_fwd             flash_fwd_sm90_kernel<bf16, 64, 1>        K1  _flash_forward
    flash_bwd_dq          flash_bwd_dq_sm90_kernel<bf16, 64, 1>     K2  _flash_backward, dq
    flash_bwd_dkv         flash_bwd_dkv_sm90_kernel<bf16, 64, 1>    K3  _flash_backward, dk/dv
    flash_fwd_d128        flash_fwd_sm90_kernel<bf16, 128, 2>       K4a _flash_forward_folded
    flash_bwd_dq_d128     flash_bwd_dq_sm90_kernel<bf16, 128, 2>    K4b ..._folded, dq
    flash_bwd_dkv_d128    flash_bwd_dkv_sm90_kernel<bf16, 128, 2>   K4b ..._folded, dk/dv
    flash_fwd_d512        flash_fwd_d512_sm90_kernel                K4a at head_dim 512
  fp16, flash_attention_sm90.cu: the same templates on fp16 (wgmma .f16)
    flash_fwd_f16         flash_fwd_sm90_kernel<f16, 64, 1>         K1 on fp16 inputs
    flash_bwd_dq_f16      flash_bwd_dq_sm90_kernel<f16, 64, 1>      K2 on fp16 inputs
    flash_bwd_dkv_f16     flash_bwd_dkv_sm90_kernel<f16, 64, 1>     K3 on fp16 inputs
    flash_fwd_f16_d128      flash_fwd_sm90_kernel<f16, 128, 2>      K4a on fp16 inputs
    flash_bwd_dq_f16_d128   flash_bwd_dq_sm90_kernel<f16, 128, 2>   K4b dq on fp16 inputs
    flash_bwd_dkv_f16_d128  flash_bwd_dkv_sm90_kernel<f16, 128, 2>  K4b dk/dv on fp16 inputs
  fp32, flash_attention_fp32.cu: 3xTF32 on mma.sync (no operand rounded to bf16)
    flash_fwd_f32_d64     flash_fwd_3xtf32_kernel<64>         K1 on fp32 inputs
    flash_bwd_dq_f32_d64  flash_bwd_dq_3xtf32_kernel<64>      K2 on fp32 inputs
    flash_bwd_dkv_f32_d64 flash_bwd_dkv_3xtf32_kernel<64>     K3 on fp32 inputs
    flash_fwd_f32_d128    flash_fwd_3xtf32_kernel<128>        K4a on fp32 inputs
    flash_bwd_dq_f32_d128   flash_bwd_dq_3xtf32_kernel<128>   K4b dq on fp32 inputs
    flash_bwd_dkv_f32_d128  flash_bwd_dkv_3xtf32_kernel<128>  K4b dk/dv on fp32 inputs
    flash_fwd_f32_d512    flash_fwd_f32_d512_kernel           K4a at 512 on fp32 inputs

Head_dim 64 is the SDXL UNet's (K1-K3 run on every SDXL micro step and
DDIM step), 128 the Anima DiT's, 512 the SD-VAE mid-attention's (bf16 in
the encoder's flash route, fp32 in the preview's decoder). The trainers
compute in bf16, or in fp16 under ``MIXED_PRECISION`` float16 (the fp16
rows); no fp16 path reaches head_dim 512, which has no fp16 kernel. Every fp32
kernel runs on the tensor cores in 3xTF32 (each operand split into two
TF32 parts, three TF32 products with fp32 accumulation), to fp32
accuracy; of the trainers only the preview's fp32 decoder reaches one
(the forward at 512). Each source's
header says what bounds its kernels, what their design does about it and
what was tried and not kept; ``PERF.md`` §6 has their times.

No caller differentiates at head_dim 512, so the backward wrappers raise
there on any device.

``flash_fwd_stats`` / ``flash_bwd_stats`` (K5) are the JAX package's
stats-level entry points over the same ops, for ring attention
(``ops/ring_attention.py``): the forward returns the row logsumexp, the
backward takes a global (out, lse) and a KV shard. As in JAX, they name
nothing.

Layout: q (B, Sq, H, D), k and v (B, Skv, H, D), as the callers hold them;
the kernels index that layout directly, so nothing is transposed or padded
(the TPU's "folded" (B, S, H*D) layout is the same memory). The row
logsumexp is (B*H, Sq) fp32. No gradient flows through it.

A wrapper launches its kernel for CUDA tensors and raises on what the
kernels do not take (any other head dim or dtype among them, and a tensor
whose data does not start on a 16-byte boundary); it runs the plain
PyTorch version only for CPU tensors. ``LAUNCHES`` counts kernel launches
per kernel, ``STATS_LAUNCHES`` the K5 entry points' calls that launched.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .remat import kept, producing

ROLES = ("forward", "dq", "dkv")
_SM90, _FP32 = "flash_attention_sm90", "flash_attention_fp32"
# (kernel name, CUDA source) by (head dim, dtype), one per role (None: no
# kernel). The kernel's C entry point is "aozora_<name>" in the library
# built from csrc/<source>.cu.
ROUTES = {
    (64, torch.bfloat16): (("flash_fwd", _SM90), ("flash_bwd_dq", _SM90),
                           ("flash_bwd_dkv", _SM90)),                               # K1-K3
    (128, torch.bfloat16): (("flash_fwd_d128", _SM90), ("flash_bwd_dq_d128", _SM90),
                            ("flash_bwd_dkv_d128", _SM90)),                         # K4a/K4b
    (512, torch.bfloat16): (("flash_fwd_d512", _SM90), None, None),                 # K4a
    (64, torch.float16): (("flash_fwd_f16", _SM90), ("flash_bwd_dq_f16", _SM90),
                          ("flash_bwd_dkv_f16", _SM90)),
    (128, torch.float16): (("flash_fwd_f16_d128", _SM90), ("flash_bwd_dq_f16_d128", _SM90),
                           ("flash_bwd_dkv_f16_d128", _SM90)),
    (64, torch.float32): (("flash_fwd_f32_d64", _FP32), ("flash_bwd_dq_f32_d64", _FP32),
                          ("flash_bwd_dkv_f32_d64", _FP32)),
    (128, torch.float32): (("flash_fwd_f32_d128", _FP32), ("flash_bwd_dq_f32_d128", _FP32),
                           ("flash_bwd_dkv_f32_d128", _FP32)),
    (512, torch.float32): (("flash_fwd_f32_d512", _FP32), None, None),
}
HEAD_DIMS = (64, 128, 512)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
SOURCES = dict(kernel for kernels in ROUTES.values() for kernel in kernels if kernel)
_ROLE_OF = {kernel[0]: i for kernels in ROUTES.values()
            for i, kernel in enumerate(kernels) if kernel}
LAUNCHES = dict.fromkeys(SOURCES, 0)
STATS_LAUNCHES = {"flash_fwd_stats": 0, "flash_bwd_stats": 0}
# entry-point argument types by role: forward, dQ, dK/dV
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P])
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, STATS_LAUNCHES):
        for name in counts:
            counts[name] = 0


def route(head_dim: int, dtype: torch.dtype, role: str) -> tuple[str, str]:
    """(kernel name, CUDA source) that a wrapper launches for ``role``
    ("forward", "dq" or "dkv") on CUDA tensors of ``head_dim`` and
    ``dtype``. Raises ValueError for a head dim with no kernels, TypeError
    for a dtype other than bfloat16, float16 and float32 and for float16 at
    head_dim 512 (not ported: no fp16 path reaches it), and
    NotImplementedError for the backward at head_dim 512."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash attention: head_dim {head_dim}; expected one "
                         f"of {list(HEAD_DIMS)}")
    if dtype not in DTYPES:
        raise TypeError(f"flash attention: dtype {dtype}; the kernels take "
                        "bfloat16, float16 or float32")
    if (head_dim, dtype) not in ROUTES:
        raise TypeError(f"flash attention: {dtype} at head_dim {head_dim} is not "
                        "ported (no kernel; the SD-VAE's head_dim-512 attention "
                        "runs in bfloat16 or float32)")
    kernel = ROUTES[head_dim, dtype][ROLES.index(role)]
    if kernel is None:
        _require_backward(head_dim)
    return kernel


def _library(source: str) -> ctypes.CDLL:
    """The built library of ``csrc/<source>.cu`` with the argument types of
    its kernels' entry points and of its error-string function set."""
    lib = _libs.get(source)
    if lib is None:
        lib = cuda_build.load(source)
        for name, src in SOURCES.items():
            if src == source:
                fn = getattr(lib, f"aozora_{name}")
                fn.argtypes = _ARGTYPES[_ROLE_OF[name]]
                fn.restype = _I
        lib.aozora_flash_error_string.argtypes = [_I]
        lib.aozora_flash_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def _launch(name: str, *args) -> None:
    lib = _library(SOURCES[name])
    code = getattr(lib, f"aozora_{name}")(*args)
    if code != 0:
        msg = lib.aozora_flash_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")
    LAUNCHES[name] += 1


def _require_backward(head_dim: int) -> None:
    """The backward exists only where the JAX package differentiates: it
    raises at a head dim whose routes have no backward (512) on any device,
    before any launch."""
    if head_dim in HEAD_DIMS and ROUTES[head_dim, torch.bfloat16][1] is None:
        raise NotImplementedError(
            f"flash attention backward at head_dim {head_dim}: no caller "
            "differentiates there (the SD-VAE mid-attention runs forward "
            "only), so it has no kernel")


def _check_cuda_inputs(q, k, v, role: str) -> str:
    """Checks what the kernels take; returns the kernel ``route`` picks for
    ``role``."""
    if q.dim() != 4:
        raise ValueError(f"flash attention: q has shape {tuple(q.shape)}; "
                         "expected (B, S, H, D)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash attention: {name} is on {t.device}, "
                             "expected the CUDA device of q")
        if t.dtype not in DTYPES:
            raise TypeError(f"flash attention: {name} has dtype {t.dtype}; "
                            "the kernels take bfloat16, float16 or float32")
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
        _check_aligned(name, t)
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
    return route(q.shape[-1], q.dtype, role)[0]


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """The kernels read and write rows with 16-byte vector accesses."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} does not start on a "
                         f"16-byte boundary (data_ptr {t.data_ptr():#x}); the "
                         "kernels' 16-byte loads need it")


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
        if name not in ("lse", "delta"):
            _check_aligned(name, t)


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
    name = _check_cuda_inputs(q, k, v, "forward")
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, k.shape[1], float(scale), _stream(q))
    return out, lse


def flash_bwd_dq(q, k, v, out, lse, dout, scale: float):
    """K2 / K4b dq: (dq, delta). The kernel also writes delta =
    rowsum(dO * O)."""
    _require_backward(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, out, lse, dout, scale)
    name = _check_cuda_inputs(q, k, v, "dq")
    _check_rows(q, lse, out=out, dout=dout)
    b, sq, h, _ = q.shape
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h,
            sq, k.shape[1], float(scale), _stream(q))
    return dq, delta


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale: float):
    """K3 / K4b dkv: (dk, dv) from the saved lse and the dq kernel's
    delta."""
    _require_backward(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale)
    name = _check_cuda_inputs(q, k, v, "dkv")
    _check_rows(q, lse, delta=delta, dout=dout)
    b, sq, h, _ = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq,
            k.shape[1], float(scale), _stream(q))
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, scale: float):
    """The dq kernel then the dk/dv kernel: (dq, dk, dv)."""
    dq, delta = flash_bwd_dq(q, k, v, out, lse, dout, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------
# Dispatcher ops (what autograd and the remat policies see)
# --------------------------------------------------------------------------

@torch.library.custom_op("aozora::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 / K4a on CUDA tensors, the plain version on the CPU."""
    return flash_fwd(q, k, v, scale)


@torch.library.custom_op("aozora::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2/K3 / K4b on CUDA tensors, the plain version on the CPU."""
    return flash_bwd(q, k, v, out, lse, dout, scale)


class _Flash(torch.autograd.Function):
    """(out, lse) = attention(q, k, v): the ``aozora::flash_fwd`` op, made
    inside ``producing("flash_out", "flash_lse")``, or the ``cached`` pair
    a Conservative region kept; lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, cached):
        if cached is None:
            with producing("flash_out", "flash_lse"):
                out, lse = torch.ops.aozora.flash_fwd(q, k, v, scale)
        else:
            out, lse = cached
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        _require_backward(q.shape[-1])
        dq, dk, dv = torch.ops.aozora.flash_bwd(q, k, v, out, lse,
                                                dout.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


class FlashAttention:
    """The flash entry: (out, lse) = attention(q, k, v), its outputs named
    "flash_out" and "flash_lse" (the JAX package's ``_flash_core``). A remat
    region whose policy keeps the names keeps them (``ops/remat.py``), and
    its recompute launches no forward kernel."""

    @staticmethod
    def apply(q, k, v, scale):
        return kept(("flash_out", "flash_lse"),
                    lambda cached: _Flash.apply(q, k, v, scale, cached))


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


# --------------------------------------------------------------------------
# K5: stats-level entry points (ring attention)
# --------------------------------------------------------------------------

def _lse3(lse, b: int, h: int, sq: int):
    """(B*H, Sq) -> the entry points' (B, Sq, H)."""
    return lse.reshape(b, h, sq).permute(0, 2, 1)


def _lse_rows(lse3):
    """(B, Sq, H) -> the kernels' contiguous fp32 (B*H, Sq)."""
    b, sq, h = lse3.shape
    return lse3.permute(0, 2, 1).reshape(b * h, sq).float().contiguous()


def flash_fwd_stats_reference(q, k, v, scale: float):
    """Plain version of ``flash_fwd_stats``."""
    b, sq, h, _ = q.shape
    out, lse = flash_forward_reference(q, k, v, scale)
    return out, _lse3(lse, b, h, sq)


def flash_bwd_stats_reference(q, k, v, out, lse3, do, scale: float):
    """Plain version of ``flash_bwd_stats``."""
    lse = _lse_rows(lse3)
    dq, delta = flash_bwd_dq_reference(q, k, v, out, lse, do, scale)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale))


def flash_fwd_stats(q, k, v, *, scale: float | None = None):
    """Forward kernel only: (out (B,Sq,H,D), lse (B,Sq,H) fp32).

    No autograd: the caller (ring attention) owns the backward and needs
    the log-sum-exp to merge KV-shard partials exactly."""
    b, sq, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    out, lse = torch.ops.aozora.flash_fwd(q, k, v, scale)
    if q.device.type != "cpu":
        STATS_LAUNCHES["flash_fwd_stats"] += 1
    return out, _lse3(lse, b, h, sq)


def flash_bwd_stats(q, k, v, out, lse3, do, *, scale: float | None = None):
    """Backward kernels from precomputed global statistics: (dq, dk, dv).

    ``out``/``lse3`` are the GLOBAL attention output and log-sum-exp for
    these q rows ((B,Sq,H,D) / (B,Sq,H) fp32); k/v may be a shard of the
    keys, and the result is then that shard's exact contribution. The dQ
    kernel takes delta = rowsum(dO * O) from the global ``out``, as the
    JAX package's backward does."""
    _require_backward(q.shape[-1])
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    out, do = out.to(q.dtype).contiguous(), do.to(q.dtype).contiguous()
    grads = torch.ops.aozora.flash_bwd(q, k, v, out, _lse_rows(lse3), do, scale)
    if q.device.type != "cpu":
        STATS_LAUNCHES["flash_bwd_stats"] += 1
    return grads
