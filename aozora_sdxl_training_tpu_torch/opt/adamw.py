"""Raven-semantics AdamW (the reference's "Raven/Titan" math) in PyTorch.

Counterpart of ``aozora_sdxl_training_tpu/opt/adamw.py``, keeping the math
that shapes training curves:

* partial bias correction: ``bc = 1 - (1 - bc) * debias_strength``;
* decoupled weight decay applied as ``p *= 1 - lr * wd`` *before* the Adam
  update;
* moments stored in a configurable dtype (bf16 default) while the update
  itself is fp32, for any parameter storage dtype;
* ``int8_blockwise`` moments (``paged_adamw_8bit``): int8 codes with one
  fp32 absmax scale per 256 elements, the second moment in the sqrt
  domain, and fp32 moments for tensors under ``min_8bit_size``.

Unlike the JAX version, parameters and moments are updated in place (one
tensor's fp32 scratch alive at a time), which keeps the port's memory at
parameters + moments.

The JAX package lays a conv out HWIO and a linear (in, out), the port OIHW
and (out, in). An int8 moment's blocks run over the tensor's flat order, so
its codes are kept in the JAX package's layout (``Layout``: the model's
``to_jax_layout`` and ``from_jax_layout``) and come out code for code as
the JAX package's; the fp32 moment is viewed in that layout to be
quantized and back after it is dequantized.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


INT8_BLOCK = 256  # elements per quantization block for int8 moment storage


class Layout(NamedTuple):
    """How the JAX package lays out each parameter: ``to_jax(name, t)``
    views a tensor of the port's layout in the JAX package's, ``from_jax``
    is its inverse."""
    to_jax: Callable[[str, torch.Tensor], torch.Tensor]
    from_jax: Callable[[str, torch.Tensor], torch.Tensor]


def _same(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


SAME_LAYOUT = Layout(_same, _same)


@dataclass(frozen=True)
class AdamWConfig:
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    debias_strength: float = 0.3
    # a torch dtype, or the string "int8_blockwise" for 8-bit moments with
    # per-256-element fp32 absmax scales
    momentum_dtype: Any = torch.bfloat16
    # tensors smaller than this keep fp32 moments under int8_blockwise
    min_8bit_size: int = 4096

    @property
    def int8_state(self) -> bool:
        return self.momentum_dtype == "int8_blockwise"

    def int8_for(self, n_elements: int) -> bool:
        """Whether a tensor of ``n_elements`` gets int8-quantized moments."""
        return self.int8_state and int(n_elements) >= int(self.min_8bit_size)

    @classmethod
    def from_params_dict(cls, raw: dict) -> "AdamWConfig":
        name = str(raw.get("momentum_dtype", "bfloat16"))
        dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32,
                 "int8": "int8_blockwise",
                 "int8_blockwise": "int8_blockwise"}.get(name, torch.bfloat16)
        return cls(
            betas=tuple(raw.get("betas", (0.9, 0.999))),
            eps=float(raw.get("eps", 1e-8)),
            weight_decay=float(raw.get("weight_decay", 0.01)),
            debias_strength=float(raw.get("debias_strength", 1.0)),
            momentum_dtype=dtype,
            min_8bit_size=int(raw.get("min_8bit_size", 4096)),
        )


def _int8_blocks(n: int) -> int:
    return -(-n // INT8_BLOCK)


def quantize_moment_int8(m32: torch.Tensor):
    """fp32 tensor -> (int8 codes [same shape], fp32 scales [n_blocks]):
    256-element blocks over the flat order, each block's absmax (over its
    zero padding too) / 127 as its scale, codes rounded half to even."""
    flat = m32.reshape(-1)
    n = flat.numel()
    nb = _int8_blocks(n)
    blocks = F.pad(flat, (0, nb * INT8_BLOCK - n)).view(nb, INT8_BLOCK)
    scales = torch.clamp(blocks.abs().amax(dim=1), min=1e-30) / 127.0
    codes = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return (codes.view(-1)[:n].reshape(m32.shape).to(torch.int8),
            scales.float())


def dequantize_moment_int8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    flat = codes.reshape(-1).float()
    nb = scales.shape[0]
    out = F.pad(flat, (0, nb * INT8_BLOCK - flat.numel())).view(nb, INT8_BLOCK)
    out = out * scales[:, None]
    return out.view(-1)[: flat.numel()].reshape(codes.shape)


def quantize_second_moment_int8(v32: torch.Tensor):
    """Second moments quantize in the sqrt domain: v spans ~6 orders of
    magnitude within a block, sqrt(v) only ~3."""
    return quantize_moment_int8(torch.sqrt(torch.clamp(v32, min=0.0)))


def dequantize_second_moment_int8(codes: torch.Tensor, scales: torch.Tensor):
    root = dequantize_moment_int8(codes, scales)
    return root * root


@dataclass
class AdamWState:
    step: int                       # shared across params
    exp_avg: dict                   # {name: tensor} in momentum_dtype, or
    exp_avg_sq: dict                # {name: (int8 codes, fp32 scales)}
    # the layout of the int8 codes (the JAX package's); float moments are
    # in the port's layout
    layout: Layout = SAME_LAYOUT


def _moment_storage(name: str, p: torch.Tensor, cfg: AdamWConfig,
                    layout: Layout):
    """(shape, dtype) of one moment of ``p``: int8 codes in the JAX
    layout's shape, or the parameter's shape in the moment dtype."""
    if cfg.int8_for(p.numel()):
        return tuple(layout.to_jax(name, p).shape), torch.int8
    return tuple(p.shape), (torch.float32 if cfg.int8_state else cfg.momentum_dtype)


def init_state(params: dict, cfg: AdamWConfig, layout: Layout = SAME_LAYOUT) -> AdamWState:
    """Zero moments; an int8 moment is (zero codes, scales of 1e-30)."""
    def zeros():
        out = {}
        for name, p in params.items():
            shape, dtype = _moment_storage(name, p, cfg, layout)
            out[name] = torch.zeros(shape, dtype=dtype, device=p.device)
            if dtype == torch.int8:
                out[name] = (out[name], torch.full(
                    (_int8_blocks(p.numel()),), 1e-30, dtype=torch.float32,
                    device=p.device))
        return out
    return AdamWState(step=0, exp_avg=zeros(), exp_avg_sq=zeros(), layout=layout)


def restored_state(host: AdamWState, params: dict, cfg: AdamWConfig) -> AdamWState:
    """A state read from a file (host tensors, keyed like ``params``) on
    the parameters' device, one moment at a time: float moments in the
    dtype ``init_state`` gives them, int8 codes and scales as they are.
    Raises when a moment's storage (int8 or float, and its shape) is not
    what ``cfg`` asks for that parameter."""
    def move(name, value, p):
        shape, dtype = _moment_storage(name, p, cfg, host.layout)
        int8 = dtype == torch.int8
        got = tuple((value[0] if isinstance(value, tuple) else value).shape)
        if isinstance(value, tuple) != int8 or got != shape:
            raise ValueError(
                f"resume state: the moment of {name} ({got}) does not fit the "
                f"optimizer ({'int8 codes' if int8 else dtype} of shape "
                f"{shape} for momentum dtype {cfg.momentum_dtype})")
        if int8:
            return tuple(t.to(p.device) for t in value)
        return value.to(device=p.device, dtype=dtype).contiguous()

    return AdamWState(
        step=int(host.step), layout=host.layout,
        exp_avg={n: move(n, host.exp_avg[n], p) for n, p in params.items()},
        exp_avg_sq={n: move(n, host.exp_avg_sq[n], p) for n, p in params.items()})


def _step_scalars(cfg: AdamWConfig, step: int, lr: float):
    """fp32 scalars as the JAX update computes them."""
    f32 = np.float32
    beta1, beta2 = cfg.betas
    bc1 = f32(1.0) - f32(np.power(np.float64(f32(beta1)), step))
    bc2 = f32(1.0) - f32(np.power(np.float64(f32(beta2)), step))
    if cfg.debias_strength < 1.0:
        bc1 = f32(1.0) - (f32(1.0) - bc1) * f32(cfg.debias_strength)
        bc2 = f32(1.0) - (f32(1.0) - bc2) * f32(cfg.debias_strength)
    step_size = f32(lr) / bc1
    wd_factor = f32(1.0) - f32(lr) * f32(cfg.weight_decay)
    return float(step_size), float(np.sqrt(bc2)), float(wd_factor)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: AdamWState,
                  cfg: AdamWConfig, *, lr: float, release: bool = False):
    """One in-place AdamW step with Raven debias semantics. With
    ``release``, each gradient leaves ``grads`` once its tensor is updated
    (it is freed there when ``grads`` held its last reference).

    Returns (params, state, update_sq): ``update_sq`` is the squared global
    L2 norm of the fp32 parameter delta, as a 0-d fp32 tensor."""
    beta1, beta2 = cfg.betas
    state.step += 1
    step_size, sqrt_bc2, wd_factor = _step_scalars(cfg, state.step, lr)
    update_sq = None
    to_jax, from_jax = state.layout
    for name, p in params.items():
        g32 = (grads.pop(name) if release else grads[name]).float()
        m, v = state.exp_avg[name], state.exp_avg_sq[name]
        int8_here = cfg.int8_for(p.numel())
        if int8_here:
            m32 = from_jax(name, dequantize_moment_int8(*m))
            v32 = from_jax(name, dequantize_second_moment_int8(*v))
        else:
            m32, v32 = m.float(), v.float()
        m32 = m32 * beta1 + g32 * (1.0 - beta1)
        v32 = v32 * beta2 + g32 * g32 * (1.0 - beta2)
        p32_orig = p.float()
        p32 = p32_orig * wd_factor if cfg.weight_decay != 0.0 else p32_orig
        p32 = p32 - step_size * m32 / (torch.sqrt(v32) / sqrt_bc2 + cfg.eps)
        usq = ((p32 - p32_orig) ** 2).sum()
        update_sq = usq if update_sq is None else update_sq + usq
        p.copy_(p32)
        if int8_here:
            for held, new in zip((*m, *v), (
                    *quantize_moment_int8(to_jax(name, m32)),
                    *quantize_second_moment_int8(to_jax(name, v32)))):
                held.copy_(new)
        else:
            m.copy_(m32)
            v.copy_(v32)
    if update_sq is None:
        update_sq = torch.zeros((), dtype=torch.float32)
    return params, state, update_sq


def global_grad_norm(grads: dict) -> torch.Tensor:
    sq = None
    for g in grads.values():
        s = (g.float() ** 2).sum()
        sq = s if sq is None else sq + s
    return torch.sqrt(sq) if sq is not None else torch.zeros(())


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales ``grads`` in place; returns (grads, raw_norm as a 0-d tensor).
    max_norm <= 0 disables clipping."""
    norm = global_grad_norm(grads)
    if max_norm is None or max_norm <= 0:
        return grads, norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, norm
