"""Qwen3-0.6B text encoder in PyTorch: the Anima caption tower.

Counterpart of ``aozora_sdxl_training_tpu/models/anima/qwen3.py``, with the
same graph and numerics: 28 layers, hidden 1024, GQA with 16 query and 8
KV heads of head_dim 128, per-head q/k RMSNorm before HF rotate-half RoPE
(fp32 tables, theta 1e6), SwiGLU MLP (intermediate 3072), RMSNorm eps 1e-6,
and causal attention under the padding mask (-1e30 before an fp32
softmax). The output is the last decoder layer's, *before* the model-level
final norm: the Anima pipeline's ``hidden_states[-1]`` at 512 tokens.

* Parameters are a flat ``{HF name: tensor}`` dict in torch layout (linear
  (out, in), the embedding (vocab, hidden)), so an HF checkpoint loads with
  a shape check; ``params_from_jax`` transposes the JAX package's (in, out)
  linear weights.
* Statistics (norms, softmax) run in fp32, or in the compute dtype where
  it is wider (float64 for a reference run).
* Attention is an einsum, as in the JAX package: no Pallas kernel runs here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..sdxl.conversion import to_tensor
from .dit import embedding_lookup

Params = dict[str, torch.Tensor]

EMBED = "model.embed_tokens.weight"


@dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0


QWEN3_0_6B = Qwen3Config()

TINY_QWEN3 = Qwen3Config(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=16,
                         intermediate_size=128, rope_theta=10000.0)


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _rms_norm(weight, x, eps: float):
    xf = x.to(_stat_dtype(x.dtype))
    norm = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * norm * weight.to(xf.dtype)).to(x.dtype)


def _linear(params: Params, name: str, x):
    return F.linear(x, params[f"{name}.weight"].to(x.dtype))


def _rope_tables(seq_len: int, head_dim: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    ang = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope(x, cos, sin):
    """HF rotate-half convention; x: (B, S, H, D)."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return (x * cos[None, :, None, :] + rot * sin[None, :, None, :]).to(x.dtype)


def qwen3_forward(params: Params, token_ids, attention_mask, cfg: Qwen3Config,
                  *, compute_dtype=torch.float32):
    """token_ids: (B, S) int; attention_mask: (B, S) bool/int or None.

    Returns the final decoder layer's output (B, S, hidden), before the
    model-level final norm."""
    b, s = token_ids.shape
    # ids past the vocabulary (the hash tokenizer's reach 49407) read its last row
    x = embedding_lookup(params[EMBED], token_ids).to(compute_dtype)
    cos, sin = _rope_tables(s, cfg.head_dim, cfg.rope_theta, x.device)

    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
    if attention_mask is not None:
        mask = mask & attention_mask.to(torch.bool)[:, None, None, :]

    rep = cfg.num_heads // cfg.num_kv_heads
    stat = _stat_dtype(compute_dtype)
    eps = cfg.rms_norm_eps
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        h = _rms_norm(params[f"{p}.input_layernorm.weight"], x, eps)
        q = _linear(params, f"{p}.self_attn.q_proj", h).reshape(
            b, s, cfg.num_heads, cfg.head_dim)
        k = _linear(params, f"{p}.self_attn.k_proj", h).reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        v = _linear(params, f"{p}.self_attn.v_proj", h).reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        q = _apply_rope(_rms_norm(params[f"{p}.self_attn.q_norm.weight"], q, eps),
                        cos, sin)
        k = _apply_rope(_rms_norm(params[f"{p}.self_attn.k_norm.weight"], k, eps),
                        cos, sin)
        # each KV head serves ``rep`` consecutive query heads (h0 h0 h1 h1 ...)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(stat)
        logits = logits * (cfg.head_dim ** -0.5)
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            b, s, cfg.num_heads * cfg.head_dim)
        x = x + _linear(params, f"{p}.self_attn.o_proj", attn)

        h = _rms_norm(params[f"{p}.post_attention_layernorm.weight"], x, eps)
        gate = F.silu(_linear(params, f"{p}.mlp.gate_proj", h))
        up = _linear(params, f"{p}.mlp.up_proj", h)
        x = x + _linear(params, f"{p}.mlp.down_proj", gate * up)
    return x


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def param_shapes(cfg: Qwen3Config) -> dict[str, tuple[int, ...]]:
    """Torch-layout shapes: linear weights (out, in), the embedding
    (vocab, hidden)."""
    d, hd = cfg.hidden_size, cfg.head_dim
    qd = cfg.num_heads * hd
    kvd = cfg.num_kv_heads * hd
    shapes = {EMBED: (cfg.vocab_size, d), "model.norm.weight": (d,)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        shapes[f"{p}.input_layernorm.weight"] = (d,)
        shapes[f"{p}.post_attention_layernorm.weight"] = (d,)
        shapes[f"{p}.self_attn.q_proj.weight"] = (qd, d)
        shapes[f"{p}.self_attn.k_proj.weight"] = (kvd, d)
        shapes[f"{p}.self_attn.v_proj.weight"] = (kvd, d)
        shapes[f"{p}.self_attn.o_proj.weight"] = (d, qd)
        shapes[f"{p}.self_attn.q_norm.weight"] = (hd,)
        shapes[f"{p}.self_attn.k_norm.weight"] = (hd,)
        shapes[f"{p}.mlp.gate_proj.weight"] = (cfg.intermediate_size, d)
        shapes[f"{p}.mlp.up_proj.weight"] = (cfg.intermediate_size, d)
        shapes[f"{p}.mlp.down_proj.weight"] = (d, cfg.intermediate_size)
    return shapes


def init_params(cfg: Qwen3Config, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """Random init: unit norm scales, N(0, 1/fan_in) matrices (the
    embedding's fan-in is its vocabulary, as in the JAX package), drawn in
    sorted name order from ``generator`` (on ``device``)."""
    device = generator.device if device is None else torch.device(device)
    params: Params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if len(shape) == 1:
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = shape[0] if name == EMBED else shape[1]
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * (1.0 / max(fan_in, 1)) ** 0.5
            params[name] = w.to(dtype)
    return params


def params_from_torch_state(state: dict, cfg: Qwen3Config, dtype=torch.float32,
                            device=None) -> Params:
    """HF-named tensors (numpy or torch, torch layout) -> the port's param
    dict, with a shape check."""
    params: Params = {}
    missing = []
    for name, want in param_shapes(cfg).items():
        if name not in state:
            missing.append(name)
            continue
        t = to_tensor(state[name])
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {want}")
        params[name] = t.to(device=device, dtype=dtype)
    if missing:
        raise ValueError(f"Qwen3 checkpoint missing {len(missing)} tensors, "
                         f"e.g. {missing[:5]}")
    return params


def params_from_jax(flat_numpy_params: dict, dtype=torch.float32,
                    device=None) -> Params:
    """The JAX package's Qwen3 params (numpy, linear weights (in, out)) in
    the port's torch layout (the embedding as it is)."""
    out: Params = {}
    for name, arr in flat_numpy_params.items():
        a = np.asarray(arr, np.float32)
        if a.ndim == 2 and name != EMBED:
            a = a.T
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                                dtype=dtype)
    return out


def detect_config(state: dict) -> Qwen3Config:
    """The tower's size from checkpoint shapes (torch layout). No rope theta
    is read: it stays 1e6."""
    d = int(state[EMBED].shape[1])
    vocab = int(state[EMBED].shape[0])
    n = 0
    while f"model.layers.{n}.input_layernorm.weight" in state:
        n += 1
    hd = int(state["model.layers.0.self_attn.q_norm.weight"].shape[0])
    q_out = int(state["model.layers.0.self_attn.q_proj.weight"].shape[0])
    kv_out = int(state["model.layers.0.self_attn.k_proj.weight"].shape[0])
    inter = int(state["model.layers.0.mlp.gate_proj.weight"].shape[0])
    return Qwen3Config(vocab_size=vocab, hidden_size=d, num_layers=n,
                       num_heads=q_out // hd, num_kv_heads=kv_out // hd,
                       head_dim=hd, intermediate_size=inter)
