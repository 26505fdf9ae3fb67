"""Functional SDXL UNet forward pass in PyTorch.

Counterpart of ``aozora_sdxl_training_tpu/models/sdxl/unet.py``, with the
same graph and the same numerics choices:

* parameters are a flat ``{diffusers_name: tensor}`` dict, in torch layout
  (conv OIHW, linear (out, in));
* ``unet_forward`` takes and returns NHWC latents like the JAX function;
  inside, activations are NCHW for ``F.conv2d``;
* compute runs in ``compute_dtype`` (bf16 by default); GroupNorm and
  LayerNorm statistics are fp32, GroupNorm eps is 1e-5 in resnets and 1e-6
  in the transformer2d norm, the GEGLU uses the exact erf GELU, the time
  embedding is ``[cos | sin]``, and the up path concatenates ``[x, skip]``;
* ``remat`` wraps each resnet and transformer unit in
  ``torch.utils.checkpoint`` (the JAX ``_maybe_remat`` units): True/"full"
  recomputes it all; "dots", "dots_no_batch" and "dots_no_logits" keep
  what the JAX policies of those names keep (``ops/remat.py``); a
  ``_hires`` suffix applies the mode only to units at or above
  ``AOZORA_REMAT_HIRES_TOKENS`` latent tokens (default 4160) and full
  remat at or above ``AOZORA_REMAT_FULL_TOKENS``, or at the planner's
  ``remat_thresholds`` (``unit_remat``);
* ``fused_gn`` (False by default, as in JAX; no trainer sets it) sends the
  resnets' norm1/norm2 + SiLU through ``ops.groupnorm_silu``'s NCHW entry
  (K6 on the card, its plain version on the CPU), SiLU in fp32 and one cast;
* attention dispatches through ``ops.attention`` (einsum or the flash
  kernels);
* ``tp`` (a ``parallel.tensor_parallel.TPConfig``, or None) runs the
  transformer blocks' attention and GEGLU feed-forward as Megatron column
  and row splits over the tp ranks, on the tp slices that ``params`` then
  holds: q/k/v and the GEGLU projection column-parallel (a layer whose
  heads tp does not divide gathers q/k/v and runs its heads whole),
  ``to_out.0`` and ``ff.net.2`` row-parallel, their biases added once after
  the reduce.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.groupnorm_silu import group_norm_silu_nchw
from ...ops.remat import remat as remat_region
from .arch import UNetConfig, param_shapes

Params = dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# Primitive layers
# --------------------------------------------------------------------------

def _w(params: Params, name: str, dtype) -> torch.Tensor:
    return params[name].to(dtype)


def _bias(params: Params, name: str, dtype):
    bias = params.get(f"{name}.bias")
    return None if bias is None else bias.to(dtype)


def conv2d(params: Params, name: str, x, *, stride: int = 1):
    """NCHW conv with torch-style symmetric padding (3x3 -> 1, 1x1 -> 0)."""
    kernel = _w(params, f"{name}.weight", x.dtype)
    return F.conv2d(x, kernel, _bias(params, name, x.dtype), stride=stride,
                    padding=kernel.shape[-1] // 2)


def linear(params: Params, name: str, x):
    return F.linear(x, _w(params, f"{name}.weight", x.dtype),
                    _bias(params, name, x.dtype))


def group_norm(params: Params, name: str, x, *, groups: int,
               eps: float = 1e-5):
    """NCHW GroupNorm with fp32 statistics."""
    y = F.group_norm(x.float(), groups, params[f"{name}.weight"].float(),
                     params[f"{name}.bias"].float(), eps)
    return y.to(x.dtype)


def layer_norm(params: Params, name: str, x, *, eps: float = 1e-5):
    y = F.layer_norm(x.float(), (x.shape[-1],), params[f"{name}.weight"].float(),
                     params[f"{name}.bias"].float(), eps)
    return y.to(x.dtype)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, diffusers convention (flip_sin_to_cos=True,
    downscale_freq_shift=0): output = [cos | sin]. fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _gn_silu(params: Params, name: str, x, groups: int, fused: bool):
    """silu(group_norm(x)) at eps 1e-5; ``fused``: through the fused op's
    NCHW entry. The resnets' inputs keep the channels-last memory that
    cuDNN carries over from the NHWC sample, and the kernel takes contiguous
    NCHW: such an input is made contiguous first, as torch's own GroupNorm
    does on CUDA, so the convolutions see the same memory formats on both
    routes."""
    if fused:
        return group_norm_silu_nchw(x.contiguous(), params[f"{name}.weight"],
                                    params[f"{name}.bias"], groups=groups, use_pallas=True)
    return F.silu(group_norm(params, name, x, groups=groups))


def resnet_block(params: Params, prefix: str, x, temb, *, groups: int,
                 fused_gn: bool = False):
    h = conv2d(params, f"{prefix}.conv1",
               _gn_silu(params, f"{prefix}.norm1", x, groups, fused_gn))
    t = linear(params, f"{prefix}.time_emb_proj", F.silu(temb))
    h = h + t[:, :, None, None].to(h.dtype)
    h = conv2d(params, f"{prefix}.conv2",
               _gn_silu(params, f"{prefix}.norm2", h, groups, fused_gn))
    if f"{prefix}.conv_shortcut.weight" in params:
        x = conv2d(params, f"{prefix}.conv_shortcut", x)
    return x + h


def _attention_layer(params: Params, prefix: str, x, context, num_heads: int,
                     attn_impl: str, tp=None):
    b, s, c = x.shape
    d = c // num_heads
    sk = context.shape[1]
    split = tp is not None and tp.splits(f"{prefix}.to_q.weight")
    heads = num_heads
    if split:
        # column-parallel q/k/v: this rank's heads (or columns)
        x_in = tp.copy(x)
        context = x_in if context is x else tp.copy(context)
        x, heads = x_in, tp.heads(num_heads)
    q = linear(params, f"{prefix}.to_q", x)
    k = linear(params, f"{prefix}.to_k", context)
    v = linear(params, f"{prefix}.to_v", context)
    if split:
        q, k, v = tp.qkv(heads, num_heads, q, k, v)
    o = attention(q.reshape(b, s, heads, d), k.reshape(b, sk, heads, d),
                  v.reshape(b, sk, heads, d), impl=attn_impl).reshape(b, s, heads * d)
    if not split:
        return linear(params, f"{prefix}.to_out.0", o)
    return tp.attention_out(heads, num_heads, o, params[f"{prefix}.to_out.0.weight"],
                            params.get(f"{prefix}.to_out.0.bias"))


def _feed_forward(params: Params, prefix: str, x, tp=None):
    proj = f"{prefix}.net.0.proj"
    if tp is None or not tp.splits(f"{proj}.weight"):
        h, gate = linear(params, proj, x).chunk(2, dim=-1)
        return linear(params, f"{prefix}.net.2", h * F.gelu(gate))
    # this rank's slice holds h_i and gate_i (the halves cut by tp)
    h, gate = linear(params, proj, tp.copy(x)).chunk(2, dim=-1)
    return tp.row(h * F.gelu(gate), params[f"{prefix}.net.2.weight"],
                  params.get(f"{prefix}.net.2.bias"))


def transformer_block(params: Params, prefix: str, x, context, *,
                      num_heads: int, attn_impl: str, tp=None):
    h = layer_norm(params, f"{prefix}.norm1", x)
    x = x + _attention_layer(params, f"{prefix}.attn1", h, h, num_heads,
                             attn_impl, tp)
    x = x + _attention_layer(params, f"{prefix}.attn2",
                             layer_norm(params, f"{prefix}.norm2", x),
                             context, num_heads, attn_impl, tp)
    return x + _feed_forward(params, f"{prefix}.ff",
                             layer_norm(params, f"{prefix}.norm3", x), tp)


def transformer2d(params: Params, prefix: str, x, context, *, depth: int,
                  num_heads: int, groups: int, attn_impl: str, tp=None):
    b, c, h, w = x.shape
    residual = x
    # diffusers Transformer2DModel uses GroupNorm eps=1e-6 (resnets use 1e-5)
    hidden = group_norm(params, f"{prefix}.norm", x, groups=groups, eps=1e-6)
    hidden = hidden.permute(0, 2, 3, 1).reshape(b, h * w, c)
    hidden = linear(params, f"{prefix}.proj_in", hidden)
    for k in range(depth):
        hidden = transformer_block(
            params, f"{prefix}.transformer_blocks.{k}", hidden, context,
            num_heads=num_heads, attn_impl=attn_impl, tp=tp)
    hidden = linear(params, f"{prefix}.proj_out", hidden)
    return hidden.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


# --------------------------------------------------------------------------
# Full forward
# --------------------------------------------------------------------------

def unit_remat(tokens: int, remat, remat_thresholds: tuple | None = None):
    """The remat mode of a resnet or transformer unit at ``tokens`` latent
    tokens (the JAX ``unet_forward``'s ``unit_remat``). Under a "<mode>_hires"
    mode, units below the hires threshold (``AOZORA_REMAT_HIRES_TOKENS``,
    default 4160: the 32x32 and 64x64 levels at 1024px) keep everything,
    units at or above the full threshold (``AOZORA_REMAT_FULL_TOKENS``,
    unset by default) recompute everything, the rest take <mode>;
    ``remat_thresholds`` (hires, full) from the planner overrides both."""
    if not remat or remat == "off":
        return False
    hires_only = isinstance(remat, str) and remat.endswith("_hires")
    base = remat[: -len("_hires")] if hires_only else remat
    hires_tokens = int(os.environ.get("AOZORA_REMAT_HIRES_TOKENS", "4160"))
    full_env = os.environ.get("AOZORA_REMAT_FULL_TOKENS", "").strip()
    full_tokens = int(full_env) if full_env else None
    if remat_thresholds is not None:
        hires_tokens, full_tokens = remat_thresholds
    if hires_only:
        if full_tokens is not None and tokens >= int(full_tokens):
            return True
        if tokens < hires_tokens:
            return False
    return base


def unet_forward(params: Params, sample, timesteps, encoder_hidden_states,
                 pooled_text_embeds, time_ids, *, cfg: UNetConfig,
                 attn_impl: str = "xla", compute_dtype=torch.bfloat16,
                 remat=False, remat_thresholds: tuple | None = None,
                 fused_gn: bool = False, tp=None):
    """SDXL UNet forward.

    sample: (B, H, W, C_in) NHWC latents.
    timesteps: (B,) float or int.
    encoder_hidden_states: (B, L, cross_attention_dim).
    pooled_text_embeds: (B, pooled_projection_dim).
    time_ids: (B, 6) SDXL micro-conditioning ids.
    Returns (B, H, W, C_out).
    """
    groups = cfg.norm_num_groups
    x = sample.to(compute_dtype).permute(0, 3, 1, 2)
    context = encoder_hidden_states.to(compute_dtype)

    # -- time + added conditioning (fp32 math, then cast) --
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
    temb = linear(params, "time_embedding.linear_1", temb)
    temb = linear(params, "time_embedding.linear_2", F.silu(temb))

    b = time_ids.shape[0]
    add_t = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
    add_t = add_t.reshape(b, cfg.num_time_ids * cfg.addition_time_embed_dim)
    add_emb = torch.cat([pooled_text_embeds.float(), add_t], dim=-1)
    add_emb = linear(params, "add_embedding.linear_1", add_emb)
    add_emb = linear(params, "add_embedding.linear_2", F.silu(add_emb))
    temb = (temb + add_emb).to(compute_dtype)

    def mode_of(h):
        return unit_remat(h.shape[2] * h.shape[3], remat, remat_thresholds)

    def res_fn(prefix, h):
        return remat_region(resnet_block, mode_of(h), params, prefix, h, temb,
                            groups=groups, fused_gn=fused_gn)

    def tf2d_fn(prefix, h, depth, heads):
        return remat_region(transformer2d, mode_of(h), params, prefix, h, context,
                            depth=depth, num_heads=heads, groups=groups,
                            attn_impl=attn_impl, tp=tp)

    # -- down path --
    x = conv2d(params, "conv_in", x)
    skips = [x]
    for i in range(cfg.num_blocks):
        for j in range(cfg.layers_per_block):
            x = res_fn(f"down_blocks.{i}.resnets.{j}", x)
            if cfg.has_cross_attn(i):
                x = tf2d_fn(f"down_blocks.{i}.attentions.{j}", x,
                            cfg.transformer_layers[i], cfg.num_heads[i])
            skips.append(x)
        if i < cfg.num_blocks - 1:
            x = conv2d(params, f"down_blocks.{i}.downsamplers.0.conv", x,
                       stride=2)
            skips.append(x)

    # -- mid --
    x = res_fn("mid_block.resnets.0", x)
    x = tf2d_fn("mid_block.attentions.0", x, cfg.mid_transformer_layers,
                cfg.num_heads[-1])
    x = res_fn("mid_block.resnets.1", x)

    # -- up path --
    rev_layers = list(reversed(cfg.transformer_layers))
    rev_heads = list(reversed(cfg.num_heads))
    for i in range(cfg.num_blocks):
        for j in range(cfg.layers_per_block + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = res_fn(f"up_blocks.{i}.resnets.{j}", x)
            if rev_layers[i] > 0:
                x = tf2d_fn(f"up_blocks.{i}.attentions.{j}", x,
                            rev_layers[i], rev_heads[i])
        if i < cfg.num_blocks - 1:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = conv2d(params, f"up_blocks.{i}.upsamplers.0.conv", x)

    # -- out --
    x = group_norm(params, "conv_norm_out", x, groups=groups)
    x = conv2d(params, "conv_out", F.silu(x))
    return x.permute(0, 2, 3, 1)


def torch_shape(shape: tuple[int, ...], kind: str) -> tuple[int, ...]:
    """``arch.param_shapes`` gives TPU layouts; this is the torch layout."""
    if kind == "conv" and len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])   # HWIO -> OIHW
    if kind == "linear" and len(shape) == 2:
        return (shape[1], shape[0])                       # (in,out) -> (out,in)
    return tuple(shape)


def init_params(cfg: UNetConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """Random init with correct shapes (testing / from-scratch training):
    zero biases, unit norm scales, N(0, 1/fan_in) weights, drawn in sorted
    name order from ``generator`` (on ``device``)."""
    device = generator.device if device is None else torch.device(device)
    params: Params = {}
    for name, (shape, kind) in sorted(param_shapes(cfg).items()):
        tshape = torch_shape(shape, kind)
        if name.endswith(".bias"):
            params[name] = torch.zeros(tshape, dtype=dtype, device=device)
        elif kind == "norm":
            params[name] = torch.ones(tshape, dtype=dtype, device=device)
        else:
            fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
            std = (1.0 / max(fan_in, 1)) ** 0.5
            w = torch.randn(tshape, generator=generator, dtype=torch.float32,
                            device=device) * std
            params[name] = w.to(dtype)
    return params
