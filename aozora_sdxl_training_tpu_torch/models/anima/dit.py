"""Anima DiT (Cosmos/Predict2-style video DiT) in PyTorch.

Counterpart of ``aozora_sdxl_training_tpu/models/anima/dit.py``, with the
same graph and the same numerics choices: 28 blocks x 2048 wide, 16 heads
(head_dim 128), patch 2x2x1, concat padding-mask channel, AdaLN-LoRA (dim
256) modulation, q/k RMSNorm, exact GELU, 3D RoPE with NTK h/w
extrapolation 4.0, and the trainable 6-layer LLM adapter mapping Qwen3
hidden states + raw T5 token ids to the 1024-d cross-attention context
padded to 512 tokens.

* Parameters are a flat ``{checkpoint_name: tensor}`` dict in torch layout
  (linear (out, in), embeddings (vocab, dim)), so a checkpoint loads with a
  shape check and ``params_from_jax`` transposes the JAX package's (in, out)
  linear weights (``from_jax_layout``; ``to_jax_layout`` is its inverse,
  which the training-state file and the int8 moments share).
* Activations are channel-last like the JAX function: latents (B, T, H, W,
  C), tokens (B, L, D).
* RMSNorm and LayerNorm statistics, RoPE and the timestep sinusoid are
  fp32; everything else runs in ``compute_dtype``.
* Attention dispatches through ``ops.attention``: the 4096-token
  self-attention of a 1024px image takes the flash kernels at head_dim 128
  (K4a/K4b); the 512-token cross-attention and adapter take einsum. Under
  an ``SPRingConfig`` (sequence parallelism) the self-attention goes
  through ``ops.ring_attention.sp_ring_attention`` at any length, and the
  other sites take its ``base_impl`` locally.
* ``remat`` True/"full" wraps each block in ``torch.utils.checkpoint``;
  "conservative" (the reference's selective checkpointing, JAX's
  ``make_block_fn``) keeps only the MLP down-projection ("mlp_down") and
  the flash kernel's (out, lse) ("flash_out", "flash_lse"), through the
  selective policy of ``ops/remat.py``, so that the backward recomputes the
  rest of the block but neither the down-projection's GEMM nor the flash
  forward. Under sequence parallelism the ring names nothing, as in JAX.
* ``tp`` (a ``parallel.tensor_parallel.TPConfig``, or None) runs the
  blocks' and the adapter's attention and MLPs as Megatron column and row
  splits over the tp ranks, on the tp slices that ``params`` then holds:
  q/k/v, ``mlp.layer1`` and the adapter's ``mlp.0`` column-parallel,
  ``output_proj``/``o_proj``, ``mlp.layer2`` and ``mlp.2`` row-parallel
  (``mlp.2.bias`` added once after the reduce). A rank runs its own heads
  (the per-head q/k RMSNorm scales then get partial gradients, which FSDP
  sums over tp), or, where tp does not divide the heads, gathers q/k/v and
  runs them all. The cross-attention context, which the trainable adapter
  makes, enters the blocks once through ``tp.copy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.ring_attention import SPRingConfig, sp_ring_attention
from ...ops.remat import linear_kept, remat as remat_region
from ...parallel.pipeline import STACK_PREFIX

Params = dict[str, torch.Tensor]


@dataclass(frozen=True)
class AnimaDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_spatial: int = 2
    patch_temporal: int = 1
    model_channels: int = 2048
    num_blocks: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    crossattn_emb_channels: int = 1024
    adaln_lora_dim: int = 256
    concat_padding_mask: bool = True
    rope_h_extrapolation_ratio: float = 4.0
    rope_w_extrapolation_ratio: float = 4.0
    rope_t_extrapolation_ratio: float = 1.0
    # LLM adapter
    adapter_source_dim: int = 1024    # Qwen3 hidden size
    adapter_target_dim: int = 1024
    adapter_layers: int = 6
    adapter_heads: int = 16
    adapter_vocab: int = 32128        # T5 vocabulary
    context_tokens: int = 512

    @property
    def head_dim(self) -> int:
        return self.model_channels // self.num_heads


ANIMA_BASE = AnimaDiTConfig()

TINY_ANIMA = AnimaDiTConfig(
    model_channels=96, num_blocks=2, num_heads=4, adaln_lora_dim=16,
    crossattn_emb_channels=32, adapter_source_dim=32, adapter_target_dim=32,
    adapter_layers=2, adapter_heads=4, adapter_vocab=128, context_tokens=16)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------

def _linear(params: Params, name: str, x):
    bias = params.get(f"{name}.bias")
    return F.linear(x, params[f"{name}.weight"].to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def _rms_norm(params: Params, name: str, x, eps: float = 1e-6):
    xf = x.float()
    norm = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * norm * params[f"{name}.weight"].float()).to(x.dtype)


def _layer_norm_noaffine(x, eps: float = 1e-6):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def sinusoidal_timestep_embedding(timesteps, dim: int):
    """(B, T) -> (B, T, dim), [cos | sin], exponent /half; fp32."""
    half = dim // 2
    exponent = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[..., None] * exponent
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# --------------------------------------------------------------------------
# 3D RoPE
# --------------------------------------------------------------------------

def rope_3d_tables(cfg: AnimaDiTConfig, t: int, h: int, w: int, device=None):
    """fp32 (cos, sin) of shape (t*h*w, head_dim//2).

    Pair frequencies are [temporal | height | width] concatenated; the pair
    (j, j + D/2) of each head vector rotates by the j-th frequency. NTK
    thetas: 10000 * ratio^(dim/(dim-2)).
    """
    d = cfg.head_dim
    dim_h = d // 6 * 2
    dim_w = dim_h
    dim_t = d - 2 * dim_h
    h_theta = 10000.0 * cfg.rope_h_extrapolation_ratio ** (dim_h / (dim_h - 2))
    w_theta = 10000.0 * cfg.rope_w_extrapolation_ratio ** (dim_w / (dim_w - 2))
    t_theta = 10000.0 * cfg.rope_t_extrapolation_ratio ** (dim_t / (dim_t - 2))

    def freqs(theta, dim):
        rng = torch.arange(0, dim, 2, dtype=torch.float32, device=device)[: dim // 2] / dim
        return 1.0 / theta ** rng

    def angles(n, theta, dim):
        return torch.arange(n, dtype=torch.float32, device=device)[:, None] \
            * freqs(theta, dim)[None]

    ang_t = angles(t, t_theta, dim_t)
    ang_h = angles(h, h_theta, dim_h)
    ang_w = angles(w, w_theta, dim_w)
    ang = torch.cat([
        ang_t[:, None, None, :].expand(t, h, w, ang_t.shape[1]),
        ang_h[None, :, None, :].expand(t, h, w, ang_h.shape[1]),
        ang_w[None, None, :, :].expand(t, h, w, ang_w.shape[1]),
    ], dim=-1).reshape(t * h * w, d // 2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_halfsplit(x, cos, sin):
    """x: (B, L, H, D); pairs are (x[j], x[j + D/2])."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention / blocks
# --------------------------------------------------------------------------

def _base_impl(attn_impl) -> str:
    """The local attention impl: SP configs carry it as .base_impl."""
    return attn_impl.base_impl if isinstance(attn_impl, SPRingConfig) else attn_impl


def _tp_heads(tp, prefix: str, x, heads: int):
    """(split, heads run here, x as the q/k/v projections' input): a
    tp-split attention (``TPConfig.heads``) takes its input through
    ``tp.copy``."""
    if tp is None or not tp.splits(f"{prefix}.q_proj.weight"):
        return False, heads, x
    return True, tp.heads(heads), tp.copy(x)


def _attention_out(tp, split: bool, heads: int, total: int, params: Params, name: str, o):
    if not split:
        return _linear(params, name, o)
    return tp.attention_out(heads, total, o, params[f"{name}.weight"],
                            params.get(f"{name}.bias"))


def _dit_attention(params: Params, prefix: str, x, context, cfg: AnimaDiTConfig,
                   rope=None, attn_impl="xla", tp=None):
    b, l, _ = x.shape
    d = cfg.head_dim
    # the cross-attention context came in through tp.copy (dit_prologue)
    split, heads, x = _tp_heads(tp, prefix, x, cfg.num_heads)
    ctx = x if context is None else context
    q = _linear(params, f"{prefix}.q_proj", x)
    k = _linear(params, f"{prefix}.k_proj", ctx)
    v = _linear(params, f"{prefix}.v_proj", ctx)
    if split:
        q, k, v = tp.qkv(heads, cfg.num_heads, q, k, v)
    q = q.reshape(b, l, heads, d)
    k = k.reshape(b, ctx.shape[1], heads, d)
    v = v.reshape(b, ctx.shape[1], heads, d)
    q = _rms_norm(params, f"{prefix}.q_norm", q)
    k = _rms_norm(params, f"{prefix}.k_norm", k)
    if rope is not None and context is None:   # rope only on self-attention
        cos, sin = rope
        q = apply_rope_halfsplit(q, cos, sin)
        k = apply_rope_halfsplit(k, cos, sin)
    if context is None and isinstance(attn_impl, SPRingConfig):
        # sequence parallelism: the self-attention tokens shard over the sp
        # ranks and KV hops the ring; cross-attention needs no communication
        # (replicated context) and uses base_impl locally
        o = sp_ring_attention(q, k, v, attn_impl)
    else:
        o = attention(q, k, v, impl=_base_impl(attn_impl))
    return _attention_out(tp, split, heads, cfg.num_heads, params, f"{prefix}.output_proj",
                          o.reshape(b, l, heads * d))


def _adaln_chunks(params: Params, prefix: str, emb, adaln_lora, n: int):
    """SiLU -> LoRA down -> LoRA up (+ shared lora term), chunked."""
    h = _linear(params, f"{prefix}.2", _linear(params, f"{prefix}.1", F.silu(emb)))
    if adaln_lora is not None:
        h = h + adaln_lora[..., : h.shape[-1]]
    return h.chunk(n, dim=-1)


def dit_block(params: Params, prefix: str, x, emb, context, rope, adaln_lora,
              cfg: AnimaDiTConfig, attn_impl="xla", tp=None):
    """x: (B, T, H, W, D); emb: (B, T, D); context: (B, Lc, Dc)."""
    b, t, h, w, d = x.shape
    res_dtype = x.dtype

    def mod(name):
        chunks = _adaln_chunks(params, f"{prefix}.{name}", emb, adaln_lora, 3)
        return tuple(c[:, :, None, None, :] for c in chunks)

    def norm_mod(xx, shift, scale):
        return _layer_norm_noaffine(xx) * (1 + scale.to(xx.dtype)) + shift.to(xx.dtype)

    shift, scale, gate = mod("adaln_modulation_self_attn")
    normed = norm_mod(x, shift, scale).reshape(b, t * h * w, d)
    out = _dit_attention(params, f"{prefix}.self_attn", normed, None, cfg,
                         rope=rope, attn_impl=attn_impl, tp=tp)
    x = x + gate.to(res_dtype) * out.reshape(b, t, h, w, d).to(res_dtype)

    shift, scale, gate = mod("adaln_modulation_cross_attn")
    normed = norm_mod(x, shift, scale).reshape(b, t * h * w, d)
    out = _dit_attention(params, f"{prefix}.cross_attn", normed, context, cfg,
                         attn_impl=attn_impl, tp=tp)
    x = x + gate.to(res_dtype) * out.reshape(b, t, h, w, d).to(res_dtype)

    # MLP (GPT2FeedForward: linear -> exact GELU -> linear, no biases)
    shift, scale, gate = mod("adaln_modulation_mlp")
    h_in = norm_mod(x, shift, scale)
    mlp_tp = tp if tp is not None and tp.splits(f"{prefix}.mlp.layer1.weight") else None
    if mlp_tp is not None:
        h_in = mlp_tp.copy(h_in)
    hmid = F.gelu(_linear(params, f"{prefix}.mlp.layer1", h_in))
    # named "mlp_down": the "conservative" policy keeps the wide->narrow
    # down-projection (the reference's MUST_SAVE rule; under tp after its
    # reduce) and skips its GEMM in the recompute
    out = linear_kept(hmid, params[f"{prefix}.mlp.layer2.weight"].to(hmid.dtype),
                      "mlp_down", mlp_tp)
    return x + gate.to(res_dtype) * out.to(res_dtype)


# --------------------------------------------------------------------------
# Patchify / unpatchify
# --------------------------------------------------------------------------

def pad_to_patch_size(x, pt: int, ps: int):
    """(B, T, H, W, C) circular pad of T/H/W up to patch multiples."""
    for axis, p in ((1, pt), (2, ps), (3, ps)):
        n = x.shape[axis]
        extra = (p - n % p) % p
        if extra:
            idx = torch.arange(n + extra, device=x.device) % n
            x = x.index_select(axis, idx)
    return x


def patchify(x, pt: int, ps: int):
    """(B, T, H, W, C) -> (B, T/pt, H/ps, W/ps, C*pt*ps*ps), features in the
    reference's (c, r, m, n) order."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // pt, pt, h // ps, ps, w // ps, ps, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)            # b t h w c r m n
    return x.reshape(b, t // pt, h // ps, w // ps, c * pt * ps * ps)


def unpatchify(x, pt: int, ps: int, out_c: int):
    """(B, T, H, W, ps*ps*pt*C) -> (B, T*pt, H*ps, W*ps, C), features in the
    reference's (p1, p2, t, C) order."""
    b, t, h, w, _ = x.shape
    x = x.reshape(b, t, h, w, ps, ps, pt, out_c)
    x = x.permute(0, 1, 6, 2, 4, 3, 5, 7)            # b t pt h p1 w p2 c
    return x.reshape(b, t * pt, h * ps, w * ps, out_c)


# --------------------------------------------------------------------------
# LLM adapter
# --------------------------------------------------------------------------

def _rope_1d(seq_len: int, head_dim: int, device=None):
    inv = 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    ang = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def _rotate(x, rope):
    cos, sin = rope
    return (x * cos[None, :, None, :] + _rotate_half(x) * sin[None, :, None, :]).to(x.dtype)


def embedding_lookup(table, ids):
    """``table[ids]`` with JAX's gather semantics: an id past the table
    reads its last row (the ids are clamped to [0, rows - 1]), and its
    gradient is dropped, as JAX's scatter-add drops out-of-range updates."""
    ids = ids.long()
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    inside = ((ids >= 0) & (ids < table.shape[0]))[..., None]
    return torch.where(inside, rows, rows.detach())


def _adapter_attention(params: Params, prefix: str, x, context, heads: int,
                       rope_q, rope_k, attn_impl: str = "xla", tp=None):
    b, l, dq = x.shape
    d = dq // heads
    total = heads
    self_attn = context is x
    split, heads, x = _tp_heads(tp, prefix, x, heads)
    if split:
        # the self-attention's context is its input
        context = x if self_attn else tp.copy(context)
    q = _linear(params, f"{prefix}.q_proj", x)
    k = _linear(params, f"{prefix}.k_proj", context)
    v = _linear(params, f"{prefix}.v_proj", context)
    if split:
        q, k, v = tp.qkv(heads, total, q, k, v)
    q = q.reshape(b, l, heads, d)
    k = k.reshape(b, context.shape[1], heads, d)
    v = v.reshape(b, context.shape[1], heads, d)
    q = _rotate(_rms_norm(params, f"{prefix}.q_norm", q), rope_q)
    k = _rotate(_rms_norm(params, f"{prefix}.k_norm", k), rope_k)
    o = attention(q, k, v, impl=attn_impl).reshape(b, l, heads * d)
    return _attention_out(tp, split, heads, total, params, f"{prefix}.o_proj", o)


def llm_adapter_forward(params: Params, source_hidden, target_ids,
                        cfg: AnimaDiTConfig, attn_impl: str = "xla", tp=None):
    """Qwen3 hidden states + T5 token ids -> adapted context. Trainable;
    runs inside the DiT forward."""
    p = "llm_adapter"
    x = embedding_lookup(params[f"{p}.embed.weight"], target_ids).to(source_hidden.dtype)
    heads = cfg.adapter_heads
    head_dim = cfg.adapter_target_dim // heads
    rope_q = _rope_1d(x.shape[1], head_dim, x.device)
    rope_k = _rope_1d(source_hidden.shape[1], head_dim, x.device)
    for i in range(cfg.adapter_layers):
        blk = f"{p}.blocks.{i}"
        h = _rms_norm(params, f"{blk}.norm_self_attn", x)
        x = x + _adapter_attention(params, f"{blk}.self_attn", h, h, heads,
                                   rope_q, rope_q, attn_impl, tp)
        h = _rms_norm(params, f"{blk}.norm_cross_attn", x)
        x = x + _adapter_attention(params, f"{blk}.cross_attn", h, source_hidden,
                                   heads, rope_q, rope_k, attn_impl, tp)
        h = _rms_norm(params, f"{blk}.norm_mlp", x)
        if tp is not None and tp.splits(f"{blk}.mlp.0.weight"):
            h = F.gelu(_linear(params, f"{blk}.mlp.0", tp.copy(h)))
            x = x + tp.row(h, params[f"{blk}.mlp.2.weight"], params.get(f"{blk}.mlp.2.bias"))
        else:
            h = F.gelu(_linear(params, f"{blk}.mlp.0", h))
            x = x + _linear(params, f"{blk}.mlp.2", h)
    x = _linear(params, f"{p}.out_proj", x)
    return _rms_norm(params, f"{p}.norm", x)


def preprocess_text_embeds(params: Params, text_embeds, t5_ids, cfg: AnimaDiTConfig,
                           attn_impl: str = "xla", tp=None):
    """Adapter + pad to ``cfg.context_tokens``."""
    if t5_ids is None:
        return text_embeds
    out = llm_adapter_forward(params, text_embeds, t5_ids, cfg, attn_impl, tp)
    if out.shape[1] < cfg.context_tokens:
        out = F.pad(out, (0, 0, 0, cfg.context_tokens - out.shape[1]))
    return out


# --------------------------------------------------------------------------
# Full forward
# --------------------------------------------------------------------------

def dit_prologue(params: Params, latents, timesteps, context, *,
                 cfg: AnimaDiTConfig, t5_ids=None, attn_impl="xla",
                 compute_dtype=torch.bfloat16, tp=None):
    """Patchify + embedders + adapter: (x, emb, context, rope, lora, shape)."""
    pt, ps = cfg.patch_temporal, cfg.patch_spatial
    orig = latents.shape
    x = pad_to_patch_size(latents.to(compute_dtype), pt, ps)
    if cfg.concat_padding_mask:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    x = _linear(params, "x_embedder.proj.1", patchify(x, pt, ps))
    _, t, h, w, _ = x.shape
    rope = rope_3d_tables(cfg, t, h, w, x.device)

    if timesteps.dim() == 1:
        timesteps = timesteps[:, None]
    sin_emb = sinusoidal_timestep_embedding(timesteps, cfg.model_channels).to(compute_dtype)
    # AdaLN-LoRA: the block embedding is the raw sinusoid, RMS-normed; the
    # modulation seed comes from the small MLP
    lora = _linear(params, "t_embedder.1.linear_2",
                   F.silu(_linear(params, "t_embedder.1.linear_1", sin_emb)))
    emb = _rms_norm(params, "t_embedding_norm", sin_emb)
    context = preprocess_text_embeds(params, context.to(compute_dtype), t5_ids,
                                     cfg, _base_impl(attn_impl), tp)
    if tp is not None and tp.splits("blocks.0.cross_attn.k_proj.weight"):
        # every block's cross-attention k/v are column-parallel on it: one
        # copy, so its gradient is summed over tp once, not once a block
        context = tp.copy(context)
    return x, emb, context, rope, lora, orig


def block_remat_mode(mode):
    """False/None/"off" = no remat; True/"full" = recompute each block;
    "conservative" = keep mlp_down, flash_out and flash_lse."""
    if not mode or mode == "off":
        return False
    if mode is True or mode == "full":
        return True
    if mode == "conservative":
        return mode
    raise ValueError(f"DiT remat mode {mode!r}; expected False, True, 'full' "
                     "or 'conservative'")


def make_block_fn(cfg: AnimaDiTConfig, attn_impl, remat, tp=None):
    """The per-block callable ``block_fn(params, prefix, x, emb, context,
    rope, lora)``: ``dit_block`` under the remat that ``block_remat_mode``
    chooses (the JAX package's ``make_block_fn``). The sequential forward
    and each GPipe stage (``parallel/pipeline.py``) run their blocks
    through it."""
    mode = block_remat_mode(remat)

    def block_fn(params, prefix, x, emb, context, rope, lora):
        return remat_region(dit_block, mode, params, prefix, x, emb, context, rope,
                            lora, cfg, attn_impl, tp)

    return block_fn


def dit_epilogue(params: Params, x, emb, lora, orig, *, cfg: AnimaDiTConfig,
                 compute_dtype=torch.bfloat16):
    """Final 2-chunk AdaLN + linear + unpatchify + crop."""
    pt, ps = cfg.patch_temporal, cfg.patch_spatial
    x = x.to(compute_dtype)
    fl = _linear(params, "final_layer.adaln_modulation.2",
                 _linear(params, "final_layer.adaln_modulation.1", F.silu(emb)))
    fl = fl + lora[..., : fl.shape[-1]]
    shift, scale = fl.chunk(2, dim=-1)
    x = _layer_norm_noaffine(x) * (1 + scale[:, :, None, None, :]) \
        + shift[:, :, None, None, :]
    x = unpatchify(_linear(params, "final_layer.linear", x), pt, ps, cfg.out_channels)
    return x[:, : orig[1], : orig[2], : orig[3], :]


def dit_forward(params: Params, latents, timesteps, context, *,
                cfg: AnimaDiTConfig, t5_ids=None, attn_impl="xla",
                compute_dtype=torch.bfloat16, remat=True, tp=None):
    """latents: (B, T, H, W, C) channel-last; timesteps: (B,) or (B, T).
    Returns (B, T, H, W, C_out) cropped back to the input size."""
    x, emb, context, rope, lora, orig = dit_prologue(
        params, latents, timesteps, context, cfg=cfg, t5_ids=t5_ids,
        attn_impl=attn_impl, compute_dtype=compute_dtype, tp=tp)
    block_fn = make_block_fn(cfg, attn_impl, remat, tp)
    for i in range(cfg.num_blocks):
        x = block_fn(params, f"blocks.{i}", x, emb, context, rope, lora)
    return dit_epilogue(params, x, emb, lora, orig, cfg=cfg,
                        compute_dtype=compute_dtype)


# --------------------------------------------------------------------------
# Parameter enumeration / init / conversion
# --------------------------------------------------------------------------

def param_shapes(cfg: AnimaDiTConfig) -> dict[str, tuple[int, ...]]:
    """Torch-layout shapes: linear weights (out, in), embeddings (vocab, dim)."""
    d = cfg.model_channels
    lora = cfg.adaln_lora_dim
    ctx = cfg.crossattn_emb_channels
    pt, ps = cfg.patch_temporal, cfg.patch_spatial
    in_c = cfg.in_channels + (1 if cfg.concat_padding_mask else 0)
    shapes: dict[str, tuple[int, ...]] = {
        "x_embedder.proj.1.weight": (d, in_c * pt * ps * ps),
        "t_embedder.1.linear_1.weight": (d, d),
        "t_embedder.1.linear_2.weight": (3 * d, d),
        "t_embedding_norm.weight": (d,),
        "final_layer.linear.weight": (ps * ps * pt * cfg.out_channels, d),
        "final_layer.adaln_modulation.1.weight": (lora, d),
        "final_layer.adaln_modulation.2.weight": (2 * d, lora),
    }
    hd = cfg.head_dim
    ff = int(d * cfg.mlp_ratio)
    for i in range(cfg.num_blocks):
        p = f"blocks.{i}"
        for attn, kdim in ((f"{p}.self_attn", d), (f"{p}.cross_attn", ctx)):
            shapes[f"{attn}.q_proj.weight"] = (d, d)
            shapes[f"{attn}.k_proj.weight"] = (d, kdim)
            shapes[f"{attn}.v_proj.weight"] = (d, kdim)
            shapes[f"{attn}.output_proj.weight"] = (d, d)
            shapes[f"{attn}.q_norm.weight"] = (hd,)
            shapes[f"{attn}.k_norm.weight"] = (hd,)
        for m in ("self_attn", "cross_attn", "mlp"):
            shapes[f"{p}.adaln_modulation_{m}.1.weight"] = (lora, d)
            shapes[f"{p}.adaln_modulation_{m}.2.weight"] = (3 * d, lora)
        shapes[f"{p}.mlp.layer1.weight"] = (ff, d)
        shapes[f"{p}.mlp.layer2.weight"] = (d, ff)

    td, sd = cfg.adapter_target_dim, cfg.adapter_source_dim
    ahd = td // cfg.adapter_heads
    ffa = int(td * 4.0)
    shapes["llm_adapter.embed.weight"] = (cfg.adapter_vocab, td)
    shapes["llm_adapter.out_proj.weight"] = (td, td)
    shapes["llm_adapter.out_proj.bias"] = (td,)
    shapes["llm_adapter.norm.weight"] = (td,)
    for i in range(cfg.adapter_layers):
        p = f"llm_adapter.blocks.{i}"
        for norm in ("norm_self_attn", "norm_cross_attn", "norm_mlp"):
            shapes[f"{p}.{norm}.weight"] = (td,)
        for attn, kdim in ((f"{p}.self_attn", td), (f"{p}.cross_attn", sd)):
            shapes[f"{attn}.q_proj.weight"] = (td, td)
            shapes[f"{attn}.k_proj.weight"] = (td, kdim)
            shapes[f"{attn}.v_proj.weight"] = (td, kdim)
            shapes[f"{attn}.o_proj.weight"] = (td, td)
            shapes[f"{attn}.q_norm.weight"] = (ahd,)
            shapes[f"{attn}.k_norm.weight"] = (ahd,)
        shapes[f"{p}.mlp.0.weight"] = (ffa, td)
        shapes[f"{p}.mlp.0.bias"] = (ffa,)
        shapes[f"{p}.mlp.2.weight"] = (td, ffa)
        shapes[f"{p}.mlp.2.bias"] = (td,)
    return shapes


def _is_linear(name: str, shape) -> bool:
    return len(shape) == 2 and not name.endswith("embed.weight")


def init_params(cfg: AnimaDiTConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """Random init (testing / from-scratch training): zero biases, unit 1-D
    scales, N(0, 1/fan_in) matrices, drawn in sorted name order from
    ``generator`` (on ``device``)."""
    device = generator.device if device is None else torch.device(device)
    params: Params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif len(shape) == 1:
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = shape[1] if _is_linear(name, shape) else shape[0]
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * (1.0 / max(fan_in, 1)) ** 0.5
            params[name] = w.to(dtype)
    return params


def _to_tensor(array) -> torch.Tensor:
    """numpy (bf16 via ml_dtypes) or tensor -> CPU tensor, no float cast."""
    if isinstance(array, torch.Tensor):
        return array
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:      # frombuffer views of file bytes
        array = array.copy()
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def params_from_torch_state(state: dict, cfg: AnimaDiTConfig,
                            dtype=torch.float32, device=None) -> Params:
    """Prefix-stripped checkpoint tensors (numpy or torch, torch layout) ->
    the port's param dict, with a shape check."""
    params: Params = {}
    missing = []
    for name, want in param_shapes(cfg).items():
        if name not in state:
            missing.append(name)
            continue
        t = _to_tensor(state[name])
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {want}")
        params[name] = t.to(device=device, dtype=dtype)
    if missing:
        raise ValueError(f"Anima checkpoint missing {len(missing)} tensors, "
                         f"e.g. {missing[:5]}")
    return params


def params_to_torch_state(params: Params) -> dict:
    """The checkpoint's tensors (the port already holds torch layout)."""
    return dict(params)


def from_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """One DiT tensor of the JAX package's layout in the port's, as a view:
    linear weights (in, out) -> (out, in); embeddings and the rest as they
    are. A stacked block leaf (``__stack__.<suffix>``, [blocks, ...]; the
    blocks hold no embedding) transposes each block's linear weight."""
    if name.startswith(STACK_PREFIX):
        return t.transpose(-1, -2) if t.dim() == 3 else t
    return t.t() if _is_linear(name, t.shape) else t


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``from_jax_layout`` (a transpose is its own)."""
    return from_jax_layout(name, t)


def params_from_jax(flat_numpy_params: dict, dtype=torch.float32,
                    device=None) -> Params:
    """The JAX package's DiT params (numpy, linear weights (in, out)) in the
    port's torch layout (linear weights (out, in); embeddings as they are)."""
    return {name: from_jax_layout(name, torch.from_numpy(np.array(arr, np.float32)))
            .contiguous().to(device=device, dtype=dtype)
            for name, arr in flat_numpy_params.items()}
