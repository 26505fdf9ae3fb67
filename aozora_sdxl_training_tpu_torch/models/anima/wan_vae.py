"""Wan-style causal-3D VAE in PyTorch: the encoder (image and video mode),
the tiled image encode, and the decoder (image and video mode).

Counterpart of ``aozora_sdxl_training_tpu/models/anima/wan_vae.py``, with
the same graph and numerics: Encoder3d with dim 96, z 16, mults (1, 2, 4,
4), channel-RMS norms (x / max(||x||, 1e-12) along channels, x sqrt(C) x
gamma), one single-head spatial attention in the middle (a bmm over 384
channels, per frame: no Pallas kernel runs here), the per-channel latent
mean/std baked into the encode, and a spatially tiled encode with ramped
blend masks (tile 96x96 latent, stride 72x72, x8 pixels); the decoder is
Wan2.x's Decoder3d mirrored (each stage after the first starts at half its
nominal width, after the channel-halving upsample conv).

* Image mode: an image is one frame, and a causal 3D conv pads time with
  leading zeros, so only the *last* temporal slice of each causal kernel
  (O, I, kt, kh, kw) ever meets real data: every CausalConv3d is a 2D conv
  with ``w[:, :, -1]``, on NCHW activations (``F.conv2d``).
* Video mode (``encode_video``, ``decode_video``): the whole clip at once,
  NCTHW activations (``F.conv3d``). A causal conv pads ``2*(kt//2)``
  leading zero frames. The encoder's temporal downsamples (flags (False,
  True, True)) run the spatial stride-2 conv per frame, then frame 0
  bypasses and the rest go through the stride-2 ``time_conv`` in windows
  (f0,f1,f2), (f2,f3,f4), ...: 1+4k frames give 1+k latent frames. The
  decoder's temporal upsamples (flags (True, True, False)) run the causal
  C -> 2C ``time_conv``, interleave its two halves per input frame and keep
  frame 0 once: 1+k latent frames give 1+4k frames. The mid-attention and
  the resample convs run frame by frame.
* Parameters are a flat dict under the reference's ``encoder.*`` /
  ``conv1.*`` (and ``decoder.*`` / ``conv2.*``) names (``model.`` dropped)
  in torch layout as a Wan file holds them (5-D causal kernels, 4-D Conv2d
  kernels, gammas squeezed to (C,)); ``params_from_jax`` carries the JAX
  package's HWIO / THWIO params across (a 4-D kernel in a causal slot acts
  as kt=1, as in JAX).
* The public functions take NHWC / NTHWC pixels or latents and give them
  back in that layout, like the JAX ones.
* The tiled encode's blend runs in numpy fp32 on the host, as in JAX. A
  clip is encoded untiled, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..sdxl.conversion import to_tensor

Params = dict[str, torch.Tensor]

# Wan2.x VAE per-channel latent statistics
LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)


@dataclass(frozen=True)
class WanVaeConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2

    @property
    def dims(self) -> list[int]:
        return [self.dim * u for u in (1,) + tuple(self.dim_mult)]


WAN_VAE = WanVaeConfig()
TINY_WAN_VAE = WanVaeConfig(dim=8, z_dim=4)


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _conv2d(params: Params, name: str, x, *, stride: int = 1, pad=None):
    """NCHW conv; ``pad`` (left, right, top, bottom) zero-pads before a
    valid conv, by default the kernel keeps the size."""
    kernel = params[f"{name}.weight"]
    if kernel.ndim == 5:      # causal 3D kernel: its last temporal slice
        kernel = kernel[:, :, -1]
    kernel = kernel.to(x.dtype)
    bias = params.get(f"{name}.bias")
    bias = None if bias is None else bias.to(x.dtype)
    if pad is None:
        return F.conv2d(x, kernel, bias, stride=stride, padding=kernel.shape[-1] // 2)
    return F.conv2d(F.pad(x, pad), kernel, bias, stride=stride)


def _channel_rms_norm(params: Params, name: str, x, eps: float = 1e-12):
    """x / max(||x||, eps) along channels (dim 1) * sqrt(C) * gamma."""
    xf = x.to(_stat_dtype(x.dtype))
    norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True))
    gamma = params[f"{name}.gamma"].to(xf.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))
    y = xf * ((x.shape[1] ** 0.5) / torch.clamp(norm, min=eps)) * gamma
    return y.to(x.dtype)


def _residual_block(params: Params, prefix: str, x):
    if f"{prefix}.shortcut.weight" in params:
        identity = _conv2d(params, f"{prefix}.shortcut", x)
    else:
        identity = x
    h = _channel_rms_norm(params, f"{prefix}.residual.0", x)
    h = _conv2d(params, f"{prefix}.residual.2", F.silu(h))
    h = _channel_rms_norm(params, f"{prefix}.residual.3", h)
    h = _conv2d(params, f"{prefix}.residual.6", F.silu(h))
    return h + identity


def _attention_block(params: Params, prefix: str, x):
    b, c, h, w = x.shape
    hidden = _channel_rms_norm(params, f"{prefix}.norm", x)
    qkv = _conv2d(params, f"{prefix}.to_qkv", hidden).flatten(2).transpose(1, 2)
    q, k, v = qkv.split(c, dim=-1)                          # (B, HW, C) each
    logits = torch.bmm(q, k.transpose(1, 2)).to(_stat_dtype(x.dtype)) * (c ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.bmm(probs, v).transpose(1, 2).reshape(b, c, h, w)
    return _conv2d(params, f"{prefix}.proj", out) + x


def _downsample(params: Params, prefix: str, x):
    """Zero-pad right and bottom by one, then a valid 3x3 stride-2 conv."""
    return _conv2d(params, f"{prefix}.resample.1", x, stride=2, pad=(0, 1, 0, 1))


def encoder_layout(cfg: WanVaeConfig):
    """Ordered (kind, name, in_dim, out_dim) of model.encoder.downsamples."""
    layers = []
    dims = cfg.dims
    idx = 0
    for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
        d = in_dim
        for _ in range(cfg.num_res_blocks):
            layers.append(("res", f"downsamples.{idx}", d, out_dim))
            d = out_dim
            idx += 1
        if i != len(cfg.dim_mult) - 1:
            layers.append(("down", f"downsamples.{idx}", out_dim, out_dim))
            idx += 1
    return layers


def encode_image(params: Params, pixels, *, cfg: WanVaeConfig = WAN_VAE,
                 normalize: bool = True, compute_dtype=torch.float32):
    """pixels: (B, H, W, 3) in [-1, 1] -> normalized latents (B, H/8, W/8, z)."""
    x = pixels.to(compute_dtype).permute(0, 3, 1, 2)
    x = _conv2d(params, "encoder.conv1", x)
    for kind, name, _, _ in encoder_layout(cfg):
        if kind == "res":
            x = _residual_block(params, f"encoder.{name}", x)
        else:
            x = _downsample(params, f"encoder.{name}", x)
    x = _residual_block(params, "encoder.middle.0", x)
    x = _attention_block(params, "encoder.middle.1", x)
    x = _residual_block(params, "encoder.middle.2", x)
    x = _channel_rms_norm(params, "encoder.head.0", x)
    x = _conv2d(params, "encoder.head.2", F.silu(x))
    x = _conv2d(params, "conv1", x)
    mu = x[:, : cfg.z_dim].permute(0, 2, 3, 1)
    if not normalize:
        return mu
    mean = torch.as_tensor(LATENT_MEAN[: cfg.z_dim], dtype=mu.dtype, device=mu.device)
    inv_std = torch.as_tensor(1.0 / LATENT_STD[: cfg.z_dim], dtype=mu.dtype,
                              device=mu.device)
    return (mu - mean) * inv_std


# --------------------------------------------------------------------------
# Video mode: the whole clip, NCTHW inside
# --------------------------------------------------------------------------

def _causal_conv3d(params: Params, name: str, x):
    """NCTHW conv with the causal temporal pad ``2*(kt//2)`` in front and
    the spatial one on both sides; a 4-D kernel acts as kt=1."""
    kernel = params[f"{name}.weight"]
    if kernel.ndim == 4:
        kernel = kernel[:, :, None]
    kernel = kernel.to(x.dtype)
    bias = params.get(f"{name}.bias")
    bias = None if bias is None else bias.to(x.dtype)
    kt, kh, kw = kernel.shape[2:]
    if kt > 1:
        b, c, _, h, w = x.shape
        x = torch.cat([x.new_zeros(b, c, 2 * (kt // 2), h, w), x], dim=2)
    return F.conv3d(x, kernel, bias, padding=(0, kh // 2, kw // 2))


def _video_map_frames(fn, x):
    """An image-space NCHW function applied to each frame of NCTHW ``x``."""
    return torch.stack([fn(x[:, :, i]) for i in range(x.shape[2])], dim=2)


def _video_residual_block(params: Params, prefix: str, x):
    if f"{prefix}.shortcut.weight" in params:
        identity = _causal_conv3d(params, f"{prefix}.shortcut", x)
    else:
        identity = x
    h = _channel_rms_norm(params, f"{prefix}.residual.0", x)
    h = _causal_conv3d(params, f"{prefix}.residual.2", F.silu(h))
    h = _channel_rms_norm(params, f"{prefix}.residual.3", h)
    h = _causal_conv3d(params, f"{prefix}.residual.6", F.silu(h))
    return h + identity


def _video_downsample(params: Params, prefix: str, x, temporal: bool):
    x = _video_map_frames(lambda f: _downsample(params, prefix, f), x)
    if not temporal or x.shape[2] == 1:
        return x
    if f"{prefix}.time_conv.weight" not in params:
        raise ValueError(f"video encode needs {prefix}.time_conv weights "
                         "(checkpoint loaded in image mode?)")
    # frame 0 bypasses; the rest: stride-2 windows (f0,f1,f2), (f2,f3,f4), ...
    bias = params.get(f"{prefix}.time_conv.bias")
    y = F.conv3d(x, params[f"{prefix}.time_conv.weight"].to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=(2, 1, 1))
    return torch.cat([x[:, :, :1], y], dim=2)


ENCODER_TEMPORAL = (False, True, True)    # the encoder's temporal downsamples
DECODER_TEMPORAL = (True, True, False)    # the decoder's temporal upsamples


def encode_video(params: Params, video, *, cfg: WanVaeConfig = WAN_VAE,
                 normalize: bool = True, compute_dtype=torch.float32):
    """video: (B, T, H, W, 3) in [-1, 1], T = 1 + 4k ->
    (B, (T+3)//4, H/8, W/8, z) normalized latents."""
    x = video.to(compute_dtype).permute(0, 4, 1, 2, 3)
    x = _causal_conv3d(params, "encoder.conv1", x)
    down_index = 0
    for kind, name, _, _ in encoder_layout(cfg):
        if kind == "res":
            x = _video_residual_block(params, f"encoder.{name}", x)
        else:
            x = _video_downsample(params, f"encoder.{name}", x,
                                  ENCODER_TEMPORAL[down_index])
            down_index += 1
    x = _video_residual_block(params, "encoder.middle.0", x)
    x = _video_map_frames(lambda f: _attention_block(params, "encoder.middle.1", f), x)
    x = _video_residual_block(params, "encoder.middle.2", x)
    x = _channel_rms_norm(params, "encoder.head.0", x)
    x = _causal_conv3d(params, "encoder.head.2", F.silu(x))
    x = _causal_conv3d(params, "conv1", x)
    mu = x[:, : cfg.z_dim].permute(0, 2, 3, 4, 1)
    if not normalize:
        return mu
    mean = torch.as_tensor(LATENT_MEAN[: cfg.z_dim], dtype=mu.dtype, device=mu.device)
    inv_std = torch.as_tensor(1.0 / LATENT_STD[: cfg.z_dim], dtype=mu.dtype,
                              device=mu.device)
    return (mu - mean) * inv_std


# --------------------------------------------------------------------------
# Tiled encode (spatial)
# --------------------------------------------------------------------------

def _axis_mask(length: int, lower: bool, upper: bool, border: int) -> np.ndarray:
    mask = np.ones(length, np.float32)
    if border > 0:
        ramp = (np.arange(border) + 1) / border
        if not lower:
            mask[:border] = ramp
        if not upper:
            mask[-border:] = ramp[::-1]
    return mask


def tile_tasks(height: int, width: int, tile_h: int, tile_w: int,
               stride_h: int, stride_w: int):
    """(top, bottom, left, right) pixel windows."""
    tasks = []
    for top in range(0, height, stride_h):
        if top >= stride_h and top - stride_h + tile_h >= height:
            continue
        for left in range(0, width, stride_w):
            if left >= stride_w and left - stride_w + tile_w >= width:
                continue
            tasks.append((top, top + tile_h, left, left + tile_w))
    return tasks


def encode_image_tiled(params: Params, pixels: np.ndarray, *,
                       cfg: WanVaeConfig = WAN_VAE, tile_size=(96, 96),
                       tile_stride=(72, 72), encode_fn=None) -> np.ndarray:
    """Spatially tiled encode with ramped blend masks.

    pixels: (B, H, W, 3) numpy in [-1, 1]; tile_size/stride in *latent*
    units (x8 pixels), as VAE_CACHING_TILE_SIZE gives them. ``encode_fn``
    maps a numpy pixel tile to its numpy latents (default:
    :func:`encode_image` on the device of ``params``); the edge tiles are
    ragged, cut at the image's border."""
    if encode_fn is None:
        device = next(iter(params.values())).device

        @torch.inference_mode()
        def encode_fn(tile):
            out = encode_image(params, torch.as_tensor(tile, device=device), cfg=cfg)
            return out.float().cpu().numpy()
    b, height, width, _ = pixels.shape
    tile_h, tile_w = (t * 8 for t in tile_size)
    stride_h, stride_w = (s * 8 for s in tile_stride)
    border = ((tile_h - stride_h) // 8, (tile_w - stride_w) // 8)

    values = np.zeros((b, height // 8, width // 8, cfg.z_dim), np.float32)
    weights = np.zeros((b, height // 8, width // 8, 1), np.float32)
    for top, bottom, left, right in tile_tasks(height, width, tile_h, tile_w,
                                               stride_h, stride_w):
        tile = pixels[:, top:min(bottom, height), left:min(right, width)]
        encoded = np.asarray(encode_fn(tile), np.float32)
        mh = _axis_mask(encoded.shape[1], top == 0, bottom >= height, border[0])
        mw = _axis_mask(encoded.shape[2], left == 0, right >= width, border[1])
        mask = np.minimum(mh[:, None], mw[None, :])[None, :, :, None]
        ot, ol = top // 8, left // 8
        values[:, ot:ot + encoded.shape[1], ol:ol + encoded.shape[2]] += encoded * mask
        weights[:, ot:ot + encoded.shape[1], ol:ol + encoded.shape[2]] += mask
    return values / weights


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

def decoder_layout(cfg: WanVaeConfig):
    """Ordered (kind, name, in_dim, out_dim) of ``model.decoder.upsamples``.

    Wan2.x Decoder3d: dims run [last, *reversed(dim_mult)]*dim; each stage
    has num_res_blocks+1 residual blocks then an upsample (but the last
    stage). The upsample conv halves the channels, so the stages after the
    first start at half their nominal input width."""
    mults = [cfg.dim_mult[-1]] + list(reversed(cfg.dim_mult))
    dims = [cfg.dim * m for m in mults]
    layers = []
    idx = 0
    n = len(cfg.dim_mult)
    for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
        if i > 0:
            in_dim //= 2
        d = in_dim
        for _ in range(cfg.num_res_blocks + 1):
            layers.append(("res", f"upsamples.{idx}", d, out_dim))
            d = out_dim
            idx += 1
        if i != n - 1:
            layers.append(("up", f"upsamples.{idx}", out_dim, out_dim // 2))
            idx += 1
    return layers


def _upsample_nearest_2x(x):
    """NCHW nearest-neighbour 2x."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _denormalized(latents, cfg: WanVaeConfig, denormalize: bool, compute_dtype):
    x = latents.to(compute_dtype)
    if not denormalize:
        return x
    mean = torch.as_tensor(LATENT_MEAN[: cfg.z_dim], dtype=x.dtype, device=x.device)
    std = torch.as_tensor(LATENT_STD[: cfg.z_dim], dtype=x.dtype, device=x.device)
    return x * std + mean


def decode_image(params: Params, latents, *, cfg: WanVaeConfig = WAN_VAE,
                 denormalize: bool = True, compute_dtype=torch.float32):
    """Normalized latents (B, H/8, W/8, z) -> pixels (B, H, W, 3) in [-1, 1]."""
    x = _denormalized(latents, cfg, denormalize, compute_dtype).permute(0, 3, 1, 2)
    x = _conv2d(params, "conv2", x)
    x = _conv2d(params, "decoder.conv1", x)
    x = _residual_block(params, "decoder.middle.0", x)
    x = _attention_block(params, "decoder.middle.1", x)
    x = _residual_block(params, "decoder.middle.2", x)
    for kind, name, _, _ in decoder_layout(cfg):
        if kind == "res":
            x = _residual_block(params, f"decoder.{name}", x)
        else:   # nearest 2x, then the channel-halving conv (no time_conv)
            x = _conv2d(params, f"decoder.{name}.resample.1", _upsample_nearest_2x(x))
    x = _channel_rms_norm(params, "decoder.head.0", x)
    x = _conv2d(params, "decoder.head.2", F.silu(x))
    return x.permute(0, 2, 3, 1)


def _video_upsample(params: Params, prefix: str, x, temporal: bool):
    if temporal and x.shape[2] > 1:
        if f"{prefix}.time_conv.weight" not in params:
            raise ValueError(f"video decode needs {prefix}.time_conv weights "
                             "(checkpoint loaded in image mode?)")
        y = _causal_conv3d(params, f"{prefix}.time_conv", x)     # (B, 2C, T, H, W)
        b, c2, t, h, w = y.shape
        # the two halves interleave per input frame: (t, 0), (t, 1), ...
        doubled = y.reshape(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5) \
            .reshape(b, c2 // 2, 2 * t, h, w)
        # frame 0 once (the mirror of the encoder's bypass), then the
        # doubled frames of inputs 1..
        x = torch.cat([x[:, :, :1], doubled[:, :, 2:]], dim=2)
    return _video_map_frames(
        lambda f: _conv2d(params, f"{prefix}.resample.1", _upsample_nearest_2x(f)), x)


def decode_video(params: Params, latents, *, cfg: WanVaeConfig = WAN_VAE,
                 denormalize: bool = True, compute_dtype=torch.float32):
    """Normalized latents (B, T', H/8, W/8, z) -> (B, 1+4(T'-1), H, W, 3)."""
    x = _denormalized(latents, cfg, denormalize, compute_dtype).permute(0, 4, 1, 2, 3)
    x = _causal_conv3d(params, "conv2", x)
    x = _causal_conv3d(params, "decoder.conv1", x)
    x = _video_residual_block(params, "decoder.middle.0", x)
    x = _video_map_frames(lambda f: _attention_block(params, "decoder.middle.1", f), x)
    x = _video_residual_block(params, "decoder.middle.2", x)
    up_index = 0
    for kind, name, _, _ in decoder_layout(cfg):
        if kind == "res":
            x = _video_residual_block(params, f"decoder.{name}", x)
        else:
            x = _video_upsample(params, f"decoder.{name}", x, DECODER_TEMPORAL[up_index])
            up_index += 1
    x = _channel_rms_norm(params, "decoder.head.0", x)
    x = _causal_conv3d(params, "decoder.head.2", F.silu(x))
    return x.permute(0, 2, 3, 4, 1)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

class _Shapes(dict):
    """Tensor shapes as a Wan file holds them (torch layout)."""

    def conv(self, name, cin, cout, k, causal=True):
        self[f"{name}.weight"] = (cout, cin, k, k, k) if causal else (cout, cin, k, k)
        self[f"{name}.bias"] = (cout,)

    def res(self, p, cin, cout):
        self[f"{p}.residual.0.gamma"] = (cin, 1, 1, 1)
        self.conv(f"{p}.residual.2", cin, cout, 3)
        self[f"{p}.residual.3.gamma"] = (cout, 1, 1, 1)
        self.conv(f"{p}.residual.6", cout, cout, 3)
        if cin != cout:
            self.conv(f"{p}.shortcut", cin, cout, 1)

    def middle(self, p, top):
        self.res(f"{p}.middle.0", top, top)
        self[f"{p}.middle.1.norm.gamma"] = (top, 1, 1)
        self.conv(f"{p}.middle.1.to_qkv", top, 3 * top, 1, causal=False)
        self.conv(f"{p}.middle.1.proj", top, top, 1, causal=False)
        self.res(f"{p}.middle.2", top, top)

    def time_conv(self, p, cin, cout):
        self[f"{p}.time_conv.weight"] = (cout, cin, 3, 1, 1)
        self[f"{p}.time_conv.bias"] = (cout,)


def param_shapes(cfg: WanVaeConfig) -> dict[str, tuple[int, ...]]:
    """The encoder's tensors as a Wan file holds them (torch layout): the
    causal convs as 5-D (O, I, kt, kh, kw) kernels (kt 3 for a 3x3 conv, 1
    for a 1x1), the downsamples' ``resample.1`` and the attention's
    projections as 4-D Conv2d kernels, the temporal downsamples'
    ``time_conv`` (O, I, 3, 1, 1), and each gamma with its broadcast dims."""
    shapes = _Shapes()
    shapes.conv("encoder.conv1", 3, cfg.dims[0], 3)
    down_index = 0
    for kind, name, in_dim, out_dim in encoder_layout(cfg):
        p = f"encoder.{name}"
        if kind == "res":
            shapes.res(p, in_dim, out_dim)
        else:
            shapes.conv(f"{p}.resample.1", out_dim, out_dim, 3, causal=False)
            if ENCODER_TEMPORAL[down_index]:
                shapes.time_conv(p, out_dim, out_dim)
            down_index += 1
    top = cfg.dims[-1]
    shapes.middle("encoder", top)
    shapes["encoder.head.0.gamma"] = (top, 1, 1, 1)
    shapes.conv("encoder.head.2", top, 2 * cfg.z_dim, 3)
    shapes.conv("conv1", 2 * cfg.z_dim, 2 * cfg.z_dim, 1)
    return dict(shapes)


def decoder_param_shapes(cfg: WanVaeConfig, *,
                         video: bool = False) -> dict[str, tuple[int, ...]]:
    """The decoder's tensors as a Wan file holds them (torch layout, as
    :func:`param_shapes`); ``video=True`` adds the temporal upsamples'
    ``time_conv`` (2C, C, 3, 1, 1) causal kernels that :func:`decode_video`
    needs (a full Wan file carries them)."""
    top = cfg.dim * cfg.dim_mult[-1]
    shapes = _Shapes()
    shapes.conv("conv2", cfg.z_dim, cfg.z_dim, 1)
    shapes.conv("decoder.conv1", cfg.z_dim, top, 3)
    shapes.middle("decoder", top)
    out_dim, up_index = cfg.dim, 0
    for kind, name, in_dim, out in decoder_layout(cfg):
        p = f"decoder.{name}"
        if kind == "res":
            shapes.res(p, in_dim, out)
        else:
            shapes.conv(f"{p}.resample.1", in_dim, out, 3, causal=False)
            if video and DECODER_TEMPORAL[up_index]:
                shapes.time_conv(p, in_dim, 2 * in_dim)
            up_index += 1
        out_dim = out
    shapes["decoder.head.0.gamma"] = (out_dim, 1, 1, 1)
    shapes.conv("decoder.head.2", out_dim, 3, 3)
    return dict(shapes)


def _random_params(shapes: dict, generator: torch.Generator, dtype, device) -> Params:
    device = generator.device if device is None else torch.device(device)
    params: Params = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name.endswith(".gamma"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = int(np.prod(shape[1:]))
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * (1.0 / max(fan_in, 1)) ** 0.5
            params[name] = w.to(dtype)
    return params


def init_params(cfg: WanVaeConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """A random encoder in a Wan file's layout (:func:`param_shapes`; load
    it with :func:`params_from_torch_state`): zero biases, unit gammas,
    N(0, 1/fan_in) kernels, drawn in sorted name order from ``generator``
    (on ``device``)."""
    return _random_params(param_shapes(cfg), generator, dtype, device)


def init_decoder_params(cfg: WanVaeConfig, generator: torch.Generator,
                        dtype=torch.float32, device=None, *,
                        video: bool = False) -> Params:
    """A random decoder (:func:`decoder_param_shapes`), drawn as
    :func:`init_params` draws the encoder."""
    return _random_params(decoder_param_shapes(cfg, video=video), generator, dtype,
                          device)


def params_from_torch_state(state: dict, dtype=torch.float32, device=None, *,
                            include_decoder: bool = False) -> Params:
    """``model.*`` checkpoint tensors (numpy or torch) -> the encoder's
    params in torch layout, kernels as stored (causal ones 5-D), gammas
    squeezed to (C,). ``include_decoder`` also keeps the ``decoder.*`` and
    ``conv2.*`` tensors (a full Wan file carries them; the reference's
    encode-only files do not)."""
    prefixes = ("encoder.", "conv1.") + (("decoder.", "conv2.") if include_decoder else ())
    params: Params = {}
    for key, value in state.items():
        if key.startswith("model."):
            key = key[len("model."):]
        if not key.startswith(prefixes):
            continue
        t = to_tensor(value)
        if key.endswith(".gamma"):
            t = t.reshape(t.shape[0])
        params[key] = t.to(device=device, dtype=dtype)
    if "encoder.conv1.weight" not in params:
        raise ValueError("No Wan VAE encoder tensors found in checkpoint")
    return params


def params_from_jax(flat_numpy_params: dict, dtype=torch.float32,
                    device=None) -> Params:
    """The JAX package's params, the encoder's and the decoder's (conv HWIO,
    causal THWIO), in torch layout (OIHW, OITHW)."""
    out: Params = {}
    for name, arr in flat_numpy_params.items():
        a = np.asarray(arr, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                                dtype=dtype)
    return out


def detect_config(params: Params) -> WanVaeConfig:
    """Base width and z-dim read off converted params, so a non-standard
    VAE (or a tiny test model) normalizes with the right latent slice."""
    dim = int(params["encoder.conv1.bias"].shape[0])
    z_dim = int(params["conv1.bias"].shape[0]) // 2
    return WanVaeConfig(dim=dim, z_dim=z_dim)
