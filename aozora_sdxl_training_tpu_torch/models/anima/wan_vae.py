"""Wan-style causal-3D VAE encoder in PyTorch (image mode) + tiled encode.

Counterpart of the image-mode encoder of
``aozora_sdxl_training_tpu/models/anima/wan_vae.py``, with the same graph
and numerics: Encoder3d with dim 96, z 16, mults (1, 2, 4, 4), channel-RMS
norms (``F.normalize`` along channels, eps 1e-12, x sqrt(C) x gamma), one
single-head spatial attention in the middle (an einsum over 384 channels:
no Pallas kernel runs here), the per-channel latent mean/std baked into the
encode, and a spatially tiled encode with ramped blend masks (tile 96x96
latent, stride 72x72, x8 pixels).

An image is one frame, and a causal 3D conv pads time with leading zeros,
so only the *last* temporal slice of each causal kernel (O, I, kt, kh, kw)
ever meets real data: every CausalConv3d is a 2D conv with ``w[:, :, -1]``.

* Parameters are a flat dict under the reference's ``encoder.*`` /
  ``conv1.*`` names (``model.`` dropped) in torch layout as a Wan file
  holds them (5-D causal kernels, 4-D Conv2d kernels, gammas squeezed to
  (C,)); ``params_from_jax`` carries the JAX package's HWIO / THWIO
  params across.
* The public functions take NHWC pixels and give NHWC latents (H/8, W/8,
  z) like the JAX ones; inside, activations are NCHW for ``F.conv2d``.
* The tiled encode's blend runs in numpy fp32 on the host, as in JAX.

The decoder and the video encode are not ported yet.
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
    xf = x.to(_stat_dtype(x.dtype))
    gamma = params[f"{name}.gamma"].to(xf.dtype)[None, :, None, None]
    y = F.normalize(xf, dim=1, eps=eps) * (x.shape[1] ** 0.5) * gamma
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
# Parameters
# --------------------------------------------------------------------------

def param_shapes(cfg: WanVaeConfig) -> dict[str, tuple[int, ...]]:
    """The encoder's tensors as a Wan file holds them (torch layout): the
    causal convs as 5-D (O, I, kt, kh, kw) kernels (kt 3 for a 3x3 conv, 1
    for a 1x1), the downsamples' ``resample.1`` and the attention's
    projections as 4-D Conv2d kernels, the temporal downsamples'
    ``time_conv`` (O, I, 3, 1, 1), and each gamma with its broadcast dims."""
    shapes: dict[str, tuple[int, ...]] = {}

    def conv(name, cin, cout, k, causal=True):
        shapes[f"{name}.weight"] = (cout, cin, k, k, k) if causal else (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)

    def res(p, cin, cout):
        shapes[f"{p}.residual.0.gamma"] = (cin, 1, 1, 1)
        conv(f"{p}.residual.2", cin, cout, 3)
        shapes[f"{p}.residual.3.gamma"] = (cout, 1, 1, 1)
        conv(f"{p}.residual.6", cout, cout, 3)
        if cin != cout:
            conv(f"{p}.shortcut", cin, cout, 1)

    conv("encoder.conv1", 3, cfg.dims[0], 3)
    temporal_flags = (False, True, True)  # the encoder's temporal downsamples
    down_index = 0
    for kind, name, in_dim, out_dim in encoder_layout(cfg):
        p = f"encoder.{name}"
        if kind == "res":
            res(p, in_dim, out_dim)
        else:
            conv(f"{p}.resample.1", out_dim, out_dim, 3, causal=False)
            if temporal_flags[down_index]:
                shapes[f"{p}.time_conv.weight"] = (out_dim, out_dim, 3, 1, 1)
                shapes[f"{p}.time_conv.bias"] = (out_dim,)
            down_index += 1
    top = cfg.dims[-1]
    res("encoder.middle.0", top, top)
    shapes["encoder.middle.1.norm.gamma"] = (top, 1, 1)
    conv("encoder.middle.1.to_qkv", top, 3 * top, 1, causal=False)
    conv("encoder.middle.1.proj", top, top, 1, causal=False)
    res("encoder.middle.2", top, top)
    shapes["encoder.head.0.gamma"] = (top, 1, 1, 1)
    conv("encoder.head.2", top, 2 * cfg.z_dim, 3)
    conv("conv1", 2 * cfg.z_dim, 2 * cfg.z_dim, 1)
    return shapes


def init_params(cfg: WanVaeConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """A random encoder in a Wan file's layout (:func:`param_shapes`; load
    it with :func:`params_from_torch_state`): zero biases, unit gammas,
    N(0, 1/fan_in) kernels, drawn in sorted name order from ``generator``
    (on ``device``)."""
    device = generator.device if device is None else torch.device(device)
    params: Params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
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


def params_from_torch_state(state: dict, dtype=torch.float32, device=None) -> Params:
    """``model.*`` checkpoint tensors (numpy or torch) -> the encoder's
    params in torch layout, kernels as stored (causal ones 5-D), gammas
    squeezed to (C,)."""
    params: Params = {}
    for key, value in state.items():
        if key.startswith("model."):
            key = key[len("model."):]
        if not key.startswith(("encoder.", "conv1.")):
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
    """The JAX package's params (conv HWIO, causal THWIO) in torch layout
    (OIHW, OITHW)."""
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
