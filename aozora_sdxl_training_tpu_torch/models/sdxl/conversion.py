"""SD single-file tensors <-> the port's flat UNet param dict.

Counterpart of ``aozora_sdxl_training_tpu/models/sdxl/conversion.py``. SD
checkpoints already hold torch layouts (conv OIHW, linear (out, in)), which
is the port's layout too, so loading is a key mapping plus a shape check.
``params_from_jax`` carries the JAX package's parameters (numpy, conv HWIO,
linear (in, out)) into the port so that both compute the same function;
``from_jax_layout`` and its inverse ``to_jax_layout`` are that layout map
for one tensor, which the training-state file and the int8 moments share.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ckpt.sd_keys import sd_to_hf_mapping, unet_key_mapping
from .arch import UNetConfig, hf_param_names, param_shapes
from .unet import torch_shape

Params = dict[str, torch.Tensor]


def torch_param_shapes(cfg: UNetConfig) -> dict[str, tuple[int, ...]]:
    return {n: torch_shape(s, k) for n, (s, k) in param_shapes(cfg).items()}


def to_tensor(array) -> torch.Tensor:
    """numpy (bf16 via ml_dtypes) or tensor -> CPU tensor, no float cast."""
    if isinstance(array, torch.Tensor):
        return array
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:      # frombuffer views of file bytes
        array = array.copy()
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def params_from_sd_state(sd_tensors: dict, cfg: UNetConfig,
                         dtype=torch.float32, device=None) -> Params:
    """Build the flat UNet param dict from an SD single-file tensor dict."""
    expected = torch_param_shapes(cfg)
    mapping = sd_to_hf_mapping(hf_param_names(cfg))
    params: Params = {}
    missing = []
    for sd_key, hf_key in mapping.items():
        if sd_key not in sd_tensors:
            missing.append(sd_key)
            continue
        t = to_tensor(sd_tensors[sd_key])
        if tuple(t.shape) != expected[hf_key]:
            raise ValueError(f"{hf_key}: checkpoint shape {tuple(t.shape)} "
                             f"!= expected {expected[hf_key]}")
        params[hf_key] = t.to(device=device, dtype=dtype)
    if missing:
        raise ValueError(
            f"Checkpoint is missing {len(missing)} UNet tensors, e.g. {missing[:5]}")
    return params


def sd_state_from_params(params: Params, dtype=torch.bfloat16) -> dict:
    """Flat param dict -> {sd_key: tensor} (torch layout already)."""
    mapping = unet_key_mapping(list(params.keys()))
    return {mapping[k]: v.to(dtype) for k, v in params.items()}


def from_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """One UNet tensor of the JAX package's layout in the port's, as a view:
    conv HWIO -> OIHW, linear (in, out) -> (out, in), the rest as it is."""
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    return t.t() if t.ndim == 2 else t


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``from_jax_layout``: OIHW -> HWIO, (out, in) -> (in,
    out), as a view."""
    if t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    return t.t() if t.ndim == 2 else t


def params_from_jax(flat_numpy_params: dict, dtype=torch.float32,
                    device=None) -> Params:
    """The JAX package's flat params (conv HWIO, linear (in, out)) in the
    port's torch layout (conv OIHW, linear (out, in))."""
    return {name: from_jax_layout(name, torch.from_numpy(np.array(arr, np.float32)))
            .contiguous().to(device=device, dtype=dtype)
            for name, arr in flat_numpy_params.items()}
