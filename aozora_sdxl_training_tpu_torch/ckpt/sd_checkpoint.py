"""SD single-file checkpoint load + trained-UNet merge-back save.

Counterpart of ``aozora_sdxl_training_tpu/ckpt/sd_checkpoint.py``: load the
base checkpoint's tensors, and save a merged file in which the trained UNet
tensors replace theirs under the SD names while every other tensor streams
through from the base file, float ones cast to the compute dtype. The
port's params are already in torch layout, so no transposes happen here.
"""

from __future__ import annotations

from pathlib import Path

import ml_dtypes
import numpy as np
import torch

from .safetensors_io import (load_all, numpy_dtype_for, read_header,
                             read_tensor, write_streaming)
from .sd_keys import unet_key_mapping

_FLOAT_ST = {"F32", "F16", "BF16"}


def numpy_dtype_for_torch(compute_dtype) -> np.dtype:
    """The numpy dtype a torch float dtype is saved as (bf16 via ml_dtypes)."""
    if compute_dtype == torch.bfloat16:
        return np.dtype(ml_dtypes.bfloat16)
    if compute_dtype == torch.float16:
        return np.dtype(np.float16)
    return np.dtype(np.float32)


def tensor_to_numpy(t: torch.Tensor, np_dtype) -> np.ndarray:
    """Host copy of ``t`` in ``np_dtype`` (bf16 via ml_dtypes)."""
    np_dtype = np.dtype(np_dtype)
    t = t.detach()
    if np_dtype == np.dtype(ml_dtypes.bfloat16):
        return t.to(torch.bfloat16).cpu().view(torch.int16).numpy().view(np_dtype)
    torch_dtype = {np.dtype(np.float16): torch.float16,
                   np.dtype(np.float32): torch.float32}[np_dtype]
    return t.to(torch_dtype).cpu().numpy()


def load_sd_tensors(path, keys=None) -> dict:
    """Load checkpoint tensors as numpy (bf16 via ml_dtypes)."""
    return load_all(path, keys=keys)


def detect_unet_io_channels(path) -> tuple[int, int]:
    """(in_channels, out_channels) peeked from conv shapes."""
    in_ch, out_ch = 4, 4
    header = read_header(path)
    key_in = "model.diffusion_model.input_blocks.0.0.weight"
    key_out = "model.diffusion_model.out.2.weight"
    if key_in in header:
        in_ch = header[key_in]["shape"][1]
    if key_out in header:
        out_ch = header[key_out]["shape"][0]
    return in_ch, out_ch


def save_merged_checkpoint(output_path, params: dict, base_checkpoint_path,
                           compute_dtype) -> None:
    """Merge trained UNet params (torch layout, any float dtype, any device)
    into the base checkpoint and save, one tensor resident at a time."""
    output_path = Path(output_path)
    base_path = Path(base_checkpoint_path)
    out_np_dtype = numpy_dtype_for_torch(compute_dtype)

    hf_to_sd = unet_key_mapping(list(params.keys()))
    sd_from_params = {sd: hf for hf, sd in hf_to_sd.items()}

    base_header = read_header(base_path)
    print(f"INFO: Base checkpoint keys: {len(base_header)}")
    print(f"INFO: UNet keys to merge:   {len(hf_to_sd)}")

    tensors: dict = {}
    merged = 0
    new_keys = []

    def unet_entry(hf_key):
        t = params[hf_key]
        return (tuple(t.shape), out_np_dtype,
                lambda t=t: tensor_to_numpy(t, out_np_dtype))

    for sd_key, spec in base_header.items():
        if sd_key in sd_from_params:
            tensors[sd_key] = unet_entry(sd_from_params[sd_key])
            merged += 1
        else:
            dt = out_np_dtype if spec["dtype"] in _FLOAT_ST else None

            def produce(sd_key=sd_key, dt=dt):
                arr = read_tensor(base_path, sd_key)
                return arr.astype(dt, copy=False) if dt is not None else arr

            tensors[sd_key] = (tuple(spec["shape"]),
                               dt or numpy_dtype_for(spec["dtype"]), produce)

    # UNet keys absent from the base file get appended (reference behavior)
    for sd_key, hf_key in sd_from_params.items():
        if sd_key not in tensors:
            tensors[sd_key] = unet_entry(hf_key)
            new_keys.append(sd_key)
            merged += 1

    if new_keys:
        print(f"WARNING: {len(new_keys)} keys not found in base checkpoint "
              f"(new keys added): {new_keys[:5]}")

    write_streaming(output_path, tensors)
    print(f"INFO: Merged {merged} UNet tensors -> {output_path.name}")
