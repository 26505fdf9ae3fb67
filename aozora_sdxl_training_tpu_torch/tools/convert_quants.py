"""CLI: convert a trained DiT/UNet checkpoint to a quantized ComfyUI export.

Drop-in (headless) equivalent of the reference's
``scripts/convert_anima_to_quants.py`` simple mode: choose a format
(e4m3 / e5m2 / int8 / nvfp4 / ternary), a layer-selection preset
(target / broad / all), and write a comfy_quant-annotated safetensors
checkpoint via the streaming writer.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..ckpt.safetensors_io import load_all, write_streaming
from . import quantize as q


def convert_checkpoint(input_path, output_path, *, format_choice="e4m3",
                       preset="target", keep_dtype="bfloat16",
                       min_elements=4096, include=(), exclude=(),
                       nvfp4_scale_multiplier=1.0) -> dict:
    import ml_dtypes
    keep = {"bfloat16": np.dtype(ml_dtypes.bfloat16),
            "float16": np.dtype(np.float16),
            "float32": np.dtype(np.float32),
            "same": None}[keep_dtype]
    state = load_all(input_path)
    out, report = q.convert_state_dict(
        state, format_choice, preset=preset, keep_dtype=keep,
        min_elements=min_elements, include_patterns=include,
        exclude_patterns=exclude,
        nvfp4_scale_multiplier=nvfp4_scale_multiplier)
    write_streaming(Path(output_path), out,
                    metadata={"aozora_quant": json.dumps(report)})
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Quantize a checkpoint for ComfyUI (comfy_quant format).")
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--format", default="e4m3",
                        choices=sorted(q.FORMAT_CHOICES))
    parser.add_argument("--preset", default="target",
                        choices=["target", "broad", "all"])
    parser.add_argument("--keep-dtype", default="bfloat16",
                        choices=["bfloat16", "float16", "float32", "same"])
    parser.add_argument("--min-elements", type=int, default=4096)
    parser.add_argument("--include", action="append", default=[],
                        help="regex of keys to force-quantize")
    parser.add_argument("--exclude", action="append", default=[],
                        help="regex of keys to keep unquantized")
    parser.add_argument("--nvfp4-scale-multiplier", type=float, default=1.0)
    args = parser.parse_args(argv)
    report = convert_checkpoint(
        args.input, args.output, format_choice=args.format,
        preset=args.preset, keep_dtype=args.keep_dtype,
        min_elements=args.min_elements, include=args.include,
        exclude=args.exclude,
        nvfp4_scale_multiplier=args.nvfp4_scale_multiplier)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
