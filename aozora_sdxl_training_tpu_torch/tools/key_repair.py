"""Anima DiT key-prefix repair: strip/normalize prefixes, rewrite streaming.

CLI form of the reference's PyQt tool
(reference scripts/anima_key_repair_gui.py:82-415): detect the current
key prefix (>=80% rule), strip or replace it, and rewrite the checkpoint
with the streaming writer (atomic tmp-rename + verification).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..ckpt.anima_checkpoint import DIT_PREFIXES, strip_prefix
from ..ckpt.safetensors_io import load_all, read_header, write_streaming


def detect_prefix(path) -> str:
    keys = tuple(read_header(path))
    for prefix in DIT_PREFIXES:
        if keys and sum(k.startswith(prefix) for k in keys) / len(keys) >= 0.8:
            return prefix
    return ""


def repair_keys(input_path, output_path, *, target_prefix: str = "") -> dict:
    """Rewrite the checkpoint with keys re-prefixed to ``target_prefix``."""
    state = load_all(input_path)
    stripped, detected = strip_prefix(state, DIT_PREFIXES)
    if target_prefix and not target_prefix.endswith("."):
        target_prefix += "."
    out = {f"{target_prefix}{k}": v for k, v in stripped.items()}
    write_streaming(Path(output_path), out)
    return {"detected_prefix": detected, "target_prefix": target_prefix,
            "tensors": len(out)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Strip/normalize Anima DiT key prefixes.")
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--prefix", default="",
                        help="target prefix (default: none)")
    parser.add_argument("--detect-only", action="store_true")
    args = parser.parse_args(argv)
    if args.detect_only:
        print(f"detected prefix: '{detect_prefix(args.input)}'")
        return
    info = repair_keys(args.input, args.output, target_prefix=args.prefix)
    print(f"Rewrote {info['tensors']} tensors: "
          f"'{info['detected_prefix']}' -> '{info['target_prefix']}' "
          f"-> {args.output}")


if __name__ == "__main__":
    main()
