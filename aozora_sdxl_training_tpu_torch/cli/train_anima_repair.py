"""CLI: quantization-aware "repair" training of a quantized Anima DiT.

``python -m aozora_sdxl_training_tpu_torch.cli.train_anima_repair --config
preset.json``, where the preset's ``anima_dit_model_path`` points at the
*quantized* checkpoint: the PyTorch port of the JAX package's
``cli/train_anima_repair.py`` (the reference's experimental repair
trainer). It loads a ComfyUI-quantized DiT (``comfy_quant`` records),
trains it through the normal Anima flow-matching loop while projecting
every optimizer step back onto the packed quantized grid with
error-feedback residuals on the device (``train/qat_project.py``), and
saves the exact packed tensors (codes + scales) as
``repaired_quantized.safetensors`` in the output directory, under the
input's key prefix.

The line-art-masked loss is on unless the preset's ``anima`` block has the
key ``repair_lineart_loss_enabled`` (``_preset_sets_lineart_flag``, as the
JAX CLI reads it: the schema's ``anima_repair_lineart_loss_enabled`` does
not turn it off); ``anima_repair_target_format: bf16`` runs the normal
trainer with no projection (the control arm). Unlike the JAX CLI,
the dequantized fp32 weights reach the trainer in memory: no temporary
checkpoint is written. Runs on CUDA; set ``AOZORA_PLATFORM=cpu`` to run on
the CPU. Not ported yet: the CLI under torchrun (``WORLD_SIZE`` > 1).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _preset_sets_lineart_flag(argv) -> bool:
    """True if the --config preset explicitly carries the lineart flag."""
    import argparse
    import json

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", type=str)
    args, _ = parser.parse_known_args(argv)
    if not args.config or not Path(args.config).exists():
        return False
    try:
        raw = json.loads(Path(args.config).read_text(encoding="utf-8"))
    except (json.JSONDecodeError, OSError):
        return False
    return ("repair_lineart_loss_enabled" in raw.get("anima", {})
            or "ANIMA_REPAIR_LINEART_LOSS_ENABLED" in raw)


def main(argv=None) -> None:
    from ..ckpt.anima_checkpoint import DIT_PREFIXES, strip_prefix
    from ..ckpt.safetensors_io import load_all, write_streaming
    from ..config.runtime import RuntimeConfig
    from ..core.platform import resolve_device
    from ..train.anima_trainer import run_anima_training
    from ..train.qat_project import make_device_projector
    from ..train.qat_repair import ProjectedQuantController

    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise NotImplementedError(
            "the QAT repair CLI under torchrun (WORLD_SIZE > 1) is not ported to "
            "the PyTorch package yet; run it as one process")
    device = resolve_device()
    config = RuntimeConfig.from_argv(argv)
    # line-art-masked loss defaults ON in the repair trainer (the
    # reference's module constant) unless the preset says no
    if not _preset_sets_lineart_flag(argv):
        config.ANIMA_REPAIR_LINEART_LOSS_ENABLED = True

    # BF16 control arm: same objective (incl. the line-art-masked loss),
    # no quantization projection: the comparison baseline for repair
    # efficacy (the reference's AnimaBFloat16RepairController)
    fmt = str(getattr(config, "ANIMA_REPAIR_TARGET_FORMAT", "auto")).lower()
    if fmt in ("bf16", "bfp16", "bfloat16"):
        print("=" * 56)
        print("INFO: BF16 repair-control training enabled.")
        print("INFO: Line-art and flow-matching losses remain identical to "
              "quant repair.")
        print("INFO: Optimizer updates are not projected into quantized "
              "codes.")
        print("=" * 56)
        run_anima_training(config, device=device)
        return

    stripped, prefix = strip_prefix(load_all(config.DIT_PATH), DIT_PREFIXES)
    controller = ProjectedQuantController(stripped)
    if not controller.controlled_keys:
        raise SystemExit(
            f"{config.DIT_PATH} carries no comfy_quant records — run the "
            "standard trainer instead.")
    print(f"INFO: QAT repair: {len(controller.controlled_keys)} quantized "
          f"tensors under prefix '{prefix}'")

    # the projection runs on the device after every optimizer step (fp16
    # residuals beside the weights): no weight crosses to the host until
    # the save
    projector = make_device_projector(controller.formats, controller.nvfp4_multipliers)
    result = run_anima_training(config, device=device, device_projector=projector,
                                dit_state=(controller.dequantized_params(), prefix))

    # one host pass at save time: the effective weights (projected +
    # residual) quantized into the exact packed records
    final = result["trainable"]
    for k, r in (result["qat_residuals"] or {}).items():
        controller.residuals[k] = r.float().cpu().numpy()
    controller.project({k: final[k].detach().float().cpu().numpy()
                        for k in controller.formats if k in final})

    out = Path(config.OUTPUT_DIR) / "repaired_quantized.safetensors"
    # the exact packed representation under the original key prefix
    write_streaming(out, {f"{prefix}{k}": np.asarray(v)
                          for k, v in controller._state.items()},
                    metadata={"aozora_repair": "projected-quantized training"})
    print(f"INFO: packed quantized checkpoint saved -> {out}")


if __name__ == "__main__":
    main()
