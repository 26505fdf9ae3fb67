"""CLI entry point: ``python -m aozora_sdxl_training_tpu_torch.cli.train_anima
--config preset.json`` — the PyTorch port of the JAX package's Anima DiT
trainer CLI (same JSON schema, same stdout grammar). Runs on CUDA; set
``AOZORA_PLATFORM=cpu`` to run on the CPU.
"""

from __future__ import annotations


def main(argv=None) -> None:
    from ..config.runtime import RuntimeConfig
    from ..core.platform import resolve_device
    from ..train.anima_trainer import run_anima_training

    device = resolve_device()
    config = RuntimeConfig.from_argv(argv)
    run_anima_training(config, device=device)


if __name__ == "__main__":
    main()
