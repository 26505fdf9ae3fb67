"""CLI entry point: ``python -m aozora_sdxl_training_tpu_torch.cli.train_anima
--config preset.json`` — the PyTorch port of the JAX package's Anima DiT
trainer CLI (same JSON schema, same stdout grammar). Runs on CUDA; set
``AOZORA_PLATFORM=cpu`` to run on the CPU.

Under torchrun it trains on every rank of the world, with the preset's
``SEQUENCE_PARALLEL_SIZE`` (ring attention) or ``PIPELINE_PARALLEL_SIZE``
(GPipe stages of the DiT blocks) and data parallelism over the rest:

    torchrun --nproc_per_node 2 -m aozora_sdxl_training_tpu_torch.cli.train_anima \\
        --config preset.json

Each rank takes ``cuda:LOCAL_RANK`` (``nccl``), or the CPU with ``gloo``
under ``AOZORA_PLATFORM=cpu``; the process group ends with the run.
"""

from __future__ import annotations


def main(argv=None) -> None:
    from ..config.runtime import RuntimeConfig
    from ..core.platform import resolve_device
    from ..parallel.sharding import (destroy_distributed, init_distributed,
                                     quiet_unless_rank_0)
    from ..train.anima_trainer import run_anima_training

    rank_device = init_distributed()
    try:
        with quiet_unless_rank_0():
            device = rank_device if rank_device is not None else resolve_device()
            config = RuntimeConfig.from_argv(argv)
            run_anima_training(config, device=device)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
