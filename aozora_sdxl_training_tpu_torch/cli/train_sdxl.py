"""CLI entry point: ``python -m aozora_sdxl_training_tpu_torch.cli.train_sdxl
--config preset.json`` — the PyTorch port of the JAX package's SDXL trainer
CLI (same JSON schema, same stdout grammar). Runs on CUDA; set
``AOZORA_PLATFORM=cpu`` to run on the CPU.

Under torchrun it trains on every rank of the world, data parallel with
the JAX package's FSDP layout (``BATCH_SIZE`` per rank):

    torchrun --nproc_per_node 2 -m aozora_sdxl_training_tpu_torch.cli.train_sdxl \\
        --config preset.json

Each rank takes ``cuda:LOCAL_RANK`` (``nccl``), or the CPU with ``gloo``
under ``AOZORA_PLATFORM=cpu``; a process group that already exists is
used as it is. The process group ends with the run, and only global rank
0 prints.
"""

from __future__ import annotations


def main(argv=None) -> None:
    from ..config.runtime import RuntimeConfig
    from ..core.platform import resolve_device
    from ..parallel.sharding import (destroy_distributed, init_distributed,
                                     quiet_unless_rank_0)
    from ..train.trainer import run_sdxl_training

    rank_device = init_distributed()
    try:
        with quiet_unless_rank_0():
            device = rank_device if rank_device is not None else resolve_device()
            config = RuntimeConfig.from_argv(argv)
            run_sdxl_training(config, device=device)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
