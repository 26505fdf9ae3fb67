"""CLI: run the caching pass only.

``python -m aozora_sdxl_training_tpu_torch.cli.cache_datasets --config
preset.json [--rebuild | --clear]`` builds or refreshes the cache of the
preset's datasets for its active mode on the card (set
``AOZORA_PLATFORM=cpu`` to run it on the CPU) and exits: SDXL's VAE latents
and CLIP embeddings, or Anima's Wan VAE latents, Qwen3 embeddings and T5
ids. It is the standalone form of the caching phase the trainers run first.
``--clear`` deletes the active mode's cache dirs. The port of the JAX
package's CLI of the same name.
"""

from __future__ import annotations


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Build dataset caches.")
    parser.add_argument("--config", required=True)
    parser.add_argument("--rebuild", action="store_true",
                        help="force a full rebuild")
    parser.add_argument("--clear", action="store_true",
                        help="delete the active mode's cache dirs and exit "
                        "(the GUI dataset cards' cache-clear, CLI form)")
    args = parser.parse_args(argv)

    from ..config.runtime import RuntimeConfig

    config = RuntimeConfig.from_argv(["--config", args.config])
    if args.clear:
        import shutil
        from pathlib import Path

        from ..gui.datasets_model import cache_folder_names

        names = cache_folder_names({
            "TRAINING_MODE": config.TRAINING_MODE,
            "PREDICTION_TYPE": config.PREDICTION_TYPE,
            "ANIMA_CACHE_FOLDER_NAME": getattr(config, "ANIMA_CACHE_FOLDER_NAME", None),
        })
        removed = 0
        for entry in config.INSTANCE_DATASETS:
            root = Path(entry["path"] if isinstance(entry, dict) else entry)
            for name in names:
                cache_dir = root / name
                if cache_dir.is_dir():
                    shutil.rmtree(cache_dir)
                    print(f"INFO: removed {cache_dir}")
                    removed += 1
        print(f"INFO: cleared {removed} cache dir(s).")
        return
    if args.rebuild:
        config.REBUILD_CACHE = True

    from ..core.platform import resolve_device

    device = resolve_device()
    if str(config.TRAINING_MODE).lower().startswith("anima"):
        from ..data.anima_cache import (check_if_anima_caching_needed,
                                        precompute_and_cache_anima)
        if args.rebuild or check_if_anima_caching_needed(config):
            precompute_and_cache_anima(config, force=args.rebuild, device=device)
        else:
            print("INFO: Anima datasets already cached.")
    else:
        from ..data.cache_builder import check_if_caching_needed, precompute_and_cache
        if args.rebuild or check_if_caching_needed(config):
            precompute_and_cache(config, force=args.rebuild, device=device)
        else:
            print("INFO: Datasets already cached.")


if __name__ == "__main__":
    main()
