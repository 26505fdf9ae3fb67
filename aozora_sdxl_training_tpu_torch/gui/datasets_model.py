"""Headless dataset-manager model.

Copy of ``aozora_sdxl_training_tpu/gui/datasets_model.py``, kept in the port so that the
port imports nothing of the JAX package.

The reference's DatasetManagerWidget (gui/gui.py:2786-3567)
manages dataset "cards": folder path, per-dataset repeats, image counts,
preview thumbnails, sorting, and per-dataset cache clearing keyed to the
active mode's cache folder name (gui.py:3404-3445, 5922-5928).  The state
and file-system behavior live here, toolkit-free; the widgets only render.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass, field
from pathlib import Path

from ..train.timestep_presets import repeated_image_count

IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}


def cache_folder_names(config: dict) -> list[str]:
    """Cache dir names for the active mode (gui.py:5922-5928): Anima uses the
    configurable ANIMA_CACHE_FOLDER_NAME; SDXL picks the per-objective dir."""
    mode = str(config.get("TRAINING_MODE", "SDXL"))
    if mode.lower().startswith("anima"):
        return [str(config.get("ANIMA_CACHE_FOLDER_NAME",
                               ".precomputed_anima_dit_cache"))]
    if config.get("PREDICTION_TYPE") == "rectified_flow":
        return [".precomputed_embeddings_cache_rf"]
    return [".precomputed_embeddings_cache_standard_sdxl"]


def list_images(path: str | Path) -> list[Path]:
    root = Path(path)
    if not root.is_dir():
        return []
    return sorted(p for p in root.iterdir()
                  if p.suffix.lower() in IMAGE_EXTENSIONS and p.is_file())


@dataclass
class DatasetEntry:
    path: str
    repeats: int = 1
    images: list[Path] = field(default_factory=list)

    @property
    def image_count(self) -> int:
        return len(self.images)

    @property
    def total_with_repeats(self) -> int:
        return self.image_count * self.repeats

    def caption_for(self, image: Path) -> str | None:
        """Sidecar .txt caption preview (same pairing the cache builder uses)."""
        txt = image.with_suffix(".txt")
        if txt.is_file():
            try:
                return txt.read_text(encoding="utf-8").strip()
            except OSError:
                return None
        return None


class DatasetManager:
    """Ordered dataset list with config round-trip and cache maintenance."""

    def __init__(self, datasets_config=None):
        self.datasets: list[DatasetEntry] = []
        if datasets_config:
            self.load_config(datasets_config)

    # -- config round-trip (gui.py:2943, 3077-3085) -------------------------
    def load_config(self, datasets_config) -> None:
        self.datasets = []
        for item in datasets_config or []:
            path = str(item.get("path", ""))
            if not path:
                continue
            self.add(path, repeats=int(item.get("repeats", 1)))

    def get_config(self) -> list[dict]:
        return [{"path": d.path, "repeats": d.repeats} for d in self.datasets]

    # -- editing ------------------------------------------------------------
    def add(self, path: str, repeats: int = 1) -> DatasetEntry:
        entry = DatasetEntry(path=str(path), repeats=max(1, int(repeats)),
                             images=list_images(path))
        self.datasets.append(entry)
        return entry

    def remove(self, indices) -> None:
        for i in sorted(set(indices), reverse=True):
            if 0 <= i < len(self.datasets):
                self.datasets.pop(i)

    def set_repeats(self, index: int, repeats: int) -> None:
        if 0 <= index < len(self.datasets):
            self.datasets[index].repeats = max(1, int(repeats))

    def rescan(self, index: int | None = None) -> None:
        targets = self.datasets if index is None else [self.datasets[index]]
        for d in targets:
            d.images = list_images(d.path)

    def sort(self, key: str = "count_desc") -> None:
        """gui.py:3058-3075: name or image-count ordering."""
        if key == "name":
            self.datasets.sort(key=lambda d: Path(d.path).name.lower())
        elif key == "count_desc":
            self.datasets.sort(key=lambda d: d.image_count, reverse=True)
        elif key == "count_asc":
            self.datasets.sort(key=lambda d: d.image_count)
        else:
            raise ValueError(f"unknown sort key: {key}")

    def total_with_repeats(self) -> int:
        return repeated_image_count(
            [{"image_count": d.image_count, "repeats": d.repeats}
             for d in self.datasets])

    # -- cache maintenance (gui.py:3404-3445) -------------------------------
    def cache_exists(self, index: int, config: dict) -> bool:
        d = self.datasets[index]
        return any((Path(d.path) / name).is_dir()
                   for name in cache_folder_names(config))

    def clear_cache(self, index: int, config: dict) -> list[str]:
        """Delete the active-mode cache dirs under the dataset; returns the
        paths removed."""
        d = self.datasets[index]
        removed = []
        for name in cache_folder_names(config):
            cache_dir = Path(d.path) / name
            if cache_dir.is_dir():
                shutil.rmtree(cache_dir)
                removed.append(str(cache_dir))
        return removed
