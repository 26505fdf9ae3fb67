"""Semantic theme palette + persisted GUI state.

Copy of ``aozora_sdxl_training_tpu/gui/theme.py``, kept in the port so that the
port imports nothing of the JAX package.

Mirrors the reference's theme engine (the reference's gui/gui_theme.py):
widgets consume semantic *roles* (surface, accent, danger, ...) instead of
raw colors, so retheming is a palette swap.  The reference emits Qt QSS;
here the palette maps onto ttk styles (``apply_to_ttk``) and exposes raw hex
for custom-drawn canvases.  Same default palette values, so screenshots of
both GUIs match.

``GuiState`` persists ``configs/gui_state.json`` with the reference's schema
(gui.py:3694-3720): ``last_config`` plus user theme/chart color overrides.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, fields


@dataclass(frozen=True)
class Theme:
    # Surfaces: deliberately close in value, from application to raised control.
    window: str = "#11151c"
    nested_group: str = "#11141d"
    deeply_nested: str = "#0b0e14"
    surface: str = "#12161e"
    surface_raised: str = "#181d27"
    surface_hover: str = "#202633"
    border: str = "#2b3242"
    border_muted: str = "#1b202b"

    # Content and interaction.
    text: str = "#e6e9f0"
    text_muted: str = "#8991a7"
    text_disabled: str = "#50586b"
    accent: str = "#c1845b"
    accent_hover: str = "#d59a72"
    accent_deep: str = "#805039"
    accent_alt: str = "#c1845b"
    danger: str = "#f05b72"
    danger_hover: str = "#ff7187"
    success: str = "#49d98a"
    warning: str = "#c2ad55"
    warning_hover: str = "#d5c36c"
    warning_deep: str = "#80702f"

    @property
    def chart(self) -> str:
        """Base group surface."""
        return self.surface

    @property
    def canvas(self) -> str:
        """Nested panels and custom-painted chart canvases."""
        return self.nested_group

    def color(self, role: str) -> str:
        return getattr(self, role)

    def with_overrides(self, overrides: dict) -> "Theme":
        """New theme with valid ``{role: "#rrggbb"}`` overrides applied."""
        valid = {f.name for f in fields(self)}
        clean = {k: v for k, v in (overrides or {}).items()
                 if k in valid and normalize_color(v)}
        return Theme(**{**{f.name: getattr(self, f.name) for f in fields(self)},
                        **{k: normalize_color(v) for k, v in clean.items()}})


THEME = Theme()

_HEX_RE = re.compile(r"^#?([0-9a-fA-F]{6})$")
_NAMED = {  # minimal named-color support for hand-edited state files
    "black": "#000000", "white": "#ffffff", "red": "#ff0000",
    "green": "#008000", "blue": "#0000ff", "orange": "#ffa500",
}


def normalize_color(value) -> str | None:
    """Return ``#rrggbb`` for a valid color string, else None
    (reference: QColor validation, gui.py:3721-3723)."""
    s = str(value).strip().lower()
    if s in _NAMED:
        return _NAMED[s]
    m = _HEX_RE.match(s)
    return f"#{m.group(1).lower()}" if m else None


def apply_to_ttk(style, theme: Theme = THEME) -> None:
    """Configure a ``tkinter.ttk.Style`` from the semantic palette."""
    t = theme
    style.theme_use("clam")
    style.configure(".", background=t.window, foreground=t.text,
                    fieldbackground=t.surface, bordercolor=t.border,
                    troughcolor=t.surface, focuscolor=t.accent)
    style.configure("TLabel", background=t.window, foreground=t.text)
    style.configure("TFrame", background=t.window)
    style.configure("TButton", background=t.surface_raised, foreground=t.text)
    style.map("TButton",
              background=[("active", t.surface_hover), ("pressed", t.accent_deep)])
    style.configure("Accent.TButton", background=t.accent, foreground=t.window)
    style.map("Accent.TButton", background=[("active", t.accent_hover)])
    style.configure("Danger.TButton", background=t.danger, foreground=t.window)
    style.map("Danger.TButton", background=[("active", t.danger_hover)])
    style.configure("TEntry", fieldbackground=t.surface, foreground=t.text,
                    insertcolor=t.text)
    style.configure("TCombobox", fieldbackground=t.surface, foreground=t.text)
    style.configure("Muted.TLabel", background=t.window, foreground=t.text_muted)
    style.configure("Status.TLabel", background=t.deeply_nested,
                    foreground=t.success)


class GuiState:
    """``configs/gui_state.json`` — last selected config + color overrides."""

    def __init__(self, config_dir: str):
        self.config_dir = config_dir
        self.state_file = os.path.join(config_dir, "gui_state.json")

    def read(self) -> dict:
        try:
            if os.path.exists(self.state_file):
                with open(self.state_file, encoding="utf-8") as f:
                    state = json.load(f)
                return state if isinstance(state, dict) else {}
        except Exception:  # noqa: BLE001 — corrupt state falls back to defaults
            pass
        return {}

    @property
    def last_config(self) -> str | None:
        return self.read().get("last_config")

    def theme(self) -> Theme:
        return THEME.with_overrides(self.read().get("theme_colors") or {})

    def save(self, *, last_config: str | None = None,
             theme_colors: dict | None = None,
             chart_colors: dict | None = None) -> None:
        state = self.read()
        if last_config is not None:
            state["last_config"] = last_config
        if theme_colors is not None:
            state["theme_colors"] = dict(theme_colors)
        if chart_colors is not None:
            state["chart_colors"] = dict(chart_colors)
        os.makedirs(self.config_dir, exist_ok=True)
        with open(self.state_file, "w", encoding="utf-8") as f:
            json.dump(state, f, indent=4)
