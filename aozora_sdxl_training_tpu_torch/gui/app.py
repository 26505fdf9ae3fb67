"""Training GUI (tkinter): preset editing, launch, live charts.

Counterpart of ``aozora_sdxl_training_tpu/gui/app.py``: a lightweight shell
over the same contracts the reference's PyQt GUI uses (the reference's
gui/gui.py): nested preset JSON in, trainer subprocess with ``--config``,
stdout grammar parsed into live status, ``force_save.flag`` emergency
checkpointing. Unlike the JAX app, which starts the repo's root
``train.py`` / ``train_anima.py`` scripts, this one starts the PyTorch
package's CLIs as modules (``python -u -m
aozora_sdxl_training_tpu_torch.cli.train_sdxl --config <preset>``, or
``...cli.train_anima``; ``trainer_command``), so a run from the GUI trains
on the CUDA card.

The heavy lifting is in toolkit-free models this file only renders:
``theme`` (semantic palette + gui_state.json), ``charts`` (series store with
min-max compaction), ``metrics`` (stdout grammar), ``datasets_model``
(dataset cards + cache clearing), ``curve_models`` (curve editing).

Run: ``python -m aozora_sdxl_training_tpu_torch.gui [preset.json]``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..config import schema
from .charts import ChartModel, sample
from .datasets_model import DatasetManager
from .log_buffer import CompressedLogBuffer
from .metrics import LiveMetrics
from .process_runner import (ProcessRunner, launch_trainer, request_force_save,
                             trainer_args)
from .theme import THEME, GuiState, apply_to_ttk

# keys in the always-visible quick-edit form; EVERY schema key is editable
# via the generated "All Settings..." window (ConfigFormWindow)
FORM_KEYS = [
    "SINGLE_FILE_CHECKPOINT_PATH", "DIT_PATH", "OUTPUT_DIR", "OUTPUT_NAME",
    "MAX_TRAIN_STEPS", "BATCH_SIZE", "GRADIENT_ACCUMULATION_STEPS",
    "PREDICTION_TYPE", "SEED", "SAVE_EVERY_N_STEPS", "UNET_EXCLUDE_TARGETS",
    "OPTIMIZER_TYPE", "MAX_BUCKET_RESOLUTION",
]

# the training CLIs the app launches, by the GUI's training mode
TRAINER_MODULES = {
    "sdxl": "aozora_sdxl_training_tpu_torch.cli.train_sdxl",
    "anima": "aozora_sdxl_training_tpu_torch.cli.train_anima",
}


def trainer_module(mode: str) -> str:
    """The CLI module for a training mode ("SDXL", "Anima DiT", ...)."""
    return TRAINER_MODULES["anima" if str(mode).lower().startswith("anima")
                           else "sdxl"]


def trainer_command(mode: str, preset, python=None) -> list[str]:
    """The argv the app launches for ``mode`` on ``preset``."""
    return trainer_args(trainer_module(mode), preset, python=python, module=True)


class ChartCanvas:
    """tk.Canvas renderer for a ChartModel with GraphPanel interaction:
    wheel = zoom about the cursor, drag = pan, double-click = reset to
    auto-follow, hover = nearest-point readout.  All window math lives in
    charts.ViewWindow (unit-tested headless)."""

    def __init__(self, parent, model: ChartModel, theme=THEME,
                 width=560, height=170):
        import tkinter as tk

        self.model = model
        self.theme = theme
        self.canvas = tk.Canvas(parent, width=width, height=height,
                                bg=theme.canvas, highlightthickness=1,
                                highlightbackground=theme.border)
        self._versions: tuple = ()
        self._pads = (46, 8, 18, 16)  # l, r, t, b
        self._drag_x: int | None = None
        self._hover: str = ""
        c = self.canvas
        c.bind("<MouseWheel>", self._wheel)
        c.bind("<Button-4>", lambda e: self._zoom(e, 0.8))
        c.bind("<Button-5>", lambda e: self._zoom(e, 1.25))
        c.bind("<ButtonPress-1>", self._press)
        c.bind("<B1-Motion>", self._drag)
        c.bind("<ButtonRelease-1>", lambda e: setattr(self, "_drag_x", None))
        c.bind("<Double-Button-1>", self._reset)
        c.bind("<Motion>", self._motion)
        c.bind("<Leave>", lambda e: self._set_hover(""))

    def grid(self, **kw):
        self.canvas.grid(**kw)

    # -- interaction ---------------------------------------------------
    def _frac_at(self, x_px) -> float:
        pad_l, pad_r, _, _ = self._pads
        w = int(self.canvas.winfo_width()) or int(self.canvas["width"])
        inner = max(w - pad_l - pad_r, 1)
        return min(max((x_px - pad_l) / inner, 0.0), 1.0)

    def _wheel(self, ev):
        self._zoom(ev, 0.8 if ev.delta > 0 else 1.25)

    def _zoom(self, ev, factor):
        self.model.zoom_at(self._frac_at(ev.x), factor)
        self._force_redraw()

    def _press(self, ev):
        self._drag_x = ev.x

    def _drag(self, ev):
        if self._drag_x is None:
            return
        pad_l, pad_r, _, _ = self._pads
        w = int(self.canvas.winfo_width()) or int(self.canvas["width"])
        inner = max(w - pad_l - pad_r, 1)
        self.model.pan_fraction((self._drag_x - ev.x) / inner)
        self._drag_x = ev.x
        self._force_redraw()

    def _reset(self, _ev):
        self.model.reset_view()
        self._force_redraw()

    def _motion(self, ev):
        x_lo, x_hi = self.model.view_range()
        x = x_lo + self._frac_at(ev.x) * (x_hi - x_lo)
        hit = self.model.nearest_point(x)
        if hit is None:
            self._set_hover("")
            return
        idx, (hx, hy) = hit
        label = self.model.series[idx].label
        self._set_hover(f"{label}: ({hx:g}, {hy:.5g})")

    def _set_hover(self, text):
        if text != self._hover:
            self._hover = text
            self._force_redraw()

    def _force_redraw(self):
        self._versions = ()
        self.redraw()

    # -- drawing -------------------------------------------------------
    def redraw(self) -> None:
        versions = (tuple(s.version for s in self.model.series),
                    self.model.view.lo, self.model.view.hi, self._hover)
        if versions == self._versions:
            return
        self._versions = versions
        c = self.canvas
        c.delete("all")
        w = int(c.winfo_width()) or int(c["width"])
        h = int(c.winfo_height()) or int(c["height"])
        pad_l, pad_r, pad_t, pad_b = self._pads
        x_lo, x_hi = self.model.view_range()
        ys = [y for s in self.model.series if s.visible
              for _, y in s.visible_slice(x_lo, x_hi)]
        if not ys:
            c.create_text(w // 2, h // 2, text=self.model.title,
                          fill=self.theme.text_muted)
            return
        y_lo, y_hi = min(ys), max(ys)
        if y_hi <= y_lo:
            y_hi = y_lo + 1e-9
        span_x, span_y = x_hi - x_lo, y_hi - y_lo

        def px(x):
            return pad_l + (x - x_lo) / span_x * (w - pad_l - pad_r)

        def py(y):
            return h - pad_b - (y - y_lo) / span_y * (h - pad_t - pad_b)

        for frac in (0.0, 0.5, 1.0):  # horizontal grid + y labels
            y = y_lo + frac * span_y
            c.create_line(pad_l, py(y), w - pad_r, py(y),
                          fill=self.theme.border)
            c.create_text(pad_l - 4, py(y), text=f"{y:.3g}", anchor="e",
                          fill=self.theme.text_muted, font=("TkDefaultFont", 7))
        title = self.model.title
        if not self.model.view.is_auto:
            title += "  [zoomed - double-click to reset]"
        c.create_text(pad_l, 8, text=title, anchor="w",
                      fill=self.theme.accent, font=("TkDefaultFont", 8, "bold"))
        if self._hover:
            c.create_text(w - pad_r, 8, text=self._hover, anchor="e",
                          fill=self.theme.text_muted, font=("TkDefaultFont", 7))
        for s in self.model.series:
            if not s.visible or len(s.data) < 2:
                continue
            pts = sample(s.visible_slice(x_lo, x_hi), 400)
            coords = []
            for x, y in pts:
                coords.extend((px(x), py(y)))
            dash = () if s.line_style == "solid" else (4, 3)
            c.create_line(*coords, fill=s.color, width=s.linewidth, dash=dash)


class DistributionCanvas:
    """Live timestep/sigma histogram + mean-loss-by-bin overlay — the tk
    rendering of the reference's LiveMetricsWidget distribution panels
    (gui.py:1853-1943).  Data comes from LiveMetrics.{timestep_histogram,
    sigma_histogram, mean_loss_by_*} each refresh."""

    def __init__(self, parent, metrics_provider, theme=THEME,
                 width=560, height=120, bins=25):
        import tkinter as tk

        self.metrics_provider = metrics_provider
        self.theme = theme
        self.bins = bins
        self.canvas = tk.Canvas(parent, width=width, height=height,
                                bg=theme.canvas, highlightthickness=1,
                                highlightbackground=theme.border)
        self._last: tuple = ()

    def grid(self, **kw):
        self.canvas.grid(**kw)

    def redraw(self) -> None:
        m = self.metrics_provider()
        use_sigma = bool(m.sigmas)
        if use_sigma:
            edges, counts = m.sigma_histogram(self.bins)
            _, means, _ = m.mean_loss_by_sigma(self.bins)
            title = "Sigma distribution + mean loss by sigma"
        else:
            edges, counts = m.timestep_histogram(self.bins)
            _, means, _ = m.mean_loss_by_timestep(self.bins)
            title = "Timestep distribution + mean loss by timestep"
        key = (tuple(counts), tuple(x if x is not None else -1
                                    for x in means))
        if key == self._last:
            return
        self._last = key
        c = self.canvas
        c.delete("all")
        w = int(c.winfo_width()) or int(c["width"])
        h = int(c.winfo_height()) or int(c["height"])
        pad_l, pad_r, pad_t, pad_b = 46, 8, 16, 12
        c.create_text(pad_l, 8, text=title, anchor="w",
                      fill=self.theme.accent, font=("TkDefaultFont", 8, "bold"))
        total = sum(counts)
        if not total:
            c.create_text(w // 2, h // 2, text="(no samples yet)",
                          fill=self.theme.text_muted)
            return
        inner_w = w - pad_l - pad_r
        inner_h = h - pad_t - pad_b
        peak = max(counts) or 1
        n = len(counts)
        for i, count in enumerate(counts):
            x0 = pad_l + inner_w * i / n
            x1 = pad_l + inner_w * (i + 1) / n - 1
            bar = inner_h * count / peak
            c.create_rectangle(x0, h - pad_b - bar, x1, h - pad_b,
                               fill=self.theme.accent, outline="")
        known = [x for x in means if x is not None]
        if known:
            lo, hi = min(known), max(known)
            span = (hi - lo) or 1e-9
            coords = []
            for i, mean in enumerate(means):
                if mean is None:
                    continue
                cx = pad_l + inner_w * (i + 0.5) / n
                cy = h - pad_b - inner_h * (mean - lo) / span
                coords.extend((cx, cy))
            if len(coords) >= 4:
                c.create_line(*coords, fill=self.theme.danger, width=2)
            c.create_text(w - pad_r, 8, anchor="e",
                          text=f"mean loss {lo:.3f}..{hi:.3f}",
                          fill=self.theme.text_muted, font=("TkDefaultFont", 7))


class ConfigFormWindow:
    """Toplevel with a form generated from EVERY schema Field for the
    current mode (the reference builds a widget per config key,
    gui.py:4034); booleans render as checkboxes, lists/dicts as JSON
    entries, everything else as text entries coerced by schema defaults."""

    def __init__(self, parent, flat: dict, mode_label: str, theme=THEME,
                 on_apply=None, log=print):
        import tkinter as tk
        from tkinter import ttk

        self.flat = flat
        self.on_apply = on_apply or (lambda: None)
        self.log = log
        self.win = tk.Toplevel(parent)
        self.win.title(f"All settings ({mode_label})")
        self.win.configure(bg=theme.window)
        self.win.geometry("720x640")

        mode_key = schema.mode_key_from_label(mode_label)
        keys = ["TRAINING_MODE"] + schema.mode_flat_keys(mode_key)

        outer = ttk.Frame(self.win)
        outer.pack(fill="both", expand=True)
        canvas = tk.Canvas(outer, bg=theme.window, highlightthickness=0)
        scroll = ttk.Scrollbar(outer, orient="vertical",
                               command=canvas.yview)
        body = ttk.Frame(canvas)
        body.bind("<Configure>", lambda e: canvas.configure(
            scrollregion=canvas.bbox("all")))
        canvas.create_window((0, 0), window=body, anchor="nw")
        canvas.configure(yscrollcommand=scroll.set)
        canvas.pack(side="left", fill="both", expand=True)
        scroll.pack(side="right", fill="y")

        self.vars: dict = {}
        for row, key in enumerate(keys):
            default = schema.default_value(key)
            value = flat.get(key, default)
            ttk.Label(body, text=key).grid(row=row, column=0, sticky="w",
                                           padx=4, pady=1)
            if isinstance(default, bool):
                var = tk.BooleanVar(value=bool(value))
                ttk.Checkbutton(body, variable=var).grid(
                    row=row, column=1, sticky="w")
            elif isinstance(default, (list, dict)):
                var = tk.StringVar(value=json.dumps(value))
                ttk.Entry(body, textvariable=var, width=58).grid(
                    row=row, column=1, sticky="we")
            else:
                var = tk.StringVar(value=str(value))
                ttk.Entry(body, textvariable=var, width=58).grid(
                    row=row, column=1, sticky="we")
            self.vars[key] = var

        ttk.Button(self.win, text="Apply", style="Accent.TButton",
                   command=self.apply).pack(pady=4)

    def apply(self):
        errors = []
        for key, var in self.vars.items():
            default = schema.default_value(key)
            raw = var.get()
            try:
                if isinstance(default, bool):
                    value = bool(raw) if not isinstance(raw, str) else \
                        raw.lower() in ("true", "1", "yes")
                elif isinstance(default, (list, dict)):
                    value = json.loads(raw) if isinstance(raw, str) else raw
                elif isinstance(default, int):
                    value = int(float(raw))
                elif isinstance(default, float):
                    value = float(raw)
                else:
                    value = raw
            except (ValueError, json.JSONDecodeError) as e:
                errors.append(f"{key}: {e}")
                continue
            self.flat[key] = value
        for err in errors:
            self.log(f"[gui] settings: kept previous value ({err})")
        self.on_apply()
        self.win.destroy()


class EditorCanvas:
    """tk.Canvas bound to a CurveEditorViewModel / HistogramEditorViewModel.

    Pure event forwarding + primitive rendering; every interaction rule
    lives in the view-model (curve_editor.py) where it is unit-tested.
    """

    def __init__(self, parent, vm, theme=THEME, on_change=None,
                 histogram=False):
        import tkinter as tk

        self.vm = vm
        self.theme = theme
        self.on_change = on_change or (lambda: None)
        self.histogram = histogram
        self.canvas = tk.Canvas(parent, width=vm.width, height=vm.height,
                                bg=theme.canvas, highlightthickness=1,
                                highlightbackground=theme.border)
        c = self.canvas
        c.bind("<ButtonPress-1>", self._press)
        c.bind("<B1-Motion>", self._drag)
        c.bind("<ButtonRelease-1>", self._release)
        c.bind("<Double-Button-1>", self._double)
        c.bind("<ButtonPress-3>", self._right)
        c.bind("<Configure>", self._configure)
        self.redraw()

    def pack(self, **kw):
        self.canvas.pack(**kw)

    def _configure(self, ev):
        self.vm.resize(ev.width, ev.height)
        self.redraw()

    def _press(self, ev):
        self.vm.press(ev.x, ev.y)
        self.redraw()

    def _drag(self, ev):
        if self.vm.drag(ev.x, ev.y):
            self.on_change()
            self.redraw()

    def _release(self, _ev):
        self.vm.release()
        self.on_change()
        self.redraw()

    def _double(self, ev):
        if not self.histogram and self.vm.double_press(ev.x, ev.y) >= 0:
            self.on_change()
            self.redraw()

    def _right(self, ev):
        if not self.histogram and self.vm.right_press(ev.x, ev.y):
            self.on_change()
            self.redraw()

    def redraw(self):
        c = self.canvas
        c.delete("all")
        t = self.theme
        if self.histogram:
            for x0, y0, x1, y1 in self.vm.bars_px():
                c.create_rectangle(x0, y0, x1, y1, fill=t.accent,
                                   outline=t.border)
            return
        for py, label in self.vm.y_ticks():
            c.create_line(self.vm.pad_l, py, self.vm.width - self.vm.pad_r,
                          py, fill=t.border)
            c.create_text(self.vm.pad_l - 4, py, text=label, anchor="e",
                          fill=t.text_muted, font=("TkDefaultFont", 7))
        line = self.vm.polyline_px()
        if len(line) >= 2:
            coords = [v for xy in line for v in xy]
            c.create_line(*coords, fill=t.accent, width=2)
        for hx, hy, sel in self.vm.handles_px():
            r = 5 if sel else 4
            c.create_oval(hx - r, hy - r, hx + r, hy + r,
                          fill=(t.warning if sel else t.success),
                          outline=t.border)


class CurveEditorWindow:
    """Toplevel with the three curve editors (LR / loss weight / timestep
    histogram).  Apply writes the same flat keys the reference's Qt editors
    persist: LR_CUSTOM_CURVE, TIMESTEP_LOSS_WEIGHT_CURVE,
    TIMESTEP_ALLOCATION."""

    def __init__(self, parent, flat: dict, theme=THEME, on_apply=None):
        import tkinter as tk
        from tkinter import ttk

        from .curve_editor import (CurveEditorViewModel,
                                   HistogramEditorViewModel)
        from .curve_models import (LRCurveModel, LossWeightCurveModel,
                                   TimestepHistogramModel)

        self.flat = flat
        self.on_apply = on_apply or (lambda: None)
        self.win = tk.Toplevel(parent)
        self.win.title("Curve editors")
        self.win.configure(bg=theme.window)

        min_lr = float(flat.get("LR_GRAPH_MIN", 0.0)) or 1e-9
        max_lr = float(flat.get("LR_GRAPH_MAX", 1e-6)) or 1e-6
        self.lr_model = LRCurveModel(flat.get("LR_CUSTOM_CURVE"),
                                     min_lr=min_lr, max_lr=max_lr)
        self.lw_model = LossWeightCurveModel(
            flat.get("TIMESTEP_LOSS_WEIGHT_CURVE"))
        alloc = flat.get("TIMESTEP_ALLOCATION") or {}
        self.ts_model = TimestepHistogramModel(
            bin_size=int(alloc.get("bin_size", 100)) or 100,
            max_tickets=max(int(flat.get("MAX_TRAIN_STEPS", 1000)), 1))
        self.ts_model.set_allocation(alloc)

        nb = ttk.Notebook(self.win)
        nb.pack(fill="both", expand=True, padx=4, pady=4)

        tabs = [
            ("LR curve (log y)", CurveEditorViewModel(
                self.lr_model, y_scale="log"), False),
            ("Loss weight", CurveEditorViewModel(
                self.lw_model, y_min=0.0, y_max=2.0), False),
            ("Timestep histogram", HistogramEditorViewModel(self.ts_model),
             True),
        ]
        self.canvases = []
        for label, vm, hist in tabs:
            frame = ttk.Frame(nb)
            nb.add(frame, text=label)
            ec = EditorCanvas(frame, vm, theme, histogram=hist)
            ec.pack(fill="both", expand=True)
            self.canvases.append(ec)
            if hist:
                row = ttk.Frame(frame)
                row.pack(fill="x")
                for mode in ("Uniform", "Wave", "Logit-Normal", "Beta",
                             "Odds-Scaled (Z-Image)"):
                    ttk.Button(row, text=mode, command=(
                        lambda m=mode, e=ec: self._ts_preset(m, e))
                    ).pack(side="left", padx=1)
            elif vm.model is self.lw_model:
                row = ttk.Frame(frame)
                row.pack(fill="x")
                ttk.Button(row, text="Bell", command=(
                    lambda e=ec: self._lw_preset("bell", e))).pack(
                    side="left", padx=1)
                ttk.Button(row, text="Min-SNR-like", command=(
                    lambda e=ec: self._lw_preset("min_snr", e))).pack(
                    side="left", padx=1)
            else:
                row = ttk.Frame(frame)
                row.pack(fill="x")
                for mode in ("Constant", "Linear", "Cosine"):
                    ttk.Button(row, text=mode, command=(
                        lambda m=mode, e=ec: self._lr_preset(m, e))
                    ).pack(side="left", padx=1)
        ttk.Label(self.win, text="drag = move point | double-click = add | "
                                 "right-click = remove",
                  style="Muted.TLabel").pack(anchor="w", padx=6)
        ttk.Button(self.win, text="Apply", style="Accent.TButton",
                   command=self.apply).pack(pady=4)

    def _lr_preset(self, mode, ec):
        self.lr_model.set_standard_preset(mode)
        ec.redraw()

    def _lw_preset(self, which, ec):
        if which == "bell":
            self.lw_model.apply_bell_preset()
        else:
            self.lw_model.apply_min_snr_like_preset()
        ec.redraw()

    def _ts_preset(self, mode, ec):
        if mode == "Uniform":
            self.ts_model.set_bin_size(self.ts_model.bin_size)
        else:
            self.ts_model.apply_distribution(mode)
        ec.redraw()

    def apply(self):
        self.flat["LR_CUSTOM_CURVE"] = self.lr_model.get_points()
        self.flat["TIMESTEP_LOSS_WEIGHT_CURVE"] = self.lw_model.get_points()
        self.flat["TIMESTEP_ALLOCATION"] = self.ts_model.get_allocation()
        self.on_apply()
        self.win.destroy()


class DatasetManagerWindow:
    """Toplevel with dataset cards: path, repeats, image count, first-image
    thumbnail (tk PhotoImage, PNG/GIF only), per-dataset cache clearing —
    the tkinter rendering of DatasetManager (gui.py:2786-3567)."""

    def __init__(self, parent, manager, config_provider, theme=THEME,
                 on_change=None, log=print):
        import tkinter as tk
        from tkinter import ttk

        self.tk = tk
        self.manager = manager
        self.config_provider = config_provider
        self.on_change = on_change or (lambda: None)
        self.log = log
        self.theme = theme
        self.win = tk.Toplevel(parent)
        self.win.title("Datasets")
        self.win.configure(bg=theme.window)
        bar = ttk.Frame(self.win)
        bar.pack(fill="x", padx=4, pady=2)
        ttk.Button(bar, text="Add folder...", command=self._add).pack(
            side="left")
        ttk.Button(bar, text="Sort by count", command=(
            lambda: self._sort("count_desc"))).pack(side="left", padx=2)
        ttk.Button(bar, text="Sort by name", command=(
            lambda: self._sort("name"))).pack(side="left")
        self.cards = ttk.Frame(self.win)
        self.cards.pack(fill="both", expand=True, padx=4, pady=2)
        self._thumbs = []  # keep PhotoImage refs alive
        self.rebuild()

    def _add(self):
        from tkinter import filedialog
        path = filedialog.askdirectory(parent=self.win)
        if path:
            self.manager.add(path)
            self._changed()

    def _sort(self, key):
        self.manager.sort(key)
        self._changed()

    def _changed(self):
        self.on_change()
        self.rebuild()

    def rebuild(self):
        from tkinter import ttk
        for child in self.cards.winfo_children():
            child.destroy()
        self._thumbs.clear()
        cfg = self.config_provider()
        for i, entry in enumerate(self.manager.datasets):
            card = ttk.Frame(self.cards, relief="groove", borderwidth=1,
                             padding=4)
            card.pack(fill="x", pady=2)
            thumb = self._thumbnail(entry)
            if thumb is not None:
                self._thumbs.append(thumb)
                self.tk.Label(card, image=thumb,
                              bg=self.theme.canvas).pack(side="left", padx=4)
            info = ttk.Frame(card)
            info.pack(side="left", fill="x", expand=True)
            ttk.Label(info, text=entry.path).pack(anchor="w")
            ttk.Label(info, style="Muted.TLabel",
                      text=f"{entry.image_count} images x {entry.repeats} "
                           f"repeats = {entry.total_with_repeats}").pack(
                anchor="w")
            spin = ttk.Spinbox(card, from_=1, to=999, width=5, command=None)
            spin.set(entry.repeats)
            spin.configure(command=lambda i=i, s=spin: self._set_repeats(i, s))
            spin.pack(side="left", padx=4)
            cache_on = self.manager.cache_exists(i, cfg)
            ttk.Button(card, text=("Clear cache" if cache_on else "no cache"),
                       state=("normal" if cache_on else "disabled"),
                       command=lambda i=i: self._clear(i)).pack(
                side="left", padx=2)
            ttk.Button(card, text="Remove",
                       style="Danger.TButton",
                       command=lambda i=i: self._remove(i)).pack(
                side="left", padx=2)

    def _thumbnail(self, entry):
        for img in entry.images[:4]:
            if img.suffix.lower() in (".png", ".gif"):
                try:
                    photo = self.tk.PhotoImage(file=str(img))
                    f = max(1, photo.width() // 64, photo.height() // 64)
                    return photo.subsample(f, f)
                except Exception:  # noqa: BLE001 — bad image, skip preview
                    continue
        return None

    def _set_repeats(self, i, spin):
        try:
            self.manager.set_repeats(i, int(spin.get()))
        except ValueError:
            return
        self._changed()

    def _remove(self, i):
        self.manager.remove([i])
        self._changed()

    def _clear(self, i):
        for path in self.manager.clear_cache(i, self.config_provider()):
            self.log(f"[gui] cleared cache {path}")
        self.rebuild()


class TrainingApp:
    def __init__(self, root, preset_path: str | None = None):
        import tkinter as tk
        from tkinter import ttk

        self.root = root
        self.tk_module = tk
        root.title("Aozora Trainer (PyTorch, CUDA)")
        self.state = GuiState(str(Path("configs")))
        self.theme = self.state.theme()
        root.configure(bg=self.theme.window)
        apply_to_ttk(ttk.Style(root), self.theme)

        if preset_path is None:
            preset_path = self.state.last_config or "preset.json"
        self.preset_path = Path(preset_path)
        self.flat = schema.flat_defaults()
        if self.preset_path.exists():
            with open(self.preset_path, encoding="utf-8") as f:
                self.flat = schema.flatten_preset(json.load(f))
        self.metrics = LiveMetrics()
        self.log = CompressedLogBuffer()
        self.runner: ProcessRunner | None = None
        self.datasets = DatasetManager(self.flat.get("INSTANCE_DATASETS"))

        top = ttk.Frame(root, padding=6)
        top.pack(fill="both", expand=True)

        # mode + form
        self.mode_var = tk.StringVar(value=self.flat.get("TRAINING_MODE", "SDXL"))
        ttk.Label(top, text="Mode").grid(row=0, column=0, sticky="w")
        ttk.Combobox(top, textvariable=self.mode_var,
                     values=["SDXL", "Anima DiT"], width=12,
                     state="readonly").grid(row=0, column=1, sticky="w")
        self.entries = {}
        for i, key in enumerate(FORM_KEYS, start=1):
            ttk.Label(top, text=key).grid(row=i, column=0, sticky="w")
            var = tk.StringVar(value=str(self.flat.get(key, "")))
            ttk.Entry(top, textvariable=var, width=52).grid(
                row=i, column=1, sticky="we")
            self.entries[key] = var

        # dataset summary (counts via the headless manager)
        self.dataset_var = tk.StringVar(value=self._dataset_summary())
        ttk.Label(top, textvariable=self.dataset_var,
                  style="Muted.TLabel").grid(
            row=len(FORM_KEYS) + 1, column=0, columnspan=2, sticky="w")

        # curve presets (edit the same preset keys the Qt editors write)
        curves = ttk.Frame(top)
        curves.grid(row=len(FORM_KEYS) + 2, column=0, columnspan=2, sticky="w")
        ttk.Label(curves, text="LR curve:").pack(side="left")
        self.lr_preset_var = tk.StringVar(value="Cosine")
        ttk.Combobox(curves, textvariable=self.lr_preset_var, width=9,
                     values=["Constant", "Linear", "Cosine"],
                     state="readonly").pack(side="left", padx=2)
        ttk.Button(curves, text="Apply",
                   command=self.apply_lr_preset).pack(side="left", padx=2)
        ttk.Label(curves, text="  Timesteps:").pack(side="left")
        # restore the preset's stored mode (reference gui.py:5734)
        self.ts_preset_var = tk.StringVar(
            value=str(self.flat.get("TIMESTEP_MODE", "Wave") or "Wave"))
        ttk.Combobox(curves, textvariable=self.ts_preset_var, width=20,
                     values=["Uniform", "Wave", "Logit-Normal", "Beta",
                             "Odds-Scaled (Z-Image)"],
                     state="readonly").pack(side="left", padx=2)
        ttk.Button(curves, text="Apply",
                   command=self.apply_timestep_preset).pack(side="left", padx=2)
        ttk.Button(curves, text="Bell loss wt",
                   command=self.apply_bell_loss_weight).pack(side="left", padx=2)
        ttk.Button(curves, text="Edit Curves...",
                   command=self.open_curve_editor).pack(side="left", padx=6)
        ttk.Button(curves, text="Datasets...",
                   command=self.open_dataset_manager).pack(side="left")
        ttk.Button(curves, text="All Settings...",
                   command=self.open_all_settings).pack(side="left", padx=6)

        # buttons
        btns = ttk.Frame(top)
        btns.grid(row=len(FORM_KEYS) + 3, column=0, columnspan=2, pady=4)
        ttk.Button(btns, text="Save Preset", command=self.save_preset).pack(
            side="left", padx=2)
        self.start_btn = ttk.Button(btns, text="Train", style="Accent.TButton",
                                    command=self.start_training)
        self.start_btn.pack(side="left", padx=2)
        ttk.Button(btns, text="Stop", style="Danger.TButton",
                   command=self.stop_training).pack(side="left", padx=2)
        ttk.Button(btns, text="Force Save",
                   command=self.force_save).pack(side="left", padx=2)
        ttk.Button(btns, text="Clear Caches",
                   command=self.clear_caches).pack(side="left", padx=2)

        self.status_var = tk.StringVar(value="idle")
        ttk.Label(top, textvariable=self.status_var).grid(
            row=len(FORM_KEYS) + 4, column=0, columnspan=2, sticky="w")

        # live charts fed from LiveMetrics series
        self.loss_chart = ChartModel("Loss", "loss")
        self.loss_chart.add_line("step loss", self.theme.accent, linewidth=1)
        self.loss_chart.add_line("ema", self.theme.success, linewidth=2)
        self.lr_chart = ChartModel("LR / Grad Norm", "lr")
        self.lr_chart.add_line("lr", self.theme.warning)
        self.lr_chart.add_line("grad (clipped)", self.theme.danger,
                               line_style="dash", linewidth=1)
        self.loss_canvas = ChartCanvas(top, self.loss_chart, self.theme)
        self.loss_canvas.grid(row=len(FORM_KEYS) + 5, column=0, columnspan=2,
                              sticky="we", pady=2)
        self.lr_canvas = ChartCanvas(top, self.lr_chart, self.theme)
        self.lr_canvas.grid(row=len(FORM_KEYS) + 6, column=0, columnspan=2,
                            sticky="we", pady=2)
        self._chart_fed = [0, 0, 0, 0]
        # live timestep/sigma histogram + mean-loss-by-bin overlay
        self.dist_canvas = DistributionCanvas(top, lambda: self.metrics,
                                              self.theme)
        self.dist_canvas.grid(row=len(FORM_KEYS) + 7, column=0, columnspan=2,
                              sticky="we", pady=2)

        self.console = tk.Text(top, height=12, width=90, state="disabled",
                               bg=self.theme.deeply_nested,
                               fg=self.theme.text,
                               insertbackground=self.theme.text)
        self.console.grid(row=len(FORM_KEYS) + 8, column=0, columnspan=2,
                          sticky="nsew")
        # latest in-training preview image (train/sampler.py announces
        # "INFO: preview image saved -> ..."; PNG loads via tk.PhotoImage)
        self.preview_label = ttk.Label(top, text="")
        self.preview_label.grid(row=len(FORM_KEYS) + 9, column=0,
                                columnspan=2, sticky="w")
        self._preview_shown: str | None = None
        self._preview_photo = None  # keep the PhotoImage ref alive
        root.after(200, self._refresh)

    # -- preset -------------------------------------------------------------
    def collect_flat(self) -> dict:
        flat = dict(self.flat)
        flat["TRAINING_MODE"] = self.mode_var.get()
        for key, var in self.entries.items():
            default = schema.default_value(key)
            value = var.get()
            if isinstance(default, bool):
                value = value.lower() in ("true", "1", "yes")
            elif isinstance(default, int):
                try:
                    value = int(float(value))
                except ValueError:
                    value = default
            elif isinstance(default, float):
                try:
                    value = float(value)
                except ValueError:
                    value = default
            flat[key] = value
        return flat

    def save_preset(self) -> Path:
        flat = self.collect_flat()
        preset = schema.nest_flat_config(flat)
        with open(self.preset_path, "w", encoding="utf-8") as f:
            json.dump(preset, f, indent=1)
        self.state.save(last_config=str(self.preset_path))
        self._log_line(f"[gui] preset saved -> {self.preset_path}")
        return self.preset_path

    # -- curve presets (same keys the reference's Qt editors write) ---------
    def apply_lr_preset(self):
        from .curve_models import LRCurveModel

        min_lr = float(self.flat.get("LR_GRAPH_MIN", 0.0)) or 1e-9
        max_lr = float(self.flat.get("LR_GRAPH_MAX", 1e-6))
        model = LRCurveModel(min_lr=min_lr, max_lr=max_lr)
        model.set_standard_preset(self.lr_preset_var.get())
        self.flat["LR_CUSTOM_CURVE"] = model.get_points()
        self._log_line(f"[gui] LR curve preset -> {self.lr_preset_var.get()}")

    def apply_timestep_preset(self):
        from .curve_models import TimestepHistogramModel

        try:
            steps = int(float(self.entries["MAX_TRAIN_STEPS"].get()))
        except (KeyError, ValueError):
            steps = int(self.flat.get("MAX_TRAIN_STEPS", 1000))
        alloc = self.flat.get("TIMESTEP_ALLOCATION") or {}
        model = TimestepHistogramModel(
            bin_size=int(alloc.get("bin_size", 100)) or 100,
            max_tickets=max(steps, 1))
        mode = self.ts_preset_var.get()
        if mode != "Uniform":
            # the Odds-Scaled preset honors the preset's TIMESTEP_ODDS_SCALE
            # (reference gui_math.py:30-46)
            model.apply_distribution(
                mode, odds_scale=float(
                    self.flat.get("TIMESTEP_ODDS_SCALE", 3.0) or 3.0))
        self.flat["TIMESTEP_ALLOCATION"] = model.get_allocation()
        # persist the selected mode like the reference GUI (gui.py:5793)
        self.flat["TIMESTEP_MODE"] = mode
        self._log_line(f"[gui] timestep allocation -> {mode} "
                       f"({sum(model.counts)} tickets)")

    def apply_bell_loss_weight(self):
        from .curve_models import LossWeightCurveModel

        model = LossWeightCurveModel()
        model.apply_bell_preset()
        self.flat["TIMESTEP_LOSS_WEIGHT_CURVE"] = model.get_points()
        self._log_line("[gui] timestep loss-weight curve -> bell preset")

    def open_curve_editor(self):
        CurveEditorWindow(
            self.root, self.flat, self.theme,
            on_apply=lambda: self._log_line(
                "[gui] curves applied (LR / loss weight / timesteps)"))

    def open_dataset_manager(self):
        def on_change():
            self.flat["INSTANCE_DATASETS"] = self.datasets.get_config()
            self.dataset_var.set(self._dataset_summary())

        DatasetManagerWindow(self.root, self.datasets, self.collect_flat,
                             self.theme, on_change=on_change,
                             log=self._log_line)

    def open_all_settings(self):
        # sync quick-edit entries into flat first so the full form shows them
        self.flat = self.collect_flat()

        def on_apply():
            for key, var in self.entries.items():
                var.set(str(self.flat.get(key, "")))
            self._log_line("[gui] settings applied (full form)")

        ConfigFormWindow(self.root, self.flat, self.mode_var.get(),
                         self.theme, on_apply=on_apply, log=self._log_line)

    def _dataset_summary(self) -> str:
        n = len(self.datasets.datasets)
        return (f"Datasets: {n} | images with repeats: "
                f"{self.datasets.total_with_repeats()}")

    def clear_caches(self):
        cfg = self.collect_flat()
        for i in range(len(self.datasets.datasets)):
            for path in self.datasets.clear_cache(i, cfg):
                self._log_line(f"[gui] cleared cache {path}")

    # -- training -----------------------------------------------------------
    def start_training(self):
        if self.runner and self.runner.is_running():
            return
        preset = self.save_preset()
        module = trainer_module(self.mode_var.get())
        self.metrics = LiveMetrics()
        self.loss_chart.clear()
        self.lr_chart.clear()
        self._chart_fed = [0, 0, 0, 0]
        self.runner = launch_trainer(
            module, preset, module=True, cwd=Path.cwd(),
            on_line=self._on_line, on_progress=self._on_progress,
            on_exit=lambda code: self._log_line(f"[gui] trainer exited ({code})"))
        self._log_line(f"[gui] launched {' '.join(self.runner.args)}")

    def stop_training(self):
        if self.runner:
            self.runner.stop()
            self._log_line("[gui] stop requested")

    def force_save(self):
        flag = request_force_save(Path.cwd())
        self._log_line(f"[gui] emergency checkpoint requested ({flag})")

    # -- console ------------------------------------------------------------
    def _on_line(self, line: str):
        self.metrics.parse_line(line)
        self._log_line(line)

    def _on_progress(self, line: str):
        self.metrics.parse_line(line)

    def _log_line(self, line: str):
        self.log.append(line)

    def _feed_charts(self):
        """Move newly-parsed metric points into the chart models."""
        feeds = [(self.metrics.step_loss, self.loss_chart, 0),
                 (self.metrics.loss_ema, self.loss_chart, 1),
                 (self.metrics.lr, self.lr_chart, 0),
                 (self.metrics.grad_clipped, self.lr_chart, 1)]
        for slot, (series, chart, line) in enumerate(feeds):
            n = len(series.xs)
            for i in range(self._chart_fed[slot], n):
                chart.append(line, series.xs[i], series.ys[i])
            self._chart_fed[slot] = n

    def _show_latest_preview(self):
        path = self.metrics.latest_preview
        if not path or path == self._preview_shown:
            return
        try:
            photo = self.tk_module.PhotoImage(file=path)
        except Exception:  # noqa: BLE001 — file mid-write or non-PNG
            return
        self._preview_photo = photo
        self._preview_shown = path
        self.preview_label.configure(image=photo,
                                     text=Path(path).name, compound="top")

    def _refresh(self):
        status = self.metrics.status_line() or "idle"
        if self.metrics.failures:
            status += f"  [{len(self.metrics.failures)} failure flags]"
        self.status_var.set(status)
        self._show_latest_preview()
        self._feed_charts()
        self.loss_canvas.redraw()
        self.lr_canvas.redraw()
        self.dist_canvas.redraw()
        self.console.configure(state="normal")
        self.console.delete("1.0", "end")
        self.console.insert("1.0", "\n".join(self.log.tail(200)))
        self.console.see("end")
        self.console.configure(state="disabled")
        self.root.after(300, self._refresh)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import tkinter as tk
    except Exception as e:  # noqa: BLE001
        raise SystemExit(f"tkinter unavailable: {e}")
    try:
        root = tk.Tk()
    except tk.TclError as e:
        raise SystemExit(
            f"cannot open display ({e}); the GUI needs an X server — "
            "on headless machines run the CLI instead: "
            "python -m aozora_sdxl_training_tpu_torch.cli.train_sdxl --config ... "
            "(or ...cli.train_anima)")
    TrainingApp(root, argv[0] if argv else None)
    root.mainloop()


if __name__ == "__main__":
    main()
