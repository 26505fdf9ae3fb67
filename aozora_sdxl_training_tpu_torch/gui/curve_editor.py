"""Toolkit-free interaction view-models for the curve/histogram editors.

Copy of ``aozora_sdxl_training_tpu/gui/curve_editor.py``, kept in the port so that the
port imports nothing of the JAX package.

The reference authors its three training curves with custom-painted Qt
widgets (draggable LR curve gui.py:1956-2251, timestep histogram
gui.py:2253-2432, loss-weight curve gui.py:2434-2683).  Here the entire
interaction layer — pixel<->data transforms, hit testing, drag semantics,
add/remove gestures — lives in these plain classes over the headless edit
models (``curve_models.py``).  The tkinter canvases in ``app.py`` only
forward mouse events and render the primitives these classes return, so
every editing behavior is unit-testable without a display.
"""

from __future__ import annotations

import math

HIT_RADIUS_PX = 10.0


class CurveEditorViewModel:
    """Editable polyline over an LRCurveModel or LossWeightCurveModel.

    y_scale "log" maps the LR axis like the reference's log-y LR editor;
    "linear" serves the loss-weight curve.  Gestures:

    * press near a handle selects it; drag moves it (model clamping rules
      apply: endpoint x pinned, interior x bounded by neighbours);
    * double-press away from handles adds a point (model placement rule:
      widest-gap bisection);
    * right-press near an interior handle removes it.
    """

    def __init__(self, model, *, width: int = 560, height: int = 240,
                 y_scale: str = "linear", y_min: float | None = None,
                 y_max: float | None = None,
                 pad: tuple[int, int, int, int] = (52, 12, 14, 20)):
        self.model = model
        self.width, self.height = int(width), int(height)
        self.y_scale = y_scale
        self._y_min = y_min
        self._y_max = y_max
        self.pad_l, self.pad_r, self.pad_t, self.pad_b = pad
        self.selected: int | None = None

    # -- axis bounds ---------------------------------------------------------
    def y_bounds(self) -> tuple[float, float]:
        lo = self._y_min if self._y_min is not None else getattr(
            self.model, "min_lr", getattr(self.model, "MIN_WEIGHT", 0.0))
        hi = self._y_max if self._y_max is not None else getattr(
            self.model, "max_lr", getattr(self.model, "MAX_WEIGHT", 1.0))
        if self.y_scale == "log":
            lo = max(lo, 1e-12)
            hi = max(hi, lo * (1 + 1e-9))
        elif hi <= lo:
            hi = lo + 1e-9
        return float(lo), float(hi)

    def resize(self, width: int, height: int) -> None:
        self.width, self.height = max(int(width), 60), max(int(height), 40)

    # -- transforms ------------------------------------------------------------
    def x_to_px(self, x: float) -> float:
        return self.pad_l + x * (self.width - self.pad_l - self.pad_r)

    def px_to_x(self, px: float) -> float:
        span = self.width - self.pad_l - self.pad_r
        return min(1.0, max(0.0, (px - self.pad_l) / span))

    def y_to_px(self, y: float) -> float:
        lo, hi = self.y_bounds()
        if self.y_scale == "log":
            y = max(y, lo)
            frac = (math.log(y) - math.log(lo)) / (math.log(hi) - math.log(lo))
        else:
            frac = (y - lo) / (hi - lo)
        frac = min(1.0, max(0.0, frac))
        return self.height - self.pad_b - frac * (
            self.height - self.pad_t - self.pad_b)

    def px_to_y(self, py: float) -> float:
        lo, hi = self.y_bounds()
        span = self.height - self.pad_t - self.pad_b
        frac = (self.height - self.pad_b - py) / span
        frac = min(1.0, max(0.0, frac))
        if self.y_scale == "log":
            return math.exp(math.log(lo) + frac * (math.log(hi) - math.log(lo)))
        return lo + frac * (hi - lo)

    # -- render primitives -----------------------------------------------------
    def handles_px(self) -> list[tuple[float, float, bool]]:
        pts = self._points()
        return [(self.x_to_px(x), self.y_to_px(y), i == self.selected)
                for i, (x, y) in enumerate(pts)]

    def polyline_px(self) -> list[tuple[float, float]]:
        return [(self.x_to_px(x), self.y_to_px(y)) for x, y in self._points()]

    def y_ticks(self, n: int = 3) -> list[tuple[float, str]]:
        lo, hi = self.y_bounds()
        out = []
        for i in range(n):
            frac = i / (n - 1) if n > 1 else 0.0
            if self.y_scale == "log":
                y = math.exp(math.log(lo) + frac * (math.log(hi) - math.log(lo)))
            else:
                y = lo + frac * (hi - lo)
            out.append((self.y_to_px(y), f"{y:.3g}"))
        return out

    def _points(self) -> list[list[float]]:
        pts = self.model.get_points()
        if isinstance(pts, dict):  # loss-weight "bell" preset token
            pts = type(self.model).bell_preview_points()
        return pts

    # -- gestures ----------------------------------------------------------------
    def hit_test(self, px: float, py: float) -> int | None:
        best, best_d = None, HIT_RADIUS_PX
        for i, (hx, hy, _) in enumerate(self.handles_px()):
            d = math.hypot(px - hx, py - hy)
            if d <= best_d:
                best, best_d = i, d
        return best

    def press(self, px: float, py: float) -> int | None:
        self.selected = self.hit_test(px, py)
        return self.selected

    def drag(self, px: float, py: float) -> bool:
        if self.selected is None:
            return False
        self.model.move_point(self.selected, self.px_to_x(px),
                              self.px_to_y(py))
        return True

    def release(self) -> None:
        self.selected = None

    def double_press(self, px: float, py: float) -> int:
        """Add a point unless double-clicking an existing handle."""
        if self.hit_test(px, py) is not None:
            return -1
        idx = self.model.add_point()
        if idx >= 0:
            # then pull the fresh point toward the click
            self.model.move_point(idx, self.px_to_x(px), self.px_to_y(py))
            self.selected = idx
        return idx

    def right_press(self, px: float, py: float) -> bool:
        idx = self.hit_test(px, py)
        if idx is None:
            return False
        removed = self.model.remove_point(idx)
        if removed:
            self.selected = None
        return removed


class HistogramEditorViewModel:
    """Editable bar chart over a TimestepHistogramModel.

    Press/drag paints bar heights (the count implied by the pointer's y);
    the view y-axis autoscales to the current max count.  Totals are free —
    the trainer rescales counts to MAX_TRAIN_STEPS x batch via
    largest-remainder anyway (data/schedule.py), matching the reference's
    histogram semantics.
    """

    def __init__(self, model, *, width: int = 560, height: int = 240,
                 pad: tuple[int, int, int, int] = (52, 12, 14, 20)):
        self.model = model
        self.width, self.height = int(width), int(height)
        self.pad_l, self.pad_r, self.pad_t, self.pad_b = pad
        self.painting = False

    def resize(self, width: int, height: int) -> None:
        self.width, self.height = max(int(width), 60), max(int(height), 40)

    def _y_max(self) -> float:
        return max(max(self.model.counts, default=1), 1) * 1.15

    def bar_index(self, px: float) -> int | None:
        n = len(self.model.counts)
        span = self.width - self.pad_l - self.pad_r
        if n == 0 or span <= 0:
            return None
        i = int((px - self.pad_l) / span * n)
        return i if 0 <= i < n else None

    def count_at(self, py: float) -> int:
        span = self.height - self.pad_t - self.pad_b
        frac = (self.height - self.pad_b - py) / span
        return max(0, int(round(min(1.0, max(0.0, frac)) * self._y_max())))

    def bars_px(self) -> list[tuple[float, float, float, float]]:
        n = len(self.model.counts)
        span = self.width - self.pad_l - self.pad_r
        y_max = self._y_max()
        base = self.height - self.pad_b
        h_span = self.height - self.pad_t - self.pad_b
        out = []
        for i, c in enumerate(self.model.counts):
            x0 = self.pad_l + span * i / n
            x1 = self.pad_l + span * (i + 1) / n
            y0 = base - (c / y_max) * h_span
            out.append((x0 + 1, y0, x1 - 1, base))
        return out

    def press(self, px: float, py: float) -> bool:
        self.painting = self.bar_index(px) is not None
        if self.painting:
            self._paint(px, py)
        return self.painting

    def drag(self, px: float, py: float) -> bool:
        if not self.painting:
            return False
        self._paint(px, py)
        return True

    def release(self) -> None:
        self.painting = False

    def _paint(self, px: float, py: float) -> None:
        i = self.bar_index(px)
        if i is not None:
            self.model.counts[i] = self.count_at(py)
